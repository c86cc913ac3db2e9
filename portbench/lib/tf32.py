"""TF32 arithmetic in plain torch, for the controls: each matrix product's
operands rounded to TF32 (1 sign, 8 exponent and 10 mantissa bits, round
to nearest, ties to even), the products summed in fp32, in the forward and
the backward alike.  That is what a card does with fp32 operands when TF32
is allowed, made the same on the CPU, so that a control reads alike in the
tests and on the card."""
from __future__ import annotations

import torch

__all__ = ["round_tf32", "matmul"]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to the nearest TF32 value, kept in fp32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, round_tf32(b).transpose(-1, -2)),
                torch.matmul(round_tf32(a).transpose(-1, -2), g))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in TF32 (2-D, or batched 3-D operands)."""
    return _MatMul.apply(a, b)
