"""Differentiable flash attention in the model layout (port of
``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v, causal, window)`` takes ``q`` ``[B, S, Hq, D]``
and ``k``, ``v`` ``[B, S, Hkv, D]`` and returns ``[B, S, Hq, D]``.  The
forward is :func:`kernel.flash_attention` on the ``[B, H, S, D]`` views of
its inputs: the CUDA kernel on CUDA tensors (which reads the views in place
and writes its output in ``q``'s layout, so nothing is transposed in
memory), the plain version on CPU tensors.  The backward recomputes through
the plain version by autograd, as the reference's ``_attn_bwd`` recomputes
through ``attention_ref``; the reference has no backward kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.contracts import contract
from repro_torch.kernels.flash_attention import kernel as _kernel

__all__ = ["flash_attention"]


class _Attn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.meta = (causal, window)
        return _kernel.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       causal, window).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _kernel.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                                v.transpose(1, 2), *ctx.meta).transpose(1, 2)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


@contract(max_sort_size=0)
def flash_attention(
    q: torch.Tensor,  # [B, S, Hq, D] (model layout)
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    return _Attn.apply(q, k, v, causal, window)
