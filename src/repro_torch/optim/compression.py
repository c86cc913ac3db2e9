"""Gradient compression for the data-parallel reduction, with error feedback
(port of ``repro.optim.compression``).

Codecs: ``none``; ``bf16`` (2x: a cast to bfloat16); ``int8`` (4x:
per-tensor symmetric int8 with an fp32 scale, ``round`` half to even, and
error feedback: each step's quantisation residual is added to the next
step's gradient).  On one card there is no reduction: ``encode`` then
``decode`` gives the gradients the reduction would have carried.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_pick

__all__ = ["Compressor"]


@dataclasses.dataclass(frozen=True)
class Compressor:
    codec: str = "none"  # none | bf16 | int8

    def init(self, grads_like: Any) -> Any:
        """The error-feedback state: fp32 zeros a leaf for int8, else ``()``."""
        if self.codec != "int8":
            return ()
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like)

    def encode(self, grads: Any, state: Any) -> Tuple[Any, Any, Any]:
        """(payload, sideband, new_state): the payload crosses the wire in
        the codec's dtype, the sideband holds int8's per-tensor fp32
        scales."""
        if self.codec == "none":
            return grads, (), state
        if self.codec == "bf16":
            return tree_map(lambda g: g.to(torch.bfloat16), grads), (), state

        def enc(g, e):
            gf = g.to(torch.float32) + e
            # tensors on both sides: the card divides by a host scalar as a
            # multiply by its reciprocal
            scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / torch.full(
                (), 127.0, device=gf.device)
            q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            return q, scale, gf - q.to(torch.float32) * scale

        out = tree_map(enc, grads, state)
        return tuple(tree_pick(grads, out, i) for i in range(3))

    def decode(self, payload: Any, sideband: Any, target_like: Any) -> Any:
        """The payload back in the dtypes of ``target_like``."""
        if self.codec == "none":
            return payload
        if self.codec == "bf16":
            return tree_map(lambda q, t: q.to(t.dtype), payload, target_like)
        return tree_map(lambda q, s, t: (q.to(torch.float32) * s).to(t.dtype),
                        payload, sideband, target_like)

    def wire_bytes(self, grads: Any) -> int:
        per = {"none": 4, "bf16": 2, "int8": 1}[self.codec]
        return sum(x.numel() * per for x in tree_leaves(grads))
