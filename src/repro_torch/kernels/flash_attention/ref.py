"""Plain-torch twin of ``repro.kernels.flash_attention.ref``: the dense
masked softmax oracle of the flash-attention kernel."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    causal: bool = True,
    window: Optional[int] = None,
    q_start: int = 0,
) -> torch.Tensor:
    """softmax(mask(q k^T / sqrt(D))) v in fp32, the query heads grouped
    over their KV head; masked scores are the finite -1e30; result in q's
    dtype.  ``q_start`` is the position of q's first row, so a block of
    query rows masks as it would inside the whole sequence."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(d)
    qi = torch.arange(q_start, q_start + sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= (qi - ki) < window
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()).reshape(b, h, sq, d).to(q.dtype)
