"""Recsys interaction layers (port of ``repro.nn.recsys``): FM pooling, DIN
target attention, the DIEN GRU and AUGRU, and MIND's capsule routing.
Layers take embedding rows that upstream code fetched through the cache:
the interaction math is cache-agnostic.  Parameters are nested dicts of
tensors under the reference's names, so converted JAX parameters drop
straight in."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref
from repro_torch.nn.layers import Dtypes, mlp, mlp_init

__all__ = ["fm_interaction", "din_attention_init", "din_attention", "gru_init", "gru", "augru",
           "capsule_routing"]

Params = Dict[str, torch.Tensor]


def fm_interaction(v: torch.Tensor, use_pallas: bool = False) -> torch.Tensor:
    """2-way FM pooling via the O(nk) sum-square trick (Rendle ICDM'10).

    v: [..., fields, dim] (embedding * feature value already folded in).
    Returns [...]: sum_{i<j} <v_i, v_j>.  ``use_pallas`` runs the FM kernel
    (serving only: it has no backward); otherwise torch ops in ``v``'s
    dtype, which autograd differentiates."""
    if use_pallas:
        from repro_torch.kernels.fm_interaction import ops as fm_ops

        return fm_ops.fm_interaction(v)
    return fm_interaction_ref(v)


# ---------------------------------------------------------------------------
# DIN: target attention over user behaviour history (arXiv:1706.06978)
# ---------------------------------------------------------------------------


def din_attention_init(gen: torch.Generator, dim: int, attn_units: Tuple[int, ...], dt: Dtypes,
                       device: torch.device) -> Dict[str, Params]:
    """The attention MLP over ``[hist, target, hist - target, hist * target]``
    (4 * dim inputs) down to one score."""
    return mlp_init(gen, (4 * dim,) + tuple(attn_units) + (1,), dt, device)


def din_attention(
    p: Dict[str, Params],
    hist: torch.Tensor,  # [B, T, D] behaviour embeddings
    target: torch.Tensor,  # [B, D] candidate item embedding
    mask: torch.Tensor,  # [B, T] bool valid positions
    dt: Dtypes,
) -> torch.Tensor:
    """Weighted-sum pooling with MLP-scored target attention -> [B, D]:
    sigmoid between the MLP's layers, a softmax over the valid positions
    (the open-source variant of the paper's unnormalised weights)."""
    tgt = target[:, None, :].expand(hist.shape)
    feats = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
    scores = mlp(p, feats, dt, act=torch.sigmoid)[..., 0]  # [B, T]
    scores = torch.where(mask, scores, -1e30)
    w = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    return torch.einsum("bt,btd->bd", w, hist)


# ---------------------------------------------------------------------------
# DIEN: GRU interest extraction + AUGRU interest evolution (arXiv:1809.03672)
# ---------------------------------------------------------------------------


def gru_init(gen: torch.Generator, d_in: int, d_h: int, dt: Dtypes,
             device: torch.device) -> Params:
    """Input and hidden maps of the update / reset / candidate gates,
    uniform(+-1/sqrt(d_h)), and a zero bias."""
    s = float(np.float32(1.0) / np.sqrt(np.float32(d_h)))

    def m(i, o):
        return torch.rand((i, o), generator=gen, dtype=dt.param, device=device) * (2 * s) - s

    return {"wx": m(d_in, 3 * d_h), "wh": m(d_h, 3 * d_h),
            "b": torch.zeros((3 * d_h,), dtype=dt.param, device=device)}


def _gru_cell(p: Params, h: torch.Tensor, x: torch.Tensor, att: Optional[torch.Tensor],
              dt: Dtypes) -> torch.Tensor:
    d_h = h.shape[-1]
    x = x.to(dt.compute)
    wx, wh, b = (p[k].to(dt.compute) for k in ("wx", "wh", "b"))
    gates = x @ wx + h @ wh + b
    u = torch.sigmoid(gates[..., :d_h])
    r = torch.sigmoid(gates[..., d_h:2 * d_h])
    # the candidate uses the reset-scaled h: its slice recomputed with r * h
    cand = torch.tanh(x @ wx[:, 2 * d_h:] + (r * h) @ wh[:, 2 * d_h:] + b[2 * d_h:])
    if att is not None:  # AUGRU: attention scales the update gate
        u = u * att[..., None]
    return (1.0 - u) * h + u * cand


def gru(p: Params, xs: torch.Tensor, dt: Dtypes,
        att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs [B, T, D] -> hidden states [B, T, H], a loop over T from a zero
    state; ``att`` [B, T] turns it into AUGRU.  Without ``att`` the
    reference scales the update gate by ones, an exact no-op left out here."""
    b, t, _ = xs.shape
    h = torch.zeros((b, p["wh"].shape[0]), dtype=dt.compute, device=xs.device)
    xs_t = xs.transpose(0, 1).contiguous()  # [T, B, D]
    hs = []
    for i in range(t):
        h = _gru_cell(p, h, xs_t[i], None if att is None else att[:, i], dt)
        hs.append(h)
    return torch.stack(hs, dim=1)


def augru(p: Params, xs: torch.Tensor, att: torch.Tensor, dt: Dtypes) -> torch.Tensor:
    return gru(p, xs, dt, att=att)


# ---------------------------------------------------------------------------
# MIND: behaviour-to-interest dynamic (capsule) routing (arXiv:1904.08030)
# ---------------------------------------------------------------------------


def capsule_routing(
    hist: torch.Tensor,  # [B, T, D] behaviour capsules
    mask: torch.Tensor,  # [B, T]
    s_matrix: torch.Tensor,  # [D, D] shared bilinear map
    n_interests: int,
    iters: int = 3,
    routing_init: Optional[torch.Tensor] = None,  # [B, K, T] fixed logits
) -> torch.Tensor:
    """B2I dynamic routing -> interest capsules [B, K, D].  The routing
    logits start at zero (or ``routing_init``) and take no gradient (the
    capsules are detached where they update them, per the paper)."""
    b, t, d = hist.shape
    u = torch.einsum("btd,de->bte", hist, s_matrix)  # mapped behaviours
    logits = (routing_init if routing_init is not None
              else torch.zeros((b, n_interests, t), dtype=u.dtype, device=u.device))

    def squash(v):
        n2 = torch.sum(v * v, dim=-1, keepdim=True)
        return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)

    caps = torch.zeros((b, n_interests, d), dtype=u.dtype, device=u.device)
    for _ in range(iters):
        w = torch.softmax(torch.where(mask[:, None, :], logits, -1e30), dim=-1)
        caps = squash(torch.einsum("bkt,btd->bkd", w, u))
        logits = logits + torch.einsum("bkd,btd->bkt", caps.detach(), u)
    return caps
