"""FFN blocks (port of ``repro.nn.moe``): the gated SwiGLU FFN and the top-k
Mixture-of-Experts.

MoE dispatch is sort-based with a fixed capacity per expert (GShard-style):
each group's (token, k) pairs are ordered by their expert (a stable sort),
positioned by a running offset, and scattered into a ``[G, E, cap, D]``
buffer; pairs past an expert's capacity are dropped, and the weighted
combine makes the drop graceful.  ``dp_groups`` G splits the tokens into
independent dispatch groups, each with its own capacity.

:func:`moe_apply_shard_map` is the reference's ``shard_map`` route on one
card: one rank, so every expert is local, the model axis has size 1 and
its ``psum`` is the identity; its body keeps the reference's casts and
order (the gate values cast to the compute dtype before the combine, the
aux loss over all tokens at once).

The expert products are ``torch.einsum``: the reference computes them
outside any Pallas kernel.  Where JAX drops an out-of-range scatter lane
(``mode="drop"``) the port writes it to a spare buffer row that is cut
off, and where it fills an out-of-range gather lane (``mode="fill"``) the
port reads a zero row appended to the buffer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.layers import Dtypes

__all__ = ["ffn_init", "ffn_apply", "moe_capacity", "moe_init", "moe_apply",
           "moe_apply_shard_map", "normal_init"]


def normal_init(gen: torch.Generator, shape, s: float, dt: Dtypes, device: torch.device,
                promote: bool) -> torch.Tensor:
    """A normal draw in ``dt.param`` times the fp32 scale ``s``; with
    ``promote``, the product in fp32 (the reference's init multiplies by an
    fp32 array, which promotes a bf16 draw)."""
    x = torch.randn(shape, generator=gen, dtype=dt.param, device=device)
    if promote:
        x = x.to(torch.promote_types(dt.param, torch.float32))
    return x.mul_(s)


def ffn_init(gen: torch.Generator, d: int, ff: int, dt: Dtypes,
             device: torch.device, lead=(), promote: bool = False) -> Dict[str, torch.Tensor]:
    """``gate`` / ``up`` [d, ff] and ``down`` [ff, d], normal / sqrt(fan-in);
    ``lead`` prepends stacking dims (the transformer's layer groups)."""
    s_in, s_ff = float(np.float32(1.0 / np.sqrt(d))), float(np.float32(1.0 / np.sqrt(ff)))
    lead = tuple(lead)
    return {"gate": normal_init(gen, lead + (d, ff), s_in, dt, device, promote),
            "up": normal_init(gen, lead + (d, ff), s_in, dt, device, promote),
            "down": normal_init(gen, lead + (ff, d), s_ff, dt, device, promote)}


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, dt: Dtypes) -> torch.Tensor:
    xc = x.to(dt.compute)
    h = F.silu(xc @ p["gate"].to(dt.compute)) * (xc @ p["up"].to(dt.compute))
    return h @ p["down"].to(dt.compute)


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def moe_init(gen: torch.Generator, d: int, ff: int, n_experts: int, dt: Dtypes,
             device: torch.device, lead=(), promote: bool = False) -> Dict[str, torch.Tensor]:
    """``router`` [d, E], ``gate`` / ``up`` [E, d, ff], ``down`` [E, ff, d]."""
    s_in, s_ff = float(np.float32(1.0 / np.sqrt(d))), float(np.float32(1.0 / np.sqrt(ff)))
    lead = tuple(lead)
    return {"router": normal_init(gen, lead + (d, n_experts), s_in, dt, device, promote),
            "gate": normal_init(gen, lead + (n_experts, d, ff), s_in, dt, device, promote),
            "up": normal_init(gen, lead + (n_experts, d, ff), s_in, dt, device, promote),
            "down": normal_init(gen, lead + (n_experts, ff, d), s_ff, dt, device, promote)}


def _route(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, ...]:
    """(probs, gate values renormalised over the top k, expert indices)."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 counts of the values of ``idx`` [..., L] in [0, n), a row per
    leading index."""
    lead = idx.shape[:-1]
    flat = idx.reshape(-1, idx.shape[-1])
    out = torch.zeros((flat.shape[0], n), dtype=torch.float32, device=idx.device)
    out.scatter_add_(1, flat, torch.ones(flat.shape, dtype=torch.float32, device=idx.device))
    return out.reshape(lead + (n,))


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, dt: Dtypes, *, top_k: int,
              capacity_factor: float = 1.25, dp_groups: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (output [B, S, D], the Switch aux load-balancing loss)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    t = b * s
    g = max(1, dp_groups)
    if t % g:
        raise ValueError(f"moe_apply: {t} tokens do not divide into {g} dispatch groups")
    tl = t // g
    cap = moe_capacity(tl, e, top_k, capacity_factor)
    dev = x.device

    xt = x.reshape(g, tl, d).to(dt.compute)
    logits = torch.einsum("gtd,de->gte", xt, p["router"].to(dt.compute)).to(torch.float32)
    probs, gate_vals, expert_idx = _route(logits, top_k)  # [G, Tl, K]

    # Switch-style aux loss (per group, then averaged)
    one = _counts(expert_idx.reshape(g, tl * top_k), e) / (tl * top_k)
    aux = e * torch.mean(torch.sum(probs.mean(1) * one, dim=-1))

    # --- sort-based dispatch, independent per group
    flat_e = expert_idx.reshape(g, tl * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous(),
                                side="left")
    pos_in_e = torch.arange(tl * top_k, device=dev)[None, :] - torch.gather(starts, -1, sorted_e)
    keep = pos_in_e < cap
    gofs = (torch.arange(g, device=dev) * (e * cap))[:, None]
    # a dropped lane goes to the spare row g*e*cap: cut off after the
    # scatter, read as zeros in the combine
    flat_slot = torch.where(keep, sorted_e * cap + pos_in_e + gofs, g * e * cap).reshape(-1)
    src_token = (order // top_k + (torch.arange(g, device=dev) * tl)[:, None]).reshape(-1)
    xt_flat = xt.reshape(t, d)
    buf = torch.zeros((g * e * cap + 1, d), dtype=dt.compute, device=dev).index_copy(
        0, flat_slot, xt_flat[src_token])
    buf = buf[:-1].reshape(g, e, cap, d)

    # --- expert FFN (batched over groups x experts)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["gate"].to(dt.compute))) * torch.einsum(
        "gecd,edf->gecf", buf, p["up"].to(dt.compute))
    out_buf = torch.einsum("gecf,efd->gecd", h, p["down"].to(dt.compute)).reshape(g * e * cap, d)

    # --- weighted combine
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    gathered = out_buf[flat_slot]  # [G*Tl*K, D]
    w = torch.gather(gate_vals.reshape(g, tl * top_k), -1, order)
    contrib = gathered * w.reshape(-1)[:, None].to(dt.compute)
    out = torch.zeros((t, d), dtype=dt.compute, device=dev).index_add(0, src_token, contrib)
    return out.reshape(b, s, d), aux


def moe_apply_shard_map(p: Dict[str, torch.Tensor], x: torch.Tensor, dt: Dtypes, *,
                        top_k: int, capacity_factor: float = 1.25
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply_shard_map`` on one card (one data rank,
    one model rank: all experts local, no ``psum``).  x [B, S, D] ->
    (output [B, S, D], aux loss)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    t = b * s
    dev = x.device
    xt = x.reshape(t, d).to(dt.compute)

    logits = (xt @ p["router"].to(dt.compute)).to(torch.float32)
    probs, gate_vals, expert_idx = _route(logits, top_k)
    gate_vals = gate_vals.to(dt.compute)
    frac = _counts(expert_idx.reshape(-1), e) / (t * top_k)
    aux = e * torch.sum(probs.mean(0) * frac)

    # the block body on its one rank: every expert local (e_l = e)
    flat_e = expert_idx.reshape(-1)
    w = gate_vals.reshape(-1)
    cap = moe_capacity(t, e, top_k, capacity_factor)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    pos = torch.arange(t * top_k, device=dev) - starts[torch.clamp_max(se, e - 1)]
    keep = (se < e) & (pos < cap)
    slot = torch.where(keep, se * cap + pos, e * cap)  # e * cap: the spare row
    src = order // top_k
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=dev).index_copy(0, slot, xt[src])
    buf = buf[:-1].reshape(e, cap, d)
    gate_w, up_w, down_w = (p[k].to(dt.compute) for k in ("gate", "up", "down"))
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, gate_w)) * torch.einsum("ecd,edf->ecf", buf,
                                                                          up_w)
    outb = torch.einsum("ecf,efd->ecd", h, down_w).reshape(e * cap, d)
    gathered = torch.cat([outb, outb.new_zeros((1, d))])[slot]
    contrib = gathered * w[order][:, None]
    out = torch.zeros_like(xt).index_add(0, src, torch.where(keep[:, None], contrib, 0))
    return out.reshape(b, s, d), aux
