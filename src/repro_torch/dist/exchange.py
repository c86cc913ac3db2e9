"""The exchange between the shards of a hybrid-parallel collection, one
shard a rank (``data == 1``).

Every rank holds the whole batch, the replicated routing tables and one
shard's arena, so the two legs between ranks are:

* **the slot leg** (:func:`slot_leg`): each rank plans its own shard and
  all-gathers its ``[U]`` int32 plan slots into the ``[S, U]`` image that
  ``ShardedEmbeddingCollection._combine_slots`` reads, as it reads the
  stacked plan's.
* **the row leg** (:func:`row_leg`): each owner takes its rows for the
  lanes routed to it from its local arena (zero rows elsewhere), encodes
  them under an ``exchange_codec``, and the rows cross to every rank, where
  each lane keeps its owner's row and decodes it.  The result is bitwise
  what the stacked layout's ``take_fill`` / ``_EncodedExchange`` gives on
  the flattened ``[S * capacity, dim]`` arena: a lane is copied, never
  summed (a sum all-reduce of zero-padded rows would turn ``-0.0`` into
  ``+0.0``), and a row codec encodes each row alone.  Every rank holds the
  whole lane gradient, the same on each, so the backward keeps the owned
  lanes' part with no collective (straight through under a codec).

Width: the slot leg sends the plan's ``U`` slots, or its compact ``W``
(``max_routed_per_shard``).  The row leg sends at the lane width (every
lane's row, zero where another rank owns it) when ``W`` is 0 or not below
the lane count; else each owner sends only its distinct routed rows, ``W
+ 1`` of them (the plan drops the lanes past ``W``, so no live address of
a shard is past it; the last row is always a zero row, which the padding
lanes read).
Every rank derives the send list and each lane's pick alike from the
replicated addresses, by a mark and a running count over the ``[S *
capacity]`` addresses: no sort and no host sync a plan sizes a buffer.  A
rank sends ``(S - 1) x`` its part a leg.  The transport is ``all_gather``
of a tensor list on both backends: gloo takes CUDA tensors there and
stages them through the host itself (it refused ``all_gather_into_tensor``
on the card), NCCL moves them card to card.  ``mesh.traffic`` counts the
collectives, the bytes this rank sent and the host seconds in the calls.

A coordinate-only mesh (no process group) runs the legs at ``model == 1``
only, where each is the identity.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import contract
from repro_torch.core.lanes import take_fill
from repro_torch.dist.mesh import HybridMesh
from repro_torch.store.codec import get_codec

__all__ = ["all_gather", "broadcast_", "compact_route", "owner_rows", "row_leg", "slot_leg"]


def all_gather(t: torch.Tensor, mesh: HybridMesh) -> torch.Tensor:
    """``[S, *t.shape]``: every model rank's ``t``, in model-rank order."""
    if mesh.group is None:
        if mesh.model != 1:
            raise ValueError(f"a mesh with no process group cannot exchange between "
                             f"{mesh.model} shards")
        return t.unsqueeze(0)
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(mesh.model)]
    t0 = time.perf_counter()
    dist.all_gather(outs, t, group=mesh.group)
    mesh.traffic.seconds += time.perf_counter() - t0
    mesh.traffic.collectives += 1
    mesh.traffic.bytes_sent += t.numel() * t.element_size() * (mesh.model - 1)
    return torch.stack(outs)


def broadcast_(t: torch.Tensor, mesh: HybridMesh, src: int = 0) -> torch.Tensor:
    """``t`` overwritten in place by model rank ``src``'s."""
    if mesh.group is None:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src, group=mesh.group)
    mesh.traffic.seconds += time.perf_counter() - t0
    mesh.traffic.collectives += 1
    if mesh.model_rank == src:
        mesh.traffic.bytes_sent += t.numel() * t.element_size() * (mesh.model - 1)
    return t


def owner_rows(part: torch.Tensor, owner: torch.Tensor, mesh: HybridMesh) -> torch.Tensor:
    """Lane ``i`` of every rank's ``part`` ``[N, ...]``, taken from rank
    ``owner[i]``: an all-gather, then one row gather (no arithmetic)."""
    n = part.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=part.device)
    return _picked(part, owner.to(torch.int64) * n + lane, mesh)


def _picked(part: torch.Tensor, pick: torch.Tensor, mesh: HybridMesh) -> torch.Tensor:
    """Entries ``pick`` of every rank's ``part`` ``[M, ...]`` laid end to
    end (rank ``r``'s entry ``j`` at ``r * M + j``)."""
    flat = all_gather(part, mesh).reshape((-1,) + tuple(part.shape[1:]))
    return flat.index_select(0, pick)


def compact_route(idx: torch.Tensor, cap: int, width: int, mesh: HybridMesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row leg's lists at the compact width: ``(send, pick)``.

    ``idx`` ``[N]`` are the combined addresses (``owner * cap + slot``, -1
    pads), the same on every rank.  Shard ``s``'s distinct live addresses,
    in ascending order, fill entries ``[0, width)`` of its block of ``width
    + 1``; ``send`` is this rank's block as local slots (-1: a zero row,
    always the last entry), and ``pick[i]`` lane ``i``'s entry among the
    blocks laid end to end (a padding lane, or a lane past its shard's
    ``width``, picks block 0's zero row)."""
    S, s = mesh.model, mesh.model_rank
    n = S * cap
    live = (idx >= 0) & (idx < n)
    at = torch.where(live, idx, n).to(torch.int64)
    seen = torch.zeros((n + 1,), dtype=torch.int32, device=idx.device)
    seen.index_fill_(0, at, 1)
    # each address's place among its shard's distinct addresses
    place = torch.cumsum(seen[:n].view(S, cap), dim=1, dtype=torch.int32) - 1
    pos = take_fill(place.view(-1), at, width).to(torch.int64)
    ok = live & (pos < width)
    owner = torch.div(at, cap, rounding_mode="floor")
    pick = torch.where(ok, owner * (width + 1) + pos, width)
    mine = ok & (owner == s)
    send = torch.full((width + 1,), -1, dtype=torch.int64, device=idx.device)
    send.index_put_((torch.where(mine, pos, width),), torch.where(mine, at - s * cap, -1))
    return send, pick


@contract(max_sort_size=0)
def slot_leg(slots: torch.Tensor, mesh: HybridMesh) -> torch.Tensor:
    """A rank's ``[1, U]`` plan slots -> every shard's ``[S, U]``."""
    return all_gather(slots[0], mesh)


class _RowLeg(torch.autograd.Function):
    """See :func:`row_leg`."""

    @staticmethod
    def forward(ctx, w_local: torch.Tensor, idx: torch.Tensor, lo: int, width: int,
                codec: Optional[str], mesh: HybridMesh) -> torch.Tensor:
        cap = w_local.shape[0]
        local = torch.where((idx >= lo) & (idx < lo + cap), idx - lo, -1)
        ctx.save_for_backward(local)
        ctx.rows = cap
        if 0 < width < idx.shape[0]:
            send, pick = compact_route(idx, cap, width, mesh)
        else:  # every lane; a padding lane (-1) reads rank 0's part: a zero row
            n = idx.shape[0]
            owner = torch.where(idx >= 0, torch.div(idx, cap, rounding_mode="floor"), 0)
            send = local
            pick = owner.to(torch.int64) * n + torch.arange(n, dtype=torch.int64,
                                                            device=idx.device)
        part = take_fill(w_local, send, 0.0)
        if codec is None:
            return _picked(part, pick, mesh)
        c = get_codec(codec)
        payload, side = c.encode(part)
        payload = _picked(payload, pick, mesh)
        if side is not None:
            side = _picked(side, pick, mesh)
        return c.decode(payload, side, w_local.dtype)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (local,) = ctx.saved_tensors
        n = ctx.rows
        grad = ct.new_zeros((n + 1,) + tuple(ct.shape[1:]))
        grad.index_add_(0, torch.where(local >= 0, local, n).to(torch.int64), ct)
        return grad[:n], None, None, None, None, None


@contract(max_sort_size=0)
def row_leg(w_local: torch.Tensor, idx: torch.Tensor, lo: int, width: int,
            codec: Optional[str], mesh: HybridMesh) -> torch.Tensor:
    """Rows of the combined addresses ``idx`` ``[N]`` (``owner * capacity +
    slot``; -1 pads, and lanes outside ``[0, S * capacity)`` are -1 too),
    read from the shards' arenas; this rank's arena ``w_local`` ``[capacity,
    dim]`` holds addresses ``[lo, lo + capacity)``.  ``width``: 0 (or at
    least ``N``) sends at the lane width, ``W < N`` at the compact width
    (see :func:`compact_route`).
    Differentiable w.r.t. ``w_local``."""
    return _RowLeg.apply(w_local, idx, lo, width, codec, mesh)
