"""The exchange between the ranks of a hybrid-parallel collection, one
shard a rank, ``data`` replicas of each shard.

Within one data replica, every rank holds the replica's slice of the batch,
the replicated routing tables and one shard's arena, so the two legs over
the replica's model group are:

* **the slot leg** (:func:`slot_leg`): each rank plans its own shard and
  all-gathers its ``[U]`` int32 plan slots into the ``[S, U]`` image that
  ``ShardedEmbeddingCollection._combine_slots`` reads, as it reads the
  stacked plan's.
* **the row leg** (:func:`row_leg`): each owner takes its rows for the
  replica's lanes routed to it from its local arena (zero rows elsewhere),
  encodes them under an ``exchange_codec``, and the rows cross to every
  rank of the replica, where each lane keeps its owner's row and decodes
  it.  The result is bitwise what the stacked layout's ``take_fill`` /
  ``_EncodedExchange`` gives on the flattened ``[S * capacity, dim]``
  arena: a lane is copied, never summed (a sum all-reduce of zero-padded
  rows would turn ``-0.0`` into ``+0.0``), and a row codec encodes each row
  alone.  Every rank holds the whole lane gradient, the same on each, so
  the backward keeps the owned lanes' part with no collective (straight
  through under a codec).

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
on the card), NCCL moves them card to card.

The data axis (``data > 1``; the data group of a shard) carries two legs:

* **the ids** (:func:`data_all_gather`): a replica's ids, gathered in
  data-rank order into the global batch's, so every replica of a shard
  plans the global batch and keeps the same cache;
* **the gradients** (:func:`data_sum`): an all-gather, then a sum in
  data-rank order, so every replica gets the same bits by construction
  whatever backend or algorithm carries them (a backend's own
  ``all_reduce`` promises no order, and the replicas must stay bitwise
  equal); one collective carries every tensor of a step.

:func:`move_homes_` copies host rows and tracker entries between the
shards' fixed homes (the refresh's swaps and the rebalance's re-homing):
each owner sends the rows that leave its homes for another shard's.
``mesh.traffic`` counts each axis' collectives, the bytes this rank sent
(by leg too) and the host seconds in the calls.

A coordinate-only mesh (no process group) runs the legs at ``model == 1``
and ``data == 1`` only, where each is the identity.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import contract
from repro_torch.core.lanes import take_fill
from repro_torch.dist.mesh import HybridMesh
from repro_torch.store.codec import get_codec

__all__ = ["all_gather", "broadcast_", "compact_route", "data_all_gather", "data_sum",
           "move_homes_", "owner_rows", "pack_rows", "row_leg", "slot_leg", "unpack_rows"]


def _gather(t: torch.Tensor, group, n: int, mesh: HybridMesh, leg: str, data: bool
            ) -> torch.Tensor:
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(outs, t, group=group)
    mesh.traffic.add(leg, t.numel() * t.element_size() * (n - 1), time.perf_counter() - t0,
                     data=data)
    return torch.stack(outs)


def all_gather(t: torch.Tensor, mesh: HybridMesh, leg: str = "model") -> torch.Tensor:
    """``[S, *t.shape]``: every model rank's ``t`` (in this rank's data
    replica), in model-rank order."""
    if mesh.group is None:
        if mesh.model != 1:
            raise ValueError(f"a mesh with no process group cannot exchange between "
                             f"{mesh.model} shards")
        return t.unsqueeze(0)
    return _gather(t, mesh.group, mesh.model, mesh, leg, False)


def data_all_gather(t: torch.Tensor, mesh: HybridMesh, leg: str = "ids") -> torch.Tensor:
    """``[D, *t.shape]``: every data replica's ``t`` (of this rank's
    shard), in data-rank order."""
    if mesh.data == 1:
        return t.unsqueeze(0)
    if mesh.data_group is None:
        raise ValueError(f"a mesh with no data group cannot exchange between {mesh.data} "
                         f"data replicas")
    return _gather(t, mesh.data_group, mesh.data, mesh, leg, True)


def _ordered_sum(g: torch.Tensor) -> torch.Tensor:
    """``g[0] + g[1] + ...``, left to right."""
    acc = g[0]
    for i in range(1, g.shape[0]):
        acc = acc + g[i]
    return acc


def data_sum(sums: Sequence[torch.Tensor], mesh: HybridMesh,
             gathers: Sequence[torch.Tensor] = (), leg: str = "grads"
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The sum of every data replica's ``sums[i]``, taken in data-rank
    order after an all-gather (the same bits on every replica), and each of
    ``gathers`` concatenated along dim 0 in data-rank order, all in one
    collective: every tensor crosses as float32 (a gathered one must hold
    its values exactly there) and comes back in its own dtype."""
    if mesh.data == 1:
        return list(sums), list(gathers)
    parts = [t.reshape(-1).to(torch.float32) for t in (*sums, *gathers)]
    g = data_all_gather(torch.cat(parts), mesh, leg)  # [D, N]
    n_sum = sum(t.numel() for t in sums)
    acc = _ordered_sum(g[:, :n_sum])
    out_s, off = [], 0
    for t in sums:
        out_s.append(acc[off : off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    out_g = []
    for t in gathers:
        block = g[:, off : off + t.numel()].reshape((mesh.data * t.shape[0],) + tuple(t.shape[1:]))
        out_g.append(block.to(t.dtype))
        off += t.numel()
    return out_s, out_g


def broadcast_(t: torch.Tensor, mesh: HybridMesh, src: int = 0) -> torch.Tensor:
    """``t`` overwritten in place by global rank ``src``'s, over the whole
    world (every data replica and every shard)."""
    if mesh.group is None:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src)
    nbytes = t.numel() * t.element_size() * (mesh.world - 1) if mesh.rank == src else 0
    mesh.traffic.add("broadcast", nbytes, time.perf_counter() - t0)
    return t


def owner_rows(part: torch.Tensor, owner: torch.Tensor, mesh: HybridMesh) -> torch.Tensor:
    """Lane ``i`` of every rank's ``part`` ``[N, ...]``, taken from rank
    ``owner[i]``: an all-gather, then one row gather (no arithmetic)."""
    n = part.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=part.device)
    return _picked(part, owner.to(torch.int64) * n + lane, mesh, "owner_rows")


def _picked(part: torch.Tensor, pick: torch.Tensor, mesh: HybridMesh, leg: str) -> torch.Tensor:
    """Entries ``pick`` of every rank's ``part`` ``[M, ...]`` laid end to
    end (rank ``r``'s entry ``j`` at ``r * M + j``)."""
    flat = all_gather(part, mesh, leg).reshape((-1,) + tuple(part.shape[1:]))
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
    return all_gather(slots[0], mesh, "slot")


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
            return _picked(part, pick, mesh, "row")
        c = get_codec(codec)
        payload, side = c.encode(part)
        payload = _picked(payload, pick, mesh, "row")
        if side is not None:
            side = _picked(side, pick, mesh, "row")
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


# ----- host rows between the shards' homes ---------------------------------------


def pack_rows(rows: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """Blocks of ``n`` rows (each ``[n, ...]``, any dtype and device) as one
    ``[n, bytes]`` uint8 block on ``dev``: their bytes side by side."""
    n = rows[0].shape[0]
    return torch.cat([x.reshape(n, int(np.prod(x.shape[1:], dtype=np.int64))).contiguous()
                      .view(torch.uint8).to(dev) for x in rows], dim=1)


def unpack_rows(block: torch.Tensor, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of :func:`pack_rows`: each leaf's rows, on its device."""
    out, off = [], 0
    n = block.shape[0]
    for leaf in leaves:
        w = int(np.prod(leaf.shape[1:], dtype=np.int64)) * leaf.element_size()
        x = block[:, off : off + w].contiguous().view(leaf.dtype)
        out.append(x.reshape((n,) + tuple(leaf.shape[1:])).to(leaf.device))
        off += w
    return out


def move_homes_(leaves: Sequence[torch.Tensor], to: np.ndarray, frm: np.ndarray, rows: int,
                mesh: HybridMesh, leg: str = "homes") -> int:
    """In place over the model group: for every ``i`` at once, home
    ``to[i]`` takes home ``frm[i]``'s content (row ``j`` of shard ``s`` is
    home ``s * rows + j``).  Each leaf is this rank's ``[rows, ...]`` slice
    (shard ``model_rank``'s homes): a host payload or sideband in its
    codec's encoding, a tracker's score or last touch.  A move within one
    shard stays local; a row that leaves for another shard crosses in its
    owner's block of departing rows (all leaves' bytes, in move order,
    padded to the largest block), copied, never summed.  Every rank
    derives the blocks alike from the global ``to`` / ``frm``.  Returns the
    rows this rank received from other shards."""
    s, S = mesh.model_rank, mesh.model
    to = np.asarray(to, np.int64)
    frm = np.asarray(frm, np.int64)
    to_o, frm_o = to // rows, frm // rows
    cross = to_o != frm_o
    local = (to_o == s) & ~cross
    arrive = np.flatnonzero((to_o == s) & cross)
    lidx = torch.from_numpy(frm[local] - s * rows)
    kept = [leaf.index_select(0, lidx.to(leaf.device)) for leaf in leaves]
    got: List[torch.Tensor] = []
    counts = np.bincount(frm_o[cross], minlength=S)
    width = int(counts.max()) if cross.any() else 0
    if width:  # the same on every rank of the group: all call the collective, or none
        pos = np.zeros(to.shape, np.int64)
        for r in range(S):
            sent = np.flatnonzero(cross & (frm_o == r))
            pos[sent] = np.arange(sent.size)
        # NCCL moves card tensors only; gloo takes the host's
        dev = torch.device("cpu")
        if mesh.backend == "nccl":
            dev = next(leaf.device for leaf in leaves if leaf.device.type == "cuda")
        mine = torch.from_numpy(frm[cross & (frm_o == s)] - s * rows)
        block = pack_rows([leaf.index_select(0, mine.to(leaf.device)) for leaf in leaves], dev)
        part = torch.zeros((width, block.shape[1]), dtype=torch.uint8, device=dev)
        part[: block.shape[0]] = block
        flat = all_gather(part, mesh, leg).reshape(S * width, -1)
        pick = torch.from_numpy(frm_o[arrive] * width + pos[arrive]).to(dev)
        got = unpack_rows(flat.index_select(0, pick), leaves)
    for k, leaf in enumerate(leaves):
        leaf.index_copy_(0, torch.from_numpy(to[local] - s * rows).to(leaf.device), kept[k])
        if arrive.size:
            leaf.index_copy_(0, torch.from_numpy(to[arrive] - s * rows).to(leaf.device), got[k])
    return int(arrive.size)
