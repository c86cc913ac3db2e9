"""The data transmitter (paper §4.3), row path (port of
``repro.core.transmitter``).

Rows move in rounds of at most ``buffer_rows`` through a staging block:
pack (gather) on the source side, one copy across the link, scatter on the
destination side.  Host to device, the pack fills a pinned staging block of
the :class:`HostStore`, which crosses PCIe with a non-blocking copy and is
scattered into the arena; device to host (``writeback=True``) runs the same
rounds in reverse.

Where the reference runs ``ceil(K / buffer_rows)`` rounds over all K lanes
(static shapes), the port first brings the lane indices and the ``active``
mask to the host (one device-to-host sync per move: the host has to know
which rows to pack out of its table) and moves only the active lanes.  The
result is the same, bit for bit; inactive lanes never cross the link.

A :class:`HostStore` side moves encoded (fp16, or int8 with its ``[n, 2]``
sideband): the staging block that crosses the link is the payload and the
sideband, decoded (load) or encoded (write-back) on the card by eager torch
ops.  Either side may also be a tiered :class:`ArenaStore`: as the source it
packs with ``gather_slots`` (the gather-decode kernel on the card), as the
destination it unpacks with ``scatter_slots`` (tail lanes encode on the
device, or take an encoded host block of their own codec verbatim).

Unlike the functional reference, ``move_rows`` updates the destination tree
in place (the host table is tens of GB) and returns it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.lanes import scatter_rows_
from repro_torch.store.arena import ArenaStore
from repro_torch.store.host_store import HostStore

__all__ = ["move_rows", "write_rows", "gather_rows", "scatter_rows", "num_rounds"]

Tree = Dict[str, torch.Tensor]
Side = Union[HostStore, ArenaStore, Tree]


def num_rounds(k: int, buffer_rows: int) -> int:
    return -(-k // buffer_rows)


def _mask_like(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def gather_rows(tree: Tree, idx: torch.Tensor, out: Optional[Tree] = None) -> Tree:
    """Pack: rows ``idx`` of every leaf into a block (``out`` if given).
    Negative / out-of-range lanes give zero rows (JAX ``mode="fill"``)."""
    res = {}
    for k, leaf in tree.items():
        ok = (idx >= 0) & (idx < leaf.shape[0])
        safe = torch.where(ok, idx, 0)
        rows = torch.index_select(leaf, 0, safe, out=out[k]) if out else leaf.index_select(0, safe)
        res[k] = rows.masked_fill_(_mask_like(~ok, rows), 0)
    return res


def scatter_rows(
    tree: Tree, idx: torch.Tensor, block: Tree, active: Optional[torch.Tensor] = None
) -> Tree:
    """Unpack in place: ``tree[idx] = block`` on active, in-range lanes
    (kept lanes must be unique; see :func:`core.lanes.scatter_rows_`)."""
    if idx.numel() == 0:
        return tree
    n = next(iter(tree.values())).shape[0]
    keep = (idx >= 0) & (idx < n)
    if active is not None:
        keep = keep & active
    scatter_rows_(list(tree.values()), idx, [block[k] for k in tree], keep)
    return tree


def _active_lanes(
    src_idx: torch.Tensor, dst_idx: torch.Tensor, active: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) indices of the active lanes, on the host (one D2H copy)."""
    lanes = torch.stack(
        [src_idx.to(torch.int64), dst_idx.to(torch.int64), active.to(torch.int64)]
    ).cpu()
    sel = lanes[2] != 0
    return lanes[0][sel], lanes[1][sel]


def _leaves(tree: Side) -> Tree:
    if isinstance(tree, HostStore):
        return tree.data
    return tree.head if isinstance(tree, ArenaStore) else tree


def move_rows(
    src_tree: Side,
    dst_tree: Side,
    src_idx: torch.Tensor,
    dst_idx: torch.Tensor,
    active: torch.Tensor,
    *,
    buffer_rows: int,
) -> Side:
    """Move rows ``src_idx`` of ``src_tree`` to rows ``dst_idx`` of
    ``dst_tree`` on the ``active`` lanes, in rounds of ``buffer_rows``.

    Either side may be a :class:`HostStore` or an :class:`ArenaStore`.  A
    host store's rows cross the link encoded: a load packs payload and
    sideband on the host and decodes them on the destination's device; a
    write-back encodes on the source's device and scatters payload and
    sideband on the host.  When an encoded host store loads into a tiered
    arena of the same codec, the arena's tail lanes take the host payload
    and sideband verbatim (head lanes decode).  Source lanes out of range
    give zero rows; destination lanes out of range are dropped.  Active
    destination lanes must be unique.  Returns ``dst_tree``, updated in
    place."""
    src_dev = next(iter(_leaves(src_tree).values())).device
    dst_dev = next(iter(_leaves(dst_tree).values())).device
    s_all, d_all = _active_lanes(src_idx, dst_idx, active)
    step = max(1, min(buffer_rows, int(src_idx.shape[0])))
    load = isinstance(src_tree, HostStore) and src_tree.pinned and dst_dev.type == "cuda"
    save = isinstance(dst_tree, HostStore) and dst_tree.pinned and src_dev.type == "cuda"
    ring = src_tree.staging(step) if load else dst_tree.staging(step) if save else None
    verbatim = (isinstance(src_tree, HostStore) and isinstance(dst_tree, ArenaStore)
                and src_tree.codec == dst_tree.codec)
    for r in range(num_rounds(int(s_all.numel()), step)):
        s = s_all[r * step : (r + 1) * step]
        d = d_all[r * step : (r + 1) * step]
        n = int(s.numel())
        enc = side = None
        if isinstance(src_tree, HostStore):  # pack the encoded rows on the host
            if load:  # into pinned staging, async H2D
                i, (stage, stage_side) = ring.acquire()
                enc = gather_rows(src_tree.data, s, out={k: b[:n] for k, b in stage.items()})
                side = gather_rows(src_tree.sideband, s,
                                   out={k: b[:n] for k, b in stage_side.items()})
                enc = {k: v.to(dst_dev, non_blocking=True) for k, v in enc.items()}
                side = {k: v.to(dst_dev, non_blocking=True) for k, v in side.items()}
                ring.release_after_copy(i)
            else:
                enc = {k: v.to(dst_dev) for k, v in gather_rows(src_tree.data, s).items()}
                side = {k: v.to(dst_dev) for k, v in gather_rows(src_tree.sideband, s).items()}
            block = src_tree.decode_block(enc, side)  # decoded on the destination's device
        elif isinstance(src_tree, ArenaStore):
            block = src_tree.gather_slots(s.to(src_dev, torch.int32))
        else:
            block = gather_rows(src_tree, s.to(src_dev))
        if isinstance(dst_tree, HostStore):  # encode on the source's device
            data_blk, side_blk = dst_tree.encode_block(block)
            if save:  # D2H into pinned staging
                _, (stage, stage_side) = ring.acquire()
                data_blk = {k: stage[k][:n].copy_(v, non_blocking=True)
                            for k, v in data_blk.items()}
                side_blk = {k: stage_side[k][:n].copy_(v, non_blocking=True)
                            for k, v in side_blk.items()}
                torch.cuda.current_stream(src_dev).synchronize()  # lands before the scatter
            else:
                data_blk = {k: v.to(dst_dev) for k, v in data_blk.items()}
                side_blk = {k: v.to(dst_dev) for k, v in side_blk.items()}
            scatter_rows(dst_tree.data, d, data_blk)  # the lanes are on the host already
            if side_blk:
                scatter_rows(dst_tree.sideband, d, side_blk)
        elif isinstance(dst_tree, ArenaStore):
            payload_blk = side_blk = None
            if verbatim:  # tail lanes take the host tier's exact bits
                payload_blk = {k: enc[k] for k in dst_tree.tail
                               if k in enc and src_tree.is_encoded(k)}
                side_blk = {k: side[k] for k in dst_tree.sideband if k in side}
            dst_tree.scatter_slots(d.to(dst_dev), {k: v.to(dst_dev) for k, v in block.items()},
                                   payload_block=payload_blk, side_block=side_blk)
        else:
            scatter_rows(dst_tree, d.to(dst_dev), {k: v.to(dst_dev) for k, v in block.items()})
    return dst_tree


def write_rows(
    rows: Tree, dst_tree: Side, dst_idx: torch.Tensor, active: torch.Tensor, *, buffer_rows: int
) -> Side:
    """Scatter an explicit block (row ``i`` -> ``dst_idx[i]``) into
    ``dst_tree`` through the same staging rounds as :func:`move_rows`.  The
    sharded collection pushes its replicated arena back to the rows' host
    homes with it."""
    src_idx = torch.arange(dst_idx.shape[0], dtype=dst_idx.dtype, device=dst_idx.device)
    return move_rows(rows, dst_tree, src_idx, dst_idx, active, buffer_rows=buffer_rows)
