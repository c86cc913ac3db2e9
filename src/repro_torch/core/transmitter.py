"""The data transmitter (paper §4.3), port of ``repro.core.transmitter``.

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
device, or, on a row-granular load, take an encoded host block of their
own codec verbatim).  A write-back from a tiered arena into an encoded
host tier packs with ``gather_encoded_slots``: each encoded leaf in one
launch of the gather-decode kernel's encode entry, which writes the host
codec's payload and sideband and no fp32 rows (bitwise ``gather_slots``
then ``encode_block``).

Chunked staging (``src_chunk_rows`` / ``dst_chunk_rows``, the paper's
chunk-based manager): a side whose every leaf's row count divides by the
chunk size moves whole contiguous chunks.  A load packs the round's unique
chunks of the source (payload and sideband of a host store) into the
staging block, which crosses the link in one copy and is sized by those
chunks; the rows are picked out of it on the destination's device.  A
write-back read-modify-writes the touched chunks of the destination on its
own side.  Values are bitwise those of the row path; a side whose rows do
not divide falls back to rows, as in the reference.  ``moves`` counts the
calls that moved chunks and those that moved rows, and the largest chunked
staging block in bytes.

Unlike the functional reference, ``move_rows`` updates the destination tree
in place (the host table is tens of GB) and returns it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.lanes import scatter_rows_, take_fill
from repro_torch.store.arena import ArenaStore
from repro_torch.store.host_store import HostStore

__all__ = ["move_rows", "write_rows", "gather_rows", "scatter_rows", "num_rounds", "moves"]

Tree = Dict[str, torch.Tensor]
Side = Union[HostStore, ArenaStore, Tree]

# one count per move_rows call, by the path its host side took; plus the
# largest staging block (bytes) a chunked load has filled
moves = {"rows": 0, "chunked": 0, "chunk_block_bytes": 0}


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


def _chunkable(leaves: Tree, chunk: int) -> bool:
    """Chunking needs every leaf's row count to divide by ``chunk``;
    otherwise the side moves rows."""
    return chunk > 0 and bool(leaves) and all(v.shape[0] % chunk == 0 for v in leaves.values())


def _chunk_plan(idx: torch.Tensor, chunk: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A round's chunk schedule: the ascending unique chunk ids of its
    in-range lanes, and each lane's flat row ``pos * chunk + idx % chunk``
    in the staged ``[n_chunks * chunk, ...]`` block (-1 out of range)."""
    ok = (idx >= 0) & (idx < n)
    cid = torch.where(ok, idx // chunk, 0)
    uniq = torch.unique(cid[ok], sorted=True)
    pos = torch.searchsorted(uniq, cid)
    return uniq, torch.where(ok, pos * chunk + idx % chunk, -1)


def _chunks(tree: Tree, uniq: torch.Tensor, chunk: int, out: Optional[Tree] = None) -> Tree:
    """Whole chunks ``uniq`` of every leaf, as ``[len(uniq) * chunk, ...]``
    rows (into ``out``'s leading rows if given)."""
    res = {}
    m = int(uniq.numel())
    for k, leaf in tree.items():
        rest = tuple(leaf.shape[1:])
        view = leaf.view((leaf.shape[0] // chunk, chunk) + rest)
        dst = out[k][: m * chunk].view((m, chunk) + rest) if out else None
        res[k] = torch.index_select(view, 0, uniq.to(leaf.device), out=dst).view((m * chunk,) + rest)
    return res


def _scatter_chunked(tree: Tree, idx: torch.Tensor, block: Tree, chunk: int) -> Tree:
    """Chunked unpack in place: gather the chunks the in-range lanes touch,
    overwrite those rows, write the chunks back.  The other rows of a
    touched chunk keep their bits, so this is the row scatter's result."""
    n = next(iter(tree.values())).shape[0]
    ok = (idx >= 0) & (idx < n)
    uniq, flat = _chunk_plan(idx, chunk, n)
    keep = flat[ok]
    for k, leaf in tree.items():
        rest = tuple(leaf.shape[1:])
        view = leaf.view((n // chunk, chunk) + rest)
        u = uniq.to(leaf.device)
        staged = view.index_select(0, u)
        rows = staged.view((-1,) + rest)
        rows.index_copy_(0, keep.to(leaf.device), block[k][ok.to(block[k].device)].to(leaf.device))
        view.index_copy_(0, u, staged)
    return tree


def _pack(tree: Tree, lanes: torch.Tensor, uniq: Optional[torch.Tensor], chunk: int,
          out: Optional[Tree] = None) -> Tree:
    """A source side's staging block: the chunks ``uniq`` when chunked, else
    the rows ``lanes``."""
    return _chunks(tree, uniq, chunk, out) if chunk else gather_rows(tree, lanes, out)


def _row_bytes(leaves: Tree) -> int:
    return sum(v[:1].numel() * v.element_size() for v in leaves.values())


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
    src_chunk_rows: int = 0,
    dst_chunk_rows: int = 0,
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
    destination lanes must be unique.  ``src_chunk_rows`` /
    ``dst_chunk_rows`` (0 = off) stage the named side in whole chunks (a
    tiered arena never chunks); a side whose rows do not divide moves
    rows.  The verbatim host -> tail path is row-granular: under a chunked
    source the staged chunks are decoded on the device and the tail
    re-encodes them, as in the reference.  Returns ``dst_tree``, updated
    in place."""
    src_dev = next(iter(_leaves(src_tree).values())).device
    dst_dev = next(iter(_leaves(dst_tree).values())).device
    s_all, d_all = _active_lanes(src_idx, dst_idx, active)
    step = max(1, min(buffer_rows, int(src_idx.shape[0])))
    chunk_src = (src_chunk_rows if not isinstance(src_tree, ArenaStore)
                 and _chunkable(_leaves(src_tree), src_chunk_rows) else 0)
    chunk_dst = (dst_chunk_rows if not isinstance(dst_tree, ArenaStore)
                 and _chunkable(_leaves(dst_tree), dst_chunk_rows) else 0)
    moves["chunked" if chunk_src or chunk_dst else "rows"] += 1
    rounds = [(s_all[a : a + step], d_all[a : a + step])
              for a in range(0, num_rounds(int(s_all.numel()), step) * step, step)]
    plans = []
    stage_rows = step
    if chunk_src:  # the staging block holds the largest round's unique chunks
        n_src = next(iter(_leaves(src_tree).values())).shape[0]
        plans = [_chunk_plan(s, chunk_src, n_src) for s, _ in rounds]
        stage_rows = max([1] + [int(u.numel()) * chunk_src for u, _ in plans])
        row_bytes = (_row_bytes(src_tree.data) + _row_bytes(src_tree.sideband)
                     if isinstance(src_tree, HostStore) else _row_bytes(src_tree))
        moves["chunk_block_bytes"] = max(moves["chunk_block_bytes"],
                                         (stage_rows if plans else 0) * row_bytes)
    load = isinstance(src_tree, HostStore) and src_tree.pinned and dst_dev.type == "cuda"
    save = isinstance(dst_tree, HostStore) and dst_tree.pinned and src_dev.type == "cuda"
    ring = src_tree.staging(stage_rows) if load else dst_tree.staging(step) if save else None
    verbatim = (isinstance(src_tree, HostStore) and isinstance(dst_tree, ArenaStore)
                and src_tree.codec == dst_tree.codec and not chunk_src)
    # the host tier's encode runs inside the arena's gather
    fused = (isinstance(src_tree, ArenaStore) and isinstance(dst_tree, HostStore)
             and dst_tree.codec != "fp32" and all(map(dst_tree.is_encoded, src_tree.head)))
    unpack = (lambda t, d, b: _scatter_chunked(t, d, b, chunk_dst)) if chunk_dst else scatter_rows
    for r, (s, d) in enumerate(rounds):
        n = int(s.numel())
        m = int(plans[r][0].numel()) * chunk_src if chunk_src else n
        enc = side = None
        uniq = plans[r][0] if chunk_src else None
        if isinstance(src_tree, HostStore):  # pack the encoded rows (or chunks) on the host
            if load:  # into pinned staging, async H2D
                i, (stage, stage_side) = ring.acquire()
                enc = _pack(src_tree.data, s, uniq, chunk_src, {k: b[:m] for k, b in stage.items()})
                side = _pack(src_tree.sideband, s, uniq, chunk_src,
                             {k: b[:m] for k, b in stage_side.items()})
                enc = {k: v.to(dst_dev, non_blocking=True) for k, v in enc.items()}
                side = {k: v.to(dst_dev, non_blocking=True) for k, v in side.items()}
                ring.release_after_copy(i)
            else:
                enc = {k: v.to(dst_dev) for k, v in _pack(src_tree.data, s, uniq, chunk_src).items()}
                side = {k: v.to(dst_dev)
                        for k, v in _pack(src_tree.sideband, s, uniq, chunk_src).items()}
            if chunk_src:  # pick the rows out of the staged chunks on the device
                flat = plans[r][1].to(dst_dev)
                enc = {k: take_fill(v, flat, 0) for k, v in enc.items()}
                side = {k: take_fill(v, flat, 0) for k, v in side.items()}
            block = src_tree.decode_block(enc, side)  # decoded on the destination's device
        elif fused:
            block, enc, side = src_tree.gather_encoded_slots(s.to(src_dev, torch.int32),
                                                             dst_tree.codec)
        elif isinstance(src_tree, ArenaStore):
            block = src_tree.gather_slots(s.to(src_dev, torch.int32))
        elif chunk_src:
            staged = _chunks(src_tree, uniq, chunk_src)
            flat = plans[r][1].to(dst_dev)
            block = {k: take_fill(v.to(dst_dev), flat, 0) for k, v in staged.items()}
        else:
            block = gather_rows(src_tree, s.to(src_dev))
        if isinstance(dst_tree, HostStore):  # encode on the source's device
            data_blk, side_blk = dst_tree.encode_block(block)
            if fused:  # the leaves the gather encoded
                data_blk.update(enc)
                side_blk.update(side)
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
            unpack(dst_tree.data, d, data_blk)  # the lanes are on the host already
            if side_blk:
                unpack(dst_tree.sideband, d, side_blk)
        elif isinstance(dst_tree, ArenaStore):
            payload_blk = side_blk = None
            if verbatim:  # tail lanes take the host tier's exact bits
                payload_blk = {k: enc[k] for k in dst_tree.tail
                               if k in enc and src_tree.is_encoded(k)}
                side_blk = {k: side[k] for k in dst_tree.sideband if k in side}
            dst_tree.scatter_slots(d.to(dst_dev), {k: v.to(dst_dev) for k, v in block.items()},
                                   payload_block=payload_blk, side_block=side_blk)
        else:
            unpack(dst_tree, d.to(dst_dev), {k: v.to(dst_dev) for k, v in block.items()})
    return dst_tree


def write_rows(
    rows: Tree, dst_tree: Side, dst_idx: torch.Tensor, active: torch.Tensor, *,
    buffer_rows: int, dst_chunk_rows: int = 0,
) -> Side:
    """Scatter an explicit block (row ``i`` -> ``dst_idx[i]``) into
    ``dst_tree`` through the same staging rounds as :func:`move_rows`.  The
    sharded collection pushes its replicated arena back to the rows' host
    homes with it."""
    src_idx = torch.arange(dst_idx.shape[0], dtype=dst_idx.dtype, device=dst_idx.device)
    return move_rows(rows, dst_tree, src_idx, dst_idx, active, buffer_rows=buffer_rows,
                     dst_chunk_rows=dst_chunk_rows)
