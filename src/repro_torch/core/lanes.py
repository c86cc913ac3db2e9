"""Masked gathers and scatters: the port's form of JAX's ``mode="fill"`` /
``mode="drop"`` indexing.

torch indexing raises on an index past the end and wraps a negative one, so
every lane that JAX would fill or drop is masked explicitly here:

* :func:`take_fill` — gather with a fill value for negative / out-of-range
  lanes (``x.at[i].get(mode="fill")`` on the non-negative lanes the callers
  pass).
* :func:`scatter_drop` — functional ``x.at[i].set(v, mode="drop")``: a copy
  of ``x`` with one trash element appended at index ``n``; dropped lanes are
  redirected there and the trash is sliced off.  No boolean filtering, so no
  host sync.  Kept lanes must be unique (CUDA ``index_put_`` gives duplicate
  indices no order); the trash element may take any of its writes.
* :func:`scatter_rows_` — in-place row scatter on kept lanes, also with no
  host sync: every dropped lane rewrites a copy of the first kept lane.
* :func:`segment_sum` — ``jax.ops.segment_sum``: rows summed into their
  segment, lanes with a segment outside ``[0, num_segments)`` dropped.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["take_fill", "scatter_drop", "scatter_rows_", "segment_sum", "i32"]


def i32(x: torch.Tensor) -> torch.Tensor:
    """torch sums int32 into int64; the reference keeps int32 (and wraps)."""
    return x.to(torch.int32)


def take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` along dim 0 with ``fill`` on lanes outside ``[0, n)``.

    An ``index_select``: its backward is one dense ``index_add_`` (that of
    ``x[idx]`` is an accumulating ``index_put_``, which sorts the ids)."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    out = torch.index_select(x, 0, torch.where(ok, idx, 0).reshape(-1))
    out = out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))
    mask = ok.reshape(ok.shape + (1,) * (out.dim() - ok.dim()))
    return torch.where(mask, out, fill)


def take_fill_ordered(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``take_fill`` whose backward sums a row's duplicate lanes in one fixed
    order on every device: ``x[idx]``, whose backward is an accumulating
    ``index_put_`` (sorted on the card), where ``index_select``'s
    ``index_add_`` sums with atomics on the card unless torch's
    deterministic algorithms are on.  For a leaf that each rank of a mesh
    steps on its own, which must stay the same on every rank."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    out = x[torch.where(ok, idx, 0).to(torch.int64)]
    mask = ok.reshape(ok.shape + (1,) * (out.dim() - ok.dim()))
    return torch.where(mask, out, fill)


def scatter_drop(
    x: torch.Tensor, idx: torch.Tensor, val, keep: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Copy of ``x`` with ``x[idx] = val`` on the lanes where ``keep`` holds
    and ``idx`` is in range; other lanes land in a trash element that is
    sliced off."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    if keep is not None:
        ok = ok & keep
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if isinstance(val, torch.Tensor):
        val = val.to(x.dtype).expand(idx.shape + tuple(x.shape[1:]))
    else:  # a Python scalar: filled on the device, no host-to-device copy
        val = torch.full(idx.shape + tuple(x.shape[1:]), val, dtype=x.dtype, device=x.device)
    ext.index_put_((torch.where(ok, idx, n).to(torch.int64),), val)
    return ext[:n]


def scatter_rows_(
    leaves: Sequence[torch.Tensor],
    idx: torch.Tensor,
    blocks: Sequence[torch.Tensor],
    keep: torch.Tensor,
) -> None:
    """In place ``leaf[idx] = block`` for each (leaf, block) pair, on the
    lanes where ``keep`` holds (their ``idx`` must be in range and unique).

    Dropped lanes are not filtered out (that would sync the host): each one
    rewrites a copy of the first kept lane, index and row alike, so every
    duplicate write carries the same bits.  With no kept lane they rewrite
    row 0 with its own value."""
    if idx.numel() == 0 or leaves[0].shape[0] == 0:
        return
    # the first kept lane (0 if none), as a [1] index: indexing by a 0-dim
    # tensor would read it on the host (``.item()``, a sync on the card)
    j = torch.argmax(keep.to(torch.int32)).reshape(1)
    has = keep.any()
    dest = torch.where(keep, idx, torch.where(has, idx.index_select(0, j)[0], 0)).to(torch.int64)
    for leaf, blk in zip(leaves, blocks):
        fill = torch.where(has, blk.index_select(0, j)[0], leaf[0])
        mask = keep.reshape(keep.shape + (1,) * (blk.dim() - keep.dim()))
        leaf.index_copy_(0, dest, torch.where(mask, blk, fill))


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``[num_segments, ...]`` sums of the rows of ``x`` by ``seg`` (any
    order); out-of-range segments land in a trash row that is sliced off.
    One ``index_add_``: on the card its summation order is not fixed."""
    ok = (seg >= 0) & (seg < num_segments)
    out = x.new_zeros((num_segments + 1,) + tuple(x.shape[1:]))
    out.index_add_(0, torch.where(ok, seg, num_segments).to(torch.int64), x)
    return out[:num_segments]
