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
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["take_fill", "scatter_drop", "i32"]


def i32(x: torch.Tensor) -> torch.Tensor:
    """torch sums int32 into int64; the reference keeps int32 (and wraps)."""
    return x.to(torch.int32)


def take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` along dim 0 with ``fill`` on lanes outside ``[0, n)``."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    out = x[torch.where(ok, idx, 0)]
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
