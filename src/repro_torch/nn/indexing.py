"""Safe row gather: negative and out-of-range indices give fill rows (port
of ``repro.nn.indexing``; a thin name over :func:`core.lanes.take_fill`)."""
from __future__ import annotations

import torch

from repro_torch.core.lanes import take_fill

__all__ = ["take_rows"]


def take_rows(table: torch.Tensor, idx: torch.Tensor, fill_value=0) -> torch.Tensor:
    """table [N, ...], idx [...] int; idx < 0 or >= N -> ``fill_value`` rows."""
    return take_fill(table, idx, fill_value)
