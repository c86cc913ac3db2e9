"""EmbeddingBag from gather + segment ops (port of ``repro.nn.embedding_bag``).

The uncached embedding path: ``torch.nn.EmbeddingBag``'s sum / mean / max
with per-sample weights, built from :func:`nn.indexing.take_rows` and
segment reductions; ``use_pallas`` (sum / mean, no weights) routes through
the embedding-bag kernel's op.  The cached path is
``EmbeddingCollection.pool``; both share these bag semantics.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lanes import segment_sum
from repro_torch.nn.indexing import take_rows

__all__ = ["embedding_bag", "one_hot_lookup"]


def one_hot_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [..] -> [.., dim]; negative ids give zero rows."""
    return take_rows(table, ids)


def embedding_bag(
    table: torch.Tensor,  # [vocab, dim]
    flat_ids: torch.Tensor,  # [N] (negative = padding)
    segment_ids: torch.Tensor,  # [N] bag index per id (sorted only for use_pallas)
    num_segments: int,
    combiner: str = "sum",
    weights: Optional[torch.Tensor] = None,  # [N] per-sample weights
    use_pallas: bool = False,
) -> torch.Tensor:
    """``[num_segments, dim]``: ``torch.nn.EmbeddingBag(sum|mean|max)`` by
    gather + segment ops; empty bags give zero rows."""
    if use_pallas and combiner in ("sum", "mean") and weights is None:
        from repro_torch.kernels.embedding_bag import ops as eb_ops

        return eb_ops.embedding_bag(table, flat_ids, segment_ids, num_segments, combiner)

    rows = take_rows(table, flat_ids)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    valid = flat_ids >= 0
    if combiner == "max":
        rows = torch.where(valid[:, None], rows, float("-inf"))
        ok = (segment_ids >= 0) & (segment_ids < num_segments)
        out = rows.new_full((num_segments + 1, rows.shape[-1]), float("-inf"))
        out = out.scatter_reduce(
            0, torch.where(ok, segment_ids, num_segments).to(torch.int64)[:, None].expand_as(rows),
            rows, "amax")[:num_segments]
        return torch.where(torch.isfinite(out), out, 0.0)
    out = segment_sum(rows, segment_ids, num_segments)
    if combiner == "mean":
        cnt = segment_sum(valid.to(out.dtype), segment_ids, num_segments)
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out
