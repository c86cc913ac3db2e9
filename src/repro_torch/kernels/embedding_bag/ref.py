"""Plain-torch twin of ``repro.kernels.embedding_bag.ref``: the uncached
gather + segment-sum oracle of the embedding bag."""
from __future__ import annotations

import torch

from repro_torch.core.lanes import segment_sum, take_fill

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(
    table: torch.Tensor,  # [V, D]
    flat_ids: torch.Tensor,  # [N] int32, -1 = padding
    segment_ids: torch.Tensor,  # [N] int32
    num_segments: int,
    combiner: str = "sum",
) -> torch.Tensor:
    """[num_segments, D] in the table's dtype: a negative id is padding (no
    row, no count), an id >= V a zero row that counts for the mean.  (On the
    CPU, ``index_add_`` accumulates a bf16 table in fp32 and rounds once;
    the reference's scatter-add rounds after every add.)"""
    rows = take_fill(table, flat_ids, 0)
    out = segment_sum(rows, segment_ids, num_segments)
    if combiner == "mean":
        cnt = segment_sum((flat_ids >= 0).to(table.dtype), segment_ids, num_segments)
        out = out / torch.clamp_min(cnt, 1)[:, None]
    return out
