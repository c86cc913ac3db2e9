"""Differentiable embedding bag (port of ``repro.kernels.embedding_bag.ops``).

The forward is :func:`kernel.embedding_bag_multi` (F features of one table
in one launch; :func:`embedding_bag` is its one-feature case): the CUDA
kernel on CUDA tensors, the plain version on CPU tensors.  The backward is
the reference's custom VJP (``_bwd``), which is XLA and not Pallas there,
as torch ops, once over all ``[ΣN]`` lanes of the F features: the pooled
cotangent of each bag goes to its kept lanes (the same position mask under
``max_bag`` truncation, divided by the same kept count for ``mean``), then
one ``index_add_`` into a zero ``[V, D]`` gradient; padding lanes and ids
>= V are dropped.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.lanes import segment_sum, take_fill
from repro_torch.kernels.embedding_bag import kernel as _kernel

__all__ = ["embedding_bag", "embedding_bag_multi"]


class _EmbeddingBagMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, flat_ids, segment_ids, lane_offsets, num_segments, combiner, max_bag):
        ctx.save_for_backward(flat_ids, segment_ids)
        ctx.meta = (table.shape[0], table.dtype, lane_offsets, num_segments, combiner, max_bag)
        return _kernel.embedding_bag_multi(table, flat_ids, segment_ids, lane_offsets,
                                           num_segments, combiner, max_bag)

    @staticmethod
    def backward(ctx, g):  # g: [F, S, D]
        flat_ids, seg = ctx.saved_tensors
        vocab, dtype, offsets, num_segments, combiner, max_bag = ctx.meta
        n_feat, dev = len(offsets) - 1, seg.device
        lane = torch.arange(flat_ids.shape[0], device=dev)
        bounds = torch.tensor(offsets[1:-1], dtype=torch.int64)
        if dev.type == "cuda":  # no host sync: a pinned, asynchronous copy
            bounds = bounds.pin_memory().to(dev, non_blocking=True)
        feat = torch.bucketize(lane, bounds, right=True)  # each lane's feature
        in_bag = (seg >= 0) & (seg < num_segments)
        # a key that rises over all lanes (features in order, segments sorted
        # within each, lanes outside [0, S) kept apart from every bag): each
        # lane's bag starts at the first lane of its key
        key = feat * (num_segments + 2) + seg.clamp(-1, num_segments) + 1
        pos = lane - torch.searchsorted(key, key)
        valid = (flat_ids >= 0) & in_bag
        if max_bag > 0:
            valid = valid & (pos < max_bag)
        bag = torch.where(in_bag, feat * num_segments + seg, n_feat * num_segments)
        g_rows = take_fill(g.reshape(n_feat * num_segments, -1), bag, 0)  # [ΣN, D]
        if combiner == "mean":
            cnt = segment_sum(valid.to(g.dtype), bag, n_feat * num_segments)
            g_rows = g_rows / take_fill(torch.clamp_min(cnt, 1.0), bag, 1.0)[:, None]
        g_rows = g_rows * valid[:, None].to(g.dtype)
        keep = valid & (flat_ids < vocab)
        d_table = g.new_zeros((vocab + 1, g.shape[-1]), dtype=dtype)
        d_table.index_add_(0, torch.where(keep, flat_ids, vocab).to(torch.int64),
                           g_rows.to(dtype))
        return d_table[:vocab], None, None, None, None, None, None


def embedding_bag_multi(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    lane_offsets: Sequence[int],
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[F, num_segments, D]`` pooled bags of F features of ``table`` (their
    flat ids and segment ids concatenated, feature ``f`` the lanes
    ``[lane_offsets[f], lane_offsets[f+1])``), differentiable w.r.t.
    ``table``: one kernel launch forward, one ``index_add_`` backward."""
    offsets = tuple(int(o) for o in lane_offsets)
    return _EmbeddingBagMulti.apply(table, flat_ids, segment_ids, offsets, num_segments,
                                    combiner, max_bag)


@contract(max_sort_size=0)
def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[num_segments, D]`` pooled bags of ``table``, differentiable w.r.t.
    ``table``; ``max_bag <= 0`` keeps every lane (the reference's ``N``).
    The many-feature op over one feature."""
    return embedding_bag_multi(table, flat_ids, segment_ids, (0, flat_ids.shape[0]),
                               num_segments, combiner, max_bag)[0]
