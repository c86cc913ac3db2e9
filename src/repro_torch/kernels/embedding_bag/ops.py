"""Differentiable embedding bag (port of ``repro.kernels.embedding_bag.ops``).

The forward is :func:`kernel.embedding_bag`: the CUDA kernel on CUDA
tensors, the plain version on CPU tensors.  The backward is the
reference's custom VJP (``_bwd``), which is XLA and not Pallas there, as
torch ops: the pooled cotangent of each bag goes to its kept lanes (the
same position mask under ``max_bag`` truncation, divided by the same kept
count for ``mean``), then one ``index_add_`` into a zero ``[V, D]``
gradient; padding lanes and ids >= V are dropped.
"""
from __future__ import annotations

import torch

from repro_torch.core.lanes import segment_sum, take_fill
from repro_torch.kernels.embedding_bag import kernel as _kernel

__all__ = ["embedding_bag"]


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, flat_ids, segment_ids, num_segments, combiner, max_bag):
        ctx.save_for_backward(flat_ids, segment_ids)
        ctx.meta = (table.shape[0], table.dtype, num_segments, combiner, max_bag)
        return _kernel.embedding_bag(table, flat_ids, segment_ids, num_segments, combiner,
                                     max_bag)

    @staticmethod
    def backward(ctx, g):
        flat_ids, seg = ctx.saved_tensors
        vocab, dtype, num_segments, combiner, max_bag = ctx.meta
        starts = _kernel.bag_starts(seg, num_segments)
        pos = torch.arange(flat_ids.shape[0], device=seg.device) - take_fill(starts, seg, 0)
        in_bag = (seg >= 0) & (seg < num_segments)
        valid = (flat_ids >= 0) & in_bag
        if max_bag > 0:
            valid = valid & (pos < max_bag)
        g_rows = take_fill(g, seg, 0)  # [N, D] the pooled cotangent per lane
        if combiner == "mean":
            cnt = segment_sum(valid.to(g.dtype), seg, num_segments)
            g_rows = g_rows / take_fill(torch.clamp_min(cnt, 1.0), seg, 1.0)[:, None]
        g_rows = g_rows * valid[:, None].to(g.dtype)
        keep = valid & (flat_ids < vocab)
        d_table = g.new_zeros((vocab + 1, g.shape[-1]), dtype=dtype)
        d_table.index_add_(0, torch.where(keep, flat_ids, vocab).to(torch.int64),
                           g_rows.to(dtype))
        return d_table[:vocab], None, None, None, None, None


def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[num_segments, D]`` pooled bags of ``table``, differentiable w.r.t.
    ``table``; ``max_bag <= 0`` keeps every lane (the reference's ``N``)."""
    return _EmbeddingBag.apply(table, flat_ids, segment_ids, num_segments, combiner, max_bag)
