"""Frequency module (port of ``repro.core.freq``): the paper's static pass
(§4.2) and the online decayed-counter tracker that ``plan_prepare`` touches
on every call, serving included.

The static half is numpy and runs once, before serving: it builds
``idx_map`` (raw id -> frequency-ranked row).  The tracker is a dataclass of
device tensors; decay is lazy (a row's score is exact as of its
``last_touch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.lanes import scatter_drop

__all__ = [
    "FreqStats",
    "FreqTracker",
    "build_freq_stats",
    "concat_table_offsets",
    "collect_counts_stream",
    "init_tracker",
    "tracker_touch",
    "tracker_observe",
    "decay_to",
    "decayed_scores",
]


@dataclasses.dataclass(frozen=True)
class FreqStats:
    """``idx_map`` int32 [vocab] raw id -> rank; ``inv_map`` its inverse."""

    idx_map: np.ndarray
    inv_map: np.ndarray
    counts: np.ndarray
    vocab: int


def build_freq_stats(counts: np.ndarray) -> FreqStats:
    """Reorder permutation by descending count, stable (ties keep raw order)."""
    vocab = int(counts.shape[0])
    inv_map = np.argsort(-counts, kind="stable").astype(np.int32)
    idx_map = np.empty_like(inv_map)
    idx_map[inv_map] = np.arange(vocab, dtype=np.int32)
    return FreqStats(idx_map=idx_map, inv_map=inv_map, counts=counts.astype(np.int64), vocab=vocab)


def concat_table_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Raw (field f, local id i) maps to global id ``offsets[f] + i``."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes, dtype=np.int64))[:-1]]).astype(
        np.int64
    )


def collect_counts_stream(
    stream: Iterable,
    feature_to_table: Mapping[str, str],
    vocab_sizes: Mapping[str, int],
    max_batches: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Per-table id counts straight off a stream of keyed batches: a
    ``Prefetcher`` (``(step, batch)`` pairs), ``FeatureBatch``-like objects
    (an ``.ids`` mapping) or ``{feature: ids}`` dicts, host or device
    tensors or arrays.  Features without a table are skipped, negative ids
    (padding) ignored; ``max_batches`` bounds the scan."""
    counts = {t: np.zeros((v,), np.int64) for t, v in vocab_sizes.items()}
    for n, item in enumerate(stream):
        if max_batches is not None and n >= max_batches:
            break
        batch = item[1] if isinstance(item, tuple) else item
        for f, arr in getattr(batch, "ids", batch).items():
            table = feature_to_table.get(f)
            if table is None:
                continue
            a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
            a = a.reshape(-1).astype(np.int64)
            np.add.at(counts[table], a[a >= 0], 1)
    return counts


@dataclasses.dataclass
class FreqTracker:
    """Per-ranked-row decayed access counters plus the rolling hit window."""

    score: torch.Tensor  # float32 [vocab] decayed mass, exact at last_touch
    last_touch: torch.Tensor  # int32 [vocab] step of the last update
    win_hits: torch.Tensor  # float32 [] decayed id-hit window
    win_misses: torch.Tensor  # float32 [] decayed unique-miss window
    refresh_swaps: torch.Tensor  # int32 [] cumulative swapped rank pairs
    refresh_rows: torch.Tensor  # int32 [] cumulative host rows moved by refresh


def init_tracker(vocab: int, device: torch.device) -> FreqTracker:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return FreqTracker(
        score=torch.zeros((vocab,), **f32),
        last_touch=torch.zeros((vocab,), **i32),
        win_hits=torch.zeros((), **f32),
        win_misses=torch.zeros((), **f32),
        refresh_swaps=torch.zeros((), **i32),
        refresh_rows=torch.zeros((), **i32),
    )


def tracker_touch(
    tracker: FreqTracker,
    rows: torch.Tensor,
    valid: torch.Tensor,
    step: torch.Tensor,
    half_life: int,
) -> FreqTracker:
    """Decay each touched row from its ``last_touch`` to ``step``, add 1.

    ``rows`` must be unique among its valid lanes (the dedup output).  The
    ``exp2`` is fp32; torch and XLA may differ in its last ulp.
    """
    safe = torch.where(valid, rows, 0)
    prev = tracker.score[safe]
    last = tracker.last_touch[safe]
    dt = torch.clamp(step - last, min=0).to(torch.float32)
    bumped = prev * torch.exp2(-dt / half_life) + 1.0
    return dataclasses.replace(
        tracker,
        score=scatter_drop(tracker.score, rows, bumped, valid),
        last_touch=scatter_drop(tracker.last_touch, rows, step, valid),
    )


def tracker_observe(
    tracker: FreqTracker, hits: torch.Tensor, misses: torch.Tensor, half_life: int
) -> FreqTracker:
    """Fold one plan's hit/miss telemetry into the rolling window."""
    d = float(np.float32(2.0 ** (-1.0 / half_life)))  # the fp32 decay factor
    return dataclasses.replace(
        tracker,
        win_hits=tracker.win_hits * d + hits.to(torch.float32),
        win_misses=tracker.win_misses * d + misses.to(torch.float32),
    )


def decay_to(
    score: torch.Tensor, last_touch: torch.Tensor, step: torch.Tensor, half_life: int
) -> torch.Tensor:
    """float32 decayed masses normalised to a common ``step`` (broadcasts:
    pass ``step[:, None]`` for a stacked per-shard tracker).  The live
    ``shard_imbalance`` metric and the replicated arena's tracker use it."""
    dt = torch.clamp(step - last_touch, min=0).to(torch.float32)
    return score * torch.exp2(-dt / half_life)


def decayed_scores(score, last_touch, step, half_life: int) -> np.ndarray:
    """Host-side float64 twin of :func:`decay_to`: every row's decayed mass
    as of ``step``."""
    s = np.asarray(score, np.float64)
    lt = np.asarray(last_touch, np.float64)
    return s * np.exp2(-np.maximum(step - lt, 0.0) / half_life)
