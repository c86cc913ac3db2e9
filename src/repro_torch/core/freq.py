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
    "collect_counts",
    "collect_counts_sampled",
    "collect_counts_stream",
    "coverage",
    "init_tracker",
    "tracker_touch",
    "tracker_observe",
    "decay_to",
    "decay_factor",
    "decay_bump",
    "decayed_scores",
]


@dataclasses.dataclass(frozen=True)
class FreqStats:
    """``idx_map`` int32 [vocab] raw id -> rank; ``inv_map`` its inverse."""

    idx_map: np.ndarray
    inv_map: np.ndarray
    counts: np.ndarray
    vocab: int

    def reorder_rows(self, weight: np.ndarray) -> np.ndarray:
        """A [vocab, dim] table reordered so row r holds the r-th most frequent id."""
        if weight.shape[0] != self.vocab:
            raise ValueError(f"weight has {weight.shape[0]} rows, the stats {self.vocab}")
        return weight[self.inv_map]

    def top_fraction_coverage(self, frac: float) -> float:
        """Share of all accesses that go to the top-``frac`` hottest ids."""
        k = max(1, int(round(frac * self.vocab)))
        sorted_counts = self.counts[self.inv_map]  # descending
        tot = sorted_counts.sum()
        return float(sorted_counts[:k].sum() / max(tot, 1))


def build_freq_stats(counts: np.ndarray) -> FreqStats:
    """Reorder permutation by descending count, stable (ties keep raw order)."""
    vocab = int(counts.shape[0])
    inv_map = np.argsort(-counts, kind="stable").astype(np.int32)
    idx_map = np.empty_like(inv_map)
    idx_map[inv_map] = np.arange(vocab, dtype=np.int32)
    return FreqStats(idx_map=idx_map, inv_map=inv_map, counts=counts.astype(np.int64), vocab=vocab)


def collect_counts(id_batches: Iterable[np.ndarray], vocab: int) -> np.ndarray:
    """The paper's one pass over the dataset: each id's occurrences, int64."""
    counts = np.zeros((vocab,), dtype=np.int64)
    for ids in id_batches:
        np.add.at(counts, ids.reshape(-1).astype(np.int64), 1)
    return counts


def collect_counts_sampled(
    id_batches: Iterable[np.ndarray],
    vocab: int,
    sample_rate: float,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Counts over a sample of the batches, each kept with probability
    ``sample_rate`` (one ``rng.random()`` draw a batch, from ``rng`` or
    ``seed``): unbiased up to scale, so the ranking is kept in expectation,
    and the same on every host for one seed."""
    if rng is None:
        rng = np.random.default_rng(seed)
    counts = np.zeros((vocab,), dtype=np.int64)
    for ids in id_batches:
        if rng.random() <= sample_rate:
            np.add.at(counts, ids.reshape(-1).astype(np.int64), 1)
    return counts


def coverage(counts: np.ndarray, top_fracs: Sequence[float]) -> dict:
    """The paper's Fig. 2 statistic: each top fraction's share of accesses."""
    stats = build_freq_stats(counts)
    return {f: stats.top_fraction_coverage(f) for f in top_fracs}


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


# Cephes's float32 exp: the polynomial and the range reduction that XLA's CPU
# backend lowers ``exp`` to, each step a fused multiply-add
_EXP_LOG2E = np.float32(1.44269504088896341)
_EXP_C1 = np.float32(0.693359375)  # ln 2 = C1 - C2, split for the reduction
_EXP_C2 = np.float32(-2.12194440e-4)
_EXP_P = tuple(np.float32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                        4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))
_EXP_LO = -88.3762626647949  # below it the result is subnormal, and flushed to 0
_F32_TINY = float(np.finfo(np.float32).tiny)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding: the float64 product of two
    float32 values is exact, so only the sum rounds (to float64, then to
    float32)."""
    f64 = lambda v: v.to(torch.float64) if isinstance(v, torch.Tensor) else float(v)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp(x)`` for ``x <= 0``, bit for bit what XLA computes on
    the CPU: ``exp(x) = 2^n * p(r)`` with ``n = floor(x log2(e) + 1/2)``,
    ``r = x - n ln 2`` and Cephes's degree-7 polynomial, each multiply-add
    fused; subnormal results flush to 0.  Float64 and float32 arithmetic is
    IEEE on the CPU and the card alike, so the result does not depend on
    the device."""
    x = torch.clamp(x, min=_EXP_LO)
    n = torch.floor(_fma(x, _EXP_LOG2E, 0.5))
    r = _fma(n, -_EXP_C1, x)
    r = _fma(n, -_EXP_C2, r)
    z = r * r
    y = torch.full_like(r, float(_EXP_P[0]))
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, z, r) + 1.0
    # 2^n from its exponent bits (n >= -127; -127 gives +0): an exact scaling
    two_n = torch.bitwise_left_shift(n.to(torch.int32) + 127, 23).view(torch.float32)
    out = y * two_n
    return torch.where(out < _F32_TINY, 0.0, out)


def decay_factor(dt: torch.Tensor, half_life: int) -> torch.Tensor:
    """float32 ``exp2(-dt / half_life)`` for ``dt >= 0`` as the reference
    computes it under ``jit`` on the CPU: XLA folds the divide and ``exp2``'s
    ``ln 2`` into one constant ``fl(fl(1 / half_life) * fl(ln 2))`` and
    lowers ``exp`` to Cephes's polynomial (:func:`_exp_f32`).  torch's own
    ``exp2`` differs from it in the last ulp on some inputs (and the card's
    from the CPU's), which is enough to reorder two near-tied rows of a
    refresh plan."""
    c = np.float32(np.float32(1.0 / half_life) * np.float32(np.log(2.0)))
    return _exp_f32(-dt.to(torch.float32)
                    * torch.full((), float(c), dtype=torch.float32, device=dt.device))


def decay_bump(score: torch.Tensor, dt: torch.Tensor, half_life: int) -> torch.Tensor:
    """``score * decay_factor(dt) + 1`` with one rounding: XLA fuses the
    reference's multiply and add."""
    return _fma(score, decay_factor(dt, half_life), 1.0)


def tracker_touch(
    tracker: FreqTracker,
    rows: torch.Tensor,
    valid: torch.Tensor,
    step: torch.Tensor,
    half_life: int,
) -> FreqTracker:
    """Decay each touched row from its ``last_touch`` to ``step``, add 1
    (:func:`decay_bump`: bitwise the reference on the CPU).

    ``rows`` must be unique among its valid lanes (the dedup output)."""
    safe = torch.where(valid, rows, 0)
    prev = tracker.score[safe]
    last = tracker.last_touch[safe]
    bumped = decay_bump(prev, torch.clamp(step - last, min=0), half_life)
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
    return score * decay_factor(torch.clamp(step - last_touch, min=0), half_life)


def decayed_scores(score, last_touch, step, half_life: int) -> np.ndarray:
    """Host-side float64 twin of :func:`decay_to`: every row's decayed mass
    as of ``step``."""
    s = np.asarray(score, np.float64)
    lt = np.asarray(last_touch, np.float64)
    return s * np.exp2(-np.maximum(step - lt, 0.0) / half_life)
