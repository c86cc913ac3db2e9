"""Synthetic batches (the ``ZipfSparseSpec`` / ``sparse_batch`` /
``DriftingZipfSpec`` / ``drifting_sparse_batch`` / ``recsys_batch`` /
``seq_batch`` / ``count_stream`` part of ``repro.data.synth``, copied so
that the same (seed, step) gives bit-identical batches in both packages):
Criteo-like sparse batches with the paper's access skew, the same stream
under hot-set drift, DIN / DIEN / MIND behaviour batches, the flat id
stream of a frequency scan, and LM token streams.  Batch ``i`` is a pure
function of (seed, i)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["DriftingZipfSpec", "ZipfSparseSpec", "count_stream", "drifting_sparse_batch",
           "recsys_batch", "seq_batch", "sparse_batch"]


@dataclasses.dataclass(frozen=True)
class ZipfSparseSpec:
    vocab_sizes: Tuple[int, ...]
    zipf_a: float = 1.2  # calibrated: ~90% of accesses to top <1% of ids
    n_dense: int = 0


def _zipf_ids(rng: np.random.Generator, vocab: int, size, a: float) -> np.ndarray:
    """Zipf over [0, vocab): ranked id r has p ~ (r+1)^-a (id == popularity rank)."""
    # inverse-CDF sampling on the truncated zipf
    u = rng.random(size)
    # approximate inverse of normalized harmonic CDF via exponent transform:
    if a == 1.0:
        ids = np.exp(u * np.log(vocab)) - 1.0
    else:
        h = (vocab ** (1.0 - a) - 1.0) / (1.0 - a)
        ids = ((u * h * (1.0 - a)) + 1.0) ** (1.0 / (1.0 - a)) - 1.0
    return np.clip(ids.astype(np.int64), 0, vocab - 1)


def sparse_batch(
    spec: ZipfSparseSpec,
    batch: int,
    seed: int,
    step: int,
    id_shift: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Criteo-style batch: one id per field + dense features + clicky label.

    ``id_shift`` (optional int64 [fields]) rotates each field's id space by a
    per-field offset after popularity sampling and before the label model."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    f = len(spec.vocab_sizes)
    sparse = np.stack(
        [_zipf_ids(rng, v, batch, spec.zipf_a) for v in spec.vocab_sizes], axis=1
    ).astype(np.int32)
    if id_shift is not None:
        vocabs = np.asarray(spec.vocab_sizes, dtype=np.int64)
        sparse = ((sparse.astype(np.int64) + id_shift) % vocabs).astype(np.int32)
    out: Dict[str, np.ndarray] = {"sparse": sparse}
    if spec.n_dense:
        out["dense"] = rng.normal(size=(batch, spec.n_dense)).astype(np.float32)
    # label depends on a hidden linear function of (hashed) ids so AUROC is learnable
    h = ((sparse * np.arange(1, f + 1)) % 97).sum(1) / (97.0 * f)
    noise = rng.normal(scale=0.3, size=batch)
    out["label"] = ((h + noise) > 0.5).astype(np.float32)
    return out


@dataclasses.dataclass(frozen=True)
class DriftingZipfSpec:
    """A Zipf sparse stream whose hot set moves: every ``drift_every`` steps
    the popularity ranking rotates by ``shift_fraction`` of each vocab (phase
    ``p`` maps sampled popularity rank ``r`` to id ``(r + p * shift) % vocab``).
    The skew is the same in every phase; only which ids are hot changes, so
    a frequency rank collected in phase 0 goes stale at each phase change."""

    base: ZipfSparseSpec
    drift_every: int = 200  # steps per popularity phase
    shift_fraction: float = 0.37  # hot-set rotation per phase (per vocab)

    def shifts(self, step: int) -> np.ndarray:
        """Per-field id rotation of the phase containing ``step``."""
        phase = step // self.drift_every
        vocabs = np.asarray(self.base.vocab_sizes, dtype=np.int64)
        per_phase = np.maximum((self.shift_fraction * vocabs).astype(np.int64), 1)
        return (phase * per_phase) % vocabs


def drifting_sparse_batch(
    spec: DriftingZipfSpec, batch: int, seed: int, step: int
) -> Dict[str, np.ndarray]:
    """``sparse_batch`` under hot-set drift; phase 0 (``step < drift_every``)
    is the undrifted stream, bit for bit."""
    return sparse_batch(spec.base, batch, seed, step, id_shift=spec.shifts(step))


def recsys_batch(
    n_items: int,
    n_users: int,
    seq_len: int,
    batch: int,
    seed: int,
    step: int,
    n_cates: Optional[int] = None,
    zipf_a: float = 1.2,
) -> Dict[str, np.ndarray]:
    """DIN / DIEN / MIND behaviour batch with Zipf-popular items: a history
    of ``seq_len`` items (the first ``hist_len`` valid, 5 to ``seq_len``), a
    target item, a uniform user and a label that follows the target's
    bucket (id % 17) in the history; with ``n_cates``, each item's category
    is ``id % n_cates``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    hist = _zipf_ids(rng, n_items, (batch, seq_len), zipf_a).astype(np.int32)
    hist_len = rng.integers(5, seq_len + 1, size=batch).astype(np.int32)
    target = _zipf_ids(rng, n_items, batch, zipf_a).astype(np.int32)
    user = rng.integers(0, n_users, size=batch).astype(np.int32)
    aff = (hist % 17 == (target % 17)[:, None]).mean(1)
    label = (aff + rng.normal(scale=0.2, size=batch) > 0.12).astype(np.float32)
    out = {"hist_items": hist, "hist_len": hist_len, "target_item": target, "user": user,
           "label": label}
    if n_cates is not None:
        out["hist_cates"] = (hist % n_cates).astype(np.int32)
        out["target_cate"] = (target % n_cates).astype(np.int32)
    return out


def seq_batch(vocab: int, batch: int, seq: int, seed: int, step: int) -> Dict[str, np.ndarray]:
    """LM token stream (markov-ish so loss decreases)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    # make it predictable: next token often (prev*7+3) % vocab
    for t in range(1, seq + 1):
        m = rng.random(batch) < 0.7
        toks[m, t] = (toks[m, t - 1] * 7 + 3) % vocab
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def count_stream(spec: ZipfSparseSpec, batch: int, n_steps: int, seed: int):
    """The flat global ids of ``n_steps`` batches, one int64 array a batch
    (the paper's §4.2 scan for frequency collection)."""
    offsets = np.concatenate([[0], np.cumsum(spec.vocab_sizes)[:-1]])
    for i in range(n_steps):
        b = sparse_batch(spec, batch, seed, i)
        yield (b["sparse"].astype(np.int64) + offsets).reshape(-1)
