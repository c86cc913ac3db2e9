"""The port's static frequency pass (``core/freq.py``) and its id stream
(``data/synth.count_stream``) against ``repro.core.freq`` and
``repro.data.synth``: ``coverage`` (the paper's Fig. 2 statistic),
``FreqStats.top_fraction_coverage``, ``FreqStats.reorder_rows``,
``collect_counts_sampled`` and ``count_stream``.  Everything is numpy on
both sides, so every output is compared for equality."""
import numpy as np
import pytest

from repro.core import freq as jfreq
from repro.data import synth as jsynth
from repro_torch.core import freq
from repro_torch.data import synth

FRACS = (0.001, 0.01, 0.015, 0.1, 0.5, 1.0)


def _counts(seed, vocab=5000, a=1.3):
    z = np.random.default_rng(seed).zipf(a, size=50_000) % vocab
    return np.bincount(z, minlength=vocab)


@pytest.mark.parametrize("seed", range(3))
def test_coverage_and_top_fraction_coverage_match_reference(seed):
    counts = _counts(seed)
    want = jfreq.coverage(counts, FRACS)
    assert freq.coverage(counts, FRACS) == want
    stats, jstats = freq.build_freq_stats(counts), jfreq.build_freq_stats(counts)
    for f in FRACS:
        assert stats.top_fraction_coverage(f) == jstats.top_fraction_coverage(f) == want[f]
    assert want[1.0] == 1.0 and want[0.01] > want[0.001]
    assert freq.coverage(np.zeros(10, np.int64), (0.5,)) == {0.5: 0.0}


def test_reorder_rows_matches_reference():
    counts = _counts(4, vocab=300)
    w = np.random.default_rng(0).normal(size=(300, 6)).astype(np.float32)
    got = freq.build_freq_stats(counts).reorder_rows(w)
    assert np.array_equal(got, jfreq.build_freq_stats(counts).reorder_rows(w))
    hottest = int(np.argmax(counts))
    assert np.array_equal(got[0], w[hottest])
    with pytest.raises(ValueError, match="rows"):
        freq.build_freq_stats(counts).reorder_rows(w[:10])


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_collect_counts_sampled_matches_reference(rate):
    """The same kept batches for one seed or one generator state."""
    spec = synth.ZipfSparseSpec(vocab_sizes=(200, 50, 30))
    jspec = jsynth.ZipfSparseSpec(vocab_sizes=(200, 50, 30))
    got = freq.collect_counts_sampled(synth.count_stream(spec, 32, 12, 1), 280, rate, seed=5)
    want = jfreq.collect_counts_sampled(jsynth.count_stream(jspec, 32, 12, 1), 280, rate, seed=5)
    assert np.array_equal(got, want) and got.dtype == want.dtype == np.int64
    got = freq.collect_counts_sampled(synth.count_stream(spec, 32, 12, 1), 280, rate,
                                      rng=np.random.default_rng(9))
    want = jfreq.collect_counts_sampled(jsynth.count_stream(jspec, 32, 12, 1), 280, rate,
                                        rng=np.random.default_rng(9))
    assert np.array_equal(got, want)
    assert int(got.sum()) == {0.0: 0, 1.0: 12 * 32 * 3}.get(rate, int(got.sum()))


@pytest.mark.parametrize("vocab_sizes,n_dense", [((100, 7, 3000), 0), ((64, 32), 8)])
def test_count_stream_matches_reference(vocab_sizes, n_dense):
    spec = synth.ZipfSparseSpec(vocab_sizes=vocab_sizes, n_dense=n_dense)
    jspec = jsynth.ZipfSparseSpec(vocab_sizes=vocab_sizes, n_dense=n_dense)
    got = list(synth.count_stream(spec, 16, 5, 3))
    want = list(jsynth.count_stream(jspec, 16, 5, 3))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64 and np.array_equal(g, w)
        assert g.shape == (16 * len(vocab_sizes),) and g.max() < sum(vocab_sizes)
