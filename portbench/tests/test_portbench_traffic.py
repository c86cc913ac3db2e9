"""The traffic generator: batch ``i`` is a pure function of (seed, i), on
the sizes the configuration gives, with the Zipf skew of the program's own
synthetic stream."""
import numpy as np
import torch

from portbench.lib import traffic

CFG = {"vocab_sizes": [1000, 10_000_000, 3, 200_000], "n_dense": 5, "batch_size": 4096}
MIX = {"generator": "zipf", "mode": "train", "zipf_a": 1.2, "label_noise": 0.3}
SEED = 2**40 + 12345  # the driver's seeds exceed 32 bits


def _gen(seed=SEED):
    return traffic.make(CFG, MIX, seed, torch.device("cpu"))


def test_batch_is_a_pure_function_of_seed_and_index():
    a, b = _gen().batch_at(7), _gen().batch_at(7)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    later = _gen()
    later.batch_at(3)
    assert all(torch.equal(a[k], later.batch_at(7)[k]) for k in a)  # no hidden state
    assert not torch.equal(a["sparse"], _gen().batch_at(8)["sparse"])
    assert not torch.equal(a["sparse"], _gen(SEED + 1).batch_at(7)["sparse"])


def test_batch_shapes_ranges_and_skew():
    b = _gen().batch_at(0)
    assert b["sparse"].shape == (4096, 4) and b["sparse"].dtype == torch.int32
    assert b["dense"].shape == (4096, 5) and b["label"].shape == (4096,)
    assert int(b["sparse"].min()) >= 0
    assert (b["sparse"] < torch.tensor(CFG["vocab_sizes"])).all()
    assert set(b["label"].unique().tolist()) <= {0.0, 1.0}
    ids = torch.cat([_gen().batch_at(i)["sparse"][:, 1] for i in range(8)]).numpy()
    top = np.mean(ids < CFG["vocab_sizes"][1] // 100)  # accesses to under 1 % of the ids
    assert top > 0.85


def test_ahead_hands_out_the_same_batches():
    feed = traffic.Ahead(_gen())
    for i in (0, 1, 2, 5):
        got, want = feed.get(i), _gen().batch_at(i)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_global_ids_offset_each_field():
    g = _gen()
    sparse = torch.tensor([[0, 0, 0, 0], [999, 1, 2, 5]], dtype=torch.int32)
    want = torch.tensor([[0, 1000, 10_001_000, 10_001_003],
                         [999, 1001, 10_001_002, 10_001_008]])
    assert torch.equal(g.global_ids(sparse), want)


def test_stream_seed_takes_large_seeds():
    s = traffic.stream_seed(2**62 + 3, "batch", 10**9)
    assert 0 <= s < 2**63 and s != traffic.stream_seed(2**62 + 4, "batch", 10**9)


def test_counts_are_the_streams_expected_frequencies():
    """The scan's counts: each field sums to the scan's length, ranks its ids
    by id, and matches the frequencies the batches draw."""
    g = _gen()
    c = g.counts()
    assert c.dtype == np.int64 and c.shape == (sum(CFG["vocab_sizes"]),)
    off = np.cumsum([0] + CFG["vocab_sizes"])
    for f in range(len(CFG["vocab_sizes"])):
        cf = c[off[f] : off[f + 1]]
        assert abs(cf.sum() / traffic.SCAN_SAMPLES - 1) < 1e-9
        assert (np.diff(cf[:-1]) <= 0).all() and cf[-1] == 0
    ids = torch.cat([g.batch_at(i)["sparse"][:, 0] for i in range(16)]).numpy()
    seen = np.bincount(ids, minlength=1000)[:5] / ids.shape[0]
    assert np.allclose(seen, c[:5] / traffic.SCAN_SAMPLES, atol=0.01)
    # across fields: the head of the 3-id field ranks above the tail of the 1000-id one
    assert c[off[2]] > c[999 - 1]
