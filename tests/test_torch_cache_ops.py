"""repro_torch.kernels.cache_ops against repro.kernels.cache_ops, bitwise.

* the port's plain ``victim_topk`` / ``dedup`` / ``compact_front`` /
  ``plan_image`` against ``repro.kernels.cache_ops.ref`` on the same
  numpy-seeded inputs, including the tie-heavy, sentinel and all-equal
  cases;
* the port's plain threshold against the Pallas kernel itself,
  ``victim_threshold_pallas`` in interpret mode;
* the sharded router's ``[S, U]`` bucketize image against the reference's
  ``ref.bucketize`` and ``bucketize_pallas`` in interpret mode, and the
  fused ``shard_bucketize`` front end's five outputs against the
  reference's, bitwise;
* the route + bucketize entry's plain route on the CPU (no launch): the
  route's edge lanes (replicated, negative, padding and past-the-table
  ranks), bitwise its torch composition;
* each wrapper's packed launch against its C entry's argument struct.

The CUDA kernels are held against their plain versions on the card by
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cache_ops import kernel as jkernel
from repro.kernels.cache_ops import ops as jops
from repro.kernels.cache_ops import ref as jref
from repro_torch.kernels.cache_ops import kernel, ops, ref

_BIG = (2**31 - 1) // 2
INT_MAX = 2**31 - 1
GEOMETRIES = ((5, 5), (257, 1), (257, 100), (399, 398))


def _tie_heavy_keys(rng, c):
    pool = np.concatenate([rng.integers(-4, 4, size=c), np.array([_BIG, -_BIG, -(_BIG // 2)])])
    return rng.choice(pool, size=c).astype(np.int32)


def test_victim_topk_matches_reference_under_ties():
    # a few (capacity, kv) geometries, so JAX compiles each op only once
    rng = np.random.default_rng(0)
    for trial in range(24):
        c, kv = GEOMETRIES[trial % len(GEOMETRIES)]
        key = _tie_heavy_keys(rng, c)
        want = np.asarray(jref.victim_topk(jnp.asarray(key), kv))
        got = ref.victim_topk(torch.from_numpy(key), kv)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), (trial, c, kv)
        # the dispatching entry point takes the same plain route on the CPU
        assert torch.equal(ops.victim_topk_impl(torch.from_numpy(key), kv), got)
        # and both equal the full stable argsort they replace
        order = torch.argsort(torch.from_numpy(key), descending=True, stable=True)[:kv]
        assert torch.equal(order.to(torch.int32), got)


def test_victim_topk_all_equal_keys():
    key = torch.full((33,), 7, dtype=torch.int32)
    assert torch.equal(ref.victim_topk(key, 33), torch.arange(33, dtype=torch.int32))


def test_ordered_u32_matches_reference():
    key = np.array([-(2**31), -1, 0, 1, 2**31 - 1, _BIG, -_BIG], np.int32)
    want = np.asarray(jref.ordered_u32(jnp.asarray(key))).astype(np.int64)
    assert np.array_equal(ref.ordered_u32(torch.from_numpy(key)).numpy(), want)


def test_plain_threshold_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    for trial in range(10):
        c = int(rng.integers(8, 600))
        kv = int(rng.integers(1, c + 1))
        if trial % 2:
            key = _tie_heavy_keys(rng, c)
        else:
            key = rng.integers(-1000, 1000, size=c).astype(np.int32)
        u = jref.ordered_u32(jnp.asarray(key))
        t_want, n_want = jkernel.victim_threshold_pallas(u, kv, tile_rows=64, interpret=True)
        t, n_gt = kernel.victim_threshold_plain(torch.from_numpy(key), kv)
        assert int(t) == int(np.asarray(t_want)), trial
        assert int(n_gt) == int(np.asarray(n_want)), trial
        assert t.dtype == torch.int64 and n_gt.dtype == torch.int32


def test_threshold_wrapper_takes_plain_route_on_cpu():
    key = torch.tensor([5, 1, 5, 3, 9, -2], dtype=torch.int32)
    before = kernel.victim_threshold.launches
    t, n_gt = kernel.victim_threshold(key, 3)
    assert kernel.victim_threshold.launches == before  # no kernel launched
    t_p, n_p = kernel.victim_threshold_plain(key, 3)
    assert int(t) == int(t_p) == 5 + 2**31 and int(n_gt) == int(n_p) == 1


def test_dedup_matches_reference_and_true_count():
    rng = np.random.default_rng(1)
    for trial in range(18):
        n, k = GEOMETRIES[trial % len(GEOMETRIES)]
        rows = rng.integers(0, 40, size=n).astype(np.int32)
        rows[rng.random(n) < 0.3] = INT_MAX  # sentinel padding lanes
        want_u, want_n = jref.dedup(jnp.asarray(rows), k, INT_MAX)
        got_u, got_n = ref.dedup(torch.from_numpy(rows), k, INT_MAX)
        assert np.array_equal(np.asarray(want_u), got_u.numpy()), trial
        assert got_u.dtype == torch.int32 and got_n.dtype == torch.int32
        assert int(want_n) == int(got_n), trial


def test_compact_front_matches_reference():
    rng = np.random.default_rng(2)
    for trial in range(18):
        n, out_len = GEOMETRIES[trial % len(GEOMETRIES)]
        mask = rng.random(n) < 0.5
        vals = rng.integers(0, 100, size=n).astype(np.int32)
        want = jref.compact_front(jnp.asarray(mask), jnp.asarray(vals), out_len)
        got = ref.compact_front(torch.from_numpy(mask), torch.from_numpy(vals), out_len)
        assert np.array_equal(np.asarray(want), got.numpy()), trial


def test_plan_image_matches_reference():
    rng = np.random.default_rng(3)
    for trial in range(12):
        vocab = int(rng.integers(8, 200))
        n, k = GEOMETRIES[trial % len(GEOMETRIES)]
        rows = rng.integers(-1, vocab, size=n).astype(np.int32)
        rows = np.where(rows >= 0, rows, INT_MAX).astype(np.int32)
        r2s = np.where(rng.random(vocab) < 0.4, rng.integers(0, 64, size=vocab), -1).astype(np.int32)
        want = jref.plan_image(jnp.asarray(rows), jnp.asarray(r2s), k)
        got = ops.plan_image_impl(torch.from_numpy(rows), torch.from_numpy(r2s), k)
        for f in ("uniq", "uniq_sorted", "uniq_valid", "uniq_slots", "miss", "miss_rows",
                  "n_miss", "n_distinct"):
            w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert w.dtype == g.dtype and np.array_equal(w, g), (trial, f)


def _routing(rng, u, s):
    """Owners in and out of [0, S), -1 locals on padding / replicated lanes."""
    owner = rng.integers(-2, s + 2, size=u).astype(np.int32)
    local = rng.integers(-1, 100, size=u).astype(np.int32)
    local[rng.random(u) < 0.2] = -1
    return owner, local


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_bucketize_matches_reference_and_pallas(s):
    rng = np.random.default_rng(s)
    for u in (0, 1, 3, 4, 4097):
        owner, local = _routing(rng, u, s)
        got = ref.bucketize(torch.from_numpy(owner), torch.from_numpy(local), s)
        assert got.dtype == torch.int32 and tuple(got.shape) == (s, u)
        want = np.asarray(jref.bucketize(jnp.asarray(owner), jnp.asarray(local), s))
        assert np.array_equal(want, got.numpy()), (s, u)
        if u:
            pallas = jkernel.bucketize_pallas(jnp.asarray(owner), jnp.asarray(local), s,
                                              interpret=True)
            assert np.array_equal(np.asarray(pallas), got.numpy()), (s, u)
        assert torch.equal(ops.bucketize_impl(torch.from_numpy(owner), torch.from_numpy(local),
                                              s), got)
    # the edge images: every lane padding, every lane replicated
    pad = torch.full((9,), -1, dtype=torch.int32)
    assert bool((ref.bucketize(pad, pad, s) == -1).all())
    assert bool((ref.bucketize(torch.zeros(9, dtype=torch.int32), pad, s) == -1).all())


def test_bucketize_wrapper_takes_plain_route_on_cpu():
    owner = torch.tensor([0, 1, 1, -1, 2], dtype=torch.int32)
    local = torch.tensor([4, 5, -1, 3, 7], dtype=torch.int32)
    before = kernel.bucketize.launches
    got = kernel.bucketize(owner, local, 2)
    assert kernel.bucketize.launches == before  # no kernel launched
    assert got.tolist() == [[4, -1, -1, -1, -1], [-1, 5, -1, -1, -1]]
    assert torch.equal(got, kernel.bucketize_plain(owner, local, 2))


@pytest.mark.parametrize("s,rep_k", [(1, 0), (2, 0), (4, 8), (3, 40)])
def test_shard_bucketize_matches_reference(s, rep_k):
    rng = np.random.default_rng(10 + s)
    vocab = 64
    owner_map = rng.integers(0, s, size=vocab).astype(np.int32)
    local_map = rng.integers(0, vocab // s + 1, size=vocab).astype(np.int32)
    for lanes in (8, 100):
        rank = rng.integers(-1, vocab, size=lanes).astype(np.int32)
        u = min(lanes, vocab)
        want = jops.shard_bucketize(jnp.asarray(rank), jnp.asarray(owner_map),
                                    jnp.asarray(local_map), rep_k, s, u)
        got = ops.shard_bucketize(torch.from_numpy(rank), torch.from_numpy(owner_map),
                                  torch.from_numpy(local_map), rep_k, s, u)
        for w, g, name in zip(want, got, ("uniq", "pos", "owner_u", "local_u", "rows_sh")):
            w = np.asarray(w)
            assert w.dtype == g.numpy().dtype and np.array_equal(w, g.numpy()), (s, lanes, name)


@pytest.mark.parametrize("rep_k", [0, 3])
def test_route_bucketize_wrapper_takes_plain_route_on_cpu(rep_k):
    """``route_bucketize`` on CPU tensors launches nothing and returns the
    route's ``(owner, local)`` and the image, -1 on every lane below
    ``rep_k``, negative, the padding rank or past the tables;
    ``route_image`` returns that image alone."""
    owner_map = torch.tensor([1, 0, 2, 1, 0, 2, 1], dtype=torch.int32)
    local_map = torch.tensor([0, 0, 0, 1, 1, 1, -1], dtype=torch.int32)
    uniq = torch.tensor([-1, 0, 2, 3, 5, 6, 7, 40, INT_MAX], dtype=torch.int32)
    before = (kernel.bucketize.launches, kernel.bucketize.fused_launches)
    owner, local, image = kernel.route_bucketize(uniq, owner_map, local_map, rep_k, 3)
    assert (kernel.bucketize.launches, kernel.bucketize.fused_launches) == before
    routed = [rep_k <= r < 7 for r in uniq.tolist()]
    assert owner.tolist() == [owner_map[r].item() if ok else -1
                              for r, ok in zip(uniq.tolist(), routed)]
    assert local.tolist() == [local_map[r].item() if ok else -1
                              for r, ok in zip(uniq.tolist(), routed)]
    assert torch.equal(image, kernel.bucketize_plain(owner, local, 3))
    for got, want in zip((owner, local, image), kernel.route_bucketize_plain(
            uniq, owner_map, local_map, rep_k, 3)):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    for got, want in zip(ops.route_bucketize_impl(uniq, owner_map, local_map, rep_k, 3),
                         (owner, local, image)):
        assert torch.equal(got, want)
    for got in (kernel.route_image(uniq, owner_map, local_map, rep_k, 3),
                kernel.route_image_plain(uniq, owner_map, local_map, rep_k, 3),
                ops.route_image_impl(uniq, owner_map, local_map, rep_k, 3)):
        assert got.dtype == torch.int32 and torch.equal(got, image)
    assert (kernel.bucketize.launches, kernel.bucketize.fused_launches) == before
    with pytest.raises(ValueError):
        kernel.route_bucketize(uniq.to("meta"), owner_map, local_map, rep_k, 3)
    with pytest.raises(ValueError):
        kernel.route_image(uniq.to("meta"), owner_map, local_map, rep_k, 3)


def _radix_select(key, kv, parts):
    """``csrc/victim_threshold.cu``'s radix select in numpy, pass by pass:
    the keys cut into ``parts`` slices as the CTAs hold them; each pass
    histograms, per slice, the 8-bit digit of the keys whose higher digits
    equal the prefix, sums the slices' histograms (the cross-CTA merge),
    picks the digit where the count from the top reaches the remaining kv,
    and adds the bins above it to n_gt.  Returns (t, n_gt)."""
    u = key.astype(np.int64) + 2**31  # key ^ 0x80000000 as uint32
    per = -(-len(u) // parts)
    slices = [u[p * per:(p + 1) * per] for p in range(parts)]
    prefix, rem, n_gt = 0, kv, 0
    for p in range(4):
        shift = 24 - 8 * p
        hist = np.zeros(256, np.int64)
        for sl in slices:
            match = sl if p == 0 else sl[(sl >> (shift + 8)) == prefix]
            hist += np.bincount((match >> shift) & 255, minlength=256)
        assert hist.sum() >= rem  # the prefix's keys hold the remaining kv
        suffix = np.cumsum(hist[::-1])[::-1]  # keys of this prefix with a digit >= b
        above = suffix - hist
        (digit,) = np.nonzero((above < rem) & (rem <= suffix))
        assert digit.size == 1, p  # exactly one bin
        d = int(digit[0])
        prefix, rem, n_gt = (prefix << 8) | d, rem - int(above[d]), n_gt + int(above[d])
        # n_gt counts every key above the prefix at this digit's resolution
        assert n_gt == int(((u >> shift) > prefix).sum()), p
    return prefix, n_gt


def _threshold_case(name):
    rng = np.random.default_rng(len(name))
    lo, hi = -(2**31), 2**31 - 1
    if name == "tie_heavy":
        key = _tie_heavy_keys(rng, 300)
        return key, int(rng.integers(1, 301))
    if name == "kv_1":
        return rng.integers(-1000, 1000, size=257).astype(np.int32), 1
    if name == "kv_n":
        return _tie_heavy_keys(rng, 257), 257
    if name == "all_equal":
        return np.full(100, -7, np.int32), 37
    if name == "int32_extremes":
        key = rng.choice(np.array([lo, lo + 1, -1, 0, hi - 1, hi]), size=200).astype(np.int32)
        return key, int(rng.integers(1, 201))
    if name == "n_1":
        return np.array([hi], np.int32), 1
    raise ValueError(name)


@pytest.mark.parametrize("name", ["tie_heavy", "kv_1", "kv_n", "all_equal", "int32_extremes",
                                  "n_1"])
def test_radix_select_emulation_matches_plain_and_pallas(name):
    """The kernel's radix digit select, emulated with the DLRM's and FM's
    cross-CTA cuts (one CTA, a 16-CTA cluster, a 132-CTA cooperative grid),
    equals the plain threshold and the Pallas kernel in interpret mode."""
    key, kv = _threshold_case(name)
    t, n_gt = kernel.victim_threshold_plain(torch.from_numpy(key), kv)
    u = jref.ordered_u32(jnp.asarray(key))
    t_want, n_want = jkernel.victim_threshold_pallas(u, kv, tile_rows=64, interpret=True)
    assert (int(t), int(n_gt)) == (int(np.asarray(t_want)), int(np.asarray(n_want)))
    for parts in (1, 16, 132):
        assert _radix_select(key, kv, parts) == (int(t), int(n_gt)), parts


def _c_struct_fields(source: str, struct: str) -> list:
    """The fields of C ``struct`` in ``source`` as (type, name), a member
    that is itself a struct of the source expanded into its fields."""
    import re

    body = re.search(r"struct %s \{(.*?)\};" % struct, source, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        m = re.fullmatch(r"(.+?)\s*(\w+);", decl)
        assert m, decl
        typ, name = m.group(1).strip(), m.group(2)
        if re.fullmatch(r"\w+Args", typ):
            fields += _c_struct_fields(source, typ)
        else:
            fields.append((typ, name))
    return fields


@pytest.mark.parametrize("name", ["gather_decode", "gather_decode_encode", "bucketize",
                                  "route_bucketize"])
def test_launch_packs_the_fields_of_its_c_struct(name):
    """Each cache-op wrapper's ``build.Kernel`` packs as many 8-byte fields
    as its C entry's argument struct has, each field a pointer or a
    ``long long`` (a mismatch shows only at the first launch on a card)."""
    import re

    launcher = getattr(kernel, "_" + name)
    source = launcher.source.read_text()
    struct = re.search(r'extern "C" int %s\(const (\w+)\* a' % name, source).group(1)
    fields = _c_struct_fields(source, struct)
    assert all(t == "long long" or t.endswith("*") for t, _ in fields), fields
    assert launcher._pack.__self__.size == 8 * len(fields), (name, fields)
