"""Card-only paths of the port against their CPU versions, on the card:
the CUDA kernels (victim threshold, one launch and no memset per call;
tiered-arena gather + decode, and its fused host encode for fp16 / int8
host tiers (one launch, rows with signed-zero extremes too), FM
interaction, embedding bag for one feature and for many in one launch,
bucketize and its fused route + image entry (one launch), flash attention's bf16
tensor-core, fp32 3xTF32 tensor-core and fp32 SIMT kernels) against their
plain PyTorch versions
(bitwise; the FM kernel within the reference's sweep tolerances, flash
attention within the card smoke's |o|-scaled bound), the pinned host-tier
transmitter (staging ring, async copies, fp32 and tiered arenas) against
the CPU move (fp32, fp16 and int8 host tiers; fp32 and tiered arenas; the
verbatim host -> tail path; chunked staging, into a tiered arena too), a
lookahead plan's eviction key through the threshold kernel at ``kv ==
capacity``, a 4-shard collection's lookups against its dense
reference, one serve and one train step of DIN, DIEN and MIND against
the CPU port, and the LM family's training step (the flash kernel in the
forward and the remat recompute), MoE layers and int8 KV-cache attention
(its integer dots exact) against the CPU port, and a GatedGCN train step
against the CPU port and bitwise across two deterministic runs.

Imports neither JAX nor the JAX package, so the machine with the card runs
it as is:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a card every test skips (a CUDA kernel has no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import transmitter
from repro_torch.kernels.cache_ops import kernel, ops
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fm_interaction import kernel as fm_kernel
from repro_torch.store.arena import ArenaStore
from repro_torch.store.codec import get_codec
from repro_torch.store.host_store import HostStore

_BIG = (2**31 - 1) // 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _tie_heavy_keys(rng, c):
    pool = np.concatenate([rng.integers(-4, 4, size=c), np.array([_BIG, -_BIG, -(_BIG // 2)])])
    return rng.choice(pool, size=c).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 37, 4096, 70001])
def test_threshold_kernel_matches_plain(cuda, c):
    rng = np.random.default_rng(c)
    for trial in range(8):
        kv = int(rng.integers(1, c + 1))
        key = torch.from_numpy(_tie_heavy_keys(rng, c)).to(cuda)
        before = kernel.victim_threshold.launches
        t, n_gt = kernel.victim_threshold(key, kv)
        assert kernel.victim_threshold.launches == before + 1
        t_p, n_p = kernel.victim_threshold_plain(key, kv)
        assert int(t) == int(t_p) and int(n_gt) == int(n_p), trial
        want = torch.argsort(key, descending=True, stable=True)[:kv].to(torch.int32)
        assert torch.equal(ops.victim_topk_impl(key, kv), want), trial


@pytest.mark.cuda
def test_threshold_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        kernel.victim_threshold(torch.zeros(8, dtype=torch.int64, device=cuda), 2)
    with pytest.raises(ValueError):
        kernel.victim_threshold(torch.zeros(8, dtype=torch.int32, device=cuda), 9)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 37, 4096, 70001, 506_438, 2_097_152])
def test_threshold_kernel_matches_plain_full_range(cuda, c):
    """The one-launch radix select, bitwise the plain version: tie-heavy
    keys with the planner's sentinels and keys over the whole int32 range,
    kv = n first (FM's plans: 2 097 152 keys)."""
    rng = np.random.default_rng(c + 1)
    for trial in range(3 if c > 100_000 else 8):
        kv = c if trial == 0 else int(rng.integers(1, c + 1))
        if trial % 2:
            key = rng.integers(-(2**31), 2**31, size=c, dtype=np.int64).astype(np.int32)
        else:
            key = _tie_heavy_keys(rng, c)
        key = torch.from_numpy(key).to(cuda)
        before = kernel.victim_threshold.launches
        t, n_gt = kernel.victim_threshold(key, kv)
        assert kernel.victim_threshold.launches == before + 1
        t_p, n_p = kernel.victim_threshold_plain(key, kv)
        assert t.dtype == torch.int64 and n_gt.dtype == torch.int32 and t.dim() == n_gt.dim() == 0
        assert int(t) == int(t_p) and int(n_gt) == int(n_p), (trial, kv)


@pytest.mark.cuda
def test_threshold_call_is_one_kernel_and_no_memset(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    key = torch.from_numpy(_tie_heavy_keys(rng, 506_438)).to(cuda)
    kernel.victim_threshold(key, 425_984)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel.victim_threshold(key, 425_984)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "threshold" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["load", "writeback"])
def test_pinned_move_rows_matches_cpu_move(cuda, direction):
    rng = np.random.default_rng(5)
    vocab, cap, dim, k = 1000, 300, 16, 256
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32))
    arena = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    n_src, n_dst = (vocab, cap) if direction == "load" else (cap, vocab)
    src = torch.from_numpy(rng.integers(-1, n_src, size=k).astype(np.int32))
    dst = torch.from_numpy(rng.permutation(n_dst)[:k].astype(np.int32))
    active = torch.from_numpy(rng.random(k) < 0.8)
    want_store = HostStore.create({"w": table.clone()})
    want_arena = {"w": arena.clone()}
    got_store = HostStore.create({"w": table.clone()}, pin=True)
    got_arena = {"w": arena.to(cuda)}
    try:
        if direction == "load":
            transmitter.move_rows(want_store, want_arena, src, dst, active, buffer_rows=7)
            transmitter.move_rows(got_store, got_arena, src.to(cuda), dst.to(cuda),
                                  active.to(cuda), buffer_rows=7)
            torch.cuda.synchronize()
            assert torch.equal(got_arena["w"].cpu(), want_arena["w"])
        else:
            transmitter.move_rows(want_arena, want_store, src, dst, active, buffer_rows=7)
            transmitter.move_rows(got_arena, got_store, src.to(cuda), dst.to(cuda),
                                  active.to(cuda), buffer_rows=7)
            assert torch.equal(got_store["w"], want_store["w"])
    finally:
        got_store.close()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("direction", ["load", "writeback"])
def test_pinned_chunked_move_matches_cpu_row_move(cuda, codec, direction):
    """Chunked staging through the pinned ring: the load's staged chunks
    cross in one copy and the rows are picked out on the card; the
    write-back's chunks are read-modified-written on the host.  Bitwise the
    CPU row move, and the move counter says which path ran."""
    rng = np.random.default_rng(9)
    vocab, cap, dim, k = 1024, 300, 16, 256
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32))
    arena = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    n_src, n_dst = (vocab, cap) if direction == "load" else (cap, vocab)
    src = torch.from_numpy(rng.integers(-1, n_src, size=k).astype(np.int32))
    dst = torch.from_numpy(rng.permutation(n_dst)[:k].astype(np.int32))
    active = torch.from_numpy(rng.random(k) < 0.8)
    want_store = HostStore.create({"w": table.clone()}, codec)
    want_arena = {"w": arena.clone()}
    got_store = HostStore.create({"w": table.clone()}, codec, pin=True)
    got_arena = {"w": arena.to(cuda)}
    chunk = {"src_chunk_rows": 64} if direction == "load" else {"dst_chunk_rows": 64}
    lanes = (src.to(cuda), dst.to(cuda), active.to(cuda))
    before = transmitter.moves["chunked"]
    try:
        if direction == "load":
            transmitter.move_rows(want_store, want_arena, src, dst, active, buffer_rows=100)
            transmitter.move_rows(got_store, got_arena, *lanes, buffer_rows=100, **chunk)
            torch.cuda.synchronize()
            assert torch.equal(got_arena["w"].cpu(), want_arena["w"])
        else:
            transmitter.move_rows(want_arena, want_store, src, dst, active, buffer_rows=100)
            transmitter.move_rows(got_arena, got_store, *lanes, buffer_rows=100, **chunk)
            for leaves, want in ((got_store.data, want_store.data),
                                 (got_store.sideband, want_store.sideband)):
                for key in want:
                    assert torch.equal(leaves[key], want[key]), key
        assert transmitter.moves["chunked"] == before + 1
    finally:
        got_store.close()


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", [False, True])
def test_lookahead_plan_on_the_card_matches_cpu(cuda, pallas):
    """A lookahead plan whose window lifts ``kv`` to the capacity: on the
    card (the threshold kernel, with ``use_pallas_plan``) bitwise the CPU
    plan, and its eviction key's victims through the kernel bitwise a
    stable argsort (the key's four tiers: protected, pinned, policy,
    empty)."""
    from repro_torch.convert import to_numpy
    from repro_torch.core import cache

    cfg = cache.CacheConfig(vocab=4096, capacity=600, ids_per_step=256, buffer_rows=1024,
                            use_pallas_plan=pallas)
    rng = np.random.default_rng(2)
    table = rng.normal(size=(4096, 8)).astype(np.float32)
    states = []
    for dev in (torch.device("cpu"), cuda):
        st = cache.init_cache(cfg, {"weight": torch.zeros((8,))}, dev)
        full = HostStore.create({"weight": torch.from_numpy(table.copy())}, pin=dev.type == "cuda")
        full, st = cache.warmup(cfg, full, st)
        states.append([full, st, dev])
    try:
        for step in range(4):
            rows = np.minimum(rng.zipf(1.2, size=256) - 1, 4095).astype(np.int32)
            fut = rng.integers(-1, 4096, size=512).astype(np.int32)
            plans = []
            for pair in states:
                full, st, dev = pair
                before = kernel.victim_threshold.launches
                plan = cache.plan_prepare(cfg, st, torch.from_numpy(rows).to(dev),
                                          future_rows=torch.from_numpy(fut).to(dev))
                if dev.type == "cuda" and pallas:
                    assert kernel.victim_threshold.launches == before + 1
                assert plan.victim_slots.shape == (600,)  # kv = min(256 + 512, 600)
                plans.append(to_numpy(plan))
                pair[0], pair[1] = cache.apply_plan(cfg, full, st, plan)
            for key in plans[0]:
                if key != "tracker":
                    assert np.array_equal(plans[0][key], plans[1][key]), (step, key)
        # the last lookahead key, captured through the planner's own pieces
        st = states[1][1]
        key = torch.where(st.slot_to_row < 0, _BIG, st.slot_to_row).to(torch.int32)
        key[:100] = -(_BIG // 2)
        key[100:150] = -_BIG
        want = torch.argsort(key, descending=True, stable=True).to(torch.int32)
        assert torch.equal(ops.victim_topk_impl(key, 600), want)
    finally:
        states[1][0].close()


def _tiered_args(rng, codec, h, t, d, k):
    """head / tail / sideband / slots for the gather-decode kernel; slots
    cover padding, both tier edges and far out-of-range values."""
    head = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32) * 3)
    payload, side = get_codec(codec).encode(rows)
    edges = [-1, h - 1, h, h + t - 1, h + t, 2**31 - 1, -(2**31), h + t + 7]
    slots = np.concatenate([edges, rng.integers(-2, h + t + 2, size=k - len(edges))])
    return head, payload, side, torch.from_numpy(slots.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [8, 16, 36, 128, 5])
@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_gather_decode_kernel_matches_plain(cuda, codec, d, offset):
    rng = np.random.default_rng(d + offset)
    args = _tiered_args(rng, codec, h=37, t=91, d=d, k=300)
    want = kernel.gather_decode_plain(*args, codec)
    # offset 1: views one element into their buffers, contiguous but not
    # 16 B aligned, so the kernel takes its scalar path
    dev = [None if a is None else
           torch.empty(a.numel() + offset, dtype=a.dtype, device=cuda)[offset:].view(a.shape)
           .copy_(a) for a in args]
    before = kernel.gather_decode.launches
    got = ops.arena_gather_impl(*dev, codec)
    torch.cuda.synchronize()
    assert kernel.gather_decode.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, kernel.gather_decode_plain(*dev, codec))


@pytest.mark.cuda
def test_gather_decode_kernel_rejects_bad_input(cuda):
    rng = np.random.default_rng(0)
    head, tail, side, slots = (a.to(cuda) for a in _tiered_args(rng, "int8", 4, 6, 8, 16))
    with pytest.raises(ValueError):
        kernel.gather_decode(head, tail, None, slots, "int8")  # int8 needs its sideband
    with pytest.raises(ValueError):
        kernel.gather_decode(head.double(), tail, side, slots, "int8")
    with pytest.raises(ValueError):
        kernel.gather_decode(head, tail, side, slots.long(), "int8")
    with pytest.raises(ValueError):
        kernel.gather_decode(head.t(), tail, side, slots, "int8")  # not contiguous
    with pytest.raises(ValueError):
        kernel.gather_decode(head, tail, side, slots.cpu(), "int8")  # mixed devices


def _bits(x):
    return x.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()])


def _fused_args(rng, codec, d, k):
    """``_tiered_args`` with constant rows (mx = mn): head row 0 at 0.75,
    head row 1 zeros, tail row 0 decoding to one value; slots on them."""
    head, tail, side, slots = _tiered_args(rng, codec, h=37, t=91, d=d, k=k)
    head[0], head[1] = 0.75, 0.0
    tail[0] = 0 if codec == "int8" else 1.5
    return head, tail, side, torch.cat([slots, torch.tensor([0, 1, 37], dtype=torch.int32)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [8, 16, 36, 128, 5])
@pytest.mark.parametrize("host", ["fp16", "int8"])
@pytest.mark.parametrize("codec", ["fp16", "int8"])
def test_gather_decode_encode_kernel_matches_plain(cuda, codec, host, d, offset):
    """The fused gather + decode + host encode, bitwise its plain version
    (payload and sideband bits): out-of-range slots, constant rows, the
    scalar path (D 5, and views off their 16 B boundary); one launch,
    counted on both counters."""
    rng = np.random.default_rng(d + 3 * offset)
    args = _fused_args(rng, codec, d, 300)
    want = kernel.gather_decode_encode_plain(*args, codec, host)
    dev = [None if a is None else
           torch.empty(a.numel() + offset, dtype=a.dtype, device=cuda)[offset:].view(a.shape)
           .copy_(a) for a in args]
    before = (kernel.gather_decode.launches, kernel.gather_decode.fused_launches)
    got = ops.arena_gather_encode_impl(*dev, codec, host)
    torch.cuda.synchronize()
    assert (kernel.gather_decode.launches, kernel.gather_decode.fused_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(got[0].cpu()), _bits(want[0]))
    if host == "int8":
        assert torch.equal(_bits(got[1].cpu()), _bits(want[1]))
    else:
        assert got[1] is None and want[1] is None
    on_card = kernel.gather_decode_encode_plain(*dev, codec, host)
    assert torch.equal(_bits(got[0]), _bits(on_card[0]))


@pytest.mark.cuda
def test_gather_decode_encode_rows_with_signed_zero_extremes(cuda):
    """Rows whose extremes are zeros of both signs, each order, all -0, and
    a -0 minimum under a positive maximum: payload and scale bitwise the
    plain version on the card, zp equal by value (its sign may differ:
    torch's min / max over +-0 ties depends on its reduction order); an
    fp16 host bitwise."""
    rows = torch.zeros((6, 128), device=cuda)
    rows[0, 1::2] = -0.0
    rows[1] = -0.0
    rows[1, 1::2] = 0.0
    rows[2] = -0.0
    rows[3, ::3] = -0.0
    rows[4, 0], rows[4, 1] = -0.0, 2.0
    rows[5] = torch.linspace(-1, 1, 128, device=cuda)
    args = (rows, torch.zeros((1, 128), dtype=torch.int8, device=cuda),
            torch.ones((1, 2), device=cuda), torch.arange(6, dtype=torch.int32, device=cuda))
    got = kernel.gather_decode_encode(*args, "int8", "int8")
    want = kernel.gather_decode_encode_plain(*args, "int8", "int8")
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1][:, 0]), _bits(want[1][:, 0]))
    assert torch.equal(got[1][:, 1], want[1][:, 1])
    for r in (2, 4, 5):  # no tie of signed zeros between min and max: bitwise
        assert torch.equal(_bits(got[1][r]), _bits(want[1][r])), r
    g16 = kernel.gather_decode_encode(*args, "int8", "fp16")[0]
    assert torch.equal(_bits(g16), _bits(kernel.gather_decode_encode_plain(*args, "int8",
                                                                           "fp16")[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 5])
def test_gather_decode_encode_rows_with_nan_and_inf(cuda, d):
    """Rows holding a NaN, +inf, -inf, both infinities, or only +inf (head
    rows, so no decode hides them), among finite rows: an int8 host's
    codes bitwise the plain version on the card (torch's amin / amax keep
    the NaN, its clamp keeps it, its cast makes it 0), the sideband NaN
    where the plain version's is and bitwise elsewhere; an fp16 host
    bitwise.  Vector (D 128) and scalar (D 5) paths."""
    rows = torch.linspace(-2, 3, 8 * d, device=cuda).reshape(8, d)
    rows[0, d // 2] = float("nan")
    rows[1, 1] = float("inf")
    rows[2, d - 1] = -float("inf")
    rows[3, 0], rows[3, 2] = float("inf"), -float("inf")
    rows[4] = float("inf")
    rows[5, 0], rows[5, 1] = float("nan"), float("inf")
    args = (rows, torch.zeros((1, d), dtype=torch.int8, device=cuda),
            torch.ones((1, 2), device=cuda), torch.arange(8, dtype=torch.int32, device=cuda))
    got = kernel.gather_decode_encode(*args, "int8", "int8")
    want = kernel.gather_decode_encode_plain(*args, "int8", "int8")
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    nan = want[1].isnan()
    assert bool(nan[0].all()) and torch.equal(got[1].isnan(), nan)
    assert torch.equal(_bits(got[1][~nan]), _bits(want[1][~nan]))
    for r in (6, 7):  # the finite rows as before
        assert torch.equal(_bits(got[1][r]), _bits(want[1][r])), r
    g16 = kernel.gather_decode_encode(*args, "int8", "fp16")[0]
    w16 = kernel.gather_decode_encode_plain(*args, "int8", "fp16")[0]
    assert torch.equal(g16.isnan(), w16.isnan())
    assert torch.equal(_bits(g16[~w16.isnan()]), _bits(w16[~w16.isnan()]))


def _one_device_op(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
def test_fused_calls_are_one_kernel_each(cuda):
    """gather_decode_encode, route_bucketize and route_image: one device op
    a call, no memset, no elementwise kernel."""
    rng = np.random.default_rng(4)
    args = [a.to(cuda) for a in _tiered_args(rng, "int8", 1000, 3000, 128, 25_000)]
    names = _one_device_op(lambda: kernel.gather_decode_encode(*args, "int8", "int8"))
    assert len(names) == 1 and "gather_decode_encode" in names[0], names
    table = torch.from_numpy(rng.integers(0, 4, 1 << 20).astype(np.int32)).to(cuda)
    uniq = torch.from_numpy(rng.integers(0, 1 << 20, 425_984).astype(np.int32)).to(cuda)
    for fn in (kernel.route_bucketize, kernel.route_image):
        names = _one_device_op(lambda: fn(uniq, table, table, 2048, 4))
        assert len(names) == 1 and "bucketize" in names[0], (fn.__name__, names)


@pytest.mark.cuda
def test_gather_decode_encode_kernel_rejects_bad_input(cuda):
    rng = np.random.default_rng(0)
    head, tail, side, slots = (a.to(cuda) for a in _tiered_args(rng, "int8", 4, 6, 8, 16))
    with pytest.raises(ValueError):
        kernel.gather_decode_encode(head, tail, side, slots, "int8", "fp32")  # no host codec
    with pytest.raises(ValueError):
        kernel.gather_decode_encode(head, tail, None, slots, "int8", "int8")
    with pytest.raises(ValueError):
        kernel.gather_decode_encode(head, tail, side, slots.long(), "int8", "int8")
    with pytest.raises(ValueError):
        kernel.gather_decode_encode(head, tail, side, slots.cpu(), "int8", "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("host", ["fp16", "int8"])
def test_writeback_into_encoded_host_fuses_the_encode(cuda, host):
    """A write-back from a tiered arena on the card into a pinned fp16 /
    int8 host tier: one gather_decode_encode launch a round and no other
    gather-decode launch, the host leaves bitwise the CPU move's."""
    rng = np.random.default_rng(11)
    vocab, cap, dim, k = 1000, 300, 16, 256
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32))
    arena = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    src = torch.from_numpy(rng.integers(-1, cap, size=k).astype(np.int32))
    dst = torch.from_numpy(rng.permutation(vocab)[:k].astype(np.int32))
    active = torch.from_numpy(rng.random(k) < 0.8)
    want_store = HostStore.create({"w": table.clone()}, host)
    got_store = HostStore.create({"w": table.clone()}, host, pin=True)
    try:
        transmitter.move_rows(ArenaStore.create({"w": arena.clone()}, 75, "int8"), want_store,
                              src, dst, active, buffer_rows=100)
        before = (kernel.gather_decode.launches, kernel.gather_decode.fused_launches)
        transmitter.move_rows(ArenaStore.create({"w": arena.to(cuda)}, 75, "int8"), got_store,
                              src.to(cuda), dst.to(cuda), active.to(cuda), buffer_rows=100)
        rounds = -(-int(active.sum()) // 100)
        assert (kernel.gather_decode.launches, kernel.gather_decode.fused_launches) == (
            before[0] + rounds, before[1] + rounds)
        for name, t in _store_leaves(want_store).items():
            assert torch.equal(_bits(_store_leaves(got_store)[name]), _bits(t)), name
    finally:
        got_store.close()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp16", "int8"])
@pytest.mark.parametrize("direction", ["load", "writeback"])
def test_pinned_move_rows_with_a_tiered_arena_matches_cpu_move(cuda, codec, direction):
    rng = np.random.default_rng(6)
    vocab, cap, dim, k = 1000, 300, 16, 256
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32))
    arena = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    n_src, n_dst = (vocab, cap) if direction == "load" else (cap, vocab)
    src = torch.from_numpy(rng.integers(-1, n_src, size=k).astype(np.int32))
    dst = torch.from_numpy(rng.permutation(n_dst)[:k].astype(np.int32))
    active = torch.from_numpy(rng.random(k) < 0.8)
    want_store = HostStore.create({"w": table.clone()})
    want_arena = ArenaStore.create({"w": arena.clone()}, 75, codec)
    got_store = HostStore.create({"w": table.clone()}, pin=True)
    got_arena = ArenaStore.create({"w": arena.to(cuda)}, 75, codec)
    lanes = (src.to(cuda), dst.to(cuda), active.to(cuda))
    try:
        if direction == "load":
            transmitter.move_rows(want_store, want_arena, src, dst, active, buffer_rows=7)
            transmitter.move_rows(got_store, got_arena, *lanes, buffer_rows=7)
            torch.cuda.synchronize()
            for part in ("head", "tail", "sideband"):
                for name, t in getattr(want_arena, part).items():
                    assert torch.equal(getattr(got_arena, part)[name].cpu(), t), part
        else:
            before = kernel.gather_decode.launches
            transmitter.move_rows(want_arena, want_store, src, dst, active, buffer_rows=7)
            transmitter.move_rows(got_arena, got_store, *lanes, buffer_rows=7)
            assert kernel.gather_decode.launches == before + -(-int(active.sum()) // 7)
            assert torch.equal(got_store["w"], want_store["w"])
    finally:
        got_store.close()


def _store_leaves(store):
    return {**{f"data.{k}": v for k, v in store.data.items()},
            **{f"sideband.{k}": v for k, v in store.sideband.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("arena_codec", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("host", ["fp16", "int8"])
@pytest.mark.parametrize("direction", ["load", "writeback"])
def test_pinned_encoded_host_store_moves_match_cpu_move(cuda, host, arena_codec, direction):
    """An encoded host tier pinned on the host, against the same move on
    the CPU, bitwise: a load stages payload and sideband, copies them
    encoded and decodes on the card (the tail of an arena of the host's
    codec takes them verbatim); a write-back encodes on the card and copies
    payload and sideband back."""
    rng = np.random.default_rng(7)
    vocab, cap, dim, k = 1000, 300, 16, 256
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32) * 2)
    arena = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    n_src, n_dst = (vocab, cap) if direction == "load" else (cap, vocab)
    src = torch.from_numpy(rng.integers(-1, n_src, size=k).astype(np.int32))
    dst = torch.from_numpy(rng.permutation(n_dst)[:k].astype(np.int32))
    active = torch.from_numpy(rng.random(k) < 0.8)

    def make_arena(w):
        return {"w": w} if arena_codec == "fp32" else ArenaStore.create({"w": w}, 75, arena_codec)

    want_store = HostStore.create({"w": table.clone()}, host)
    got_store = HostStore.create({"w": table.clone()}, host, pin=True)
    want_arena, got_arena = make_arena(arena.clone()), make_arena(arena.to(cuda))
    lanes = (src.to(cuda), dst.to(cuda), active.to(cuda))
    try:
        assert got_store.pinned and set(got_store.sideband) == set(want_store.sideband)
        if direction == "load":
            transmitter.move_rows(want_store, want_arena, src, dst, active, buffer_rows=7)
            transmitter.move_rows(got_store, got_arena, *lanes, buffer_rows=7)
            torch.cuda.synchronize()
            if arena_codec == "fp32":
                assert torch.equal(got_arena["w"].cpu(), want_arena["w"])
            else:
                for part in ("head", "tail", "sideband"):
                    for name, t in getattr(want_arena, part).items():
                        assert torch.equal(getattr(got_arena, part)[name].cpu(), t), part
                if arena_codec == host:  # the verbatim host -> tail path
                    ok = (active & (dst >= 75) & (src >= 0)).numpy()
                    got_tail = got_arena.tail["w"].cpu()[dst.numpy()[ok] - 75]
                    assert torch.equal(got_tail, got_store.data["w"][src.numpy()[ok]])
        else:
            transmitter.move_rows(want_arena, want_store, src, dst, active, buffer_rows=7)
            transmitter.move_rows(got_arena, got_store, *lanes, buffer_rows=7)
            for name, t in _store_leaves(want_store).items():
                assert torch.equal(_store_leaves(got_store)[name], t), name
    finally:
        got_store.close()
    assert not got_store.pinned


@pytest.mark.cuda
@pytest.mark.parametrize("arena_codec", ["fp16", "int8"])
@pytest.mark.parametrize("host", ["fp16", "int8"])
def test_pinned_chunked_load_into_tiered_arena_matches_cpu(cuda, host, arena_codec):
    """A chunked load of an encoded, pinned host tier into a tiered arena
    on the card: the staged chunks are decoded on the card and the tail
    re-encodes them (no verbatim host bits under a chunked source, as in
    the reference); head, tail payload and sideband bitwise the CPU port's
    chunked move on the same inputs."""
    rng = np.random.default_rng(21)
    vocab, cap, head, dim, k = 1024, 300, 75, 16, 256
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32) * 3)
    arena = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    src = torch.from_numpy(rng.integers(-1, vocab, size=k).astype(np.int32))
    dst = torch.from_numpy(rng.permutation(cap)[:k].astype(np.int32))
    active = torch.from_numpy(rng.random(k) < 0.8)
    want_store = HostStore.create({"w": table.clone()}, host)
    got_store = HostStore.create({"w": table.clone()}, host, pin=True)
    want_arena = ArenaStore.create({"w": arena.clone()}, head, arena_codec)
    got_arena = ArenaStore.create({"w": arena.to(cuda)}, head, arena_codec)
    before = transmitter.moves["chunked"]
    try:
        transmitter.move_rows(want_store, want_arena, src, dst, active, buffer_rows=100,
                              src_chunk_rows=64)
        transmitter.move_rows(got_store, got_arena, src.to(cuda), dst.to(cuda),
                              active.to(cuda), buffer_rows=100, src_chunk_rows=64)
        torch.cuda.synchronize()
        for part in ("head", "tail", "sideband"):
            for name, t in getattr(want_arena, part).items():
                assert torch.equal(getattr(got_arena, part)[name].cpu(), t), part
        assert transmitter.moves["chunked"] == before + 2
    finally:
        got_store.close()


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d", [(64, 39, 10), (1000, 26, 16), (128, 8, 128), (1, 4, 4),
                                   (4097, 40, 10), (33, 3, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_fm_kernel_matches_plain(cuda, b, f, d, dtype, strided):
    """rtol 1e-3, atol 1e-5 * (max|ref| + 1): the reference's sweep tolerance
    (the kernel and torch sum over F and D in different orders); bf16 adds
    2^-7 to rtol: one rounding of the output, which may fall either way, is
    at most 2^-7 of the value."""
    g = torch.Generator(device=cuda).manual_seed(b + f)
    v = torch.randn((b, f, d + strided), generator=g, device=cuda).to(dtype)
    v = v[..., :d]
    before = fm_kernel.fm_interaction.launches
    got = fm_kernel.fm_interaction(v)
    assert fm_kernel.fm_interaction.launches == before + 1
    want = fm_kernel.fm_interaction_plain(v)
    assert got.dtype == dtype and got.shape == (b,)
    scale = float(want.float().abs().max()) + 1.0
    rtol = 1e-3 if dtype == torch.float32 else 1e-3 + 2**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5 * scale)


@pytest.mark.cuda
def test_fm_kernel_rejects_bad_input(cuda):
    v = torch.ones((4, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        fm_kernel.fm_interaction(v.double())
    with pytest.raises(ValueError):
        fm_kernel.fm_interaction(v.transpose(1, 2))  # d not unit-stride
    with pytest.raises(ValueError):
        fm_kernel.fm_interaction(v[0])
    with pytest.raises(RuntimeError, match="no backward"):
        fm_kernel.fm_interaction(v.requires_grad_())


def _bags(rng, v, n, s, mb_hi):
    seg = np.sort(rng.integers(0, s, n)).astype(np.int32)
    ids = rng.integers(-1, v + (v // 10), n).astype(np.int32)  # some ids >= V
    return torch.from_numpy(ids), torch.from_numpy(seg), int(rng.integers(0, mb_hi))


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,n,s", [(64, 512, 40, 10), (128, 1024, 100, 7), (32, 256, 16, 16),
                                     (1000, 6, 3000, 500), (5000, 128, 16384, 4096),
                                     (300, 37, 200, 90)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_kernel_matches_plain(cuda, v, d, n, s, dtype, combiner):
    """Bitwise: both sum each bag in order in the table's dtype."""
    rng = np.random.default_rng(v + n)
    ids, seg, mb = _bags(rng, v, n, s, 6)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(cuda, dtype)
    args = (table, ids.to(cuda), seg.to(cuda), s, combiner, mb)
    before = eb_kernel.embedding_bag_multi.launches
    got = eb_kernel.embedding_bag(*args)
    assert eb_kernel.embedding_bag_multi.launches == before + 1
    want = eb_kernel.embedding_bag_plain(*args)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(want.cpu(), eb_kernel.embedding_bag_plain(
        table.cpu(), ids, seg, s, combiner, mb))
    # a row-strided view of a wider table
    wide = torch.cat([table, table[:, :3]], dim=1)[:, :d]
    assert torch.equal(eb_kernel.embedding_bag(wide, *args[1:]), want)


@pytest.mark.cuda
def test_embedding_bag_op_grad_on_the_card(cuda):
    rng = np.random.default_rng(2)
    ids, seg, _ = _bags(rng, 200, 900, 64, 2)
    table = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    for combiner in ("sum", "mean"):
        grads = []
        for dev in ("cpu", cuda):
            w = table.to(dev).requires_grad_()
            out = eb_ops.embedding_bag(w, ids.to(dev), seg.to(dev), 64, combiner, max_bag=5)
            (gw,) = torch.autograd.grad(torch.sum(out * g.to(dev)), [w])
            grads.append(gw.cpu())
        torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)


def _multi_bags(rng, v, s, spec):
    """F features of unequal lane counts (lanes, low, high): sorted segment
    ids in [low, high), so low < 0 and high > s give lanes in no bag; some
    ids >= V."""
    segs = [np.sort(rng.integers(lo, hi, n)).astype(np.int32) for n, lo, hi in spec]
    ids = [rng.integers(-1, v + v // 10, len(x)).astype(np.int32) for x in segs]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in segs])]).astype(int).tolist()
    return (torch.from_numpy(np.concatenate(ids)), torch.from_numpy(np.concatenate(segs)),
            offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("max_bag", [0, 3])
def test_embedding_bag_multi_kernel_matches_plain(cuda, d, dtype, combiner, max_bag):
    """One launch for F features (unequal lane counts, an empty feature,
    lanes at -1 and at S), bitwise the per-feature plain version."""
    rng = np.random.default_rng(d + max_bag)
    s, v = 300, 5000
    ids, seg, offsets = _multi_bags(rng, v, s, [(4000, -2, s + 2), (0, 0, 1), (1500, 0, s),
                                                (17, 5, 6), (16384, -1, s + 1)])
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(cuda, dtype)
    args = (table, ids.to(cuda), seg.to(cuda), offsets, s, combiner, max_bag)
    before = eb_kernel.embedding_bag_multi.launches
    got = eb_kernel.embedding_bag_multi(*args)
    assert eb_kernel.embedding_bag_multi.launches == before + 1
    want = eb_kernel.embedding_bag_multi_plain(*args)
    assert got.dtype == dtype and got.shape == (5, s, d) and torch.equal(got, want)
    assert torch.equal(want.cpu(), eb_kernel.embedding_bag_multi_plain(
        table.cpu(), ids, seg, offsets, s, combiner, max_bag))


@pytest.mark.cuda
def test_embedding_bag_multi_kernel_splits_many_features(cuda):
    """More features than one launch's parameters hold (256): two launches,
    still bitwise the plain version."""
    rng = np.random.default_rng(9)
    ids, seg, offsets = _multi_bags(rng, 100, 6, [(int(n), -1, 7) for n in
                                                  rng.integers(0, 12, 300)])
    table = torch.from_numpy(rng.normal(size=(100, 8)).astype(np.float32)).to(cuda)
    args = (table, ids.to(cuda), seg.to(cuda), offsets, 6, "mean", 4)
    before = eb_kernel.embedding_bag_multi.launches
    got = eb_kernel.embedding_bag_multi(*args)
    assert eb_kernel.embedding_bag_multi.launches == before + 2
    assert torch.equal(got, eb_kernel.embedding_bag_multi_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_multi_op_grad_on_the_card(cuda, combiner):
    """The one backward over all lanes against the per-feature op's
    backward, relative to the summed magnitudes (both sum with atomics)."""
    rng = np.random.default_rng(4)
    s = 64
    ids, seg, offsets = _multi_bags(rng, 200, s, [(900, -1, s + 1), (300, 0, s), (0, 0, 1)])
    ids, seg = ids.to(cuda), seg.to(cuda)
    table = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(3, s, 16)).astype(np.float32)).to(cuda)

    def grads(cot, fused):
        w = table.clone().requires_grad_()
        if fused:
            out = eb_ops.embedding_bag_multi(w, ids, seg, offsets, s, combiner, max_bag=5)
        else:
            out = torch.stack([eb_ops.embedding_bag(w, ids[lo:hi], seg[lo:hi], s, combiner,
                                                    max_bag=5)
                               for lo, hi in zip(offsets[:-1], offsets[1:])])
        return torch.autograd.grad(torch.sum(out * cot), [w])[0]

    magnitude = grads(g.abs(), False)
    err = ((grads(g, True) - grads(g, False)).abs() / (magnitude + 1)).max()
    assert float(err) <= 1e-5


@pytest.mark.cuda
def test_embedding_bag_kernel_rejects_bad_input(cuda):
    """Sorted segment ids are the caller's contract, as in the reference:
    checking them would sync the host."""
    table = torch.ones((10, 8), device=cuda)
    ids = torch.zeros(6, dtype=torch.int32, device=cuda)
    seg = torch.zeros(6, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        eb_kernel.embedding_bag(table.double(), ids, seg, 2)
    with pytest.raises(ValueError):
        eb_kernel.embedding_bag(table, ids.long(), seg, 2)
    with pytest.raises(ValueError):
        eb_kernel.embedding_bag(table, ids, seg[:5], 2)
    with pytest.raises(ValueError):
        eb_kernel.embedding_bag(table.t(), ids, seg, 2)  # columns not unit-stride
    with pytest.raises(ValueError):
        eb_kernel.embedding_bag(table, ids.cpu(), seg, 2)  # mixed devices
    with pytest.raises(ValueError):
        eb_kernel.embedding_bag(table, ids, seg, 2, combiner="max")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_bucketize_kernel_matches_plain(cuda, s):
    rng = np.random.default_rng(s)
    for u in (0, 1, 3, 4, 4097, 425_984):
        owner = torch.from_numpy(rng.integers(-2, s + 2, size=u).astype(np.int32)).to(cuda)
        local = torch.from_numpy(rng.integers(-1, 1 << 20, size=u).astype(np.int32)).to(cuda)
        before = kernel.bucketize.launches
        got = kernel.bucketize(owner, local, s)
        assert kernel.bucketize.launches == before + (1 if u else 0)
        assert torch.equal(got, kernel.bucketize_plain(owner, local, s)), (s, u)
    pad = torch.full((4097,), -1, dtype=torch.int32, device=cuda)
    assert bool((kernel.bucketize(pad, pad, s) == -1).all())  # every lane padding
    rep = torch.zeros((4097,), dtype=torch.int32, device=cuda)
    assert bool((kernel.bucketize(rep, pad, s) == -1).all())  # every lane replicated


@pytest.mark.cuda
def test_bucketize_kernel_rejects_bad_input(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernel.bucketize(x.to(torch.int64), x, 2)
    with pytest.raises(ValueError):
        kernel.bucketize(x[1:], x[1:], 2)  # not 16 B aligned
    with pytest.raises(ValueError):
        kernel.bucketize(x, x, 0)
    with pytest.raises(ValueError):
        kernel.bucketize(x, x.cpu(), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_route_bucketize_kernel_matches_plain(cuda, s):
    """The route + bucketize kernel's owner, local and image, and its
    image-only entry (``route_image``, the sharded plan's call), bitwise
    the plain version: rep_k 0 and 2048, U % 4 != 0, uniq off its 16 B
    boundary, negative, padding and past-the-table ranks, every lane
    padding, every lane replicated; one launch a call on both counters."""
    from repro_torch.kernels.cache_ops.ops import PAD_RANK

    rng = np.random.default_rng(20 + s)
    n = 1 << 16
    r_owner = torch.from_numpy(rng.integers(0, s, n).astype(np.int32)).to(cuda)
    r_local = torch.from_numpy(rng.integers(-1, n // s, n).astype(np.int32)).to(cuda)
    for rep_k in (0, 2048):
        for u in (0, 1, 3, 4, 4097, 425_984):
            ranks = rng.integers(-2, n + 2, size=u).astype(np.int32)
            ranks[rng.random(u) < 0.05] = PAD_RANK
            for offset in (0, 1):
                uniq = torch.empty(u + offset, dtype=torch.int32, device=cuda)[offset:]
                uniq.copy_(torch.from_numpy(ranks))
                before = (kernel.bucketize.launches, kernel.bucketize.fused_launches)
                got = kernel.route_bucketize(uniq, r_owner, r_local, rep_k, s)
                assert (kernel.bucketize.launches, kernel.bucketize.fused_launches) == (
                    before[0] + (1 if u else 0), before[1] + (1 if u else 0))
                want = kernel.route_bucketize_plain(uniq, r_owner, r_local, rep_k, s)
                for g, w, part in zip(got, want, ("owner", "local", "image")):
                    assert torch.equal(g, w), (rep_k, u, offset, part)
                image = kernel.route_image(uniq, r_owner, r_local, rep_k, s)
                assert (kernel.bucketize.launches, kernel.bucketize.fused_launches) == (
                    before[0] + (2 if u else 0), before[1] + (2 if u else 0))
                assert torch.equal(image, want[2]), (rep_k, u, offset, "image alone")
    for lanes in (torch.full((4097,), PAD_RANK), torch.arange(4097) % 2048):
        lanes = lanes.to(torch.int32).to(cuda)
        got = kernel.route_bucketize(lanes, r_owner, r_local, 2048, s)
        got += (kernel.route_image(lanes, r_owner, r_local, 2048, s),)
        assert all(bool((g == -1).all()) for g in got)


@pytest.mark.cuda
def test_route_bucketize_kernel_rejects_bad_input(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernel.route_bucketize(x.to(torch.int64), x, x, 0, 2)
    with pytest.raises(ValueError):
        kernel.route_bucketize(x, x, x[:4], 0, 2)  # the tables differ in length
    with pytest.raises(ValueError):
        kernel.route_bucketize(x, x, x, 0, 0)
    with pytest.raises(ValueError):
        kernel.route_bucketize(x, x.cpu(), x, 0, 2)
    with pytest.raises(ValueError):
        kernel.route_image(x, x, x[:4], 0, 2)
    with pytest.raises(ValueError):
        kernel.route_image(x, x, x, 0, 0)


@pytest.mark.cuda
def test_four_shard_lookup_matches_dense_reference(cuda):
    from repro_torch.core.collection import FeatureBatch, TableConfig
    from repro_torch.core.sharded import ShardedEmbeddingCollection

    tables = [TableConfig("big", vocab=512, dim=8, ids_per_step=16),
              TableConfig("small", vocab=96, dim=8, ids_per_step=16)]
    coll = ShardedEmbeddingCollection.create(tables, num_shards=4, cache_ratio=0.2,
                                             replicate_top_k=8, use_pallas_plan=True)
    rng = np.random.default_rng(1)
    state = coll.init(0, counts={t.name: rng.integers(0, 50, t.vocab) for t in tables},
                      device=cuda)
    before = kernel.bucketize.launches
    for i in range(6):
        fb = FeatureBatch(ids={t.name: torch.from_numpy(
            rng.integers(-1, t.vocab, 16).astype(np.int32)).to(cuda) for t in tables})
        state, _, rows = coll.lookup(state, fb)
        ref = coll.dense_reference(coll.flush(state), fb)
        for f in fb.features:
            assert torch.equal(rows[f], ref[f].to(cuda)), (i, f)
    assert kernel.bucketize.launches == before + 6
    state.slabs["__shared__"].full.close()


FLASH_CASES = [
    (2, 4, 2, 512, 64, True, None),  # test_kernels.py's sweep
    (1, 4, 4, 512, 64, True, 128),
    (2, 8, 2, 256, 32, False, None),
    (1, 2, 1, 1024, 128, True, 256),
    (2, 6, 3, 256, 16, True, None),  # head dims of the SMOKE configs
    (2, 6, 2, 256, 20, True, 64),
    (1, 15, 5, 512, 64, True, None),  # SmolLM-360M's heads
    (2, 4, 2, 96, 64, True, None),  # a ragged last tile
    (1, 4, 2, 512, 64, True, 4096),  # a window wider than the sequence
    (1, 2, 1, 256, 256, False, 100),  # the widest head, a window without causality
    (8, 15, 5, 4096, 64, True, None),  # SmolLM-360M's live prefill layer
    (1, 32, 16, 2048, 128, True, 1024),  # Gemma-3-27B's heads and local window
]


def _bf16_ulp(x):
    """The spacing of bf16 values at each element of ``x`` (0 where x is 0)."""
    m, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, s, d, causal, window, dtype):
    """The card smoke's bound: 2e-5 (1 + |o|) per element, plus one bf16
    ulp of o in bf16 (each output is one rounding of an fp32 result)."""
    g = torch.Generator(device=cuda).manual_seed(s + hq)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype)
               for h in (hq, hkv, hkv))
    before = fa_kernel.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal, window)
    assert fa_kernel.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    want = fa_kernel.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), causal, window).transpose(1, 2)
    bound = 2e-5 * (1 + want.float().abs())
    if dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(want)
    over = (got.float() - want.float()).abs() - bound
    assert bool(torch.isfinite(got).all())
    assert float(over.max()) <= 0, f"{int((over > 0).sum())} elements over, worst {over.max()}"


@pytest.mark.cuda
def test_flash_kernel_grad_matches_plain_autograd(cuda):
    """Forward by the kernel, backward by recompute through the plain
    version: q, k and v gradients equal the plain version's own autograd
    within 1e-4 (fp32)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    leaves = [torch.randn((1, 256, h, 32), generator=g, device=cuda) for h in (4, 2, 2)]
    want = [t.clone().requires_grad_() for t in leaves]
    got = [t.clone().requires_grad_() for t in leaves]
    cot = torch.randn((1, 256, 4, 32), generator=g, device=cuda)
    before = fa_kernel.flash_attention.launches
    (fa_ops.flash_attention(*got) * cot).sum().backward()
    assert fa_kernel.flash_attention.launches == before + 1
    q, k, v = (t.transpose(1, 2) for t in want)
    (fa_kernel.flash_attention_plain(q, k, v).transpose(1, 2) * cot).sum().backward()
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,route", [(torch.bfloat16, 64, "wgmma"),
                                           (torch.float32, 64, "tf32x3"),
                                           (torch.float32, 128, "tf32x3"),
                                           (torch.float32, 256, "simt")])
def test_flash_kernel_route_by_dtype(cuda, dtype, d, route):
    """bf16 launches the bf16 tensor-core kernel; fp32 the 3xTF32
    tensor-core kernel up to d 128 and the SIMT kernel past it."""
    q = torch.randn((1, 2, 128, d), device=cuda).to(dtype)
    kv = torch.randn((1, 1, 128, d), device=cuda).to(dtype)
    before = dict(fa_kernel.flash_attention.route_launches)
    fa_kernel.flash_attention(q, kv, kv)
    after = fa_kernel.flash_attention.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 256])
def test_flash_fp32_kernels_read_a_strided_head_dim(cuda, d):
    """The fp32 kernels (3xTF32 at d 64 and 100, SIMT at 256) read q, k and
    v with a head-dim stride other than 1 in place, within the card
    smoke's bound of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((1, h, 256, d), generator=g, device=cuda).transpose(2, 3)
               .contiguous().transpose(2, 3) for h in (4, 2, 2))  # d-stride 256
    assert q.stride(3) == 256
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v, True, 100)
    assert fa_kernel.flash_attention.launches == before + 1
    want = fa_kernel.flash_attention_plain(q, k, v, True, 100)
    over = (got - want).abs() - 2e-5 * (1 + want.abs())
    assert float(over.max()) <= 0, f"{int((over > 0).sum())} elements over, worst {over.max()}"


@pytest.mark.cuda
def test_flash_bf16_kernel_rejects_a_strided_head_dim(cuda):
    """The tensor-core kernel copies rows with head-dim stride 1; another
    stride raises rather than being copied."""
    q = torch.randn((1, 2, 64, 16), device=cuda).to(torch.bfloat16)
    kv = torch.randn((1, 1, 64, 16), device=cuda).to(torch.bfloat16)
    strided = kv.transpose(2, 3).contiguous().transpose(2, 3)  # d-stride 64
    before = fa_kernel.flash_attention.launches
    with pytest.raises(ValueError, match="stride"):
        fa_kernel.flash_attention(q, strided, kv)
    with pytest.raises(ValueError, match="stride"):
        fa_kernel.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), kv, kv)
    assert fa_kernel.flash_attention.launches == before


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_input(cuda):
    q = torch.ones((1, 2, 64, 8), device=cuda)
    kv = torch.ones((1, 1, 64, 8), device=cuda)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q, kv.cpu(), kv.cpu())
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(torch.ones((1, 2, 300, 8), device=cuda), kv, kv)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(torch.ones((1, 2, 64, 264), device=cuda),
                                  torch.ones((1, 1, 64, 264), device=cuda),
                                  torch.ones((1, 1, 64, 264), device=cuda))


def _tree_equal(want, got, path=""):
    """Two ``convert.to_numpy`` trees, leaf by leaf, bitwise."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _tree_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and np.array_equal(want, got), path
    else:
        assert want == got, path


def _refresh_states(coll, cuda, steps=12):
    """A dirty CPU state (lookups, then an SGD step on the arena) and its
    copies on the CPU and on the card (host tier pinned)."""
    from repro_torch import convert
    from repro_torch.core.collection import FeatureBatch

    rng = np.random.default_rng(0)
    counts = {t.name: rng.integers(0, 50, t.vocab) for t in coll.tables.values()}
    state = coll.init(0, counts=counts, device="cpu")
    for i in range(steps):
        ids = {t.name: torch.from_numpy(rng.integers(-1, t.vocab, 16).astype(np.int32))
               for t in coll.tables.values()}
        state, _, _ = coll.lookup(state, FeatureBatch(ids=ids))
    grads = {k: torch.ones_like(v) for k, v in coll.weights(state).items()}
    tree = convert.to_numpy(coll.apply_grads(state, grads, 0.1))
    return (convert.collection_state_from_numpy(tree, device="cpu", collection=coll),
            convert.collection_state_from_numpy(tree, device=cuda, collection=coll))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [0, 4])
def test_refresh_on_the_card_matches_cpu(cuda, shards):
    """A refresh of a dirty state with an int8 host tier and an int8-tiered
    arena (the write-back gathers through the gather-decode kernel), and
    sharded a budgeted exchange with a replicated head then a re-homing:
    the report and every state leaf bitwise the CPU's."""
    from repro_torch import convert
    from repro_torch.core.collection import EmbeddingCollection, TableConfig
    from repro_torch.core.refresh import RefreshConfig
    from repro_torch.core.sharded import ShardedEmbeddingCollection

    tables = [TableConfig("big", vocab=4096, dim=16, ids_per_step=16, cache_ratio=0.1),
              TableConfig("small", vocab=96, dim=16, ids_per_step=16, cache_ratio=0.3)]
    kw = dict(cache_ratio=0.1, host_precision="int8", arena_precision="int8")
    if shards:
        coll = ShardedEmbeddingCollection.create(tables, num_shards=shards, replicate_top_k=8,
                                                 **kw)
        cfgs = [RefreshConfig(max_swaps=64, exchange_budget=16),
                RefreshConfig(max_swaps=0, rebalance_threshold=1.0)]
    else:
        coll = EmbeddingCollection.create(tables, **kw)
        cfgs = [RefreshConfig(max_swaps=64)]
    cpu, card = _refresh_states(coll, cuda)
    before = kernel.gather_decode.launches
    for cfg in cfgs:
        cpu, want = coll.refresh(cpu, cfg)
        card, got = coll.refresh(card, cfg)
        assert got == want and want.total_swaps + sum(want.rebalance_moves.values()) > 0
    assert kernel.gather_decode.launches > before
    _tree_equal(convert.to_numpy(cpu), convert.to_numpy(card))
    for slab in card.slabs.values():
        assert slab.full.pinned
        slab.full.close()


@pytest.mark.cuda
def test_tracker_decay_on_the_card_matches_cpu(cuda):
    """The tracker's decay (Cephes exp with float64-emulated fused
    multiply-adds) gives the CPU's float32 bits on the card."""
    from repro_torch.core import freq

    dt = torch.arange(0, 300_000, dtype=torch.int32)
    score = torch.from_numpy(np.random.default_rng(1).gamma(1.5, 20.0, dt.numel())
                             .astype(np.float32))
    for half_life in (1024, 18, 5, 7):
        want = freq.decay_bump(score, dt, half_life)
        got = freq.decay_bump(score.to(cuda), dt.to(cuda), half_life).cpu()
        assert torch.equal(got, want), half_life
        assert torch.equal(freq.decay_factor(dt.to(cuda), half_life).cpu(),
                           freq.decay_factor(dt, half_life)), half_life


def _close_tree(want, got, path, skip=()):
    """Two ``convert.to_numpy`` trees: float leaves named in ``skip`` within
    rtol 1e-5 / atol 1e-6, every other leaf bitwise."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _close_tree(want[k], got[k], f"{path}/{k}", skip)
    elif path.rsplit("/", 1)[-1] in skip:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=path)
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and np.array_equal(want, got), path
    else:
        assert want == got, path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["din", "dien", "mind"])
def test_recsys_family_on_the_card_matches_cpu(cuda, arch):
    """DIN, DIEN and MIND at their smoke shapes (``use_pallas_plan``), one
    state on the CPU and its copy on the card: one serve step (logits
    within rtol 1e-5 / atol 1e-6) and one train step (loss within rtol
    1e-5), one threshold launch a plan on the card; the cache's index
    state and counters bitwise the CPU's, arena rows within rtol 1e-5 /
    atol 1e-6."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import dien, din, mind
    from repro_torch.data import synth
    from repro_torch.models.recsys_models import DIENModel, DINModel, MINDModel

    cls, smoke = {"din": (DINModel, din.SMOKE), "dien": (DIENModel, dien.SMOKE),
                  "mind": (MINDModel, mind.SMOKE)}[arch]
    cfg = dataclasses.replace(smoke, use_pallas_plan=True)
    model = cls(cfg)
    tree = convert.to_numpy(model.init(0, device="cpu"))
    states = {d: convert.state_from_numpy(tree, device=d, collection=model.collection)
              for d in ("cpu", cuda)}
    out = {}
    for d, state in states.items():
        before = kernel.victim_threshold.launches
        batches = [{k: torch.from_numpy(v).to(d) for k, v in synth.recsys_batch(
            cfg.n_items, cfg.n_users, cfg.seq_len, cfg.batch_size, 0, s,
            n_cates=None if arch == "mind" else cfg.n_cates).items()} for s in range(2)]
        logits, emb = model.serve_step(state, batches[0])
        state, metrics = model.train_step(dict(state, emb=emb), batches[1])
        launches = kernel.victim_threshold.launches - before
        out[d] = (logits.cpu(), float(metrics["loss"]), convert.to_numpy(state), launches)
        for slab in state["emb"].slabs.values():
            slab.full.close()
    (w_logits, w_loss, w_state, _), (g_logits, g_loss, g_state, launches) = out.values()
    assert launches == 2
    torch.testing.assert_close(g_logits, w_logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5)
    _close_tree(w_state["emb"], g_state["emb"], "emb", skip=("weight",))
    _close_tree(w_state["params"], g_state["params"], "params", skip=("w", "b", "wx", "wh",
                                                                      "s_matrix"))


def _lm_tree_close(want, got, rtol, atol, path=""):
    if isinstance(want, dict):
        for k in want:
            _lm_tree_close(want[k], got[k], rtol, atol, f"{path}/{k}")
        return
    assert want.dtype == got.dtype and want.shape == got.shape, path
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=atol, msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,compressor", [("smollm", "none"), ("olmoe", "int8"),
                                             ("grok", "bf16")])
def test_lm_train_step_on_the_card_matches_cpu(cuda, arch, compressor):
    """One ``LMModel.train_step`` of a SMOKE config with ``use_pallas`` (the
    flash kernel in the forward and in the remat recompute: 2 launches a
    group layer) from one state on the CPU and its copy on the card, TF32
    off: loss and gradient norm within rtol 1e-5, the new state within the
    CPU parity test's tolerances (``tests/test_torch_lm_train.py``)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import grok_1_314b, olmoe_1b_7b, smollm_360m
    from repro_torch.data import synth
    from repro_torch.models.lm import LMModel

    smoke = {"smollm": smollm_360m, "olmoe": olmoe_1b_7b, "grok": grok_1_314b}[arch].SMOKE
    cfg = dataclasses.replace(smoke, use_pallas=True)
    model = LMModel(cfg, lr=1e-3, compressor=compressor)
    tree = convert.to_numpy(model.init(0, device="cpu"))
    batch = synth.seq_batch(cfg.vocab, 2, 32, 0, 0)
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d in ("cpu", cuda):
            state = convert.lm_state_from_numpy(tree, d)
            before = fa_kernel.flash_attention.launches
            state, m = model.train_step(state, {k: torch.from_numpy(v).to(d)
                                                for k, v in batch.items()})
            out[d] = (float(m["loss"]), float(m["grad_norm"]), state,
                      fa_kernel.flash_attention.launches - before)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (w_loss, w_norm, w_state, _), (g_loss, g_norm, g_state, launches) = out.values()
    assert launches == 2 * cfg.n_layers
    np.testing.assert_allclose([g_loss, g_norm], [w_loss, w_norm], rtol=1e-5)
    _lm_tree_close(w_state["params"], g_state["params"], 1e-5, 2e-4, "params")
    for k, atol in (("m", 1e-4), ("v", 1e-7)):
        _lm_tree_close(w_state["opt"][k], g_state["opt"][k], 1e-4, atol, k)


@pytest.mark.cuda
@pytest.mark.parametrize("s_cache", [40, 4096])
def test_int8_decode_attention_on_the_card_is_exact(cuda, s_cache):
    """The int8 KV-cache attention on the card: the query's codes and the
    score dots (``raw``) bitwise the CPU's, the value dots (``acc``)
    bitwise the exact integer dot of the card's own codes (fp32 chunks of
    1024 positions), TF32 on or off; the output within rtol 1e-4 / atol
    1e-4 * max|o| of the CPU's plus the effect of any weight code that
    rounds the other way."""
    from repro_torch.nn import transformer as T

    rng = np.random.default_rng(s_cache)
    b, hkv, g, hd = 2, 5, 3, 64
    args = [rng.normal(size=(b, 1, hkv * g, hd)).astype(np.float32)]
    args += [rng.integers(-127, 128, size=(b, s_cache, hkv, hd)).astype(np.int8)
             for _ in range(2)]
    args += [rng.uniform(0.01, 0.05, size=(b, s_cache, hkv)).astype(np.float32)
             for _ in range(2)]
    cpu = T._attention_i8_parts(*(torch.from_numpy(a) for a in args), torch.tensor(s_cache - 3))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for allow in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            card = T._attention_i8_parts(*(torch.from_numpy(a).to(cuda) for a in args),
                                         torch.tensor(s_cache - 3, device=cuda))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        assert torch.equal(card["q8"].cpu(), cpu["q8"]) and torch.equal(card["raw"].cpu(),
                                                                        cpu["raw"])
        w8, vc = card["w8"].cpu().to(torch.int64), torch.from_numpy(args[2]).to(torch.int64)
        assert torch.equal(card["acc"].cpu().to(torch.int64),
                           torch.einsum("bhgs,bshd->bhgd", w8, vc))
        flips = (card["w8"].cpu().to(torch.int64) - cpu["w8"].to(torch.int64)).abs()
        assert int(flips.max()) <= 1
        bound = (card["wmax"].cpu() / 127.0) * torch.einsum("bhgs,bshd->bhgd", flips.float(),
                                                           vc.abs().float())
        diff = (card["out"].cpu() - cpu["out"]).abs().reshape(bound.shape)
        o = cpu["out"].abs().max()
        assert bool((diff <= 1e-4 * o + 1e-4 * cpu["out"].abs().reshape(bound.shape)
                     + bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["global", "shard_map"])
def test_moe_on_the_card_matches_cpu(cuda, impl):
    """``moe_apply`` (2 dispatch groups) and ``moe_apply_shard_map`` at
    olmoe SMOKE's widths with drops (capacity factor 0.5), TF32 off:
    output and aux within rtol / atol 1e-5 of the CPU's."""
    from repro_torch.nn import moe as M
    from repro_torch.nn.layers import Dtypes

    dt = Dtypes(param=torch.float32, compute=torch.float32)
    p = M.moe_init(torch.Generator().manual_seed(0), 64, 32, 8, dt, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 32, 64)).astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for d in ("cpu", cuda):
            pd = {k: v.to(d) for k, v in p.items()}
            if impl == "global":
                out.append(M.moe_apply(pd, x.to(d), dt, top_k=4, capacity_factor=0.5,
                                       dp_groups=2))
            else:
                out.append(M.moe_apply_shard_map(pd, x.to(d), dt, top_k=4, capacity_factor=0.5))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (w_out, w_aux), (g_out, g_aux) = out
    torch.testing.assert_close(g_out.cpu(), w_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_aux.cpu(), w_aux, rtol=1e-5, atol=1e-5)


def _gnn_leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_gnn_leaves(v, f"{path}/{k}"))
        return out
    return {path: tree.detach().cpu()}


@pytest.mark.cuda
def test_gatedgcn_train_step_on_the_card_matches_cpu(cuda, monkeypatch):
    """One SMOKE GatedGCN ``train_step`` on a full graph from one state on
    the CPU and its copy on the card, TF32 off: the loss within rtol 1e-5,
    the new state within ``tests/test_torch_gnn.py``'s tolerances (an
    element whose first-step gradient is nonzero but below 1e-5 of its
    layer's max held to 2.01 lr, as Adam's first step is ``lr * sign(g)``;
    the batch is checked to hold no ReLU input within 1e-6 of 0); then two
    runs of 2 steps on the card under deterministic algorithms, bitwise
    equal (``index_add_`` sums in no fixed order outside that mode)."""
    import torch.utils.deterministic as det

    from repro_torch.configs.gatedgcn import SMOKE
    from repro_torch.data import graphs
    from repro_torch.models.gatedgcn import GatedGCNModel
    from repro_torch.nn import gnn as G
    from repro_torch.optim.optimizers import tree_map

    gaps = []
    impl = G.layernorm

    def recorded(*args, **kw):
        y = impl(*args, **kw)
        gaps.append(float(y.detach().abs().min()))
        return y

    monkeypatch.setattr(G, "layernorm", recorded)
    model = GatedGCNModel(SMOKE)
    cpu_state = model.init(0, device="cpu")
    nbs = [graphs.full_graph_batch(64, 256, 12, 5, s) for s in range(2)]
    batches = {d: [{k: torch.from_numpy(v).to(d) for k, v in b.items()} for b in nbs]
               for d in ("cpu", cuda)}
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d in ("cpu", cuda):
            state, m = model.train_step(tree_map(lambda x: x.to(d), cpu_state), batches[d][0])
            out[d] = (float(m["loss"]), state)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert min(gaps) > 1e-6, f"seeded input has a ReLU near tie (|x| {min(gaps)})"
    (w_loss, w_state), (g_loss, g_state) = out.values()
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5)
    want, got = (_gnn_leaves(s["params"]) for s in (w_state, g_state))
    for path, m in _gnn_leaves(w_state["opt"]["m"]).items():
        g = m.double().abs() / 0.1
        top = g.flatten(1).amax(1).view(-1, *[1] * (g.dim() - 1)) if \
            path.startswith("/layers/") else g.max()
        near = (g != 0) & (g < 1e-5 * top)
        torch.testing.assert_close(got[path][~near], want[path][~near], rtol=1e-5, atol=2e-4,
                                   msg=path)
        if near.any():
            assert float((got[path][near] - want[path][near]).abs().max()) <= 2.01e-3, path
    for k, atol in (("m", 1e-6), ("v", 1e-9)):
        w, g = (_gnn_leaves(s["opt"][k]) for s in (w_state, g_state))
        for path in w:
            torch.testing.assert_close(g[path], w[path], rtol=1e-4, atol=atol, msg=path)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill, det.fill_uninitialized_memory = det.fill_uninitialized_memory, False
    try:
        for _ in range(2):
            state, losses = tree_map(lambda x: x.to(cuda), cpu_state), []
            for b in batches[cuda]:
                state, m = model.train_step(state, b)
                losses.append(float(m["loss"]))
            runs.append((losses, _gnn_leaves(state)))
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
