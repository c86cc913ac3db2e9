"""Card-only paths of the port against their CPU versions, on the card:
the CUDA kernels (victim threshold, tiered-arena gather + decode) against
their plain PyTorch versions (bitwise), and the pinned host-tier
transmitter (staging ring, async copies, fp32 and tiered arenas) against
the CPU move.

Imports neither JAX nor the JAX package, so the machine with the card runs
it as is:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a card every test skips (a CUDA kernel has no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import transmitter
from repro_torch.kernels.cache_ops import kernel, ops
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
