"""repro_torch.core.transmitter.move_rows against repro.core.transmitter:
both directions (host store -> arena, arena -> host store), a staging buffer
smaller than K, inactive lanes and -1 source lanes, and chunked staging
(``src_chunk_rows`` / ``dst_chunk_rows``) on raw trees and fp32 / fp16 /
int8 host stores.  Every comparison is bitwise; encoded moves are held
against the eager reference in one round (its multi-round ``fori_loop`` is
compiled, and XLA may move an int8 code by an ulp there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_tree_equal, jax_to_numpy

from repro.core import transmitter as jtx
from repro.store.host_store import HostStore as JHostStore
from repro_torch.convert import to_numpy
from repro_torch.core import transmitter as tx
from repro_torch.store.host_store import HostStore


def _lanes(rng, k, n_src, n_dst):
    """Unique destinations on the active lanes; -1 sources on some of them."""
    src = rng.integers(0, n_src, size=k).astype(np.int32)
    src[rng.random(k) < 0.2] = -1
    dst = rng.permutation(n_dst)[:k].astype(np.int32)
    active = rng.random(k) < 0.7
    dst[~active & (rng.random(k) < 0.5)] = -1  # inactive -1 lanes are dropped too
    return src, dst, active


@pytest.mark.parametrize("direction", ["load", "writeback"])
@pytest.mark.parametrize("buffer_rows", [3, 7, 64])
def test_move_rows_matches_reference(direction, buffer_rows):
    rng = np.random.default_rng(buffer_rows)
    vocab, cap, dim, k = 96, 24, 8, 20
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    arena = rng.normal(size=(cap, dim)).astype(np.float32)
    j_store = JHostStore.create({"weight": jnp.asarray(table)})
    t_store = HostStore.create({"weight": torch.from_numpy(table.copy())})
    j_arena = {"weight": jnp.asarray(arena)}
    t_arena = {"weight": torch.from_numpy(arena.copy())}
    if direction == "load":
        src, dst, active = _lanes(rng, k, vocab, cap)
        want = jtx.move_rows(j_store, j_arena, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(active), buffer_rows=buffer_rows)["weight"]
        got = tx.move_rows(t_store, t_arena, torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(active), buffer_rows=buffer_rows)["weight"]
        assert got is t_arena["weight"]  # updated in place
    else:
        src, dst, active = _lanes(rng, k, cap, vocab)
        want = jtx.move_rows(j_arena, j_store, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(active), buffer_rows=buffer_rows)["weight"]
        got = tx.move_rows(t_arena, t_store, torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(active), buffer_rows=buffer_rows)["weight"]
    assert np.array_equal(np.asarray(want), got.numpy())


def test_num_rounds_matches_reference():
    for k, b in [(1, 1), (10, 3), (9, 3), (65536, 65536), (425984, 65536)]:
        assert tx.num_rounds(k, b) == jtx.num_rounds(k, b)


def test_gather_and_scatter_rows_mask_lanes():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(10, 4)).astype(np.float32)
    idx = np.array([3, -1, 9, 12, 0], np.int32)
    want = jtx.gather_rows({"w": jnp.asarray(w)}, jnp.asarray(idx))["w"]
    got = tx.gather_rows({"w": torch.from_numpy(w)}, torch.from_numpy(idx))["w"]
    assert np.array_equal(np.asarray(want), got.numpy())

    block = rng.normal(size=(5, 4)).astype(np.float32)
    dst_idx = np.array([2, 7, 11, 5, 0], np.int32)  # 11 is out of range: dropped
    active = np.array([True, False, True, True, False])
    want = jtx.scatter_rows({"w": jnp.asarray(w)}, jnp.asarray(dst_idx),
                            {"w": jnp.asarray(block)}, jnp.asarray(active))["w"]
    t = {"w": torch.from_numpy(w.copy())}
    tx.scatter_rows(t, torch.from_numpy(dst_idx), {"w": torch.from_numpy(block)},
                    torch.from_numpy(active))
    assert np.array_equal(np.asarray(want), t["w"].numpy())
    # no kept lane at all: the tree is unchanged
    t = {"w": torch.from_numpy(w.copy())}
    tx.scatter_rows(t, torch.from_numpy(dst_idx), {"w": torch.from_numpy(block)},
                    torch.zeros(5, dtype=torch.bool))
    assert np.array_equal(t["w"].numpy(), w)


@pytest.mark.parametrize("codec", ["fp16", "int8"])
@pytest.mark.parametrize("direction", ["load", "writeback"])
def test_encoded_host_store_moves_match_reference(codec, direction):
    """An encoded host store on either side, one round (the eager
    reference's bitwise regime): a load gathers payload and sideband and
    decodes them on arrival; a write-back encodes and scatters both."""
    rng = np.random.default_rng(11)
    vocab, cap, dim, k = 96, 24, 8, 20
    table = rng.normal(size=(vocab, dim)).astype(np.float32) * 2
    arena = rng.normal(size=(cap, dim)).astype(np.float32)
    j_store = JHostStore.create({"weight": jnp.asarray(table)}, codec)
    t_store = HostStore.create({"weight": torch.from_numpy(table.copy())}, codec)
    j_arena = {"weight": jnp.asarray(arena)}
    t_arena = {"weight": torch.from_numpy(arena.copy())}
    if direction == "load":
        src, dst, active = _lanes(rng, k, vocab, cap)
        want = jtx.move_rows(j_store, j_arena, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(active), buffer_rows=64)["weight"]
        got = tx.move_rows(t_store, t_arena, torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(active), buffer_rows=64)["weight"]
        assert np.array_equal(np.asarray(want), got.numpy())
        return
    src, dst, active = _lanes(rng, k, cap, vocab)
    want = jtx.move_rows(j_arena, j_store, jnp.asarray(src), jnp.asarray(dst),
                         jnp.asarray(active), buffer_rows=64)
    got = tx.move_rows(t_arena, t_store, torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(active), buffer_rows=64)
    assert got is t_store
    assert np.array_equal(np.asarray(want.data["weight"]), got.data["weight"].numpy())
    for key in want.sideband:
        assert np.array_equal(np.asarray(want.sideband[key]), got.sideband[key].numpy())
    assert set(want.sideband) == set(got.sideband) == ({"weight"} if codec == "int8" else set())


@pytest.mark.parametrize("host,arena", [("int8", "int8"), ("fp16", "fp16"), ("int8", "fp16"),
                                        ("fp32", "int8")])
def test_host_to_tiered_arena_load_matches_reference(host, arena):
    """A host store into a tiered arena: where the codecs match, the tail
    lanes take the host payload and sideband verbatim (no decode and
    re-encode) and the head lanes decode; otherwise every lane decodes and
    the tail re-encodes.  Payload, sideband and head bitwise."""
    from repro.store.arena import ArenaStore as JArenaStore
    from repro_torch import convert
    from repro_torch.store.arena import ArenaStore

    rng = np.random.default_rng(5)
    vocab, cap, head, dim, k = 96, 24, 6, 8, 20
    table = rng.normal(size=(vocab, dim)).astype(np.float32) * 3
    start = rng.normal(size=(cap, dim)).astype(np.float32)
    j_store = JHostStore.create({"weight": jnp.asarray(table)}, host)
    t_store = HostStore.create({"weight": torch.from_numpy(table.copy())}, host)
    j_arena = JArenaStore.create({"weight": jnp.asarray(start)}, head, arena)
    t_arena = ArenaStore.create({"weight": torch.from_numpy(start.copy())}, head, arena)
    src, dst, active = _lanes(rng, k, vocab, cap)
    want = jtx.move_rows(j_store, j_arena, jnp.asarray(src), jnp.asarray(dst),
                         jnp.asarray(active), buffer_rows=64)
    got = tx.move_rows(t_store, t_arena, torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(active), buffer_rows=64)
    assert got is t_arena
    w, g = convert.to_numpy(got), {f: np.asarray(getattr(want, f)["weight"])
                                   for f in ("head", "tail")}
    assert np.array_equal(g["head"], w["head"]["weight"])
    assert np.array_equal(g["tail"], w["tail"]["weight"])
    if arena == "int8":
        assert np.array_equal(np.asarray(want.sideband["weight"]), w["sideband"]["weight"])
    if host == arena:  # the tail holds the host tier's exact bits
        tail = (dst >= head) & active & (src >= 0)
        assert np.array_equal(w["tail"]["weight"][dst[tail] - head],
                              t_store.data["weight"].numpy()[src[tail]])


# --------------------------------------------------------------------------
# chunked staging: bitwise the row path and the reference's chunked move
# --------------------------------------------------------------------------


def _chunk_lanes(rng, n_src, n_dst, k=24):
    si = rng.integers(-1, n_src, size=k).astype(np.int32)
    di = rng.permutation(n_dst)[:k].astype(np.int32)
    ac = rng.integers(0, 2, size=k).astype(bool)
    return si, di, ac


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("scr,dcr", [(8, 0), (0, 8), (8, 8), (16, 4), (5, 3)])
def test_chunked_move_bit_identical(scr, dcr):
    """Raw trees on either side: the chunked move equals the port's row
    move in three rounds and the reference's chunked move in one; (5, 3)
    divide neither side and fall back to rows."""
    rng = np.random.default_rng(11)
    src = rng.normal(size=(64, 4)).astype(np.float32)
    dst = rng.normal(size=(32, 4)).astype(np.float32)
    si, di, ac = _chunk_lanes(rng, 64, 32)
    want = jtx.move_rows({"w": jnp.asarray(src)}, {"w": jnp.asarray(dst)}, jnp.asarray(si),
                         jnp.asarray(di), jnp.asarray(ac), buffer_rows=24,
                         src_chunk_rows=scr, dst_chunk_rows=dcr)["w"]
    rows = tx.move_rows({"w": torch.from_numpy(src)}, {"w": torch.from_numpy(dst.copy())},
                        *_t(si, di, ac), buffer_rows=8)["w"]
    before = dict(tx.moves)
    got = tx.move_rows({"w": torch.from_numpy(src)}, {"w": torch.from_numpy(dst.copy())},
                       *_t(si, di, ac), buffer_rows=8, src_chunk_rows=scr, dst_chunk_rows=dcr)["w"]
    assert torch.equal(rows, got) and np.array_equal(np.asarray(want), got.numpy())
    path = "rows" if (scr, dcr) == (5, 3) else "chunked"
    assert tx.moves[path] == before[path] + 1


@pytest.mark.parametrize("codec", ["fp32", "fp16", "int8"])
def test_chunked_move_hoststore_bit_identical(codec):
    """An encoded host store chunked on the load (payload and sideband
    move as chunks) and on the write-back (read-modify-write of the touched
    chunks): bitwise the row path (three rounds) and the reference's
    chunked move (one round, its bitwise regime)."""
    rng = np.random.default_rng(12)
    table = rng.normal(size=(64, 4)).astype(np.float32)
    jhs = JHostStore.create({"w": jnp.asarray(table)}, codec)

    def store():
        return HostStore.create({"w": torch.from_numpy(table.copy())}, codec)

    dst = rng.normal(size=(32, 4)).astype(np.float32)
    si, di, ac = _chunk_lanes(rng, 64, 32)
    want = jtx.move_rows(jhs, {"w": jnp.asarray(dst)}, *map(jnp.asarray, (si, di, ac)),
                         buffer_rows=24, src_chunk_rows=8)["w"]
    rows = tx.move_rows(store(), {"w": torch.from_numpy(dst.copy())}, *_t(si, di, ac),
                        buffer_rows=8)["w"]
    got = tx.move_rows(store(), {"w": torch.from_numpy(dst.copy())}, *_t(si, di, ac),
                       buffer_rows=8, src_chunk_rows=8)["w"]
    assert torch.equal(rows, got) and np.array_equal(np.asarray(want), got.numpy())
    src = rng.normal(size=(32, 4)).astype(np.float32)
    di2 = rng.permutation(64)[:24].astype(np.int32)
    want = jtx.move_rows({"w": jnp.asarray(src)}, jhs, *map(jnp.asarray, (di, di2, ac)),
                         buffer_rows=24, dst_chunk_rows=8)
    rows = tx.move_rows({"w": torch.from_numpy(src)}, store(), *_t(di, di2, ac), buffer_rows=8)
    got = tx.move_rows({"w": torch.from_numpy(src)}, store(), *_t(di, di2, ac), buffer_rows=8,
                       dst_chunk_rows=8)
    for leaves, jleaves in ((got.data, want.data), (got.sideband, want.sideband)):
        assert set(leaves) == set(jleaves)
        for k in leaves:
            assert np.array_equal(np.asarray(jleaves[k]), leaves[k].numpy()), k
    assert torch.equal(rows.data["w"], got.data["w"])


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("arena", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("host", ["fp32", "fp16", "int8"])
def test_chunked_load_into_arena_matches_reference(host, arena, chunk):
    """A host store loaded into an fp32 or tiered arena, by rows and in
    chunks of 16: the arena's head, payload, sideband and decoded rows
    bitwise the eager reference's ``move_rows`` in one round.  Under a
    chunked source both decode the staged chunks and the tail re-encodes
    them; by rows, a tail of the host's codec takes the host bits."""
    from repro.store.arena import ArenaStore as JArenaStore
    from repro_torch.store.arena import ArenaStore

    rng = np.random.default_rng(5)
    table = rng.normal(size=(96, 8)).astype(np.float32) * 3
    start = rng.normal(size=(24, 8)).astype(np.float32)
    j_store = JHostStore.create({"weight": jnp.asarray(table)}, host)
    t_store = HostStore.create({"weight": torch.from_numpy(table.copy())}, host)
    if arena == "fp32":
        j_arena = {"weight": jnp.asarray(start)}
        t_arena = {"weight": torch.from_numpy(start.copy())}
    else:
        j_arena = JArenaStore.create({"weight": jnp.asarray(start)}, 6, arena)
        t_arena = ArenaStore.create({"weight": torch.from_numpy(start.copy())}, 6, arena)
    src, dst, active = _lanes(rng, 20, 96, 24)
    want = jtx.move_rows(j_store, j_arena, *map(jnp.asarray, (src, dst, active)),
                         buffer_rows=64, src_chunk_rows=chunk)
    got = tx.move_rows(t_store, t_arena, *_t(src, dst, active), buffer_rows=64,
                       src_chunk_rows=chunk)
    assert got is t_arena
    assert_tree_equal(jax_to_numpy(want), to_numpy(got))
    if arena != "fp32":
        slots = torch.arange(24, dtype=torch.int32)
        assert np.array_equal(np.asarray(want.gather_slots(jnp.asarray(slots.numpy()))["weight"]),
                              got.gather_slots(slots)["weight"].numpy())


@pytest.mark.parametrize("host", ["fp16", "int8"])
@pytest.mark.parametrize("arena", ["fp16", "int8"])
def test_writeback_from_tiered_arena_into_encoded_host_matches_reference(arena, host,
                                                                         monkeypatch):
    """A write-back from a tiered arena into an fp16 / int8 host tier in one
    round: the leaf packed by one gather-decode-encode call (no
    ``encode_block`` of fp32 rows), the host payload and sideband bitwise
    the eager reference's ``move_rows`` (``gather_slots`` then
    ``encode_block``); a constant tail row and -1 source lanes included."""
    from repro.store.arena import ArenaStore as JArenaStore
    from repro_torch.kernels.cache_ops import ops
    from repro_torch.store.arena import ArenaStore

    calls = []
    impl = ops.arena_gather_encode_impl

    def counted(*args):
        calls.append(args[-1])
        return impl(*args)

    monkeypatch.setattr(ops, "arena_gather_encode_impl", counted)
    rng = np.random.default_rng(9)
    table = rng.normal(size=(96, 8)).astype(np.float32) * 3
    start = rng.normal(size=(24, 8)).astype(np.float32)
    start[7] = 0.5  # a constant tail row (the head holds slots 0-5)
    j_store = JHostStore.create({"weight": jnp.asarray(table)}, host)
    t_store = HostStore.create({"weight": torch.from_numpy(table.copy())}, host)
    j_arena = JArenaStore.create({"weight": jnp.asarray(start)}, 6, arena)
    t_arena = ArenaStore.create({"weight": torch.from_numpy(start.copy())}, 6, arena)
    src, dst, active = _lanes(rng, 20, 24, 96)
    src[:2], active[:2] = 7, [True, False]  # the constant row, once active
    want = jtx.move_rows(j_arena, j_store, *map(jnp.asarray, (src, dst, active)), buffer_rows=64)
    got = tx.move_rows(t_arena, t_store, *_t(src, dst, active), buffer_rows=64)
    assert got is t_store and calls == [host]
    assert_tree_equal(jax_to_numpy(want.data), to_numpy(got.data))
    assert_tree_equal(jax_to_numpy(want.sideband), to_numpy(got.sideband))
    assert set(got.sideband) == ({"weight"} if host == "int8" else set())


def test_chunked_staging_block_sized_by_unique_chunks():
    """One round's staging block holds its unique chunks, not
    ``buffer_rows`` x ``chunk_rows`` rows: 3 lanes in 2 chunks of 16 rows
    of an int8 row (8 payload bytes + 8 sideband bytes) is 2 x 16 x 16 B."""
    table = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    store = HostStore.create({"w": torch.from_numpy(table)}, "int8")
    arena = {"w": torch.zeros((8, 8))}
    tx.moves["chunk_block_bytes"] = 0
    src, dst = np.array([1, 5, 40], np.int32), np.array([0, 1, 2], np.int32)
    tx.move_rows(store, arena, *_t(src, dst, np.ones(3, bool)), buffer_rows=65536,
                 src_chunk_rows=16)
    assert tx.moves["chunk_block_bytes"] == 2 * 16 * (8 + 8)
    want = store.decode_rows(torch.from_numpy(src.astype(np.int64)))["w"]
    assert torch.equal(arena["w"][:3], want)


def test_chunked_cache_pipeline_bit_identical():
    """``chunk_rows`` through ``warmup`` / ``prepare`` / ``flush``: slots, the
    host table and the arena bitwise the row path's and the reference's."""
    from repro.core import cache as jcache
    from repro_torch.core import cache

    rng = np.random.default_rng(13)
    kw = dict(vocab=128, capacity=32, ids_per_step=16, buffer_rows=16)
    table = rng.normal(size=(128, 8)).astype(np.float32)
    jcfg = jcache.CacheConfig(**kw, chunk_rows=8, use_pallas_plan=True)
    jst = jcache.init_cache(jcfg, {"weight": jnp.zeros((8,), jnp.float32)})
    jfull, jst = jcache.warmup(jcfg, {"weight": jnp.asarray(table)}, jst)
    runs = []
    for chunk in (0, 8):
        cfg = cache.CacheConfig(**kw, chunk_rows=chunk, use_pallas_plan=True)
        st = cache.init_cache(cfg, {"weight": torch.zeros((8,))}, torch.device("cpu"))
        full, st = cache.warmup(cfg, {"weight": torch.from_numpy(table.copy())}, st)
        runs.append((cfg, full, st))
    for _ in range(4):
        rows = rng.integers(-1, 128, size=16).astype(np.int32)
        jfull, jst, jsl = jcache.prepare(jcfg, jfull, jst, jnp.asarray(rows))
        out = []
        for cfg, full, st in runs:
            full, st, sl = cache.prepare(cfg, full, st, torch.from_numpy(rows))
            out.append((cfg, full, st))
            assert np.array_equal(np.asarray(jsl), sl.numpy())
            assert np.array_equal(np.asarray(jfull["weight"]), full["weight"].numpy())
        runs = out
    jfull, jst = jcache.flush(jcfg, jfull, jst)
    for cfg, full, st in runs:
        full, st = cache.flush(cfg, full, st)
        assert np.array_equal(np.asarray(jfull["weight"]), full["weight"].numpy())
        assert np.array_equal(np.asarray(jst.cached_rows["weight"]), st.cached_rows["weight"].numpy())
