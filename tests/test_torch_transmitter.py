"""repro_torch.core.transmitter.move_rows against repro.core.transmitter:
both directions (host store -> arena, arena -> host store), a staging buffer
smaller than K, inactive lanes and -1 source lanes.  fp32 rows move
bit-exactly, so every comparison is bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transmitter as jtx
from repro.store.host_store import HostStore as JHostStore
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
