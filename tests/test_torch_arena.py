"""The port's row codecs, tiered ``ArenaStore`` and plain gather-decode
(and gather + decode + host encode) against the JAX package, on
numpy-seeded inputs.

Tolerances: the codecs, the ``ArenaStore`` ops and the plain
``arena_gather`` run the reference's ops in its order, one eager op each,
so they are compared BITWISE against the reference run eagerly.  Under
``jax.jit`` XLA may fuse the int8 decode's multiply and add into one FMA,
so against the jitted reference and the Pallas kernel (interpret mode,
jitted as ``tests/test_cache_ops.py`` runs it) the port is held within
1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cache_ops import kernel as jkernel
from repro.kernels.cache_ops import ref as jref
from repro.store.arena import ArenaStore as JArenaStore
from repro.store.arena import tiered_arena_bytes as jtiered_arena_bytes
from repro.store.codec import get_codec as jget_codec
from repro.store.host_store import HostStore as JHostStore
from repro_torch.convert import to_numpy
from repro_torch.kernels.cache_ops import kernel, ops, ref
from repro_torch.store.arena import ArenaStore, tiered_arena_bytes
from repro_torch.store.codec import get_codec

CODECS = ["fp16", "int8"]


def _rows(n=24, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(0.01, 3.0, size=(n, 1))
    x[0] = 0.25  # a constant row (int8: scale from the 1e-12 floor)
    x[1] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("d", [8, 13])
def test_codec_matches_reference_bitwise(codec, d):
    x = _rows(d=d, seed=d)
    jp, js = jget_codec(codec).encode(jnp.asarray(x))
    tp, ts = get_codec(codec).encode(torch.from_numpy(x))
    assert tp.dtype == get_codec(codec).payload_dtype(torch.float32)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    if codec == "int8":
        assert np.array_equal(np.asarray(js), ts.numpy())
    else:
        assert js is None and ts is None
    jd = jget_codec(codec).decode(jp, js, jnp.float32)
    td = get_codec(codec).decode(tp, ts, torch.float32)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert get_codec(codec).row_bytes((d,), torch.float32) == jget_codec(codec).row_bytes(
        (d,), jnp.float32)


def test_int8_projection_is_stable():
    """decode -> encode of an untouched row reproduces its payload."""
    c = get_codec("int8")
    p1, s1 = c.encode(torch.from_numpy(_rows(seed=3)))
    y1 = c.decode(p1, s1, torch.float32)
    p2, s2 = c.encode(y1)
    assert torch.equal(p1, p2)
    torch.testing.assert_close(c.decode(p2, s2, torch.float32), y1, rtol=0, atol=1e-6)


def _pair(codec, cap=32, head=8, d=8, seed=1):
    x = _rows(cap, d, seed)
    return (JArenaStore.create({"weight": jnp.asarray(x)}, head, codec),
            ArenaStore.create({"weight": torch.from_numpy(x)}, head, codec))


@pytest.mark.parametrize("codec", CODECS)
def test_arena_store_matches_reference(codec):
    ja, ta = _pair(codec)
    assert ta.head_capacity == ja.head_capacity and ta.capacity == ja.capacity
    for k in ("head", "tail", "sideband"):
        got, want = to_numpy(getattr(ta, k)), jax.tree_util.tree_map(np.asarray, getattr(ja, k))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[n], want[n]) for n in got)
    slots = np.array([-1, 0, 7, 8, 9, 31, 32, 40, -5, 3], np.int32)
    want = ja.gather_slots(jnp.asarray(slots))["weight"]
    got = ta.gather_slots(torch.from_numpy(slots))["weight"]
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(ja.decode_leaf("weight")), ta.decode_leaf("weight").numpy())
    # scatter: head and tail lanes, inactive and out-of-range lanes dropped
    # (an active negative slot is never produced; JAX would wrap it)
    rng = np.random.default_rng(4)
    dst = np.array([2, 12, 30, 5, 40, -1, 17], np.int32)
    active = np.array([True, True, True, False, True, False, True])
    block = rng.normal(size=(7, 8)).astype(np.float32)
    ja = ja.scatter_slots(jnp.asarray(dst), {"weight": jnp.asarray(block)}, jnp.asarray(active))
    ta = ta.scatter_slots(torch.from_numpy(dst), {"weight": torch.from_numpy(block)},
                          torch.from_numpy(active))
    for k in ("head", "tail", "sideband"):
        want = jax.tree_util.tree_map(np.asarray, getattr(ja, k))
        got = to_numpy(getattr(ta, k))
        assert all(np.array_equal(got[n], want[n]) for n in want), k
    # whole-leaf SGD: decode, step, re-encode
    full = ja.decode_leaf("weight")
    g = rng.normal(size=full.shape).astype(np.float32)
    g[::3] = 0.0  # untouched rows keep their payload
    ja = ja.replace_leaf("weight", full - 0.1 * jnp.asarray(g))
    tfull = ta.decode_leaf("weight")
    ta.replace_leaf("weight", tfull - 0.1 * torch.from_numpy(g))
    for k in ("head", "tail", "sideband"):
        want = jax.tree_util.tree_map(np.asarray, getattr(ja, k))
        got = to_numpy(getattr(ta, k))
        assert all(np.array_equal(got[n], want[n]) for n in want), k
    assert ta.device_bytes() == ja.device_bytes()
    assert ta.fp32_equiv_bytes() == ja.fp32_equiv_bytes()


@pytest.mark.parametrize("codec", ["fp32", *CODECS])
def test_tiered_arena_bytes_matches_reference(codec):
    assert tiered_arena_bytes(506_438, 126_610, 128, torch.float32, codec) == \
        jtiered_arena_bytes(506_438, 126_610, 128, jnp.float32, codec)


def test_untouched_tail_rows_keep_their_payload():
    """A zero-gradient step re-encodes every tail row to its own payload;
    the re-derived (scale, zp) may move by an ulp of the decoded min/max."""
    _, ta = _pair("int8")
    before = ta.tail["weight"].clone(), ta.sideband["weight"].clone(), ta.decode_leaf("weight")
    ta.replace_leaf("weight", ta.decode_leaf("weight"))
    assert torch.equal(ta.tail["weight"], before[0])
    torch.testing.assert_close(ta.sideband["weight"], before[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(ta.decode_leaf("weight"), before[2], rtol=0, atol=1e-6)


_SLOTS = np.array([-1, 0, 5, 7, 8, 15, 31, 40, -3, 2, 2**31 - 1, 32, 9], np.int32)


@pytest.mark.parametrize("codec", CODECS)
def test_plain_arena_gather_matches_reference(codec):
    ja, ta = _pair(codec)
    h, t, s = ja.head["weight"], ja.tail["weight"], ja.sideband.get("weight")
    decode = jget_codec(codec).decode
    eager = jref.arena_gather(h, t, s, jnp.asarray(_SLOTS), decode, jnp.float32)
    jitted = jax.jit(lambda h, t, s, sl: jref.arena_gather(h, t, s, sl, decode, jnp.float32))(
        h, t, s, jnp.asarray(_SLOTS))
    pallas = jax.jit(lambda h, t, s, sl: jkernel.gather_decode_pallas(
        h, t, s, sl, codec, jnp.float32, interpret=True))(h, t, s, jnp.asarray(_SLOTS))
    got = kernel.gather_decode_plain(ta.head["weight"], ta.tail["weight"],
                                     ta.sideband.get("weight"), torch.from_numpy(_SLOTS), codec)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(_SLOTS), 8)
    assert np.array_equal(np.asarray(eager), got.numpy())
    np.testing.assert_array_max_ulp(np.asarray(jitted), got.numpy(), maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(pallas), got.numpy(), maxulp=1)
    # the generic ref with the codec's decode is the same function
    assert torch.equal(got, ref.arena_gather(
        ta.head["weight"], ta.tail["weight"], ta.sideband.get("weight"),
        torch.from_numpy(_SLOTS), get_codec(codec).decode, torch.float32))


@pytest.mark.parametrize("codec", CODECS)
def test_wrapper_takes_the_plain_version_on_cpu(codec):
    _, ta = _pair(codec)
    before = kernel.gather_decode.launches
    args = (ta.head["weight"], ta.tail["weight"], ta.sideband.get("weight"),
            torch.from_numpy(_SLOTS))
    assert torch.equal(ops.arena_gather_impl(*args, codec),
                       kernel.gather_decode_plain(*args, codec))
    assert kernel.gather_decode.launches == before
    with pytest.raises(ValueError):
        kernel.gather_decode(*args, "fp32")


def _bits_equal(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape, (want.dtype, got.dtype)
    assert np.array_equal(want.view(np.uint8), got.view(np.uint8))


@pytest.mark.parametrize("d", [8, 13])
@pytest.mark.parametrize("host", CODECS)
@pytest.mark.parametrize("codec", CODECS)
def test_gather_decode_encode_matches_reference(codec, host, d):
    """The fused gather + decode + host encode (its plain version on the
    CPU) bitwise the reference's arena ``gather_slots`` then the host
    store's ``encode_block``: fp16 / int8 tails into fp16 / int8 hosts,
    out-of-range slots, constant rows (mx = mn) in the head and the tail;
    also through the ops entry and ``ArenaStore.gather_encoded_slots``."""
    x = _rows(32, d, seed=d)
    x[9], x[10] = -1.5, 0.0  # constant tail rows (the head holds slots 0-7)
    ja = JArenaStore.create({"weight": jnp.asarray(x)}, 8, codec)
    ta = ArenaStore.create({"weight": torch.from_numpy(x)}, 8, codec)
    slots = np.concatenate([_SLOTS, [1, 10, 30]]).astype(np.int32)
    jstore = JHostStore.create({"weight": jnp.zeros((1, d), jnp.float32)}, host)
    want_p, want_s = jstore.encode_block(ja.gather_slots(jnp.asarray(slots)))
    args = (ta.head["weight"], ta.tail["weight"], ta.sideband.get("weight"),
            torch.from_numpy(slots))
    before = (kernel.gather_decode.launches, kernel.gather_decode.fused_launches)
    payload, side = kernel.gather_decode_encode(*args, codec, host)
    assert (kernel.gather_decode.launches, kernel.gather_decode.fused_launches) == before
    _bits_equal(want_p["weight"], payload)
    if host == "int8":
        _bits_equal(want_s["weight"], side)
    else:
        assert side is None and not want_s
    p2, s2 = ops.arena_gather_encode_impl(*args, codec, host)
    assert torch.equal(p2, payload) and (s2 is None or torch.equal(s2, side))
    rows, p3, s3 = ta.gather_encoded_slots(torch.from_numpy(slots), host)
    assert not rows and torch.equal(p3["weight"], payload)
    assert set(s3) == ({"weight"} if host == "int8" else set())
    with pytest.raises(ValueError):
        kernel.gather_decode_encode(*args, codec, "fp32")
