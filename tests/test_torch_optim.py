"""The port's optimizers, schedules and gradient ``Compressor`` against
``repro.optim`` on identical numpy-seeded inputs, on the CPU.

Bitwise: AdamW / Adam over several steps (parameters and both moments,
fp32 and bf16 parameters, a float and a scheduled learning rate), the
clipped gradients when no clipping happens, and every codec's payload,
sideband and error-feedback state over steps.  The bias corrections'
``b**t`` is a float64 power rounded to fp32, which equals XLA's fp32 power
(glibc's ``powf``) at the default betas for every step below 872, so the
steps checked bitwise lie there; at step 5000 the update is held within
2e-7 relative (one ulp of the power moves ``1 - b2**t`` by at most one
ulp).

Within a few ulps: the global norm (XLA and torch sum a leaf's squares in
different orders; rtol 1e-6), the clipped gradients when clipping scales
them (the scale carries the norm's last bits), and the schedules (XLA's
and torch's ``cos``; rtol 2.5e-7, one fp32 ulp).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro.optim.compression import Compressor as JCompressor
from repro_torch.optim import optimizers as O
from repro_torch.optim import schedules as S
from repro_torch.optim.compression import Compressor

SHAPES = {"w": (6, 5), "b": (7,), "a": {"z": (3, 4), "c": (2,)}}  # keys out of sorted order


def _draw(rng, shapes, scale=1.0, dtype=np.float32):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale, dtype) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(dtype)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(tree))


def _np(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def _assert_tree(want, got, path="", rtol=0.0):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _assert_tree(want[k], got[k], f"{path}/{k}", rtol)
        return
    w, g = np.asarray(want), _np(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (path, w.dtype, g.dtype)
    if rtol == 0.0:
        bits = [np.atleast_1d(x).view(np.uint8) for x in (w, g)]
        assert np.array_equal(*bits), path
    else:
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32), rtol=rtol,
                                   atol=0, err_msg=path)


def test_tree_leaves_take_the_reference_order():
    tree = _draw(np.random.default_rng(0), SHAPES)
    want = jax.tree_util.tree_leaves(_jax(tree))
    got = O.tree_leaves(_torch(tree))
    assert [w.shape for w in want] == [tuple(g.shape) for g in got]
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("max_norm", [1e3, 1.0])  # no clipping / clipped
def test_global_norm_and_clip_match_reference(max_norm):
    grads = _draw(np.random.default_rng(1), SHAPES)
    jn = JO.global_norm(_jax(grads))
    n = O.global_norm(_torch(grads))
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    jclipped, jn2 = JO.clip_by_global_norm(_jax(grads), max_norm)
    clipped, n2 = O.clip_by_global_norm(_torch(grads), max_norm)
    assert float(n2) == float(n)
    _assert_tree(jax.tree_util.tree_map(np.asarray, jclipped), clipped,
                 rtol=0.0 if max_norm > float(jn) else 1e-6)
    if max_norm < float(jn):
        np.testing.assert_allclose(float(O.global_norm(clipped)), max_norm, rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lr", ["float", "schedule"])
def test_adam_matches_reference_bitwise_over_steps(weight_decay, dtype, lr):
    npd = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(2)
    params = _draw(rng, SHAPES, 1.0, npd)
    jlr = 3e-3 if lr == "float" else JS.linear_warmup_cosine(3e-3, 2, 10)
    tlr = 3e-3 if lr == "float" else S.linear_warmup_cosine(3e-3, 2, 10)
    jopt = JO.adam(jlr, weight_decay=weight_decay)
    opt = O.adam(tlr, weight_decay=weight_decay)
    jp, p = _jax(params), _torch(params)
    js, s = jopt.init(jp), opt.init(p)
    for step in range(6):
        grads = _draw(rng, SHAPES, 10.0 ** (step % 3 - 1), npd)
        jp, js = jopt.update(_jax(grads), js, jp, jnp.int32(step))
        p, s = opt.update(_torch(grads), s, p, torch.tensor(step, dtype=torch.int32))
        _assert_tree(jax.tree_util.tree_map(np.asarray, jp), p, f"params step {step}")
        for k in ("m", "v"):
            _assert_tree(jax.tree_util.tree_map(np.asarray, js[k]), s[k], f"{k} step {step}")


@pytest.mark.parametrize("step,rtol", [(871, 0.0), (5000, 2e-7)])
def test_adamw_bias_correction_at_late_steps(step, rtol):
    """Past step 871 XLA's ``powf`` and the port's rounded float64 power
    may differ by one ulp."""
    rng = np.random.default_rng(3)
    params, m, v, grads = (_draw(rng, SHAPES) for _ in range(4))
    v = {k: np.abs(x) if not isinstance(x, dict) else {j: np.abs(y) for j, y in x.items()}
         for k, x in v.items()}
    want, _ = JO.adamw(1e-3).update(_jax(grads), {"m": _jax(m), "v": _jax(v)}, _jax(params),
                                    jnp.int32(step))
    got, _ = O.adamw(1e-3).update(_torch(grads), {"m": _torch(m), "v": _torch(v)},
                                  _torch(params), torch.tensor(step, dtype=torch.int32))
    _assert_tree(jax.tree_util.tree_map(np.asarray, want), got, rtol=rtol)


def test_schedules_match_reference():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150, 400, 1000]
    for jf, f in ((JS.constant(0.5), S.constant(0.5)),
                  (JS.linear_warmup_cosine(1.0, 10, 100), S.linear_warmup_cosine(1.0, 10, 100)),
                  (JS.linear_warmup_cosine(3e-4, 0, 37, 1e-5),
                   S.linear_warmup_cosine(3e-4, 0, 37, 1e-5)),
                  (JS.inverse_sqrt(1.0, 100), S.inverse_sqrt(1.0, 100)),
                  (JS.inverse_sqrt(2e-3, 7), S.inverse_sqrt(2e-3, 7))):
        for step in steps:
            want = np.asarray(jf(jnp.int32(step)))
            got = f(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0, err_msg=step)


@pytest.mark.parametrize("codec,factor", [("none", 4), ("bf16", 2), ("int8", 1)])
def test_compressor_wire_bytes_match_reference(codec, factor):
    grads = _draw(np.random.default_rng(4), SHAPES)
    n = sum(x.size for x in jax.tree_util.tree_leaves(grads))
    assert Compressor(codec).wire_bytes(_torch(grads)) == \
        JCompressor(codec).wire_bytes(_jax(grads)) == n * factor


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_compressor_encode_decode_and_error_feedback_bitwise(codec):
    """Five steps of encode then decode from the zero state: payload,
    scales, the error-feedback residuals and the decoded gradients."""
    rng = np.random.default_rng(5)
    jc, c = JCompressor(codec), Compressor(codec)
    like = _draw(rng, SHAPES)
    js, s = jc.init(_jax(like)), c.init(_torch(like))
    if codec != "int8":
        assert js == () and s == ()
    for step in range(5):
        grads = _draw(rng, SHAPES, 10.0 ** (step - 2))
        jpay, jside, js = jc.encode(_jax(grads), js)
        pay, side, s = c.encode(_torch(grads), s)
        _assert_tree(jax.tree_util.tree_map(np.asarray, jpay), pay, f"payload {step}")
        if codec == "int8":
            _assert_tree(jax.tree_util.tree_map(np.asarray, jside), side, f"scales {step}")
            _assert_tree(jax.tree_util.tree_map(np.asarray, js), s, f"residual {step}")
        want = jc.decode(jpay, jside, _jax(grads))
        got = c.decode(pay, side, _torch(grads))
        _assert_tree(jax.tree_util.tree_map(np.asarray, want), got, f"decoded {step}")


def test_int8_round_is_half_to_even_like_the_reference():
    """Gradients on exact .5 code boundaries: the max is 127, so the scale
    is 1 and each value's code is its round half to even."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.0], np.float32)
    jpay, _, _ = JCompressor("int8").encode({"g": jnp.asarray(g)},
                                            {"g": jnp.zeros(8, jnp.float32)})
    pay, _, _ = Compressor("int8").encode({"g": torch.from_numpy(g)},
                                          {"g": torch.zeros(8)})
    assert np.array_equal(pay["g"].numpy(), np.asarray(jpay["g"]))
    assert pay["g"].tolist() == [127, 0, 2, 2, 0, -2, -126, 3]
