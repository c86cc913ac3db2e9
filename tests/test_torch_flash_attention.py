"""The port's flash attention against the JAX package, on the CPU: the
port's ``ops.flash_attention`` (on CPU tensors, the plain version) against
the JAX ``flash_attention`` (its Pallas kernel in interpret mode, as
``test_kernels.py`` runs it) and against the JAX ``attention_ref``, on
``test_kernels.py``'s sweep; the plain version on the shapes the card smoke
adds (head dims 16 and 20, 15 query heads over 5 KV heads, a length of 96,
a window wider than the sequence); the gradient; and the shapes the
reference rejects.

Tolerances are the reference sweep's: fp32 2e-5, bf16 3e-2 (rtol and atol),
and 1e-4 for the gradient (``test_kernels.py``'s grad test).  The plain
version computes the oracle's dense softmax, so against ``attention_ref``
only the summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops

SWEEP = [
    (2, 4, 2, 512, 64, True, None),
    (1, 4, 4, 512, 64, True, 128),
    (2, 8, 2, 256, 32, False, None),
    (1, 2, 1, 1024, 128, True, 256),
]
EXTRA = [
    (2, 6, 3, 256, 16, True, None),  # gemma's SMOKE head dim
    (2, 6, 2, 256, 20, True, 64),  # smollm's SMOKE head dim
    (1, 15, 5, 256, 64, True, None),  # SmolLM-360M's heads
    (2, 4, 2, 96, 64, True, None),  # a length that is no multiple of 64
    (1, 4, 2, 512, 64, True, 4096),  # a window wider than the sequence
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, hq, hkv, s, d, dtype):
    """q, k, v [B, S, H, D] as JAX arrays and torch tensors of the same values."""
    rng = np.random.default_rng(s + hq)
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    jx = [jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrays]
    tt = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrays]
    return jx, tt


def _t(x):
    return x.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel_and_oracle(b, hq, hkv, s, d, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, hq, hkv, s, d, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float().numpy()
    want_kernel = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=window), np.float32)
    want_ref = np.asarray(_t(jax_ref(_t(jq), _t(jk), _t(jv), causal, window)), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", EXTRA)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_oracle(b, hq, hkv, s, d, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, hq, hkv, s, d, dtype)
    got = kernel.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       causal, window)
    want = np.asarray(jax_ref(_t(jq), _t(jk), _t(jv), causal, window), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_attention_grad_matches_jax_grad():
    """q, k and v gradients of sum(attention) within 1e-4 (the reference's
    own grad test holds its kernel's q gradient to the oracle's)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 256, 32, "float32")
    want = jax.grad(lambda a, b_, c: jax_flash(a, b_, c).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.flash_attention(q, k, v).sum().backward()
    for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("sq,sk", [(300, 300), (256, 300), (512, 384)])
def test_block_misfit_raises_where_the_reference_asserts(sq, sk):
    """min(256, S) must divide S, for the queries and the keys alike."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 2, sq, 8)).astype(np.float32)
    kv = rng.normal(size=(1, 1, sk, 8)).astype(np.float32)
    with pytest.raises(AssertionError):
        from repro.kernels.flash_attention.kernel import flash_attention_pallas

        flash_attention_pallas(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    with pytest.raises(ValueError, match="multiple"):
        kernel.flash_attention(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))


@pytest.mark.parametrize("q_shape,k_shape,v_shape", [
    ((1, 3, 64, 8), (1, 2, 64, 8), (1, 2, 64, 8)),  # Hkv does not divide Hq
    ((1, 2, 64, 8), (1, 1, 64, 4), (1, 1, 64, 4)),  # head dims differ
    ((1, 2, 64, 8), (1, 1, 64, 8), (1, 1, 32, 8)),  # k and v differ
    ((2, 64, 8), (1, 1, 64, 8), (1, 1, 64, 8)),  # q is not [B, H, S, D]
])
def test_wrapper_rejects_shapes_that_do_not_fit(q_shape, k_shape, v_shape):
    with pytest.raises(ValueError):
        kernel.flash_attention(torch.zeros(q_shape), torch.zeros(k_shape), torch.zeros(v_shape))


def _bf16_ulp(x):
    """The spacing of bf16 values at each element of ``x`` (0 where x is 0)."""
    m, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


def _tensor_core_arithmetic(q, k, v, causal, window, split):
    """The bf16 card kernel's arithmetic in torch, on [B, H, S, D] bf16
    inputs: fp32 scores of the bf16 q and k; the online softmax over 64-key
    tiles in log2 units with the -1e30 sentinel (-inf past Sk), a 64-row
    group skipping a tile with no live pair; p @ v from p split into bf16
    ``hi + lo`` (``split``) or rounded to bf16 once, accumulated in fp32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    pad = (0, 0, 0, -sk % 64)  # the kernel zero-fills a ragged last tile
    kk = torch.nn.functional.pad(k.float().repeat_interleave(hq // hkv, dim=1), pad)
    vv = torch.nn.functional.pad(v.float().repeat_interleave(hq // hkv, dim=1), pad)
    sc = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    rows = torch.arange(sq)[:, None]
    group = rows // 64  # a warpgroup's 64 rows
    for k0 in range(0, sk, 64):
        keys = torch.arange(k0, k0 + 64)[None, :]
        live = keys < sk
        if causal:
            live = live & (rows >= keys)
        if window is not None:
            live = live & (rows - keys < window)
        group_live = torch.zeros(int(group.max()) + 1, dtype=torch.bool).index_put_(
            (group[:, 0],), live.any(1), accumulate=True)[group]  # [Sq, 1]
        s = q.float() @ kk[:, :, k0:k0 + 64].transpose(2, 3)
        s = torch.where(live, s, torch.tensor(-1e30))
        s = torch.where(keys < sk, s, torch.tensor(-torch.inf))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * sc)
        p = torch.exp2(s * sc - m_new * sc)
        hi = p.bfloat16().float()
        pv = hi @ vv[:, :, k0:k0 + 64]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vv[:, :, k0:k0 + 64]
        m = torch.where(group_live, m_new, m)
        l = torch.where(group_live, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(group_live, acc * corr + pv, acc)
    return (acc / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window",
                         SWEEP + EXTRA + [(1, 2, 1, 4096, 64, True, None)])
def test_tensor_core_rounding_scheme_meets_the_card_bound(b, hq, hkv, s, d, causal, window):
    """The card kernel's bf16 arithmetic, emulated, within the card smoke's
    bound of the plain version: 2e-5 (1 + |o|) plus one bf16 ulp of o.  At
    S 4096 a single bf16 rounding of p breaks that bound: the reason p is
    split into hi + lo."""
    _, (q, k, v) = _inputs(b, hq, hkv, s, d, "bfloat16")
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    want = kernel.flash_attention_plain(q, k, v, causal, window).float()
    bound = 2e-5 * (1 + want.abs()) + _bf16_ulp(want)
    got = _tensor_core_arithmetic(q, k, v, causal, window, split=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    over = (got.float() - want).abs() - bound
    assert float(over.max()) <= 0, f"{int((over > 0).sum())} elements over, worst {over.max()}"
    if s == 4096:
        once = _tensor_core_arithmetic(q, k, v, causal, window, split=False)
        assert int(((once.float() - want).abs() > bound).sum()) > 0
