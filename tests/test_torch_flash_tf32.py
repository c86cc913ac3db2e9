"""The 3xTF32 flash kernel's arithmetic, emulated in plain torch on the CPU
(a CUDA kernel has no CPU mode), against the JAX ``attention_ref`` and the
port's ``flash_attention_plain``; and the wrapper's choice of kernel by
dtype and head width.

The emulation follows ``csrc/flash_attention_tf32.cu`` step by step: q
times the fp32 scale, every operand split as hi = tf32(x), lo = tf32(x -
hi) (round to nearest, ties away, by bit masking), each product issued as
hi*lo + lo*hi + hi*hi, the tensor cores' fp32 accumulator modelled as
rounding toward zero after each 8-deep k-step (products of TF32 values are
exact), the reference's online softmax over 64-key tiles in fp32 (the -1e30
sentinel, -inf past Sk), each tile's P V in a fresh accumulator folded in
as acc * corr + pv, and the CTA's range of key tiles (128 query rows at
d <= 64, 64 at d <= 128).  It is held to the card smoke's bound,
2e-5 (1 + |o|) per element; one TF32 rounding of each operand misses it.

``python tests/test_torch_flash_tf32.py`` prints the table in the kernel's
note: elements over the bound against an fp64 oracle, one rounding and the
split.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel
from test_torch_flash_attention import EXTRA, SWEEP, _inputs, _t

SMOLLM = (1, 15, 5, 1024, 64, True, None)  # SmolLM-360M's heads and head width
TOL = 2e-5  # the card smoke's bound: 2e-5 (1 + |o|) per element
BK = 64  # keys per tile


def _tf32(x):
    """fp32 -> the nearest TF32 value (10-bit mantissa), ties away from zero
    (``cvt.rna.tf32.f32``): half an ulp added to the magnitude bits, the low
    13 bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _rz(x):
    """float64 -> fp32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(acc, terms, depth):
    """acc + sum of a @ b over ``terms``, 8 deep a k-step (a [.., M, K],
    b [.., K, N]), each k-step's sum rounded toward zero into fp32."""
    for a, b in terms:
        for k0 in range(0, depth, 8):
            acc = _rz(acc.double() + a[..., k0:k0 + 8].double() @ b[..., k0:k0 + 8, :].double())
    return acc


def tf32x3_arithmetic(q, k, v, causal=True, window=None, split=True):
    """The kernel's arithmetic on [B, H, S, D] fp32 inputs (``split=False``:
    one TF32 rounding of each operand, hi*hi alone)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bq = 128 if d <= 64 else 64  # query rows a CTA
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    qh, ql = _split(q * scale)
    kh, kl = (t.repeat_interleave(hq // hkv, dim=1) for t in _split(k))
    vh, vl = (t.repeat_interleave(hq // hkv, dim=1) for t in _split(v))
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    nk, ncta = -(-sk // BK), -(-sq // bq)
    ranges = []  # each CTA's live key tiles [j_lo, j_hi)
    for c in range(ncta):
        q0 = c * bq
        j_hi = min(nk, (min(q0 + bq, sq) - 1) // BK + 1) if causal else nk
        j_lo = (q0 - (BK - 1) - window) // BK + 1 if window is not None and (
            q0 - (BK - 1) - window >= 0) else 0
        ranges.append((j_lo, j_hi))
    for j in range(nk):
        ctas = [c for c, (lo, hi) in enumerate(ranges) if lo <= j < hi]
        if not ctas:
            continue
        r0, r1 = ctas[0] * bq, min((ctas[-1] + 1) * bq, sq)  # the CTAs are contiguous
        keys = torch.arange(j * BK, (j + 1) * BK)
        rows = torch.arange(r0, r1)[:, None]
        ks = slice(j * BK, min((j + 1) * BK, sk))
        pad = (0, 0, 0, (j + 1) * BK - min((j + 1) * BK, sk))  # zeros past Sk
        tk = [torch.nn.functional.pad(t[:, :, ks], pad).transpose(2, 3) for t in (kh, kl)]
        tv = [torch.nn.functional.pad(t[:, :, ks], pad) for t in (vh, vl)]
        qa, qb = qh[:, :, r0:r1], ql[:, :, r0:r1]
        zero = torch.zeros((b, hq, r1 - r0, BK))
        terms = [(qa, tk[1]), (qb, tk[0]), (qa, tk[0])] if split else [(qa, tk[0])]
        s = _mma(zero, terms, d)
        masked = torch.zeros((r1 - r0, BK), dtype=torch.bool)
        if causal:
            masked |= rows < keys
        if window is not None:
            masked |= rows - keys >= window
        s = torch.where(masked, torch.tensor(-1e30), s)
        s = torch.where(keys >= sk, torch.tensor(-torch.inf), s)
        m_old = m[:, :, r0:r1]
        m_new = torch.maximum(m_old, s.amax(-1, keepdim=True))
        corr = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new)
        l[:, :, r0:r1] = l[:, :, r0:r1] * corr + p.sum(-1, keepdim=True)
        m[:, :, r0:r1] = m_new
        ph, pl = _split(p)
        terms = [(pl, tv[0]), (ph, tv[1]), (ph, tv[0])] if split else [(ph, tv[0])]
        pv = _mma(torch.zeros((b, hq, r1 - r0, d)), terms, BK)
        acc[:, :, r0:r1] = (acc[:, :, r0:r1].double() * corr.double() + pv.double()).float()
    return acc / l.clamp_min(1e-30)


def _oracle(q, k, v, causal, window):
    """The dense masked softmax in fp64."""
    return kernel.attention_ref(q.double(), k.double(), v.double(), causal, window).float()


def _excess(got, want):
    """(elements over 2e-5 (1 + |want|), worst |got - want| - bound)."""
    over = (got - want).abs() - TOL * (1 + want.abs())
    return int((over > 0).sum()), float(over.max())


def _case(b, hq, hkv, s, d):
    _, tt = _inputs(b, hq, hkv, s, d, "float32")
    return [t.transpose(1, 2) for t in tt]  # [B, H, S, D] views


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", SWEEP + EXTRA + [SMOLLM])
def test_tf32x3_arithmetic_meets_the_card_bound(b, hq, hkv, s, d, causal, window):
    """Within 2e-5 (1 + |o|) of the port's plain version and of the JAX
    ``attention_ref`` on the same inputs."""
    (jq, jk, jv), _ = _inputs(b, hq, hkv, s, d, "float32")
    q, k, v = _case(b, hq, hkv, s, d)
    got = tf32x3_arithmetic(q, k, v, causal, window)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    plain = kernel.flash_attention_plain(q, k, v, causal, window)
    ref = torch.from_numpy(np.array(jax_ref(_t(jq), _t(jk), _t(jv), causal, window)))
    for name, want in (("plain", plain), ("jax attention_ref", ref)):
        n_over, worst = _excess(got, want)
        assert n_over == 0, f"{name}: {n_over} elements over the bound, worst excess {worst}"


def test_one_tf32_rounding_misses_the_bound():
    """At SmolLM's heads, rounding each operand to TF32 once puts elements
    past 2e-5 (1 + |o|): the reason every product is issued three times."""
    q, k, v = _case(*SMOLLM[:5])
    want = _oracle(q, k, v, True, None)
    assert _excess(tf32x3_arithmetic(q, k, v, split=False), want)[0] > 0
    assert _excess(tf32x3_arithmetic(q, k, v), want)[0] == 0


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2**-11, -(one + 2**-11), one + 2**-12, one + 3 * 2**-12, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + 2**-10, -(one + 2**-10), one, one + 2**-10, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32))
    hi, lo = _split(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi + lo - r).abs() <= r.abs() * 2.0**-21).all())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 16, "tf32x3"), (torch.float32, 20, "tf32x3"), (torch.float32, 64, "tf32x3"),
    (torch.float32, 100, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.float32, 129, "simt"), (torch.float32, 256, "simt"),
])
def test_route_by_dtype_and_head_width(dtype, d, route):
    """The kernel a CUDA call launches, chosen without a launch."""
    assert kernel.route(dtype, d) == route


def test_route_rejects_other_dtypes():
    with pytest.raises(ValueError, match="fp32 or bf16"):
        kernel.route(torch.float16, 64)


if __name__ == "__main__":
    cases = [(1, 4, 2, 512, 64, True, None), SMOLLM, (1, 2, 1, 4096, 64, True, None),
             (1, 2, 1, 2048, 128, True, 1024), (2, 6, 3, 256, 16, True, None)]
    print("case (b, hq, hkv, s, d, causal, window): elements over 2e-5 (1 + |o|) against the "
          "fp64 oracle, worst excess; one TF32 rounding | 3xTF32 split")
    for c in cases:
        q, k, v = _case(*c[:5])
        want = _oracle(q, k, v, *c[5:])
        print(c, _excess(tf32x3_arithmetic(q, k, v, *c[5:], split=False), want), "|",
              _excess(tf32x3_arithmetic(q, k, v, *c[5:]), want), flush=True)
