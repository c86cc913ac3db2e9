"""The port's LM serving path against the JAX package, on the CPU, on the
SMOKE configs of three dense LMs: smollm-360m (head dim 20, 3 query heads
over 1 KV head), gemma3-27b (5 local layers of window 8 to 1 global, one
group of 6 and 2 remainder layers, ``kv_repeat=2``, ring-buffer caches) and
internlm2-20b (``kv_repeat=2``).  Parameters come from one JAX init and
cross through ``repro_torch.convert``; tokens come from ``seq_batch``,
bitwise the same in both packages.

Covered: the configs field for field; ``rmsnorm``, ``rope``, the chunked
``gqa_attention``, ``decode_attention`` and ``ffn_apply``; ``forward``
logits with ``use_pallas`` off (the chunked route) and on (the JAX Pallas
kernel in interpret mode, the port's plain flash version); ``prefill_step``;
and 12 ``decode_step`` calls from position 0 (the 8-slot rings of gemma's
local layers wrap), logits at every step and every cache leaf after the
last.

The JAX side runs jitted (``forward``, ``prefill_step``, ``decode_fn``),
its Pallas kernel in interpret mode.

Tolerances: fp32 1e-5 (rtol and atol): torch and XLA sum matrix products
and reductions in different orders.  bf16: ``rmsnorm`` and ``rope`` end in
one bf16 rounding, which the two packages may take either way from fp32
values that differ in the last bits: one bf16 ulp, rtol 2^-7.  smollm's
SMOKE forward in bf16 compute chains about a dozen such roundings per layer
(q, k, v, rope, attention, the FFN's three products and SiLU, the residual
adds, the logits); its logits are held within 2^-6 of max|logit|, about
four bf16 ulps at the largest logit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_parity import jax_to_numpy

from repro.configs import gemma3_27b as j_gemma
from repro.configs import internlm2_20b as j_intern
from repro.configs import lm_common as j_common
from repro.configs import smollm_360m as j_smollm
from repro.data import synth as j_synth
from repro.dist.partitioning import split_params
from repro.models.lm import LMModel as JLMModel
from repro.nn import layers as JL
from repro.nn import moe as JM
from repro.nn import transformer as JT
from repro_torch import convert
from repro_torch.configs import gemma3_27b, internlm2_20b, lm_common, smollm_360m
from repro_torch.data import synth
from repro_torch.models.lm import LMModel
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import transformer as T

CONFIGS = {"smollm": (smollm_360m, j_smollm), "gemma3": (gemma3_27b, j_gemma),
           "internlm2": (internlm2_20b, j_intern)}
TOL = 1e-5
B, S, DECODE_STEPS = 2, 32, 12


def _dtype_name(dt):
    return jnp.dtype(dt).name if not isinstance(dt, torch.dtype) else str(dt).split(".")[-1]


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtypes"] = {k: _dtype_name(v) for k, v in out["dtypes"].items()}
    return out


def _np(x):
    """A port tensor as a numpy array, bf16 through its uint16 bits."""
    a = convert.to_numpy(x)
    return a.view(ml_dtypes.bfloat16).astype(np.float32) if a.dtype == np.uint16 else a


def _close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=err_msg)


def _models(name, bf16=False, **overrides):
    """(port config, JAX config, port params, JAX params) from one JAX init;
    ``bf16`` sets both packages' bf16 params and compute dtypes."""
    mod, jmod = CONFIGS[name]
    cfg = dataclasses.replace(mod.SMOKE, **overrides)
    jcfg = dataclasses.replace(jmod.SMOKE, **overrides)
    if bf16:
        cfg = dataclasses.replace(cfg, dtypes=lm_common.BF16)
        jcfg = dataclasses.replace(jcfg, dtypes=j_common.BF16)
    jparams = _jax_params(name, bf16)
    return cfg, jcfg, convert.lm_params_from_numpy(jax_to_numpy(jparams), "cpu"), jparams


@functools.lru_cache(maxsize=None)
def _jax_params(name, bf16):
    """One JAX init per config (jitted: eager init takes seconds); the
    parameters do not depend on ``use_pallas``.  Read only."""
    jcfg = CONFIGS[name][1].SMOKE
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtypes=j_common.BF16)
    return jax.jit(lambda key: split_params(JT.init_lm_tree(key, jcfg))[0])(
        jax.random.PRNGKey(0))


_jforward = jax.jit(JT.forward, static_argnums=1)


def _tokens(vocab, seed=0):
    return synth.seq_batch(vocab, B, S, seed, 0)["tokens"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_match_reference_field_for_field(name, which):
    mod, jmod = CONFIGS[name]
    assert _fields(getattr(mod, which)) == _fields(getattr(jmod, which))


def test_shapes_and_dtypes_match_reference():
    assert lm_common.LM_SHAPES == j_common.LM_SHAPES
    assert lm_common.SHAPE_DEFS == j_common.SHAPE_DEFS
    assert _fields(T.TransformerConfig(1, 8, 1, 1, 8, 8, dtypes=lm_common.BF16))["dtypes"] == \
        _fields(JT.TransformerConfig(1, 8, 1, 1, 8, 8, dtypes=j_common.BF16))["dtypes"]


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_seq_batch_is_bitwise_the_reference(seed, step):
    want = j_synth.seq_batch(97, 3, 40, seed, step)
    got = synth.seq_batch(97, 3, 40, seed, step)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _layer_inputs(name):
    """A config's widths, and seeded [B, S, ...] activations for its layers."""
    cfg = CONFIGS[name][0].SMOKE
    rng = np.random.default_rng(len(name))
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.eff_kv_heads
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (hq, hkv, hkv))
    return cfg, x, q, k, v


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rmsnorm_and_rope_match_jax(name):
    cfg, x, q, _, _ = _layer_inputs(name)
    scale = np.random.default_rng(1).normal(size=(cfg.d_model,)).astype(np.float32)
    jdt = JL.Dtypes(param=jnp.float32, compute=jnp.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), jdt)
    _close(L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), cfg.dtypes), want)
    pos = np.broadcast_to(np.arange(S) + 5, (B, S))
    want = JL.rope(jnp.asarray(q), jnp.asarray(pos), cfg.rope_theta)
    _close(L.rope(torch.from_numpy(q), torch.from_numpy(pos.copy()), cfg.rope_theta), want)


def test_rmsnorm_and_rope_match_jax_in_bf16():
    cfg, x, q, _, _ = _layer_inputs("smollm")
    scale = np.random.default_rng(1).normal(size=(cfg.d_model,)).astype(np.float32)
    jx, jq = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q).astype(jnp.bfloat16)
    tx, tq = torch.from_numpy(x).bfloat16(), torch.from_numpy(q).bfloat16()
    want = JL.rmsnorm({"scale": jnp.asarray(scale).astype(jnp.bfloat16)}, jx, j_common.BF16)
    got = L.rmsnorm({"scale": torch.from_numpy(scale).bfloat16()}, tx, lm_common.BF16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=2**-7, atol=0)
    pos = np.broadcast_to(np.arange(S) + 5, (B, S))
    want = JL.rope(jq, jnp.asarray(pos), cfg.rope_theta)
    got = L.rope(tq, torch.from_numpy(pos.copy()), cfg.rope_theta)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=2**-7, atol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunked_gqa_attention_matches_jax(name):
    cfg, _, q, k, v = _layer_inputs(name)
    window = cfg.window if "local" in cfg.pattern else None
    want = JL.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                            window=window, block_q=cfg.block_q, block_k=cfg.block_k)
    got = L.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, window=window, block_q=cfg.block_q, block_k=cfg.block_k)
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("cache_len", [1, 17, S])
def test_decode_attention_matches_jax(name, cache_len):
    cfg, _, q, k, v = _layer_inputs(name)
    for window in (None, 8):
        want = JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(cache_len), window=window)
        got = L.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.tensor(cache_len), window=window)
        _close(got, want, err_msg=f"window {window}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ffn_apply_matches_jax(name):
    cfg, x, _, _, _ = _layer_inputs(name)
    jdt = JL.Dtypes(param=jnp.float32, compute=jnp.float32)
    jp = {k: np.array(v.value) for k, v in
          JM.ffn_init(jax.random.PRNGKey(2), cfg.d_model, cfg.d_ff, jdt).items()}
    want = JM.ffn_apply({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x), jdt)
    got = M.ffn_apply({k: torch.from_numpy(v) for k, v in jp.items()}, torch.from_numpy(x),
                      cfg.dtypes)
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(name, use_pallas):
    cfg, jcfg, params, jparams = _models(name, use_pallas=use_pallas)
    toks = _tokens(cfg.vocab)
    want, _ = _jforward(jparams, jcfg, jnp.asarray(toks))
    got, aux = T.forward(params, cfg, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    _close(got, want)


def test_forward_matches_jax_in_bf16():
    cfg, jcfg, params, jparams = _models("smollm", bf16=True)
    assert params["embed"]["table"].dtype == torch.bfloat16  # crossed as its bits
    toks = _tokens(cfg.vocab)
    want = np.asarray(_jforward(jparams, jcfg, jnp.asarray(toks))[0], np.float32)
    got = _np(T.forward(params, cfg, torch.from_numpy(toks))[0])
    atol = 2**-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_step_matches_jax(name):
    cfg, jcfg, params, jparams = _models(name, use_pallas=True)
    toks = _tokens(cfg.vocab, seed=1)
    want = jax.jit(JLMModel(jcfg).prefill_step)(jparams, {"tokens": jnp.asarray(toks)})
    got = LMModel(cfg).prefill_step(params, {"tokens": toks})
    assert got.shape == (B, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_steps_and_caches_match_jax(name):
    """Twelve steps from position 0 into caches of ``max_len`` S (gemma's
    local layers get 8-slot rings, which wrap), then every cache leaf."""
    cfg, jcfg, params, jparams = _models(name)
    toks = _tokens(cfg.vocab, seed=2)
    jdecode = jax.jit(JLMModel(jcfg).decode_fn)
    jcaches = JT.init_decode_caches(jcfg, B, S, dtype=jnp.float32)
    caches = T.init_decode_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    model = LMModel(cfg)
    for t in range(DECODE_STEPS):
        want, jcaches = jdecode(jparams, jcaches, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        got, caches = model.decode_fn(params, caches, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.tensor(t, dtype=torch.int32))
        assert got.shape == (B, cfg.vocab)
        _close(got, want, err_msg=f"step {t}")
    want_tree, got_tree = jax_to_numpy(jcaches), convert.to_numpy(caches)
    assert want_tree.keys() == got_tree.keys()
    for part in want_tree:
        assert want_tree[part].keys() == got_tree[part].keys()
        for layer, (wk, wv) in want_tree[part].items():
            gk, gv = got_tree[part][layer]
            assert gk.shape == wk.shape and gv.shape == wv.shape
            _close(gk, wk, err_msg=f"{part}/{layer}/k")
            _close(gv, wv, err_msg=f"{part}/{layer}/v")


def test_specs_are_meta_tensors_of_the_reference_shapes():
    cfg, jcfg = gemma3_27b.SMOKE, j_gemma.SMOKE
    want = JLMModel(jcfg).decode_specs(3, 20)
    got = LMModel(cfg).decode_specs(3, 20)
    assert got["token"].shape == want["token"].shape and got["pos"].shape == ()
    for part, layers in want["caches"].items():
        for layer, (wk, wv) in layers.items():
            gk, gv = got["caches"][part][layer]
            assert gk.device.type == "meta" and gk.shape == wk.shape and gv.shape == wv.shape
    assert LMModel(cfg).prefill_specs(3, 20)["tokens"].shape == (3, 20)
