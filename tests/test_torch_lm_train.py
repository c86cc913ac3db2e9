"""The port's LM training, MoE layers and int8 KV-cache decode against the
JAX package on the CPU, at the SMOKE configs of the five LM archs
(smollm-360m, gemma3-27b, internlm2-20b, olmoe-1b-7b, grok-1-314b).

Each config starts from one jitted JAX init, converted through numpy
(``convert.lm_state_from_numpy``): the parameters, AdamW's zero moments,
the step and the int8 compressor's zero error feedback.  Batches come from
``seq_batch``, bitwise the same in both packages.

Covered: the new configs field for field; the training state's dtypes
for a BF16 config (fp32 matrices and moments, bf16 embedding table and
norm scales, as the reference's init gives them); ``softmax_xent``; three
``LMModel.train_step`` calls for each config with ``use_pallas`` off and on
and each compressor (``none`` / ``bf16`` / ``int8``) in turn: the loss and
metrics, and the whole state after every step; remat (each group layer's
attention runs twice a step, the state bitwise a run without remat); the
reference's ``test_models_smoke.py`` LM archs (a train step, then a decode
step) on the port alone; int8 KV-cache decode (16 teacher-forced steps and
the caches after them; the int8 attention's integer accumulators, exact);
and the launcher's LM archs.

Tolerances: losses and metrics rtol 1e-5 (torch and XLA sum matrix
products in different orders; read: 7e-7 for losses, 7e-6 for gradient
norms).  The state after each step: parameters within rtol 1e-5 / atol
2e-4 (0.2 lr), ``m`` within rtol 1e-4 / atol 1e-4, ``v`` within rtol
1e-4 / atol 1e-7, and the int8 error feedback within atol 1e-3 (read:
1.6e-4, 7.1e-5, 3.3e-8 and 7.1e-4).  AdamW's step ``lr * m / (sqrt(v) +
1e-8)`` has slope ``lr / 1e-8`` at a zero gradient, so a gradient element
within ~1e-8 of zero turns a last-bit difference into a visible one; and
a compressor's rounding (one bf16 ulp) falls either way for gradients
that agree to ~1e-6.

The int8 compressor's rounding is held apart.  Its code is
``round((g + e) / s)`` with the code step ``s = max|g + e| / 127`` of the
tensor, and an element whose ``(g + e) / s`` lies within the two
packages' difference (~1e-6 relative) of a half-integer lands on the
other code in one of them: it is "flipped".  A flip moves that element's
update and, through the error feedback, its next gradient, so free-running
steps compound flips (read: smollm reached 142 flipped elements at step
2) and the metrics drift with the CPU's thread count.  So the int8 cases
start every step from the reference's state (converted afresh), and each
step's flips are named and bounded:

* flipped: the error feedback ``comp`` differs by more than half a code
  step (``s`` as the port's encode computed it); no element may differ by
  more than one code (1.5 s);
* the count: a flip needs ``(g + e) / s`` within ``|d((g + e) / s)| <=
  254 r`` of a half-integer when both ``g + e`` and ``s`` agree within
  rtol ``r`` = 1e-5 (``|g + e| <= 127 s``), a band of ``508 r`` of each
  unit, so at most ``1 + 508 r n`` of a tensor's ``n`` elements (read:
  0-5 of grok's 451 904 a step, and at most 2 in one tensor, at 1, 3, 4
  and 8 CPU threads);
* a flipped element's parameter lies within one AdamW update of its
  value before the step.  With ``m_t = (1 - b1) sum_i b1^(t-i) g_i`` and
  ``v_t = (1 - b2) sum_i b2^(t-i) g_i^2``, Cauchy-Schwarz gives
  ``|m_t / (1 - b1^t)| / sqrt(v_t / (1 - b2^t)) <= c_t = (1 - b1) / (1 -
  b1^t) * sqrt((1 - b2^t) / (1 - b2) * sum_{k<t} (b1^2 / b2)^k)``, so a
  step moves an element by at most ``lr * c_t`` plus its weight decay
  ``lr * 0.01 * |p|`` (c_1 = 1, c_2 = 1.0013, c_3 = 1.0036 at the
  default betas), and by the rounding of ``p`` to its dtype;
* a flipped element's moments: the decoded gradients differ by one code,
  so ``m`` by ``(1 - b1) s`` and ``v`` by ``(1 - b2) |q_a^2 - q_b^2| s^2
  <= (1 - b2) 255 s^2``, each within its own tolerance on top;
* every element that is not flipped keeps the tolerances above.

The ``none`` and ``bf16`` cases run their 3 steps free, from one
converted state (the stronger check), and pass at any thread count.  MoE configs route by
``top_k`` over router probabilities: the seeds here give no token a near
tie between its k-th and (k+1)-th expert (``tests/test_torch_moe.py``
checks the gap on its inputs), and a swapped expert would show as a loss
off by far more than the tolerance.  int8 decode: cache codes within one
code; cache scales within 2e-6 relative (a scale is max|k| / 127, and
the two packages' k and v agree to ~1e-6 relative a few layers in; read:
1.34e-6); logits within rtol 1e-4 / atol 1e-3 * max|logit|, an eighth of
one int8 code step (1/127): each step quantises q, k, v and the attention
weights, and a value that the two packages compute ~1e-6 apart can round
to neighbouring codes, which moves that term by one code (read: 4.1e-4 *
max|logit| on smollm, whose 9th step has such a rounding; at most 1.2e-6
on the others).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_to_numpy

from repro.configs import gemma3_27b as j_gemma
from repro.configs import grok_1_314b as j_grok
from repro.configs import internlm2_20b as j_intern
from repro.configs import lm_common as j_common
from repro.configs import olmoe_1b_7b as j_olmoe
from repro.configs import smollm_360m as j_smollm
from repro.data import synth as j_synth
from repro.dist.partitioning import split_params
from repro.models import common as j_models_common
from repro.models.lm import LMModel as JLMModel
from repro.nn import transformer as JT
from repro_torch import convert
from repro_torch.configs import (gemma3_27b, grok_1_314b, internlm2_20b, lm_common, olmoe_1b_7b,
                                 smollm_360m)
from repro_torch.data import synth
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import common
from repro_torch.models.lm import LMModel
from repro_torch.nn import transformer as T

CONFIGS = {"smollm": (smollm_360m, j_smollm), "gemma3": (gemma3_27b, j_gemma),
           "internlm2": (internlm2_20b, j_intern), "olmoe": (olmoe_1b_7b, j_olmoe),
           "grok": (grok_1_314b, j_grok)}
ARCHS = {"smollm": "smollm-360m", "gemma3": "gemma3-27b", "internlm2": "internlm2-20b",
         "olmoe": "olmoe-1b-7b", "grok": "grok-1-314b"}
LR = 1e-3  # the reference launcher's LM learning rate
B, S, STEPS = 2, 32, 3
# (config, use_pallas, compressor): every config with the kernel off and on,
# every compressor with both
TRAIN_CASES = [("smollm", False, "none"), ("smollm", True, "int8"),
               ("gemma3", False, "bf16"), ("gemma3", True, "none"),
               ("internlm2", False, "int8"), ("internlm2", True, "bf16"),
               ("olmoe", False, "none"), ("olmoe", True, "int8"),
               ("grok", False, "int8"), ("grok", True, "bf16")]
STATE_TOL = {"params": (1e-5, 2e-4), "m": (1e-4, 1e-4), "v": (1e-4, 1e-7)}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtypes"] = {k: (jnp.dtype(v).name if not isinstance(v, torch.dtype)
                         else str(v).split(".")[-1]) for k, v in out["dtypes"].items()}
    return out


@pytest.mark.parametrize("name", ["olmoe", "grok"])
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_moe_configs_match_reference_field_for_field(name, which):
    mod, jmod = CONFIGS[name]
    assert _fields(getattr(mod, which)) == _fields(getattr(jmod, which))


def _leaf_dtypes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_dtypes(v, f"{path}/{k}"))
        return out
    dt = tree.dtype
    return {path: (tuple(tree.shape), str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
                   else jnp.dtype(dt).name)}


@pytest.mark.parametrize("name", ["smollm", "olmoe"])
def test_bf16_train_state_dtypes_match_reference(name):
    mod, jmod = CONFIGS[name]
    cfg = dataclasses.replace(mod.SMOKE, dtypes=lm_common.BF16)
    jcfg = dataclasses.replace(jmod.SMOKE, dtypes=j_common.BF16)
    want = jax.eval_shape(JLMModel(jcfg, compressor="int8").init, jax.random.PRNGKey(0))
    got = LMModel(cfg, compressor="int8").init(0, device="cpu")
    assert sorted(got) == sorted(want) == ["comp", "opt", "params", "step"]
    for part in want:
        assert _leaf_dtypes(got[part]) == _leaf_dtypes(want[part]), part
    params = _leaf_dtypes(got["params"])
    assert params["/embed/table"][1] == "bfloat16" and params["/head/w"][1] == "float32"
    # serving keeps every leaf in dtypes.param
    served = T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {d for _, d in _leaf_dtypes(served).values()} == {"bfloat16"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    want = j_models_common.softmax_xent(jl, jnp.asarray(labels))
    got = common.softmax_xent(torch.from_numpy(logits).to(getattr(torch, dtype)),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """One jitted JAX init of a SMOKE config's parameters (read only)."""
    jcfg = CONFIGS[name][1].SMOKE
    return jax.jit(lambda key: split_params(JT.init_lm_tree(key, jcfg))[0])(
        jax.random.PRNGKey(0))


def _jax_state(name, compressor):
    """The reference's ``LMModel.init`` state over the cached parameters:
    zero fp32 moments and error feedback, step 0."""
    params = _jax_params(name)
    zeros = jax.tree_util.tree_map(lambda p: jnp.zeros_like(p, jnp.float32), params)
    state = {"params": params, "opt": {"m": zeros, "v": zeros}, "step": jnp.int32(0)}
    if compressor == "int8":
        state["comp"] = zeros
    return state


def _batch(vocab, step, seed=0):
    return synth.seq_batch(vocab, B, S, seed, step)


def _close_tree(want, got, rtol, atol, what):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), what
        for k in want:
            _close_tree(want[k], got[k], rtol, atol, f"{what}/{k}")
        return
    g = convert.to_numpy(got)
    assert g.dtype == want.dtype and g.shape == want.shape, what
    np.testing.assert_allclose(g, want, rtol=rtol, atol=atol, err_msg=what)


class _ScaleRecorder:
    """The port's compressor, keeping the sideband (each tensor's int8 code
    step) of its last encode."""

    def __init__(self, inner):
        self.inner, self.codec, self.scales = inner, inner.codec, None

    def init(self, grads_like):
        return self.inner.init(grads_like)

    def encode(self, grads, state):
        payload, self.scales, new_state = self.inner.encode(grads, state)
        return payload, self.scales, new_state

    def decode(self, payload, sideband, target_like):
        return self.inner.decode(payload, sideband, target_like)


def _adam_step_bound(t, b1=0.9, b2=0.999):
    """c_t: the most |m_hat| / sqrt(v_hat) can be after t AdamW steps
    (the module docstring's Cauchy-Schwarz bound)."""
    series = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / (1 - b1 ** t) * np.sqrt((1 - b2 ** t) / (1 - b2) * series)


def _flat(tree, path=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: convert.to_numpy(tree)}


def _int8_step_close(want, before, got, scales, t):
    """One int8 step's state, leaf by leaf: the flipped elements named and
    bounded, every other element at the free-running tolerances.  Returns
    the flips a leaf."""
    trees = {"p0": before["params"], "w": want["params"], "g": got["params"],
             "wm": want["opt"]["m"], "gm": got["opt"]["m"], "wv": want["opt"]["v"],
             "gv": got["opt"]["v"], "we": want["comp"], "ge": got["comp"], "s": scales}
    flat = {k: _flat(v) for k, v in trees.items()}
    flips = {}
    for path, s in flat["s"].items():
        x = {k: v[path] for k, v in flat.items()}
        s = float(s)
        for k in ("g", "gm", "gv", "ge"):
            w = "w" + k[1:]
            assert x[k].dtype == x[w].dtype and x[k].shape == x[w].shape, (path, k)
        d_comp = np.abs(x["ge"].astype(np.float64) - x["we"])
        assert d_comp.max() < 1.5 * s, f"{path}: error feedback more than one code apart"
        flip = d_comp > 0.5 * s
        n = flips[path] = int(flip.sum())
        assert n <= 1 + 508 * 1e-5 * flip.size, f"{path}: {n} of {flip.size} elements flipped"
        keep = ~flip
        for g, w, (rtol, atol) in (("g", "w", STATE_TOL["params"]), ("gm", "wm", STATE_TOL["m"]),
                                   ("gv", "wv", STATE_TOL["v"]), ("ge", "we", (0.0, 1e-3))):
            np.testing.assert_allclose(x[g][keep], x[w][keep], rtol=rtol, atol=atol,
                                       err_msg=f"{path} {g}")
        if not n:
            continue
        p0, p1 = x["p0"][flip].astype(np.float64), x["g"][flip].astype(np.float64)
        ulp = np.finfo(x["g"].dtype).eps
        bound = LR * (_adam_step_bound(t) + 0.01 * np.abs(p0)) + 2 * ulp * np.abs(p0)
        assert (np.abs(p1 - p0) <= bound * (1 + 1e-6)).all(), f"{path}: flipped update"
        d_m = np.abs(x["gm"][flip] - x["wm"][flip])
        d_v = np.abs(x["gv"][flip] - x["wv"][flip])
        assert (d_m <= 0.1 * s * 1.01 + STATE_TOL["m"][1]).all(), f"{path}: flipped m"
        assert (d_v <= 1e-3 * 255 * s * s * 1.01 + STATE_TOL["v"][1]).all(), f"{path}: flipped v"
    return flips


@pytest.mark.parametrize("name,use_pallas,compressor", TRAIN_CASES)
def test_train_steps_match_reference(name, use_pallas, compressor):
    mod, jmod = CONFIGS[name]
    cfg = dataclasses.replace(mod.SMOKE, use_pallas=use_pallas)
    jcfg = dataclasses.replace(jmod.SMOKE, use_pallas=use_pallas)
    jmodel = JLMModel(jcfg, lr=LR, compressor=compressor)
    model = LMModel(cfg, lr=LR, compressor=compressor)
    model.compressor = recorder = _ScaleRecorder(model.compressor)
    jstate = _jax_state(name, compressor)
    state = convert.lm_state_from_numpy(jax_to_numpy(jstate), "cpu")
    jstep = jax.jit(jmodel.train_step)
    flips = []  # int8: flipped elements a leaf, a step
    for step in range(STEPS):
        batch = _batch(cfg.vocab, step)
        before = jax_to_numpy(jstate)
        if compressor == "int8":  # each step from the reference's state
            state = convert.lm_state_from_numpy(before, "cpu")
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = model.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "xent", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {k}")
        want = jax_to_numpy(jstate)
        assert int(state["step"]) == int(want["step"]) == step + 1
        if compressor == "int8":
            flips.append(_int8_step_close(want, before, state, recorder.scales, step + 1))
            continue
        _close_tree(want["params"], state["params"], *STATE_TOL["params"], f"{step} params")
        for k in ("m", "v"):
            _close_tree(want["opt"][k], state["opt"][k], *STATE_TOL[k], f"{step} opt/{k}")
        assert "comp" not in state
    if compressor == "int8":
        print(f"{name}: flipped elements a step {[sum(f.values()) for f in flips]}, at most "
              f"{max(max(f.values()) for f in flips)} in one tensor")


def _count_attention(monkeypatch):
    calls = []
    impl = fa_ops.flash_attention

    def counted(*args, **kw):
        calls.append(1)
        return impl(*args, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("name", ["smollm", "gemma3"])
def test_remat_recomputes_each_group_layer_and_changes_nothing(name, monkeypatch):
    """With ``remat`` each group layer's attention runs in the forward and
    again in the backward's recompute (the remainder layers once, as the
    reference's ``jax.checkpoint`` wraps the groups only); the new state is
    bitwise a run without remat."""
    cfg = dataclasses.replace(CONFIGS[name][0].SMOKE, use_pallas=True)
    states, counts = [], []
    for remat in (True, False):
        model = LMModel(dataclasses.replace(cfg, remat=remat), lr=LR)
        state = model.init(0, device="cpu")
        calls = _count_attention(monkeypatch)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 0).items()}
        state, _ = model.train_step(state, batch)
        states.append(convert.to_numpy(state))
        counts.append(len(calls))
    grouped = cfg.n_groups * len(cfg.pattern)
    assert counts == [2 * grouped + cfg.n_rem, grouped + cfg.n_rem]
    for part in ("params", "opt"):
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                               states[0][part], states[1][part])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_smoke_train_then_decode(name):
    """The reference's ``test_models_smoke.py`` LM case on the port: one
    train step and one decode step of the SMOKE config, finite."""
    cfg = CONFIGS[name][0].SMOKE
    model = LMModel(cfg, lr=LR)
    state = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    state, metrics = model.train_step(state, {"tokens": toks,
                                              "labels": torch.roll(toks, -1, dims=1)})
    caches = T.init_decode_caches(cfg, 2, 16, dtype=torch.float32, device="cpu")
    logits, _ = model.decode_fn(state["params"], caches, toks[:, :1],
                                torch.zeros((), dtype=torch.int32))
    assert logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(logits).all())


@functools.lru_cache(maxsize=None)
def _jdecode(name):
    jcfg = dataclasses.replace(CONFIGS[name][1].SMOKE, kv_cache_int8=True)
    return jcfg, jax.jit(JLMModel(jcfg).decode_fn)


@pytest.mark.parametrize("name", ["smollm", "gemma3", "olmoe"])
def test_int8_decode_matches_reference(name):
    """16 teacher-forced steps from position 0 into int8 caches of 32 slots
    (gemma's local layers get 8-slot rings, which wrap): logits at every
    step, then every cache leaf."""
    cfg = dataclasses.replace(CONFIGS[name][0].SMOKE, kv_cache_int8=True)
    jcfg, jdecode = _jdecode(name)
    jparams = _jax_params(name)
    params = convert.lm_params_from_numpy(jax_to_numpy(jparams), "cpu")
    toks = _batch(cfg.vocab, 0, seed=2)["tokens"]
    jcaches = JT.init_decode_caches(jcfg, B, S)
    caches = T.init_decode_caches(cfg, B, S, device="cpu")
    model = LMModel(cfg)
    for t in range(16):
        want, jcaches = jdecode(jparams, jcaches, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        got, caches = model.decode_fn(params, caches, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.tensor(t, dtype=torch.int32))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-3 * float(np.abs(want).max()), err_msg=f"step {t}")
    want_tree, got_tree = jax_to_numpy(jcaches), convert.to_numpy(caches)
    for part in want_tree:
        for layer, leaves in want_tree[part].items():
            got_leaves = got_tree[part][layer]
            assert len(leaves) == len(got_leaves) == 4
            for i, (w, g) in enumerate(zip(leaves, got_leaves)):
                assert g.dtype == w.dtype and g.shape == w.shape, (part, layer, i)
                if i < 2:  # codes
                    assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
                else:  # scales
                    np.testing.assert_allclose(g, w, rtol=2e-6, atol=0)


@pytest.mark.parametrize("s_cache", [40, 2304])  # one chunk; three chunks of 1024, padded
def test_int8_attention_matches_reference_with_exact_accumulators(s_cache):
    rng = np.random.default_rng(s_cache)
    b, hkv, g, hd = 2, 2, 3, 20
    q = rng.normal(size=(b, 1, hkv * g, hd)).astype(np.float32)
    kc, vc = (rng.integers(-127, 128, size=(b, s_cache, hkv, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.05, size=(b, s_cache, hkv)).astype(np.float32)
              for _ in range(2))
    valid = s_cache - 3
    want = JT._decode_attention_i8(*(jnp.asarray(a) for a in (q, kc, vc, ks, vs)),
                                   jnp.int32(valid))
    parts = T._attention_i8_parts(*(torch.from_numpy(a) for a in (q, kc, vc, ks, vs)),
                                  torch.tensor(valid))
    np.testing.assert_allclose(parts["out"].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    jq8, _ = JT._quant_i8(jnp.asarray(q).reshape(b, hkv, g, hd))
    assert np.array_equal(parts["q8"].numpy(), np.asarray(jq8))
    # the accumulators equal the exact integer dots of the port's own codes
    raw = np.einsum("bhgd,bshd->bhgs", parts["q8"].numpy().astype(np.int64),
                    kc.astype(np.int64))
    acc = np.einsum("bhgs,bshd->bhgd", parts["w8"].numpy().astype(np.int64),
                    vc.astype(np.int64))
    assert parts["raw"].dtype == parts["acc"].dtype == torch.int32
    assert np.array_equal(parts["raw"].numpy(), raw) and np.array_equal(parts["acc"].numpy(), acc)


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b"])
def test_train_launcher_trains_lm_archs(arch, capsys, monkeypatch):
    """The reference launcher's LM path: the SMOKE config at lr 1e-3 on
    ``seq_batch(vocab, 8, 64, 0, step)``, through the serial ``Trainer``:
    three finite losses, and the loss falls (each step's batch differs, so
    the loss of step 0's batch is taken before and after the three)."""
    states = []
    run = launch_train.Trainer.run
    monkeypatch.setattr(launch_train.Trainer, "run", lambda self: states.append(run(self))
                        or states[-1])
    trainer = launch_train.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert f"arch={arch} steps=3" in capsys.readouterr().out
    model, make_batch = launch_train.build_lm(arch)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(0).items()}
    with torch.no_grad():
        before = float(model.loss_fn(model.init(0, device="cpu")["params"], batch)[0])
        after = float(model.loss_fn(states[0]["params"], batch)[0])
    assert before == pytest.approx(losses[0], rel=1e-6) and after < before


@pytest.mark.parametrize("flag,message", [
    (["--cache-policy", "lru"], "--cache-policy needs a collection-backed arch"),
    (["--refresh-interval", "2"], "--refresh-interval needs a collection-backed arch"),
    (["--pipeline-depth", "2"], "--pipeline-depth needs a collection-backed arch"),
])
def test_train_launcher_rejects_cache_flags_for_lm_archs(flag, message):
    with pytest.raises(SystemExit, match=message):
        launch_train.main(["--arch", "olmoe-1b-7b", "--steps", "1", "--device", "cpu", *flag])


def test_seq_batch_of_the_launcher_is_the_reference_batch():
    want = j_synth.seq_batch(256, 8, 64, 0, 2)
    got = synth.seq_batch(256, 8, 64, 0, 2)
    assert all(np.array_equal(got[k], want[k]) for k in want)
