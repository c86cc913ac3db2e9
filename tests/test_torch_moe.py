"""The port's top-k Mixture-of-Experts (``repro_torch.nn.moe``) against
``repro.nn.moe`` on the CPU, from the reference's ``moe_init`` converted
through numpy and numpy-seeded inputs.

Covered: ``moe_capacity``; ``moe_init``'s shapes and its dtypes with and
without ``promote`` (the reference's bf16 init gives fp32 matrices);
``moe_apply`` at ``dp_groups`` 1 and 2 and capacity factors with and
without drops (the drops counted from the reference's routing); the
output, the aux loss and the gradients of the parameters and the input;
``moe_apply_shard_map`` against the reference run under a (1, 1)
("data", "model") mesh, and against ``moe_apply`` at olmoe SMOKE's shape.

Tolerances: fp32, rtol and atol 1e-5 (torch and XLA sum the router and
expert products in different orders).  ``jax.lax.top_k`` breaks ties
toward the lower index and ``torch.topk`` promises no order, and router
probabilities an ulp apart can swap near-tied experts: every input here is
checked to have a gap of at least 1e-5 between each token's k-th and
(k+1)-th router probability, so no near tie exists.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmoe_1b_7b as j_olmoe
from repro.dist import partitioning as dist
from repro.dist.partitioning import split_params
from repro.nn import layers as JL
from repro.nn import moe as JM
from repro_torch.configs import lm_common, olmoe_1b_7b
from repro_torch.nn import moe as M
from repro_torch.nn.layers import Dtypes

TOL = 1e-5
F32 = Dtypes(param=torch.float32, compute=torch.float32)
JF32 = JL.Dtypes(param=jnp.float32, compute=jnp.float32)
# (d, ff, experts, top_k): olmoe SMOKE's and grok SMOKE's widths
WIDTHS = {"olmoe": (64, 32, 8, 4), "grok": (64, 128, 8, 2)}


def _inputs(name, b=2, s=32, seed=0):
    d, ff, e, k = WIDTHS[name]
    jp, _ = split_params(JM.moe_init(jax.random.PRNGKey(seed), d, ff, e, JF32))
    p = {n: np.asarray(v) for n, v in jp.items()}
    x = np.random.default_rng(seed + 1).normal(size=(b, s, d)).astype(np.float32)
    _assert_no_near_ties(p, x, k)
    return p, x, k


def _assert_no_near_ties(p, x, k):
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1])) @ p["router"], -1)
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    gap = top[:, k - 1] - top[:, k]
    assert gap.min() > 1e-5, f"seeded input has a near tie in the router (gap {gap.min()})"


def _dropped(p, x, k, cf, groups):
    """Pairs past their expert's capacity under the reference's routing."""
    e = p["router"].shape[-1]
    xt = x.reshape(groups, -1, x.shape[-1])
    cap = JM.moe_capacity(xt.shape[1], e, k, cf)
    idx = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt) @ p["router"], -1), k)[1])
    counts = np.stack([np.bincount(i.reshape(-1), minlength=e) for i in idx])
    return int(np.maximum(counts - cap, 0).sum())


def _t(tree):
    return {n: torch.from_numpy(v.copy()) for n, v in tree.items()}


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=err_msg)


def test_moe_capacity_matches_reference():
    for t in (1, 7, 16, 64, 100, 4096, 16384):
        for e, k, cf in ((8, 4, 1.25), (64, 8, 1.25), (8, 2, 0.5), (8, 2, 4.0)):
            assert M.moe_capacity(t, e, k, cf) == JM.moe_capacity(t, e, k, cf)


@pytest.mark.parametrize("promote", [False, True])
def test_moe_init_shapes_and_dtypes(promote):
    bf16 = lm_common.BF16
    want, _ = split_params(jax.eval_shape(
        lambda: JM.moe_init(jax.random.PRNGKey(0), 64, 32, 8, JL.Dtypes(
            param=jnp.bfloat16, compute=jnp.bfloat16))))
    got = M.moe_init(torch.Generator().manual_seed(0), 64, 32, 8, bf16, torch.device("cpu"),
                     lead=(3,), promote=promote)
    for n, w in want.items():
        assert tuple(got[n].shape) == (3,) + w.shape, n
        # the reference multiplies a bf16 draw by an fp32 array: fp32 matrices
        assert got[n].dtype == (torch.float32 if promote else torch.bfloat16), n
        assert w.dtype == jnp.float32, n


def _loss_and_grads(fn, p, x, cot):
    pt = {n: v.clone().requires_grad_(True) for n, v in p.items()}
    xt = x.clone().requires_grad_(True)
    out, aux = fn(pt, xt)
    ((out * cot).sum() + 0.01 * aux).backward()
    return out, aux, {n: v.grad for n, v in pt.items()}, xt.grad


def _jloss_and_grads(fn, p, x, cot):
    def loss(p_, x_):
        out, aux = fn(p_, x_)
        return (out * cot).sum() + 0.01 * aux, (out, aux)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (out, aux)), (gp, gx) = step({n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    return out, aux, gp, gx


def _check(got, want, what):
    out, aux, gp, gx = got
    wout, waux, wgp, wgx = want
    _close(out, wout, f"{what} output")
    _close(aux, waux, f"{what} aux")
    _close(gx, wgx, f"{what} grad x")
    for n in wgp:
        _close(gp[n], wgp[n], f"{what} grad {n}")


@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [4.0, 0.5])  # no drops / drops
def test_moe_apply_matches_reference(name, groups, cf):
    p, x, k = _inputs(name)
    assert (_dropped(p, x, k, cf, groups) > 0) == (cf < 1), "the case's drops"
    cot = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    want = _jloss_and_grads(lambda p_, x_: JM.moe_apply(
        p_, x_, JF32, top_k=k, capacity_factor=cf, dp_groups=groups), p, x, jnp.asarray(cot))
    got = _loss_and_grads(lambda p_, x_: M.moe_apply(
        p_, x_, F32, top_k=k, capacity_factor=cf, dp_groups=groups), _t(p),
        torch.from_numpy(x), torch.from_numpy(cot))
    _check(got, want, f"{name} G {groups} cf {cf}")


@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_shard_map_matches_reference_on_a_one_by_one_mesh(name, cf):
    p, x, k = _inputs(name, seed=3)
    cot = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with dist.axis_rules(mesh, {"batch": ("data",)}):
        want = _jloss_and_grads(lambda p_, x_: JM.moe_apply_shard_map(
            p_, x_, JF32, top_k=k, capacity_factor=cf, data_axes=("data",)), p, x,
            jnp.asarray(cot))
    got = _loss_and_grads(lambda p_, x_: M.moe_apply_shard_map(
        p_, x_, F32, top_k=k, capacity_factor=cf), _t(p), torch.from_numpy(x),
        torch.from_numpy(cot))
    _check(got, want, f"{name} shard_map cf {cf}")


def test_shard_map_route_equals_global_route_at_olmoe_smoke_shape():
    cfg = olmoe_1b_7b.SMOKE
    assert dataclasses.asdict(cfg)["capacity_factor"] == j_olmoe.SMOKE.capacity_factor
    p, x, k = _inputs("olmoe", seed=5)
    assert k == cfg.top_k and x.shape[-1] == cfg.d_model
    pt, xt = _t(p), torch.from_numpy(x)
    out, aux = M.moe_apply(pt, xt, F32, top_k=k, capacity_factor=cfg.capacity_factor)
    out2, aux2 = M.moe_apply_shard_map(pt, xt, F32, top_k=k,
                                       capacity_factor=cfg.capacity_factor)
    torch.testing.assert_close(out2, out, rtol=TOL, atol=TOL)
    torch.testing.assert_close(aux2, aux, rtol=TOL, atol=TOL)
