"""The port's graph family (``nn.layers.layernorm``, ``nn/gnn.py``,
``data/graphs.py``, ``models/gatedgcn.py``, ``configs/gatedgcn.py``) against
the JAX package on the CPU, at the SMOKE config (3 layers, d_hidden 16).

The model tests start from the reference's jitted init, converted through
numpy (``convert.gatedgcn_state_from_numpy``); batches come from the
port's ``data/graphs.py``, which the builder tests hold bitwise to the
reference's.  The reference's functions are jitted once each
(``functools.lru_cache``).

Tolerances.  Forward values (LayerNorm, the layer, logits, losses) rtol
1e-5 / atol 1e-6 (fp32: torch and XLA order the matrix products' and the
segment sums' additions differently; read: 3.2e-7 of max|value|, losses
3.0e-7 relative).  LayerNorm with bf16 compute: one bf16 ulp (the fp32
values may straddle a rounding boundary).  The layer's gradients rtol
1e-5, atol 1e-6 * max|g| of the tensor (read: 2.7e-7 of max|g|, 0.14 of
the tolerance).

A ReLU input within a rounding error of 0 falls on either side of the
kink in the two packages and changes every gradient behind it (seed 0's
first molecule batch has a LayerNorm output 1.4e-7 from 0, which moved
layer gradients by up to 5 % of their max against 2.7e-7 elsewhere; a
float64 run of the port agrees with its fp32 run to 1e-6).  So every
batch here is checked to hold no ReLU input within ``RELU_GAP`` (1e-6) of
0, as ``tests/test_torch_moe.py`` checks its routers for near ties; the
molecule batches use seed 1 (smallest gap read: 1.8e-5).

Three ``train_step`` calls (Adam, lr 1e-3) on a full graph, a sampled
block and a molecule batch, free running from one converted state: the
loss rtol 1e-5 each step; parameters rtol 1e-5 / atol 2e-4 (0.2 lr), Adam's
``m`` rtol 1e-4 / atol 1e-6 and ``v`` rtol 1e-4 / atol 1e-9 (read:
parameters 2.4e-6 apart at most, ``m`` 1.2e-7, ``v`` 1.9e-8 at rtol).  A
gradient element near zero: Adam's first step is ``lr * g / (|g| +
1e-8)``, ``lr * sign(g)`` for any |g| well above 1e-8, so an element whose
gradient is at the level of the two packages' rounding noise could step by
``+lr`` in one and ``-lr`` in the other.  Such an element is one whose
gradient (recovered from the reference's moments, ``(m_t - b1 m_{t-1}) /
(1 - b1)``) is below 1e-5 * max|g| of its tensor (of its layer, in the
stacked ``[L, ...]`` leaves), the gradients' agreement, while not exactly
0 (an exactly-zero gradient, such as the graph task's unused readout
columns, gives a zero update in both).  Its parameter is held to 2.01 lr
(two updates of opposite sign; Adam moves an element by at most 1.0036 lr
a step at t <= 3, see ``tests/test_torch_lm_train.py``) instead of 0.2
lr.  Read: 6 such elements over the nine steps, each within 0.2 lr all
the same, at 1 and 8 CPU threads; the file passes at 1, 3, 4 and 8.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_to_numpy

from repro.configs import gatedgcn as j_cfg
from repro.configs import shapes as j_shapes
from repro.data import graphs as j_graphs
from repro.dist.partitioning import split_params
from repro.models.gatedgcn import GatedGCNConfig as JConfig
from repro.models.gatedgcn import GatedGCNModel as JModel
from repro.nn import gnn as JG
from repro.nn import layers as JL
from repro_torch import convert
from repro_torch.configs import gatedgcn as cfg_mod
from repro_torch.configs import shapes
from repro_torch.core.lanes import segment_sum
from repro_torch.data import graphs
from repro_torch.launch import train as launch_train
from repro_torch.models.gatedgcn import GatedGCNConfig, GatedGCNModel
from repro_torch.nn import gnn as G
from repro_torch.nn import layers as L

J32 = JL.Dtypes(param=jnp.float32, compute=jnp.float32)
T32 = L.Dtypes(param=torch.float32, compute=torch.float32)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = {"params": (1e-5, 2e-4), "m": (1e-4, 1e-6), "v": (1e-4, 1e-9)}
LR, B1 = 1e-3, 0.9
RELU_GAP = 1e-6  # a ReLU input within this of 0 is a near tie (docstring)
NEAR_ZERO = 1e-5  # a gradient below this share of its tensor's max|g| is near zero
FLIP_BOUND = 2.01 * LR  # two Adam updates of opposite sign at t <= 3


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_layernorm_matches_reference(compute):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(37, 70)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=70).astype(np.float32)
    bias = rng.normal(size=70).astype(np.float32)
    jdt = JL.Dtypes(param=jnp.float32, compute=getattr(jnp, compute))
    tdt = L.Dtypes(param=torch.float32, compute=getattr(torch, compute))
    want = JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x), jdt)
    got = L.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
                      torch.from_numpy(x), tdt)
    assert got.dtype == getattr(torch, compute)
    want = np.asarray(want.astype(jnp.float32))
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    else:  # one bf16 ulp
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=0)
    init = L.layernorm_init(70, tdt, "cpu")
    assert torch.equal(init["scale"], torch.ones(70)) and torch.equal(init["bias"],
                                                                        torch.zeros(70))


# ---------------------------------------------------------------------------
# The GatedGCN layer: forward and gradients
# ---------------------------------------------------------------------------

N_LAYER, E_LAYER, D_LAYER = 24, 80, 16


def _layer_graph(case):
    rng = np.random.default_rng({"padded": 1, "isolated": 2, "all_padding": 3}[case])
    src = rng.integers(0, N_LAYER, E_LAYER).astype(np.int32)
    dst = rng.integers(0, N_LAYER, E_LAYER).astype(np.int32)
    if case == "padded":  # padding lanes on either side and on both
        src[::7] = -1
        dst[3::11] = -1
        dst[::7] = -1
    elif case == "isolated":  # node 5 has no in-edges, node 6 none at all
        dst[dst == 5] = 4
        src[src == 6] = 7
        dst[dst == 6] = 7
        src[-4:] = -1
        dst[-4:] = -1
    else:
        src[:] = -1
        dst[:] = -1
    h = rng.normal(size=(N_LAYER, D_LAYER)).astype(np.float32)
    e = rng.normal(size=(E_LAYER, D_LAYER)).astype(np.float32)
    wh = rng.normal(size=(N_LAYER, D_LAYER)).astype(np.float32)
    we = rng.normal(size=(E_LAYER, D_LAYER)).astype(np.float32)
    return src, dst, h, e, wh, we


@functools.lru_cache(maxsize=None)
def _j_layer_params():
    init = jax.jit(lambda k: split_params(JG.gatedgcn_layer_init(k, D_LAYER, J32))[0])
    p = jax_to_numpy(init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)  # LayerNorm scales and biases off their 1 / 0 init
    for ln in ("ln_h", "ln_e"):
        p[ln] = {"scale": (1 + 0.2 * rng.normal(size=D_LAYER)).astype(np.float32),
                 "bias": (0.1 * rng.normal(size=D_LAYER)).astype(np.float32)}
    return p


@functools.lru_cache(maxsize=None)
def _j_layer_fns():
    def loss(p, h, e, src, dst, wh, we):
        ho, eo = JG.gatedgcn_layer(p, h, e, src, dst, J32)
        return jnp.sum(ho * wh) + jnp.sum(eo * we)

    fwd = jax.jit(lambda p, h, e, src, dst: JG.gatedgcn_layer(p, h, e, src, dst, J32))
    return fwd, jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def _grad_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    floor = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor, err_msg=what)


@pytest.mark.parametrize("case", ["padded", "isolated", "all_padding"])
def test_gatedgcn_layer_matches_reference(case, relu_gap):
    src, dst, h, e, wh, we = _layer_graph(case)
    p = _j_layer_params()
    fwd, grad = _j_layer_fns()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want_h, want_e = fwd(jp, jnp.asarray(h), jnp.asarray(e), jnp.asarray(src), jnp.asarray(dst))
    tp = {k: _t(v) for k, v in p.items()}
    tp = {k: {n: x.requires_grad_(True) for n, x in v.items()} for k, v in tp.items()}
    th, te = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(e).requires_grad_(True)
    got_h, got_e = G.gatedgcn_layer(tp, th, te, torch.from_numpy(src), torch.from_numpy(dst), T32)
    _assert_no_relu_near_tie(relu_gap, case)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), **FWD_TOL)
    np.testing.assert_allclose(got_e.detach().numpy(), np.asarray(want_e), **FWD_TOL)
    (torch.sum(got_h * torch.from_numpy(wh)) + torch.sum(got_e * torch.from_numpy(we))).backward()
    gp, gh, ge = grad(jp, jnp.asarray(h), jnp.asarray(e), jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(wh), jnp.asarray(we))
    _grad_close(th.grad, gh, "dh")
    _grad_close(te.grad, ge, "de")
    for k, v in jax_to_numpy(gp).items():
        for n, g in v.items():
            _grad_close(tp[k][n].grad, g, f"d{k}/{n}")
    if case == "isolated":  # no in-edges: no message, h' = h + relu(LN(U h))
        agg_free = h[5] + np.maximum(L.layernorm(
            tp["ln_h"], L.dense(tp["U"], th[5:6], T32), T32).detach().numpy()[0], 0)
        np.testing.assert_allclose(got_h[5].detach().numpy(), agg_free, rtol=1e-6, atol=1e-6)


def test_segment_sum_drops_padding_and_out_of_range_lanes():
    """The layer's and the pooling's segment sum (``core.lanes.segment_sum``)
    against ``jax.ops.segment_sum``, which drops out-of-range segments."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    seg = torch.tensor([0, 2, -1, 3, 2, 9])
    got = segment_sum(x, seg, 3)
    want = jax.ops.segment_sum(jnp.asarray(x.numpy()), jnp.asarray(seg.numpy()), num_segments=3)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The sampler and the batch builders: bitwise
# ---------------------------------------------------------------------------


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("fanouts", [(4, 3), (15, 10)])
def test_neighbor_sample_is_bitwise_the_reference(fanouts):
    indptr, indices, _ = graphs.random_graph_csr(500, 3000, 0)
    indptr[200:] = indptr[200]  # a run of nodes with no neighbours
    indptr[-1] = len(indices)
    out = []
    for fn in (G.neighbor_sample, JG.neighbor_sample):
        rng = np.random.default_rng(5)
        out.append(fn(indptr, indices, rng.integers(0, 500, 16), fanouts, rng))
    (gn, gs, gd, gb), (wn, ws, wd, wb) = out
    assert gb == wb == 16
    for g, w in ((gn, wn), (gs, ws), (gd, wd)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (gs == -1).any()


def test_neighbor_sampler_validity():
    """The reference's ``test_data_serve.py::test_neighbor_sampler_validity``
    on the port."""
    indptr, indices, _ = graphs.random_graph_csr(500, 3000, 0)
    rng = np.random.default_rng(0)
    nodes, src, dst, n_seed = graphs.neighbor_sample(
        indptr, indices, rng.integers(0, 500, 16), (4, 3), rng)
    assert n_seed == 16
    assert len(nodes) == 16 * (1 + 4 + 12)
    assert len(src) == 16 * (4 + 12)
    m = src >= 0
    assert src[m].max() < len(nodes) and dst[m].max() < len(nodes)
    assert (dst[m] >= 0).all()


@pytest.mark.parametrize("builder", ["random_graph_csr", "full_graph_batch", "sampled_batch",
                                     "molecule_batch"])
def test_batch_builders_are_bitwise_the_reference(builder):
    if builder == "random_graph_csr":
        (gi, gx, (gs, gd)), (wi, wx, (ws, wd)) = (
            m.random_graph_csr(1000, 7000, 3) for m in (graphs, j_graphs))
        _assert_batches_equal({"i": gi, "x": gx, "s": gs, "d": gd},
                              {"i": wi, "x": wx, "s": ws, "d": wd})
        return
    if builder == "full_graph_batch":
        args = (300, 1200, 12, 5, 2)
    elif builder == "molecule_batch":
        args = (16, 30, 64, 16, 0, 3)
    else:
        indptr, indices, _ = graphs.random_graph_csr(400, 2000, 1)
        rng = np.random.default_rng(0)
        feats = rng.normal(size=(400, 12)).astype(np.float32)
        labels = rng.integers(0, 5, 400).astype(np.int32)
        args = (indptr, indices, feats, labels, 32, (5, 3), 0, 4)
    _assert_batches_equal(getattr(graphs, builder)(*args), getattr(j_graphs, builder)(*args))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtypes"] = {k: (str(v).split(".")[-1] if isinstance(v, torch.dtype)
                         else jnp.dtype(v).name) for k, v in out["dtypes"].items()}
    return out


def test_configs_match_reference_field_for_field():
    assert shapes.GNN_SHAPES == j_shapes.GNN_SHAPES == tuple(cfg_mod.SHAPE_CFG)
    assert cfg_mod.SHAPE_CFG == j_cfg.SHAPE_CFG
    assert [cfg_mod._pad512(n) for n in (1, 512, 513, 2708)] == [512, 512, 1024, 3072]
    assert _fields(cfg_mod.SMOKE) == _fields(JConfig(d_feat=12, n_classes=5, n_layers=3,
                                                     d_hidden=16))
    assert [f.name for f in dataclasses.fields(GatedGCNConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    for shape, (_, _, _, d_feat, n_classes, task, _) in cfg_mod.SHAPE_CFG.items():
        kw = dict(d_feat=d_feat, n_classes=n_classes, task=task)
        assert _fields(GatedGCNConfig(**kw)) == _fields(JConfig(**kw)), shape


# ---------------------------------------------------------------------------
# The model: init, fwd, loss, train steps
# ---------------------------------------------------------------------------


def _cfgs(task):
    return (dataclasses.replace(cfg_mod.SMOKE, task=task),
            dataclasses.replace(JConfig(d_feat=12, n_classes=5, n_layers=3, d_hidden=16),
                                task=task))


@functools.lru_cache(maxsize=None)
def _j_init(task):
    """The reference's jitted init state of the SMOKE config (numpy leaves)."""
    return jax_to_numpy(jax.jit(JModel(_cfgs(task)[1]).init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _j_fns(task):
    m = JModel(_cfgs(task)[1])
    return jax.jit(m.loss_fn), jax.jit(m.train_step)


def _leaf_specs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_specs(v, f"{path}/{k}"))
        return out
    dt = tree.dtype
    return {path: (tuple(tree.shape), str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
                   else jnp.dtype(dt).name)}


@pytest.mark.parametrize("task", ["node", "graph"])
def test_init_leaves_match_reference_shapes_and_dtypes(task):
    cfg, jcfg = _cfgs(task)
    want = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    got = GatedGCNModel(cfg).init(0, device="cpu")
    assert _leaf_specs(got) == _leaf_specs(want)
    assert got["params"]["layers"]["A"]["w"].shape == (3, 16, 16)
    n, e = 40, 90
    for k, v in GatedGCNModel(cfg).input_specs(n, e, n_graphs=4).items():
        w = JModel(jcfg).input_specs(n, e, n_graphs=4)[k]
        assert v.device.type == "meta" and tuple(v.shape) == w.shape, k
        assert str(v.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, k


def _batch(kind, step):
    if kind == "full":
        return graphs.full_graph_batch(64, 256, 12, 5, step)
    if kind == "molecule":  # seed 1: seed 0's first batch has a ReLU near tie (docstring)
        return graphs.molecule_batch(8, 30, 64, 12, 1, step)
    indptr, indices, _ = graphs.random_graph_csr(200, 800, 1)
    feats = np.random.default_rng(0).normal(size=(200, 12)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 5, 200).astype(np.int32)
    return graphs.sampled_batch(indptr, indices, feats, labels, 8, (3, 2), 0, step)


TASK = {"full": "node", "sampled": "node", "molecule": "graph"}


@pytest.mark.parametrize("kind", ["full", "sampled", "molecule"])
def test_fwd_and_loss_match_reference(kind):
    task = TASK[kind]
    model = GatedGCNModel(_cfgs(task)[0])
    state = convert.gatedgcn_state_from_numpy(_j_init(task), "cpu")
    batch = _batch(kind, 0)
    jloss, _ = _j_fns(task)
    want_loss, want_logits = jloss(jax.tree_util.tree_map(jnp.asarray, _j_init(task)["params"]),
                                   _j(batch))
    loss, logits = model.loss_fn(state["params"], _t(batch))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **FWD_TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), **FWD_TOL)
    served, _ = model.serve_step(state, _t(batch))
    assert torch.equal(served, logits.detach())
    rows = 8 if task == "graph" else len(batch["feat"])
    assert tuple(logits.shape) == (rows, 5)


def _state_close(want, got, rtol, atol, what, near_zero=None):
    if isinstance(want, dict):
        for k in want:
            _state_close(want[k], got[k], rtol, atol, f"{what}/{k}",
                         None if near_zero is None else near_zero[k])
        return
    g = convert.to_numpy(got)
    assert g.dtype == want.dtype and g.shape == want.shape, what
    keep = np.ones(want.shape, bool) if near_zero is None else ~near_zero
    np.testing.assert_allclose(g[keep], want[keep], rtol=rtol, atol=atol, err_msg=what)
    if near_zero is not None and near_zero.any():
        assert np.abs(g[near_zero] - want[near_zero]).max() <= FLIP_BOUND, what


def _near_zero(m_new, m_old, stacked=False):
    """Elements whose gradient this step (recovered from the reference's
    moments) is nonzero but below ``NEAR_ZERO`` of its tensor's max (each
    layer's, in the stacked ``[L, ...]`` leaves)."""
    if isinstance(m_new, dict):
        return {k: _near_zero(m_new[k], m_old[k], stacked or k == "layers") for k in m_new}
    g = np.abs((m_new.astype(np.float64) - B1 * m_old) / (1 - B1))
    top = g.max(axis=tuple(range(1, g.ndim)), keepdims=True) if stacked else g.max()
    return (g != 0) & (g < NEAR_ZERO * top)


@pytest.fixture
def relu_gap(monkeypatch):
    """Records the smallest |LayerNorm output| of each GatedGCN layer call:
    the ReLU's input, whose sign two packages may round apart near 0."""
    seen = []
    impl = G.layernorm

    def recorded(*args, **kw):
        y = impl(*args, **kw)
        seen.append(float(y.detach().abs().min()))
        return y

    monkeypatch.setattr(G, "layernorm", recorded)
    return seen


def _assert_no_relu_near_tie(seen, what):
    gap = min(seen)
    seen.clear()
    assert gap > RELU_GAP, f"seeded input has a ReLU near tie ({what}: |x| {gap})"


@pytest.mark.parametrize("kind", ["full", "sampled", "molecule"])
def test_train_steps_match_reference(kind, relu_gap):
    task = TASK[kind]
    model = GatedGCNModel(_cfgs(task)[0])
    jstate = jax.tree_util.tree_map(jnp.asarray, _j_init(task))
    state = convert.gatedgcn_state_from_numpy(_j_init(task), "cpu")
    _, jstep = _j_fns(task)
    m_old = _j_init(task)["opt"]["m"]
    for step in range(3):
        batch = _batch(kind, step)
        jstate, jm = jstep(jstate, _j(batch))
        state, m = model.train_step(state, _t(batch))
        _assert_no_relu_near_tie(relu_gap, f"step {step}")
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **FWD_TOL,
                                   err_msg=f"step {step} loss")
        want = jax_to_numpy(jstate)
        assert int(state["step"]) == int(want["step"]) == step + 1
        near = _near_zero(want["opt"]["m"], m_old)
        _state_close(want["params"], state["params"], *STATE_TOL["params"], f"{step} params",
                     near)
        for k in ("m", "v"):
            _state_close(want["opt"][k], state["opt"][k], *STATE_TOL[k], f"{step} opt/{k}")
        m_old = want["opt"]["m"]


def test_reference_smoke_on_the_port():
    """The reference's ``configs.gatedgcn.smoke()`` on the port: a train step
    on a full graph, then one on a sampled block, both finite."""
    m = GatedGCNModel(cfg_mod.SMOKE)
    st = m.init(0, device="cpu")
    st, metrics = m.train_step(st, _t(graphs.full_graph_batch(64, 256, 12, 5)))
    indptr, indices, _ = graphs.random_graph_csr(200, 800, 1)
    sb = graphs.sampled_batch(indptr, indices, np.random.default_rng(0).normal(
        size=(200, 12)).astype("float32"), np.zeros(200, "int32"), 8, (3, 2), 0, 0)
    st, m2 = m.train_step(st, _t(sb))
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(m2["loss"]))
    assert int(st["step"]) == 2


def test_launcher_trains_gatedgcn_on_the_cpu():
    trainer = launch_train.main(["--arch", "gatedgcn", "--device", "cpu", "--steps", "2"])
    losses = [r["loss"] for r in trainer.history]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("flag,msg", [
    (["--cache-policy", "lru"], "--cache-policy needs a collection-backed arch; gatedgcn has "
                                "no embedding cache"),
    (["--refresh-interval", "2"], "--refresh-interval needs a collection-backed arch; gatedgcn "
                                  "has no cached slabs to re-rank"),
    (["--pipeline-depth", "2"], "--pipeline-depth needs a collection-backed arch; gatedgcn has "
                                "no split plan/compute step"),
])
def test_launcher_gatedgcn_rejects_cache_flags(flag, msg):
    with pytest.raises(SystemExit, match=msg):
        launch_train.main(["--arch", "gatedgcn", "--device", "cpu", "--steps", "1", *flag])
