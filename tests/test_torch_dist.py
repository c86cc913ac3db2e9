"""Hybrid parallel over ranks (``launch.mesh``, ``dist.*``, the sharded
collection under a mesh): one cache shard a process, held bitwise to the
one-process stacked layout and, through it, the unsharded port, and within
rtol 1e-5 to the reference's single-device losses.

The rank tests spawn one gloo world of CPU ranks per shard count (S 1, 2
and 4) through ``repro_torch.dist.run`` and run every job of that S in it;
the ranks and the in-process references run on one torch thread each.
Configs: the reference's own mesh test (``tests/test_sharded.py``:
vocab (2048, 256), dim 8, batch 16, cache 0.15, lr 0.2, 6 steps) with
K 0, K 8 and the int8 exchange; the collection lookups of
``tests/test_torch_sharded.py``'s small tables; BENCH_PR7's exchange count.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_rank_jobs as rank_jobs
from torch_parity import TRACKER_FLOATS, TRACKER_RTOL, jax_to_numpy

from repro.core import collection as jcol
from repro.core.sharded import ShardedEmbeddingCollection as JSharded
from repro.launch.mesh import make_hybrid_mesh as jax_make_hybrid_mesh
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro_torch import convert
from repro_torch.core import collection as col
from repro_torch.core.collection import SHARED_ARENA, FeatureBatch
from repro_torch.core.sharded import ShardedEmbeddingCollection, _shard
from repro_torch.data import synth
from repro_torch.dist import group, run
from repro_torch.dist.exchange import compact_route
from repro_torch.dist.partitioning import (P, hybrid_rules, shard_state, sharded_paths,
                                           spec_leaves, unshard_state)
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.dist.mesh import HybridMesh, check_mesh_shape
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.train import checkpoint as ckpt

BASE = dict(vocab_sizes=(2048, 256), embed_dim=8, batch_size=16, cache_ratio=0.15, lr=0.2,
            bottom_mlp=(16, 8), top_mlp=(16,))
STEPS = 6
CKPT_STEPS = 3
SERVE = 2
CASES = {"k0": {}, "k8": dict(replicate_top_k=8),
         "int8": dict(replicate_top_k=8, exchange_codec="int8"),
         # the row leg at a compact width (a batch routes at most 21 distinct rows)
         "k8w": dict(replicate_top_k=8, max_routed_per_shard=24),
         "int8w": dict(replicate_top_k=8, exchange_codec="int8", max_routed_per_shard=24)}
BENCH = dict(vocab_sizes=(65536, 32768, 16384, 16384), embed_dim=32, batch_size=2048,
             cache_ratio=0.1, lr=0.5, bottom_mlp=(64, 32), top_mlp=(64,), replicate_top_k=2048)


@pytest.fixture(autouse=True)
def one_thread():
    """The in-process references on one thread, as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(S, case):
    return DLRMConfig(**BASE, model_shards=S, **CASES[case])


def _bench_cfg(S):
    lanes = BENCH["batch_size"] * len(BENCH["vocab_sizes"])
    return DLRMConfig(**BENCH, model_shards=S, max_routed_per_shard=2 * lanes // S if S >= 4 else 0)


def _batch(cfg, stream, i):
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    return {k: torch.from_numpy(v) for k, v in
            synth.sparse_batch(spec, cfg.batch_size, stream, i).items()}


def _port_run(cfg, steps=STEPS, state=None, stream=1, serve=0):
    """The one-process port: (losses, serve scores, count metrics, state)."""
    model = DLRM(cfg)
    state = model.init(0, device="cpu") if state is None else state
    scores = []
    for i in range(serve):
        logits, emb = model.serve_step(state, _batch(cfg, 0, i))
        scores.append(logits.detach().numpy())
        state = dict(state, emb=emb)
    losses, counts = [], []
    for i in range(steps):
        state, m = model.train_step(state, _batch(cfg, stream, i))
        losses.append(float(m["loss"]))
        counts.append(rank_jobs.count_metrics(m))
    return losses, scores, counts, state


# --------------------------------------------------------------------------
# without a spawn: the mesh, the specs, a rank's init
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model,n", [(1, 1), (2, 2), (4, 4), (3, 4), (4, 2), (0, 4), (4, 8),
                                     (2, 8)])
def test_mesh_shape_and_errors_match_reference(model, n):
    """The reference refuses a device count that does not divide into the
    shard count; the port refuses the same ranks, and ``data > 1`` too
    (item 13b).  A coordinate-only mesh sits at (0, model_rank)."""
    try:
        jax_make_hybrid_mesh(model, n)
        ref = "built"
    except ValueError as e:  # or a divisible shape past this host's JAX devices
        ref = "indivisible" if "not divisible" in str(e) else "divisible"
    if ref == "indivisible":
        with pytest.raises(ValueError, match="not divisible"):
            check_mesh_shape(model, n)
    elif n // model > 1:
        with pytest.raises(ValueError, match="item 13b"):
            check_mesh_shape(model, n)
    else:
        check_mesh_shape(model, n)
        for s in range(model):
            m = HybridMesh.coordinate(model, s)
            assert (m.coords, m.model_rank, m.world, m.group) == ((0, s), s, model, None)
    assert hybrid_rules() == {"batch": ("data",), "shard": ("model",)}


def _jax_specs(tree):
    """key -> axes of every partition-spec leaf of a reference spec tree (the
    key format of ``jax.tree_util.keystr``, which ``spec_leaves`` shares)."""
    from jax.sharding import PartitionSpec

    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jax.tree_util.keystr(k): tuple(v) for k, v in leaves}


@pytest.mark.parametrize("kw", [
    dict(replicate_top_k=8),
    dict(arena_precision="int8", host_precision="int8"),
    dict(arena_precision="fp16", host_precision="fp16"),
    dict(budget_bytes=15_000, host_precision="int8"),
])
def test_shard_specs_match_reference_leaf_for_leaf(kw):
    tables = [jcol.TableConfig("big", vocab=512, dim=8, ids_per_step=16, cache_ratio=0.2),
              jcol.TableConfig("small", vocab=96, dim=8, ids_per_step=16, cache_ratio=0.2)]
    ptables = [col.TableConfig("big", vocab=512, dim=8, ids_per_step=16),
               col.TableConfig("small", vocab=96, dim=8, ids_per_step=16)]
    jc = JSharded.create(tables, num_shards=2, cache_ratio=0.2, **kw)
    jc.init(jax.random.PRNGKey(0))
    pc = ShardedEmbeddingCollection.create(ptables, num_shards=2, cache_ratio=0.2, **kw)
    pc.init(0, device="cpu")
    want = _jax_specs(jc.shard_specs())
    got = {k: tuple(p) for k, p in spec_leaves(pc.shard_specs())}
    assert want == got
    assert sum(1 for a in got.values() if a[:1] == ("model",)) > 10


@pytest.mark.parametrize("S,kw", [(2, dict(replicate_top_k=8)), (4, dict(replicate_top_k=8)),
                                  (4, dict(arena_precision="int8", host_precision="int8"))])
def test_rank_init_is_the_stacked_shard_bitwise(S, kw):
    """A rank draws every chunk and keeps its shard's homes: its state is
    shard ``s`` of the stacked state, leaf for leaf; the ranks' states
    stack back into it."""
    cfg = DLRMConfig(**BASE, model_shards=S, **kw)
    stacked_model = DLRM(cfg)
    stacked = stacked_model.init(0, device="cpu")
    specs = stacked_model.state_specs()
    ranks = []
    for s in range(S):
        model = DLRM(cfg, mesh=HybridMesh.coordinate(S, s))
        state = model.init(0, device="cpu")
        ranks.append(state)
        want = ckpt._flatten(shard_state(stacked, specs, HybridMesh.coordinate(S, s)))
        got = ckpt._flatten(state)
        assert [k for k, _ in want] == [k for k, _ in got]
        for (k, a), (_, b) in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        slab, whole = state["emb"].slabs[SHARED_ARENA], stacked["emb"].slabs[SHARED_ARENA]
        assert slab.full["weight"].shape[0] == 1
        assert torch.equal(_shard(slab.full.data["weight"], 0),
                           _shard(whole.full.data["weight"], s))
        assert model.collection.device_bytes()["device_process"] == \
            model.collection.device_bytes()["device_per_shard"]
    back = ckpt._flatten(unshard_state(ranks, specs))
    for (k, a), (_, b) in zip(ckpt._flatten(stacked), back):
        assert torch.equal(a, b), k


def test_item_13b_surfaces_raise_under_a_mesh():
    mesh = HybridMesh.coordinate(2, 1)
    tables = [col.TableConfig("big", vocab=512, dim=8, ids_per_step=16),
              col.TableConfig("small", vocab=96, dim=8, ids_per_step=16)]
    coll = ShardedEmbeddingCollection.create(tables, num_shards=2, cache_ratio=0.2, mesh=mesh)
    state = coll.init(0, device="cpu")
    fb = FeatureBatch(ids={"big": torch.arange(16, dtype=torch.int32),
                           "small": torch.arange(16, dtype=torch.int32)})
    for what, fn in (("refresh", lambda: coll.refresh(state)),
                     ("rebalance", lambda: coll._maybe_rebalance(
                         SHARED_ARENA, coll.cached_slabs[SHARED_ARENA],
                         state.slabs[SHARED_ARENA], None, True)),
                     ("lookahead", lambda: coll.plan_prepare(state, fb, fb_future=(fb,))),
                     ("pool", lambda: coll.pool({}, fb)),
                     ("budget", lambda: ShardedEmbeddingCollection.create(
                         tables, num_shards=2, budget_bytes=20_000, mesh=mesh))):
        with pytest.raises(ValueError, match="item 13b"):
            fn()
    with pytest.raises(ValueError, match="model axis"):
        ShardedEmbeddingCollection.create(tables, num_shards=4, mesh=mesh)
    with pytest.raises(ValueError, match="no process group"):
        coll.plan_prepare(state, fb)  # a coordinate alone cannot exchange
    with pytest.raises(ValueError, match="item 13b"):
        check_mesh_shape(2, 4)


@pytest.mark.parametrize("S,cap,width", [(1, 40, 40), (3, 16, 7), (4, 8, 3), (2, 32, 1)])
def test_compact_route_picks_each_lane_from_its_owner(S, cap, width):
    """Every rank's send list at the compact width, laid end to end and
    picked, gives each live lane its owner's row, as the stacked layout's
    gather of the flattened arena does, while its shard has at most
    ``width`` distinct addresses; padding, out-of-range lanes and lanes
    past their shard's width read a zero row."""
    rng = np.random.default_rng(S * 100 + width)
    arena = torch.from_numpy(rng.standard_normal((S * cap, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, S * cap + 3, 64).astype(np.int32))
    blocks, picks = [], []
    for s in range(S):
        send, pick = compact_route(idx, cap, width, HybridMesh(data=1, model=S, rank=s))
        assert send.shape == (width + 1,) and int(send[-1]) == -1
        live = send >= 0
        assert bool((send[live] < cap).all()) and len(set(send[live].tolist())) == int(live.sum())
        blocks.append(torch.where(live[:, None], arena[s * cap + send.clamp_min(0)], 0.0))
        picks.append(pick)
    for p in picks[1:]:
        assert torch.equal(p, picks[0])  # every rank derives the same pick
    got = torch.cat(blocks).index_select(0, picks[0])
    ok = (idx >= 0) & (idx < S * cap)
    owner = torch.where(ok, idx.long() // cap, -1)
    seen = {}
    for i in range(64):
        a = int(idx[i])
        if not bool(ok[i]):
            assert not got[i].any()
            continue
        order = sorted({int(x) for x in idx[ok] if int(x) // cap == int(owner[i])})
        if order.index(a) < width:
            assert torch.equal(got[i], arena[a]), i
        else:
            assert not got[i].any()
        seen[a] = True
    assert seen


def test_replicated_head_gradient_sums_by_sorted_index_put():
    """The replicated head's lanes: the forward and gradient of
    ``take_fill`` (here, where both sum in lane order), but the backward
    an accumulating ``index_put_`` (sorted on the card, so every rank sums
    its copy's lanes in one order), never ``index_add_``'s atomics."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.lanes import take_fill, take_fill_ordered

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(-2, 12, 200).astype(np.int32))
    ct = torch.from_numpy(rng.standard_normal((200, 4)).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    grads = []
    for fn in (take_fill, take_fill_ordered):
        x = x0.clone().requires_grad_()
        out = fn(x, idx, 0.0)
        with Ops() as ops:
            out.backward(ct)
        grads.append((fn(x0, idx, 0.0), x.grad, ops.seen))
    (a, ga, _), (b, gb, seen) = grads
    assert torch.equal(a, b) and torch.equal(ga, gb)
    assert any(op.startswith("_index_put_impl") or op.startswith("index_put") for op in seen)
    assert not any(op.startswith("index_add") for op in seen), seen


def test_stacked_checkpoint_restore_reads_only_the_ranks_rows(tmp_path):
    """Restoring a one-process save into a rank maps each whole leaf and
    copies only that shard's rows: the rank's peak host allocation stays
    near one shard's bytes, never the whole leaf's."""
    import tracemalloc

    S, rows = 4, 1 << 18
    whole = torch.arange(S * rows, dtype=torch.float32).reshape(S, rows)
    ckpt.save(tmp_path, 0, {"table": whole, "head": torch.ones(3)})
    specs = {"table": P("model", None), "head": P(None)}
    like = {"table": torch.empty((1, rows)), "head": torch.empty(3)}
    shard_bytes = rows * 4
    tracemalloc.start()
    state, _ = ckpt.restore(tmp_path, like, mesh=HybridMesh(data=1, model=S, rank=2),
                            specs=specs)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert torch.equal(state["table"], whole[2:3]) and torch.equal(state["head"], torch.ones(3))
    assert peak < 2 * shard_bytes < S * shard_bytes, peak


# --------------------------------------------------------------------------
# refused before any rank starts
# --------------------------------------------------------------------------


@pytest.fixture
def no_spawn(monkeypatch):
    def spawned(*a, **k):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(run.mp, "spawn", spawned)


@pytest.mark.parametrize("argv,match", [
    (["--model-shards", "2", "--ranks", "2", "--backend", "nccl"], "nccl with 2 ranks"),
    (["--model-shards", "2", "--ranks", "2", "--backend", "nccl", "--device", "cpu"], "gloo"),
    (["--model-shards", "2", "--ranks", "4", "--backend", "gloo", "--device", "cpu"],
     "item 13b"),
    (["--model-shards", "4", "--ranks", "2", "--backend", "gloo", "--device", "cpu"],
     "not divisible"),
    (["--arch", "fm", "--ranks", "2", "--backend", "gloo", "--device", "cpu"], "fm is not"),
    (["--model-shards", "2", "--ranks", "2", "--device", "cpu"], "needs --backend"),
    (["--model-shards", "2", "--backend", "gloo", "--device", "cpu"], "needs --ranks"),
    (["--model-shards", "2", "--ranks", "2", "--backend", "gloo", "--device", "cpu",
      "--pipeline-depth", "2"], "item 13b"),
])
def test_launchers_refuse_a_bad_world_before_spawning(no_spawn, argv, match):
    with pytest.raises(SystemExit, match=match):
        train_launch.main(["--steps", "1", "--batch", "16"] + argv)
    if "--arch" not in argv and "--pipeline-depth" not in argv:
        with pytest.raises(SystemExit, match=match):
            serve_launch.main(["--arch", "dlrm-criteo", "--requests", "16", "--batch", "16"]
                              + argv)


def test_group_refuses_a_bad_world_before_spawning(no_spawn):
    with pytest.raises(ValueError, match="nccl with 1 ranks needs 1 cards"):  # no card here
        run.run_ranks(rank_jobs.dlrm_rank, 1, "nccl", None, ([],))
    with pytest.raises(ValueError, match="backend 'mpi'"):
        run.run_ranks(rank_jobs.dlrm_rank, 2, "mpi", "cpu", ([],))
    with pytest.raises(ValueError, match="backend 'mpi'"):
        group.init_ranks("mpi", 0, 1, "/nonexistent", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        group.rank_device(0)  # the rank's device defaults to the card
    assert group.rank_device(3, "cpu") == torch.device("cpu")


# --------------------------------------------------------------------------
# the ranks: one world a shard count
# --------------------------------------------------------------------------

_SMALL = [("big", 512), ("small", 96)]


def _lookup_setup(S, K=8):
    tables = [col.TableConfig(n, vocab=v, dim=8, ids_per_step=16) for n, v in _SMALL]
    jtables = [jcol.TableConfig(n, vocab=v, dim=8, ids_per_step=16, cache_ratio=0.2)
               for n, v in _SMALL]
    rng = np.random.default_rng(1)
    counts = {n: rng.integers(0, 50, v) for n, v in _SMALL}
    kw = dict(cache_ratio=0.2, replicate_top_k=K, use_pallas_plan=True)
    jc = JSharded.create(jtables, num_shards=S, **kw)
    js = jc.init(jax.random.PRNGKey(0), counts=counts)
    state0 = convert.collection_state_from_numpy(jax_to_numpy(js), "cpu")
    steps = []
    for i in range(3):
        r = np.random.default_rng(100 + i)
        steps.append({n: r.integers(-1, v, 16).astype(np.int32) for n, v in _SMALL})
    ref = []
    lookup = jax.jit(jc.lookup)  # index state and rows exact; tracker floats within rtol
    for ids in steps:
        js, ja, jr = lookup(js, jcol.FeatureBatch(
            ids={k: jax.numpy.asarray(v) for k, v in ids.items()}))
        ref.append((jax_to_numpy(ja), jax_to_numpy(jr)))
    final = convert.collection_state_from_numpy(jax_to_numpy(js), "cpu")
    flushed = convert.collection_state_from_numpy(jax_to_numpy(jax.jit(jc.flush)(js)), "cpu")
    job = dict(tables=tables, S=S, kw=kw, counts=counts, state=state0, steps=steps)
    return job, ref, final, flushed, jc.metrics(js)


_WORLDS = {}


def world(S, tmp_root):
    """Every rank job of shard count ``S``, run in one gloo world of CPU
    ranks, with the in-process references it is held to."""
    if S in _WORLDS:
        return _WORLDS[S]
    d = Path(tmp_root) / f"world_{S}"
    d.mkdir(parents=True, exist_ok=True)
    jobs = []
    for case in CASES:  # the port's own init: bitwise the stacked and unsharded runs
        jobs.append(dict(cfg=_cfg(S, case), train=STEPS, serve=SERVE if case == "k8" else 0,
                         replicated=True))
    jstates = {}
    for case in ("k0", "k8"):  # the reference's init, converted: the reference's losses
        jm = JDLRM(JDLRMConfig(**BASE, model_shards=S, **CASES[case]))
        jstates[case] = jax_to_numpy(jm.init(jax.random.PRNGKey(0)))
        jobs.append(dict(cfg=_cfg(S, case), train=STEPS, state_np=jstates[case]))
    jobs.append(dict(cfg=_bench_cfg(S), prepare=5))
    # the checkpoint hand-off both ways: a stacked save restored into the ranks,
    # and the ranks' save restored into the stacked layout (by the test)
    cfg = _cfg(S, "int8")
    _, _, _, st = _port_run(cfg, steps=CKPT_STEPS)
    st = DLRM(cfg).flush(st)
    ckpt.save(d / "stacked", CKPT_STEPS, st)
    jobs.append(dict(cfg=cfg, train=CKPT_STEPS, save=str(d / "ranks"), next_step=True,
                     digests=True))
    jobs.append(dict(cfg=cfg, restore=str(d / "stacked"), next_step=True,
                     next_index=CKPT_STEPS, digests=True))
    lookup_job, lookup_ref, final, flushed, jm = _lookup_setup(S)
    res = run.run_ranks(rank_jobs.dlrm_rank, S, "gloo", "cpu", (jobs + [lookup_job],), threads=1)
    lookups = [r.pop() for r in res]
    _WORLDS[S] = dict(res=res, jstates=jstates, dir=d, lookups=lookups, lookup_ref=lookup_ref,
                      final=final, flushed=flushed, jmetrics=jm, stacked_next=None)
    return _WORLDS[S]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def ref_losses():
    """The reference's single-device losses (its mesh test's own target)."""
    jm = JDLRM(JDLRMConfig(**BASE))
    js = jm.init(jax.random.PRNGKey(0))
    step = jax.jit(jm.train_step)
    out = []
    for i in range(STEPS):
        js, m = step(js, {k: jax.numpy.asarray(v.numpy()) for k, v in
                          _batch(_cfg(1, "k0"), 1, i).items()})
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_rank_losses_bitwise_stacked_and_unsharded(S, case, tmp_root):
    """fp32 losses, every rank's the same, bitwise the one-process stacked
    layout's at the same S, and every rank's replicated leaves (MLPs, head,
    routing maps) bitwise the stacked state's; the fp32 exchanges bitwise
    the unsharded port's too (the int8 exchange rounds the rows on the
    wire)."""
    w = world(S, tmp_root)
    i = list(CASES).index(case)
    cfg = _cfg(S, case)
    stacked, _, counts, state = _port_run(cfg, serve=SERVE if case == "k8" else 0)
    split = sharded_paths(DLRM(cfg).state_specs())
    replicated = {k: rank_jobs.digest(v) for k, v in ckpt._flatten(state) if k not in split}
    assert any(k.startswith("['params']") for k in replicated) and any(".rep." in k for k in replicated)
    for r in w["res"]:
        assert r[i]["losses"] == stacked, r[i]["rank"]
        assert r[i]["metrics"] == counts  # the count-valued metrics, step by step
        assert r[i]["replicated"] == replicated, r[i]["rank"]
    assert all(c["uniq_overflows"] == 0 for c in counts)
    if "int8" not in case:
        assert stacked == _port_run(DLRMConfig(**BASE))[0]


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", ["k0", "k8"])
def test_rank_losses_match_reference_single_device(S, case, tmp_root, ref_losses):
    """From the reference's own init: within rtol 1e-5 of its single-device
    losses, and bitwise the port's stacked run from that state."""
    w = world(S, tmp_root)
    i = len(CASES) + ["k0", "k8"].index(case)
    state = convert.state_from_numpy(w["jstates"][case], device="cpu")
    stacked = _port_run(_cfg(S, case), state=state)[0]
    for r in w["res"]:
        assert r[i]["losses"] == stacked
        np.testing.assert_allclose(r[i]["losses"], ref_losses, rtol=1e-5, atol=0)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_rank_serve_scores_bitwise_stacked(S, tmp_root):
    w = world(S, tmp_root)
    _, scores, _, _ = _port_run(_cfg(S, "k8"), steps=0, serve=SERVE)
    want = np.concatenate(scores)
    for r in w["res"]:
        assert np.array_equal(r[1]["scores"], want)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_rank_traffic_counts_the_collectives_and_bytes_sent(S, tmp_root):
    """Three collectives a fp32 step (the slot leg, the row leg, the
    metrics' counters), four with the int8 exchange (payload and sideband);
    a rank sends (S - 1) x its part of each: the slot leg at the plan's
    width, the row leg at the lane width, or W + 1 rows at a compact W."""
    w = world(S, tmp_root)
    lanes, dim = BASE["batch_size"] * len(BASE["vocab_sizes"]), BASE["embed_dim"]
    u = min(lanes, sum(BASE["vocab_sizes"]))
    for i, case in enumerate(CASES):
        row = dim + 8 if "int8" in case else 4 * dim
        width = CASES[case].get("max_routed_per_shard", 0)
        slots, rows = (width, width + 1) if width else (u, lanes)
        t = w["res"][0][i]["train_traffic"]
        per_step = (slots * 4 + rows * row + 12 * 4) * (S - 1)
        assert t["collectives"] == STEPS * (4 if "int8" in case else 3), (case, t)
        assert t["bytes_sent"] == STEPS * per_step, (case, t)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_rank_exchange_bytes_match_bench_pr7(S, tmp_root):
    """BENCH_PR7's 278 652 B per step (8 444 B of ids, 270 208 B of rows),
    over batches 1-5 after batch 0, on every rank."""
    w = world(S, tmp_root)
    for r in w["res"]:
        m0, m1 = r[len(CASES) + 2]["prepare_metrics"]
        assert m1["uniq_overflows"] == 0
        per_step = {k: round((m1[k] - m0[k]) / 5) for k in
                    ("exchange_bytes", "exchange_id_bytes", "exchange_row_bytes")}
        assert per_step == {"exchange_bytes": 278652, "exchange_id_bytes": 8444,
                            "exchange_row_bytes": 270208}


@pytest.mark.parametrize("S", [1, 2, 4])
def test_rank_lookups_match_reference_sharded_lookup(S, tmp_root):
    """Each lookup's addresses and rows bitwise the reference's sharded
    lookup; each rank's state after them, and after a flush, is shard s of
    the reference's state (its tracker floats within TRACKER_RTOL); the
    metrics equal the reference's."""
    w = world(S, tmp_root)
    for r in w["lookups"]:
        mesh = HybridMesh.coordinate(S, r["model_rank"])
        for got, (ja, jr) in zip(r["steps"], w["lookup_ref"]):
            for f in ja:
                assert np.array_equal(got["addresses"][f].numpy(), ja[f]), f
                assert np.array_equal(got["rows"][f].numpy(), jr[f]), f
        coll = ShardedEmbeddingCollection.create(
            [col.TableConfig(n, vocab=v, dim=8, ids_per_step=16) for n, v in _SMALL],
            num_shards=S, cache_ratio=0.2, replicate_top_k=8, use_pallas_plan=True)
        coll.init(0, device="cpu")
        for key, whole in (("state", w["final"]), ("flushed", w["flushed"])):
            want = dict(ckpt._flatten(shard_state(whole, coll.shard_specs(), mesh)))
            assert set(want) == set(r[key])
            for k, a in want.items():
                if k.rsplit(".", 1)[-1] in TRACKER_FLOATS:
                    np.testing.assert_allclose(r[key][k].numpy(), a.numpy(), rtol=TRACKER_RTOL)
                else:
                    assert torch.equal(r[key][k], a), (key, k)
        jm, m = w["jmetrics"], r["metrics"]
        for k in ("cache_misses", "cache_evictions", "uniq_overflows", "exchange_bytes",
                  "shard_imbalance_routed", "hit_rate"):
            assert m[k] == float(jm[k]), k
        for k in ("exchange_routed_lanes", "exchange_lane_bytes", "slab_hits",
                  "host_moved_rows"):
            assert m[k][SHARED_ARENA] == int(jm[k][SHARED_ARENA]), k
        assert np.array_equal(m["exchange_per_shard_lanes"].numpy(),
                              np.asarray(jm["exchange_per_shard_lanes"]))
        np.testing.assert_allclose(m["shard_imbalance"], float(jm["shard_imbalance"]),
                                   rtol=TRACKER_RTOL)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_checkpoint_moves_across_world_sizes_bitwise(S, tmp_root):
    """The ranks' split save restored into one process's stacked layout,
    and a stacked save restored into the ranks: the next step's loss and
    the state bitwise the run that kept going."""
    w = world(S, tmp_root)
    cfg = _cfg(S, "int8")
    saved, handed = w["res"][0][-2], w["res"][0][-1]
    for r in w["res"]:
        assert r[-2]["next_loss"] == saved["next_loss"]
        assert r[-1]["next_loss"] == saved["next_loss"]  # stacked -> ranks
        assert r[-1]["digests"] == r[-2]["digests"]
    model = DLRM(cfg)
    state, step = ckpt.restore(w["dir"] / "ranks", model.init(1, device="cpu"))  # ranks -> stacked
    assert step == CKPT_STEPS
    _, _, _, kept = _port_run(cfg, steps=CKPT_STEPS)
    kept = model.flush(kept)
    for (k, a), (_, b) in zip(ckpt._flatten(kept), ckpt._flatten(state)):
        assert torch.equal(a, b), k
    state, m = model.train_step(state, _batch(cfg, 1, CKPT_STEPS))
    assert float(m["loss"]) == saved["next_loss"]


def test_launcher_ranks_match_model_shards():
    """``launch/train.py --model-shards 2 --ranks 2 --backend gloo --device
    cpu`` gives the losses of ``--model-shards 2`` in one process."""
    common = ["--device", "cpu", "--steps", "3", "--batch", "16", "--model-shards", "2",
              "--replicate-top-k", "8"]
    one = [h["loss"] for h in train_launch.main(common).history]
    ranks = train_launch.main(common + ["--ranks", "2", "--backend", "gloo"])
    assert [[h["loss"] for h in r["history"]] for r in ranks] == [one, one]
