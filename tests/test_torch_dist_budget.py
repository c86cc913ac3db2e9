"""The budget mode and ``pool`` under a ``(data, model)`` mesh: gloo CPU
ranks at ``(1, 2)`` and ``(2, 2)``, one cache shard a process, held to the
one-process stacked layout on the same global batches, and (one case) to
the reference's sharded budget collection.

The budget plan keeps the planner's DEVICE tables whole on every rank and
shards each CACHED slab, one shard a rank, with its own host codec.

Tolerances, as ``tests/test_torch_dist_data.py`` derives them:

* ``pool`` (its outputs, the gradients as the train step sums them over
  the data axis, the state after the update) and every integer leaf and
  tracker are bitwise.  At ``data > 1`` the gradients' yardstick is the
  stacked layout's gradient of each replica's bags, summed in data-rank
  order and scaled by ``1 / data`` as the ranks' ``_data_mean`` does (a
  sum over the whole batch reassociates);
* the DLRM's losses and trained floats: bitwise at ``(1, 2)``; at ``(2,
  2)`` each replica's loss is the mean over its half of the batch, so
  they stay within rtol 1e-5 (losses) and rtol 1e-5 / atol 1e-6 (the
  trained floats) of the stacked layout's, and the replicas bitwise equal
  to each other;
* the reference's lookups bitwise, its segment-sum pooling within rtol
  1e-6 (one sum reassociated by XLA; the port's two routes agree bitwise).

One gloo world a mesh shape runs every job of that shape.  Configs: the
reference's mesh test's DLRM (dim 8, global batch 16, lr 0.2) at five
tables of vocab (2048, 256, 1024, 64, 8) under a 70 000 B budget: three
DEVICE tables (256, 64, 8) and two CACHED (2048, 1024); bags of 4 lanes;
the reference's budget test's tables (``tests/test_sharded.py``).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_rank_jobs as rank_jobs
from torch_parity import jax_to_numpy

from repro.core import collection as jcol
from repro.core.sharded import ShardedEmbeddingCollection as JSharded
from repro_torch import convert
from repro_torch.core import collection as col
from repro_torch.core import refresh as refresh_lib
from repro_torch.core.sharded import ShardedEmbeddingCollection
from repro_torch.data import synth
from repro_torch.dist import exchange, run
from repro_torch.dist.mesh import HybridMesh
from repro_torch.dist.partitioning import shard_state, sharded_paths, unshard_state
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.train import checkpoint as ckpt

VOCABS = (2048, 256, 1024, 64, 8)
BUDGET = 70_000
BASE = dict(vocab_sizes=VOCABS, embed_dim=8, batch_size=16, cache_ratio=0.15, lr=0.2,
            bottom_mlp=(16, 8), top_mlp=(16,), device_budget_bytes=BUDGET)
STEPS = 4
CKPT_STEPS = 3
CASES = {"k8": dict(replicate_top_k=8),
         "int8": dict(replicate_top_k=8, host_precision="int8", arena_precision="int8")}
SHAPES = [(1, 2), (2, 2)]  # (data, model)
S = 2
REFRESH = dict(max_swaps=24, exchange_budget=16)
RTOL, ATOL = 1e-5, 1e-6
TRAINED = ("cached_rows", ".full.", ".rep.rows", "['params']", "['opt']", ".weight")
# the bag jobs: collection tables of the DLRM's vocabularies, 4 bags of 4 lanes a step
BAG_TABLES = [col.TableConfig(f"t{i}", vocab=v, dim=8, ids_per_step=16)
              for i, v in enumerate(VOCABS)]
BAG_KW = dict(budget_bytes=BUDGET, cache_ratio=0.15, replicate_top_k=8, use_pallas_plan=True)
BAGS, LANES, BAG_STEPS, BAG_LR = 4, 4, 2, 0.2
COMBINERS = {"sum": LANES, "mean": 3}  # combiner -> max_bag
# the reference's budget test (tests/test_sharded.py): a 4096-row CACHED table, a DEVICE one
CHAIN = [("big", 4096), ("hot", 64)]
CHAIN_BUDGET = 80_000
# each world's jobs after the cases
REFRESH_JOB = len(CASES)
SAVED_JOB = REFRESH_JOB + 1
BAG_JOB = {c: SAVED_JOB + 1 + i for i, c in enumerate(COMBINERS)}
CHAIN_JOB = SAVED_JOB + 1 + len(COMBINERS)


@pytest.fixture(autouse=True)
def one_thread():
    """The in-process references on one thread, as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case):
    return DLRMConfig(**BASE, model_shards=S, **CASES[case])


def _batch(cfg, stream, i):
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    return {k: torch.from_numpy(v) for k, v in
            synth.sparse_batch(spec, cfg.batch_size, stream, i).items()}


def _stacked(cfg, steps=STEPS):
    """The one-process stacked layout on the global batches: (losses, state)."""
    model = DLRM(cfg)
    state = model.init(0, device="cpu")
    losses = []
    for i in range(steps):
        state, m = model.train_step(state, _batch(cfg, 1, i))
        losses.append(float(m["loss"]))
    return losses, state


def _trained(key):
    return any(t in key for t in TRAINED)


def _bag_steps(vocabs, names, seed):
    """Global bag steps: each feature's ids ``[BAGS * LANES]`` (Zipf, each
    bag 1-4 lanes long, the rest -1) and a cotangent ``[BAGS, 8]``."""
    rng = np.random.default_rng(seed)
    steps, cots = [], []
    for _ in range(BAG_STEPS):
        ids, cot = {}, {}
        for n, v in zip(names, vocabs):
            x = (rng.zipf(1.3, (BAGS, LANES)) % v).astype(np.int32)
            x[np.arange(LANES)[None, :] >= rng.integers(1, LANES + 1, BAGS)[:, None]] = -1
            ids[n] = x.reshape(-1)
            cot[n] = rng.standard_normal((BAGS, 8)).astype(np.float32)
        steps.append({"ids": ids, "bags": BAGS, "lanes": LANES})
        cots.append(cot)
    return steps, cots


def _bag_job(combiner):
    names = [t.name for t in BAG_TABLES]
    bags, cots = _bag_steps(VOCABS, names, seed=7 + len(combiner))
    return dict(tables=BAG_TABLES, S=S, kw=BAG_KW, bags=bags, cot=cots, combiner=combiner,
                max_bag=COMBINERS[combiner], lr=BAG_LR)


def _chain_setup():
    """The reference's sharded budget collection (its init, converted) and
    its lookups and segment-sum pooling on the same bags: the job, and the
    reference's rows and pooled outputs a step."""
    jtables = [jcol.TableConfig(n, vocab=v, dim=8, ids_per_step=16, cache_ratio=0.1)
               for n, v in CHAIN]
    tables = [col.TableConfig(n, vocab=v, dim=8, ids_per_step=16, cache_ratio=0.1)
              for n, v in CHAIN]
    jc = JSharded.create(jtables, num_shards=S, budget_bytes=CHAIN_BUDGET)
    assert jc.device_slabs and jc.cached_slabs
    js = jc.init(jax.random.PRNGKey(0))
    state0 = convert.collection_state_from_numpy(jax_to_numpy(js), "cpu")
    bags, cots = _bag_steps([v for _, v in CHAIN], [n for n, _ in CHAIN], seed=3)
    lookup = jax.jit(jc.lookup)
    ref = []
    for step in bags:
        seg = jnp.repeat(jnp.arange(BAGS, dtype=jnp.int32), LANES)
        fb = jcol.FeatureBatch(ids={k: jnp.asarray(v) for k, v in step["ids"].items()},
                               segments={k: seg for k in step["ids"]}, num_segments=BAGS)
        js, _, rows = lookup(js, fb)
        ref.append((jax_to_numpy(rows), jax_to_numpy(jc.pool(rows, fb, "sum"))))
    job = dict(tables=tables, S=S, kw=dict(budget_bytes=CHAIN_BUDGET), state=state0, bags=bags,
               cot=cots, combiner="sum", max_bag=0, lr=0.0)
    return job, ref


def _jobs(D, d):
    jobs = [dict(cfg=_cfg(case), train=STEPS, replicated=True, digests=True, state_out=True)
            for case in CASES]
    # the refresh and the re-homing over the budget plan, from the ranks' own state
    jobs.append(dict(cfg=_cfg("int8"), train=3, flush=False,
                     refresh=dict(cfg=REFRESH, rebalance=0.0, cool_head=True)))
    # the ranks' checkpoint of the budget plan, read into the stacked layout by the test
    jobs.append(dict(cfg=_cfg("int8"), train=CKPT_STEPS, save=str(d / "ranks"), state_out=True,
                     next_step=True))
    jobs += [_bag_job(c) for c in COMBINERS]
    chain, ref = _chain_setup()
    return jobs + [chain], ref


_WORLDS = {}


def world(D, tmp_root):
    if D not in _WORLDS:
        d = Path(tmp_root) / f"world_{D}x{S}"
        d.mkdir(parents=True, exist_ok=True)
        jobs, chain_ref = _jobs(D, d)
        res = run.run_ranks(rank_jobs.dlrm_rank, D * S, "gloo", "cpu", (jobs,), threads=1)
        _WORLDS[D] = dict(res=res, dir=d, jobs=jobs, chain_ref=chain_ref)
    return _WORLDS[D]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("budget_ranks")


def _close(state):
    for slab in state.slabs.values() if hasattr(state, "slabs") else state["emb"].slabs.values():
        if hasattr(slab, "full"):
            slab.full.close()


# --------------------------------------------------------------------------
# without a spawn
# --------------------------------------------------------------------------


def test_budget_plan_builds_under_a_mesh_as_the_stacked_shard():
    """``create(budget_bytes=, mesh=)`` builds; a rank's init is shard ``s``
    of the stacked budget state leaf for leaf (the DEVICE tables whole),
    its codecs resolve as the stacked layout's, and its ``device_process``
    is the stacked layout's ``device_per_shard``."""
    cfg = _cfg("int8")
    stacked_model = DLRM(cfg)
    stacked = stacked_model.init(0, device="cpu")
    coll = stacked_model.collection
    assert sorted(coll.device_slabs) == ["f1", "f3", "f4"]
    assert sorted(coll.cached_slabs) == ["f0", "f2"]
    specs = stacked_model.state_specs()
    for s in range(S):
        model = DLRM(cfg, mesh=HybridMesh.coordinate(S, s))
        state = model.init(0, device="cpu")
        want = ckpt._flatten(shard_state(stacked, specs, HybridMesh.coordinate(S, s)))
        got = ckpt._flatten(state)
        assert [k for k, _ in want] == [k for k, _ in got]
        for (k, a), (_, b) in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        for n in coll.device_slabs:
            assert torch.equal(state["emb"].slabs[n].weight, stacked["emb"].slabs[n].weight)
        assert model.collection.host_precision == coll.host_precision
        db = model.collection.device_bytes()
        assert db["device_process"] == db["device_per_shard"] == coll.device_bytes()[
            "device_per_shard"]
        _close(state)
    _close(stacked)


def test_device_grad_rows_are_the_global_batchs_distinct_ids():
    """At ``data > 1`` a DEVICE table's gradient crosses at the global
    batch's distinct ids (ascending, -1 padding to the lanes); a table no
    larger than its lanes crosses whole (no entry)."""
    coll = DLRM(_cfg("k8"), mesh=HybridMesh.coordinate(S, 0, 0, 2)).collection
    fb = DLRM(_cfg("k8")).features(_batch(_cfg("k8"), 1, 0))
    fb.ids["f1"][3] = -1
    rows = coll._device_grad_rows(fb)
    assert sorted(rows) == ["f1", "f3"]  # f4: vocab 8 <= 16 lanes
    for n, r in rows.items():
        ids = fb.ids[n].numpy()
        u = np.unique(ids[ids >= 0])
        assert r.dtype == torch.int32 and r.shape == (16,)
        assert np.array_equal(r.numpy(), np.concatenate([u, -np.ones(16 - u.size, np.int32)]))
    grads = {n: torch.randn(t.vocab, 8) for n, t in coll.device_slabs.items()}
    for n in rows:  # rows outside the batch's ids are zero in a replica's gradient
        keep = torch.zeros(coll.device_slabs[n].vocab, dtype=torch.bool)
        keep[rows[n][rows[n] >= 0].long()] = True
        grads[n][~keep] = 0.0
    parts = coll.pick_grad_rows(grads, rows)
    assert parts["f4"] is grads["f4"] and parts["f1"].shape == (16, 8)
    back = coll.place_grad_rows(grads, parts, rows)
    for n in grads:
        assert torch.equal(back[n], grads[n]), n


def test_unequal_bag_lanes_across_replicas_are_refused(monkeypatch):
    """Every replica must feed the same number of lanes of a feature: the
    lane counts cross the data axis first, and a mismatch is refused on
    every rank, naming the feature."""
    coll = ShardedEmbeddingCollection.create(BAG_TABLES, num_shards=S,
                                             mesh=HybridMesh.coordinate(S, 0, 0, 2), **BAG_KW)
    seg = torch.zeros(4, dtype=torch.int32)
    fb = col.FeatureBatch(ids={"t0": torch.arange(4, dtype=torch.int32),
                               "t1": torch.arange(4, dtype=torch.int32)},
                          segments={"t0": seg, "t1": seg}, num_segments=1)

    def gathered(t, mesh, leg):  # the other replica fed 6 lanes of t1
        assert leg == "lanes"
        return torch.stack([t, torch.tensor([4, 6])])

    monkeypatch.setattr(exchange, "data_all_gather", gathered)
    with pytest.raises(ValueError, match=r"feature\(s\) \['t1'\]"):
        coll._global_batches([fb])


# --------------------------------------------------------------------------
# the ranks: one world a mesh shape
# --------------------------------------------------------------------------


@pytest.mark.parametrize("D,_", SHAPES)
@pytest.mark.parametrize("case", list(CASES))
def test_budget_ranks_hold_the_stacked_layout(D, _, case, tmp_root):
    """The budget plan's steps: every rank's integer state and tracker
    bitwise the stacked layout's shard, its losses and trained floats
    (MLPs, DEVICE tables, arenas, host slices, head) bitwise at ``(1, 2)``
    and within the stated tolerance at ``(2, 2)``; every rank's DEVICE
    tables, MLPs and routing maps bitwise the others', each replica's shard
    bitwise its twin's; ``device_process`` the stacked layout's
    ``device_per_shard``; each slab's host codec the same on every rank."""
    w = world(D, tmp_root)
    i = list(CASES).index(case)
    cfg = _cfg(case)
    losses, state = _stacked(cfg)
    model = DLRM(cfg)
    state = model.flush(state)
    specs = model.state_specs()
    per_shard = model.collection.device_bytes()["device_per_shard"]
    by_shard = {}
    for r in w["res"]:
        got = r[i]
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=0)
        if D == 1:
            assert got["losses"] == losses
        want = dict(ckpt._flatten(shard_state(state, specs,
                                              HybridMesh.coordinate(S, got["model_rank"]))))
        assert set(want) == set(got["state"])
        for k, a in want.items():
            b = got["state"][k]
            if _trained(k) and a.is_floating_point() and D > 1:
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=k)
            elif not (_trained(k) and D > 1):
                assert a.dtype == b.dtype and torch.equal(a, b), k
        assert got["device_bytes"]["device_process"] == per_shard
        by_shard.setdefault(got["model_rank"], []).append(got["digests"])
        assert got["replicated"] == w["res"][0][i]["replicated"], got["rank"]
        assert any(".slabs['f1'].weight" in k for k in got["replicated"])
        assert all(c["uniq_overflows"] == 0 for c in got["metrics"])
    for digests in by_shard.values():
        assert all(x == digests[0] for x in digests)
    _close(state)


@pytest.mark.parametrize("D,_", SHAPES)
def test_budget_refresh_and_rebalance_bitwise_stacked(D, _, tmp_root):
    """A refresh pass and a forced re-homing across the ranks over the
    budget plan (two CACHED slabs, each with its own int8 host codec and
    owner tables), from the ranks' own state: every rank's state after
    each pass bitwise the stacked layout's pass from the same state, and a
    lookup and ``dense_reference`` after them bitwise on the replica's rows."""
    w = world(D, tmp_root)
    i = REFRESH_JOB
    cfg = _cfg("int8")
    model = DLRM(cfg)
    stacked = model.init(0, device="cpu")
    coll = model.collection
    split = sharded_paths(coll.shard_specs())
    lead = sorted((r[i] for r in w["res"] if r[i]["data_rank"] == 0),
                  key=lambda r: r["model_rank"])
    for key, t in ckpt._flatten(stacked["emb"]):
        t.copy_(torch.cat([r["refresh_before"][key] for r in lead]) if key in split
                else lead[0]["refresh_before"][key])
    emb, rep = coll.refresh(stacked["emb"], refresh_lib.RefreshConfig(**REFRESH))
    after = {k: v.clone() for k, v in ckpt._flatten(emb)}
    emb, reb = coll.refresh(emb, refresh_lib.RefreshConfig(max_swaps=0, rebalance_threshold=0.0))
    rebalanced = {k: v.clone() for k, v in ckpt._flatten(emb)}
    assert rep.total_swaps > 0 and set(rep.swaps) == {"f0", "f2"}
    assert sum(reb.rebalance_moves.values()) > 0
    fb = model.features(_batch(cfg, 1, 99))
    dense = coll.dense_reference(emb, fb)
    emb, _, rows = coll.lookup(emb, fb)
    for r in w["res"]:
        got = r[i]
        assert got["refresh_report"]["swaps"] == rep.swaps
        assert got["rebalance_report"]["rebalance_moves"] == reb.rebalance_moves
        s = got["model_rank"]
        for whole, mine in ((after, got["refresh_after"]), (rebalanced, got["rebalance_after"])):
            assert set(whole) == set(mine)
            for k, a in whole.items():
                want = a[s : s + 1] if k in split else a
                assert want.dtype == mine[k].dtype and torch.equal(want, mine[k]), k
        b = cfg.batch_size // D
        lo = got["data_rank"] * b
        for f in fb.features:
            assert torch.equal(got["probe_dense"][f], dense[f][lo : lo + b]), f
            assert torch.equal(got["probe_rows"][f], rows[f][lo : lo + b]), f
    _close(emb)


@pytest.mark.parametrize("D,_", SHAPES)
def test_budget_checkpoint_restores_into_the_stacked_layout(D, _, tmp_root):
    """The ranks' save of the budget plan (the replicated DEVICE tables
    written once, not once a shard) restored into one process's stacked
    layout: bitwise the ranks' state, and its next step the ranks'."""
    w = world(D, tmp_root)
    cfg = _cfg("int8")
    model = DLRM(cfg)
    specs = sharded_paths(model.state_specs())
    state, step = ckpt.restore(w["dir"] / "ranks", model.init(1, device="cpu"))
    assert step == CKPT_STEPS
    lead = sorted((r[SAVED_JOB] for r in w["res"] if r[SAVED_JOB]["data_rank"] == 0),
                  key=lambda r: r["model_rank"])
    for k, t in ckpt._flatten(state):
        want = torch.cat([r["state"][k] for r in lead]) if k in specs else lead[0]["state"][k]
        assert torch.equal(t, want), k
    saved = sorted((w["dir"] / "ranks").glob("step_*"))[-1]
    whole = [e["key"] for e in json.loads((saved / "manifest.json").read_text())["leaves"]]
    assert sum(".slabs['f1'].weight" in k for k in whole) == 1
    for s in range(S):
        part = (saved / f"shard_{s:04d}" / "manifest.json").read_text()
        assert "'f1'" not in part and "'f0'" in part
    state, m = model.train_step(state, _batch(cfg, 1, CKPT_STEPS))
    nxt = float(m["loss"])
    for r in w["res"]:
        if D == 1:
            assert r[SAVED_JOB]["next_loss"] == nxt
        else:
            np.testing.assert_allclose(r[SAVED_JOB]["next_loss"], nxt, rtol=RTOL, atol=0)
        assert r[SAVED_JOB]["next_loss"] == w["res"][0][SAVED_JOB]["next_loss"]
    _close(state)


def _stacked_bags(job, D):
    """The stacked layout's bag steps on the global batches
    (``torch_rank_jobs.stacked_bag_step``: each replica's bags
    differentiated alone, the gradients summed in data-rank order and
    scaled by ``1 / D``); the state after the last update."""
    coll = ShardedEmbeddingCollection.create(job["tables"], num_shards=S, **job["kw"])
    state = coll.init(0, device="cpu")
    if job.get("state") is not None:  # a copy of the stacked state the ranks were given
        state = unshard_state([job["state"]], coll.shard_specs())
    out = []
    for step, cot in zip(job["bags"], job["cot"]):
        state, reps, grads, _ = rank_jobs.stacked_bag_step(
            coll, state, step, cot, D, job["combiner"], job["max_bag"], job["lr"], "cpu")
        out.append(dict(reps=reps, grads=grads))
    return coll, out, state


@pytest.mark.parametrize("D,_", SHAPES)
@pytest.mark.parametrize("combiner", list(COMBINERS))
def test_pool_ranks_bitwise_stacked(D, _, combiner, tmp_root):
    """``pool`` under the mesh (one ``embedding_bag_multi`` call a slab over
    the gathered lanes): each replica's pooled outputs bitwise the stacked
    kernel route's (and, where ``max_bag`` keeps every lane, the segment-sum
    route's; that route is the stacked layout's too), the gradients (arenas,
    the replicated head, the DEVICE tables) bitwise the stacked layout's,
    and every rank's state after two updates bitwise the stacked layout's
    shard; the DEVICE tables' gradient crossed the data axis at the global
    batch's distinct ids, fewer rows than the whole tables."""
    w = world(D, tmp_root)
    i = BAG_JOB[combiner]
    coll, want, state = _stacked_bags(w["jobs"][i], D)
    specs = coll.shard_specs()
    for r in w["res"]:
        got = r[i]
        d, s = got["data_rank"], got["model_rank"]
        for g, stp in zip(got["steps"], want):
            rep = stp["reps"][d]
            for f, x in rep["pooled"].items():
                assert torch.equal(g["pooled"][f], x), f
                assert torch.equal(g["plain"][f], rep["plain"][f]), f
                if COMBINERS[combiner] >= LANES:  # the segment sum keeps every lane
                    assert torch.equal(g["pooled"][f], g["plain"][f]), f
            assert set(g["grads"]) == set(stp["grads"])
            assert any(k.endswith("::rep") for k in g["grads"])
            for k, x in stp["grads"].items():
                x = x[s : s + 1] if k in coll.cached_slabs else x
                assert torch.equal(g["grads"][k], x), k
        mine = dict(ckpt._flatten(shard_state(state, specs, HybridMesh.coordinate(S, s))))
        assert set(mine) == set(got["state"])
        for k, a in mine.items():
            assert torch.equal(got["state"][k], a), k
        legs = got["traffic"]["parts"]
        if D == 1:
            assert not legs
        else:  # the DEVICE leg: each table's lanes (16 a step) a step, f4 (vocab 8) whole
            dim, lanes = 8, BAGS * LANES
            rows = sum(min(t.vocab, lanes) for t in coll.device_slabs.values())
            assert legs["grads.device"] == BAG_STEPS * 4 * (D - 1) * dim * rows
            whole = sum(t.vocab for t in coll.device_slabs.values())
            assert legs["grads.device"] < BAG_STEPS * 4 * (D - 1) * dim * whole
    _close(state)


@pytest.mark.parametrize("D,_", SHAPES)
def test_pool_ranks_match_reference_budget_lookup(D, _, tmp_root):
    """Chained to the reference: its sharded budget collection (a CACHED
    and a DEVICE table, ``tests/test_sharded.py``) from its own init; each
    replica's lookup rows bitwise the reference's, and its pooled bags (the
    kernel route under the mesh) within rtol 1e-6 of the reference's
    segment-sum pooling of the same rows."""
    w = world(D, tmp_root)
    for r in w["res"]:
        got = r[CHAIN_JOB]
        d = got["data_rank"]
        for g, (jrows, jpooled) in zip(got["steps"], w["chain_ref"]):
            n, b = BAGS * LANES // D, BAGS // D
            for f in jrows:
                assert np.array_equal(g["rows"][f].numpy(), jrows[f][d * n : (d + 1) * n]), f
                np.testing.assert_allclose(g["pooled"][f].numpy(), jpooled[f][d * b : (d + 1) * b],
                                           rtol=1e-6, atol=1e-7, err_msg=f)
        assert got["host_precision"] == {"big": "fp32"}
