"""Hybrid parallel with ``data > 1``: a ``(data=D, model=S)`` mesh of gloo
CPU ranks, each data replica feeding ``1 / D`` of every global batch,
held to the one-process stacked layout at ``S`` shards (bitwise the
``(1, S)`` ranks, ``tests/test_torch_dist.py``) on the same global
batches, and to the reference's single-device sharded DLRM.

Tolerances, derived as the DLRM tests derive theirs:

* integer state (slots, index images, use counts, counters, plan clocks,
  the routing maps, the refresh's swaps and homes) and every leaf the
  gradients do not reach (the frequency tracker: its touches come from
  the global plan) are bitwise the stacked layout's, and the replicas of
  a shard are bitwise equal to each other;
* losses within rtol 1e-5 of the stacked layout's and of the reference's
  (the cross-framework bound of ``tests/test_torch_dist.py``); at ``D >
  1`` the batch's sum is split over the replicas and reassociated, which
  moves a loss by a few fp32 ulps (~1e-7 relative);
* the trained floats (MLPs, arena and host rows, the replicated head)
  within rtol 1e-5 / atol 1e-6 of the stacked layout's: ``STEPS`` SGD
  steps at lr 0.2 of gradients that differ by reassociation (a few ulps
  each) move a weight by far less than 1e-6.

One gloo world a mesh shape runs every job of that shape: ``(2, 1)``,
``(2, 2)`` and ``(1, 2)``.  Configs: the reference's own mesh test
(``tests/test_sharded.py``: vocab (2048, 256), dim 8, global batch 16,
cache 0.15, lr 0.2, 6 steps) with K 0, K 8, the int8 exchange and the
plan at a compact width.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_rank_jobs as rank_jobs

from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro_torch.core import refresh as refresh_lib
from repro_torch.data import synth
from repro_torch.dist import exchange, run
from repro_torch.dist.mesh import HybridMesh
from repro_torch.dist.partitioning import shard_state, sharded_paths
from repro_torch.launch import train as train_launch
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.train import checkpoint as ckpt
from torch_parity import jax_to_numpy

BASE = dict(vocab_sizes=(2048, 256), embed_dim=8, batch_size=16, cache_ratio=0.15, lr=0.2,
            bottom_mlp=(16, 8), top_mlp=(16,))
STEPS = 6
CKPT_STEPS = 3
SERVE = 2
CASES = {"k0": {}, "k8": dict(replicate_top_k=8),
         "int8": dict(replicate_top_k=8, exchange_codec="int8"),
         # the slot leg and the arena gradient at a compact width (a batch routes at
         # most 21 distinct rows to a shard)
         "k8w": dict(replicate_top_k=8, max_routed_per_shard=24)}
SHAPES = [(2, 1), (2, 2), (1, 2)]  # (data, model)
REFRESH = dict(max_swaps=24, exchange_budget=16)
ARENAS = ("fp32", "int8")  # the refresh job's arena precisions
# each world's jobs after the cases: the reference's init, the refresh jobs, the
# ranks' checkpoint save, the stacked checkpoint handed to the ranks
REF_JOB = len(CASES)
REFRESH_JOB = {a: REF_JOB + 1 + i for i, a in enumerate(ARENAS)}
SAVED_JOB = REF_JOB + 1 + len(ARENAS)
HANDED_JOB = SAVED_JOB + 1
RTOL, ATOL = 1e-5, 1e-6
# every leaf the gradients reach: the trained floats (and an encoded host tier's codes)
TRAINED = ("cached_rows", ".full.", ".rep.rows", "['params']", "['opt']")


@pytest.fixture(autouse=True)
def one_thread():
    """The in-process references on one thread, as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(S, case):
    return DLRMConfig(**BASE, model_shards=S, **CASES[case])


def _refresh_cfg(S, arena):
    """The refresh job's config: K 8, its arena fp32 or int8-tiered (the
    rows a pass moves out of the arena decode through ``gather_decode``'s
    plain version)."""
    return DLRMConfig(**BASE, model_shards=S, replicate_top_k=8, arena_precision=arena)


def _batch(cfg, stream, i):
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    return {k: torch.from_numpy(v) for k, v in
            synth.sparse_batch(spec, cfg.batch_size, stream, i).items()}


def _stacked(cfg, steps=STEPS, state=None, serve=0):
    """The one-process stacked layout on the global batches: (losses, serve
    scores, count metrics, state)."""
    model = DLRM(cfg)
    state = model.init(0, device="cpu") if state is None else state
    scores = []
    for i in range(serve):
        logits, emb = model.serve_step(state, _batch(cfg, 0, i))
        scores.append(logits.detach().numpy())
        state = dict(state, emb=emb)
    losses, counts = [], []
    for i in range(steps):
        state, m = model.train_step(state, _batch(cfg, 1, i))
        losses.append(float(m["loss"]))
        counts.append(rank_jobs.count_metrics(m))
    return losses, scores, counts, state


def _trained(key):
    return any(t in key for t in TRAINED)


def _unshard(ranks, key, specs):
    """The stacked leaf ``key`` from the data-rank-0 ranks' leaves (``ranks``
    in model-rank order)."""
    if key in specs:
        return torch.cat([r[key] for r in ranks])
    return ranks[0][key]


def _jobs(D, S, d):
    jobs = []
    for case in CASES:  # the port's init: integer state bitwise (1, S), floats within tol
        job = dict(cfg=_cfg(S, case), train=STEPS, serve=SERVE if case == "k8" else 0,
                   replicated=True, digests=True, state_out=True)
        if case == "k8":  # the lookahead (and the refresh) under the same mesh
            job.update(pipelined=STEPS, depth=2, refresh_interval=2)
        jobs.append(job)
    jm = JDLRM(JDLRMConfig(**BASE, model_shards=S))  # the reference's init
    jobs.append(dict(cfg=_cfg(S, "k0"), train=STEPS,
                     state_np=jax_to_numpy(jm.init(jax.random.PRNGKey(0)))))
    for arena in ARENAS:  # the refresh and the re-homing, from the ranks' own state
        jobs.append(dict(cfg=_refresh_cfg(S, arena), train=3, flush=False,
                         refresh=dict(cfg=REFRESH, rebalance=0.0, cool_head=True)))
    # the checkpoint both ways: the ranks' save (read into the stacked layout by the
    # test) and a stacked save read into the ranks
    cfg = _cfg(S, "int8")
    _, _, _, st = _stacked(cfg, steps=CKPT_STEPS)
    st = DLRM(cfg).flush(st)
    ckpt.save(d / "stacked", CKPT_STEPS, st)
    jobs.append(dict(cfg=cfg, train=CKPT_STEPS, save=str(d / "ranks"), state_out=True,
                     next_step=True))
    jobs.append(dict(cfg=cfg, restore=str(d / "stacked"), next_step=True,
                     next_index=CKPT_STEPS, digests=True))
    return jobs, st


_WORLDS = {}


def world(D, S, tmp_root):
    if (D, S) not in _WORLDS:
        d = Path(tmp_root) / f"world_{D}x{S}"
        d.mkdir(parents=True, exist_ok=True)
        jobs, stacked_save = _jobs(D, S, d)
        res = run.run_ranks(rank_jobs.dlrm_rank, D * S, "gloo", "cpu", (jobs,), threads=1)
        _WORLDS[D, S] = dict(res=res, dir=d, stacked_save=stacked_save)
    return _WORLDS[D, S]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("data_ranks")


@pytest.fixture(scope="module")
def ref_losses():
    """The reference's single-device sharded DLRM on the global batches,
    from its own init, by shard count."""
    out = {}
    for S in sorted({s for _, s in SHAPES}):
        jm = JDLRM(JDLRMConfig(**BASE, model_shards=S))
        js = jm.init(jax.random.PRNGKey(0))
        step = jax.jit(jm.train_step)
        losses = []
        for i in range(STEPS):
            js, m = step(js, {k: jax.numpy.asarray(v.numpy())
                              for k, v in _batch(_cfg(S, "k0"), 1, i).items()})
            losses.append(float(m["loss"]))
        out[S] = losses
    return out


# --------------------------------------------------------------------------
# without a spawn
# --------------------------------------------------------------------------


def test_data_sum_is_the_same_bits_in_data_rank_order():
    """``data_sum`` over a coordinate at ``data == 1`` is the identity, and
    the ordered sum it takes is left to right."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    want = (g[0] + g[1]) + g[2]
    assert torch.equal(exchange._ordered_sum(g), want)
    mesh = HybridMesh.coordinate(2, 1)
    sums, gathers = exchange.data_sum([g[0]], mesh, [g[1]])
    assert torch.equal(sums[0], g[0]) and torch.equal(gathers[0], g[1])


def test_data_slice_is_the_replicas_rows():
    """``HybridMesh.data_slice``: replica ``d`` of ``D`` holds rows ``[d *
    B / D, (d + 1) * B / D)``, laid end to end in data-rank order they are
    the global batch; the whole batch at ``D == 1``; a batch that does not
    split is refused."""
    x = np.arange(24).reshape(12, 2)
    for D in (1, 2, 3, 4):
        parts = [HybridMesh.coordinate(2, 1, d, D).data_slice(x) for d in range(D)]
        assert all(p.shape == (12 // D, 2) for p in parts)
        assert np.array_equal(np.concatenate(parts), x)
    t = torch.arange(12)
    assert HybridMesh.coordinate(2, 0).data_slice(t) is t
    with pytest.raises(ValueError, match="does not split over data=5"):
        HybridMesh.coordinate(1, 0, 0, 5).data_slice(t)


def test_launcher_refuses_a_batch_the_replicas_cannot_split(monkeypatch):
    monkeypatch.setattr(run.mp, "spawn", lambda *a, **k: pytest.fail("a rank was spawned"))
    with pytest.raises(SystemExit, match="does not split over data=2"):
        train_launch.main(["--steps", "1", "--batch", "15", "--model-shards", "2", "--ranks",
                           "4", "--backend", "gloo", "--device", "cpu"])


# --------------------------------------------------------------------------
# the ranks: one world a mesh shape
# --------------------------------------------------------------------------


@pytest.mark.parametrize("D,S", SHAPES)
@pytest.mark.parametrize("case", list(CASES))
def test_data_ranks_hold_the_stacked_layout(D, S, case, tmp_root):
    """Every rank's integer state and tracker bitwise the stacked layout's
    shard on the global batches, and the count-valued metrics step by
    step; the losses and the trained floats within the stated tolerance
    (bitwise at ``D == 1``); the replicas of each shard bitwise equal, and
    every rank's replicated leaves (MLPs, head, routing maps) too."""
    w = world(D, S, tmp_root)
    i = list(CASES).index(case)
    cfg = _cfg(S, case)
    losses, _, counts, state = _stacked(cfg, serve=SERVE if case == "k8" else 0)
    model = DLRM(cfg)
    state = model.flush(state)  # as the ranks flush after their steps
    specs = model.state_specs()
    by_shard = {}
    for r in w["res"]:
        got = r[i]
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=0)
        if D == 1:
            assert got["losses"] == losses
        assert got["metrics"] == [{k: v for k, v in c.items()} for c in counts]
        want = dict(ckpt._flatten(shard_state(state, specs, HybridMesh.coordinate(S, got[
            "model_rank"]))))
        assert set(want) == set(got["state"])
        for k, a in want.items():
            b = got["state"][k]
            if _trained(k) and a.is_floating_point():
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=k)
            elif not _trained(k):
                assert a.dtype == b.dtype and torch.equal(a, b), k
        by_shard.setdefault(got["model_rank"], []).append(got["digests"])
        assert got["replicated"] == w["res"][0][i]["replicated"], got["rank"]
        assert all(c["uniq_overflows"] == 0 for c in got["metrics"])
    for digests in by_shard.values():
        assert all(x == digests[0] for x in digests)


@pytest.mark.parametrize("D,S", SHAPES)
def test_data_ranks_match_reference_single_device(D, S, tmp_root, ref_losses):
    """From the reference's own init: within rtol 1e-5 of its single-device
    sharded DLRM on the same global batches, every rank the same."""
    w = world(D, S, tmp_root)
    i = REF_JOB
    for r in w["res"]:
        assert r[i]["losses"] == w["res"][0][i]["losses"]
        np.testing.assert_allclose(r[i]["losses"], ref_losses[S], rtol=1e-5, atol=0)


@pytest.mark.parametrize("D,S", SHAPES)
def test_data_ranks_pipelined_losses_bitwise_serial(D, S, tmp_root):
    """The ``PipelinedTrainer`` at depth 2 (the window's ids gathered over
    the data axis, its addresses from the owners' index images) with a
    refresh every 2 steps, bitwise the serial steps under the same mesh."""
    w = world(D, S, tmp_root)
    i = list(CASES).index("k8")
    for r in w["res"]:
        assert r[i]["pipe_losses"] == r[i]["losses"], r[i]["rank"]


@pytest.mark.parametrize("D,S", SHAPES)
def test_data_ranks_serve_scores_match_stacked(D, S, tmp_root):
    """Each replica scores its slice and every rank holds the whole batch's
    scores: bitwise at ``D == 1``, within rtol 1e-5 at ``D > 1`` (a
    replica's MLP runs on a smaller batch), the same on every rank."""
    w = world(D, S, tmp_root)
    i = list(CASES).index("k8")
    _, scores, _, _ = _stacked(_cfg(S, "k8"), steps=0, serve=SERVE)
    want = np.concatenate(scores)
    for r in w["res"]:
        assert np.array_equal(r[i]["scores"], w["res"][0][i]["scores"])
        np.testing.assert_allclose(r[i]["scores"], want, rtol=1e-5, atol=1e-6)
        if D == 1:
            assert np.array_equal(r[i]["scores"], want)


@pytest.mark.parametrize("arena", ARENAS)
@pytest.mark.parametrize("D,S", SHAPES)
def test_data_ranks_refresh_and_rebalance_bitwise_stacked(D, S, arena, tmp_root):
    """A refresh pass (``exchange_budget`` metering the cross-shard pairs;
    the replicated head made the coldest ranks, so it demotes the head's
    ranks and the head pulls the promoted rows from their owners) and a
    forced re-homing across the ranks, from the ranks' own state:
    every rank's state after each pass bitwise the stacked layout's pass
    from the same state (the swaps, homes, rows, host slices and trackers),
    and a lookup and ``dense_reference`` after them bitwise the stacked
    layout's on the replica's rows; with an fp32 arena and an int8-tiered
    one (whose rows leave the arena decoded)."""
    w = world(D, S, tmp_root)
    i = REFRESH_JOB[arena]
    cfg = _refresh_cfg(S, arena)
    model = DLRM(cfg)
    stacked = model.init(0, device="cpu")
    coll = model.collection
    split = sharded_paths(coll.shard_specs())
    lead = sorted((r[i] for r in w["res"] if r[i]["data_rank"] == 0),
                  key=lambda r: r["model_rank"])
    for key, t in ckpt._flatten(stacked["emb"]):
        t.copy_(_unshard([r["refresh_before"] for r in lead], key, split))
    emb, rep = coll.refresh(stacked["emb"], refresh_lib.RefreshConfig(**REFRESH))
    after = {k: v.clone() for k, v in ckpt._flatten(emb)}  # the passes update in place
    emb, reb = coll.refresh(emb, refresh_lib.RefreshConfig(max_swaps=0, rebalance_threshold=0.0))
    rebalanced = {k: v.clone() for k, v in ckpt._flatten(emb)}
    assert rep.total_swaps > 0
    assert not torch.equal(after[".slabs['__shared__'].rep.rows"],
                           lead[0]["refresh_before"][".slabs['__shared__'].rep.rows"])
    assert sum(reb.rebalance_moves.values()) > 0 or S == 1  # one shard: every home stays
    fb = model.features(_batch(cfg, 1, 99))
    dense = coll.dense_reference(emb, fb)
    emb, _, rows = coll.lookup(emb, fb)
    for r in w["res"]:
        got = r[i]
        assert got["refresh_report"]["swaps"] == rep.swaps
        assert got["refresh_report"]["deferred_swaps"] == rep.deferred_swaps
        assert got["refresh_report"]["cross_shard_rows"] == rep.cross_shard_rows
        assert got["rebalance_report"]["rebalance_moves"] == reb.rebalance_moves
        mesh = HybridMesh.coordinate(S, got["model_rank"])
        for whole, mine in ((after, got["refresh_after"]), (rebalanced, got["rebalance_after"])):
            assert set(whole) == set(mine)
            for k, a in whole.items():
                want = a[mesh.model_rank : mesh.model_rank + 1] if k in split else a
                assert want.dtype == mine[k].dtype and torch.equal(want, mine[k]), k
        b = cfg.batch_size // D
        lo = got["data_rank"] * b
        for f in fb.features:
            assert torch.equal(got["probe_dense"][f], dense[f][lo : lo + b]), f
            assert torch.equal(got["probe_rows"][f], rows[f][lo : lo + b]), f


@pytest.mark.parametrize("D,S", SHAPES)
def test_data_ranks_checkpoint_moves_to_and_from_the_stacked_layout(D, S, tmp_root):
    """The ranks' save (data rank 0 of each shard writes it) restored into
    one process's stacked layout is bitwise the ranks' state; a stacked
    save restored into the ranks is bitwise each shard of it, and their
    next steps agree on every rank."""
    w = world(D, S, tmp_root)
    cfg = _cfg(S, "int8")
    saved, handed = SAVED_JOB, HANDED_JOB
    model = DLRM(cfg)
    specs = sharded_paths(model.state_specs())
    state, step = ckpt.restore(w["dir"] / "ranks", model.init(1, device="cpu"))
    assert step == CKPT_STEPS
    lead = sorted((r[saved] for r in w["res"] if r[saved]["data_rank"] == 0),
                  key=lambda r: r["model_rank"])
    for k, t in ckpt._flatten(state):
        assert torch.equal(t, _unshard([r["state"] for r in lead], k, specs)), k
    st = w["stacked_save"]
    for r in w["res"]:
        assert r[saved]["next_loss"] == w["res"][0][saved]["next_loss"]
        assert r[handed]["next_loss"] == w["res"][0][handed]["next_loss"]
        mine = shard_state(st, model.state_specs(), HybridMesh.coordinate(S, r[handed][
            "model_rank"]))
        assert r[handed]["digests"] == rank_jobs.shard_digests(mine)
    ranks_dir = sorted((w["dir"] / "ranks").glob("step_*"))[-1]
    assert sorted(p.name for p in ranks_dir.glob("shard_*")) == [f"shard_{s:04d}"
                                                                for s in range(S)]


def test_launcher_trains_data_replicas_with_the_window_and_the_refresh():
    """``launch/train.py --ranks 4 --model-shards 2`` (a (2, 2) mesh) with
    ``--pipeline-depth 2`` and ``--refresh-interval 2``: every rank's losses
    the same, within rtol 1e-5 of ``--model-shards 2`` in one process."""
    common = ["--device", "cpu", "--steps", "4", "--batch", "16", "--model-shards", "2",
              "--replicate-top-k", "8", "--pipeline-depth", "2", "--refresh-interval", "2"]
    one = [h["loss"] for h in train_launch.main(common).history]
    ranks = train_launch.main(common + ["--ranks", "4", "--backend", "gloo"])
    got = [[h["loss"] for h in r["history"]] for r in ranks]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], one, rtol=1e-5, atol=0)
