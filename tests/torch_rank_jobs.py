"""The rank jobs of the hybrid-parallel tests and of ``chip_smoke.py``'s
phase 19, run through ``repro_torch.dist.run.run_ranks``.

Not part of the package: ``test_torch_dist.py``, ``test_torch_cuda.py`` and
``chip_smoke.py`` import it from ``tests/`` (the smoke puts that directory
on ``sys.path``), and each spawned rank imports it by name on the parent's
``sys.path``.  It imports neither JAX nor the JAX package.

* :func:`dlrm_rank` runs a list of jobs, each on a fresh mesh: a DLRM's
  init, a serve engine, train steps, a flush, a checkpoint save or
  restore, a step after it, digests of the rank's shard and of its
  replicated leaves, and on the card the kernel launches and host syncs
  of one step; or collection lookups (addresses, rows, state, metrics) on
  one shard.
* On the card, bitwise comparisons run under :func:`deterministic`, which
  each rank enters itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.analysis.census import sync_census
from repro_torch.core import cache as cache_lib
from repro_torch.core.collection import FeatureBatch
from repro_torch.core.sharded import ShardedEmbeddingCollection, ShardedSlab
from repro_torch.core.transmitter import num_rounds
from repro_torch.data import synth
from repro_torch.dist.partitioning import shard_state, sharded_paths
from repro_torch.kernels.cache_ops import kernel
from repro_torch.launch.mesh import make_hybrid_mesh
from repro_torch.models.dlrm import DLRM
from repro_torch.serve.engine import ServeEngine
from repro_torch.store.arena import ArenaStore
from repro_torch.store.codec import get_codec
from repro_torch.train import checkpoint as ckpt


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms, for bitwise comparisons on the card
    (``index_add_``, the gather's backward, sums duplicate lanes with
    atomics otherwise); uninitialised memory is left unfilled."""
    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (equal digests: bitwise equal tensors)."""
    return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()).hexdigest()


def shard_digests(state: Dict[str, Any]) -> Dict[str, str]:
    """Digests of every cached slab's arena and host slice (payload and
    sideband) and replicated head, by path."""
    out = {}
    for sname, slab in state["emb"].slabs.items():
        if not isinstance(slab, ShardedSlab):
            continue
        rows = slab.cache.cached_rows
        tiers = ({f"{t}/{k}": v for t in ("head", "tail", "sideband")
                  for k, v in getattr(rows, t).items()} if isinstance(rows, ArenaStore)
                 else dict(rows))
        for k, v in tiers.items():
            out[f"{sname}/arena/{k}"] = digest(v)
        for k, v in slab.full.data.items():
            out[f"{sname}/host/{k}"] = digest(v)
        for k, v in slab.full.sideband.items():
            out[f"{sname}/host_side/{k}"] = digest(v)
        out[f"{sname}/rep"] = digest(slab.rep.rows)
        out[f"{sname}/slot_to_row"] = digest(slab.cache.slot_to_row)
    return out


# ----- DLRM jobs --------------------------------------------------------------


def _launches() -> Dict[str, int]:
    return {"bucketize": kernel.bucketize.launches,
            "route_bucketize": kernel.bucketize.fused_launches,
            "victim_threshold": kernel.victim_threshold.launches,
            "gather_decode": kernel.gather_decode.launches,
            "gather_decode_encode": kernel.gather_decode.fused_launches}


def _zero_launches() -> None:
    kernel.bucketize.launches = kernel.bucketize.fused_launches = 0
    kernel.victim_threshold.launches = 0
    kernel.gather_decode.launches = kernel.gather_decode.fused_launches = 0


class _Rounds:
    """The write-back and flush rounds the plans imply (one gather-decode
    launch each from a tiered arena), counted off ``cache.apply_plan`` /
    ``cache.flush`` calls."""

    def __init__(self):
        self.lib, self.apply, self.flush = cache_lib, cache_lib.apply_plan, cache_lib.flush
        self.writeback = self.flushed = 0

    def __enter__(self):
        def apply(cfg, full, state, plan):
            if cfg.writeback:
                n = int(plan.evict_active.sum())
                self.writeback += num_rounds(n, max(1, min(cfg.buffer_rows,
                                                           int(plan.victim_slots.shape[0]))))
            return self.apply(cfg, full, state, plan)

        def flush(cfg, full, state):
            cap = int(state.slot_to_row.shape[0])
            n = int((state.slot_to_row >= 0).sum())
            self.flushed += num_rounds(n, max(1, min(cfg.buffer_rows, cap)))
            return self.flush(cfg, full, state)

        self.lib.apply_plan, self.lib.flush = apply, flush
        return self

    def __exit__(self, *exc):
        self.lib.apply_plan, self.lib.flush = self.apply, self.flush


def _arena_image(coll, emb, addresses, rows):
    """The uncached rows as a tiered arena holds them: a lane whose slot is
    in an encoded tail reads its host row through the arena codec (the
    fp32 head and the replicated head read it as it is)."""
    out = dict(rows)
    for sname in coll.cached_slabs:
        arena = emb.slabs[sname].cache.cached_rows
        if not isinstance(arena, ArenaStore):
            continue
        c, head, cap = get_codec(arena.codec), arena.head_capacity, arena.capacity
        member = {t.name for t in coll.cached_slabs[sname].tables}
        for f, a in addresses.items():
            if coll.feature_to_table[f] not in member:
                continue
            r = rows[f].reshape(-1, rows[f].shape[-1])
            coded = c.decode(*c.encode(r), r.dtype).reshape(rows[f].shape)
            tail = ((a >= 0) & (a < coll.num_shards * cap) & (a % cap >= head))[..., None]
            out[f] = torch.where(tail, coded, rows[f])
    return out


def _rss_gb() -> float:
    """This process's resident host memory now, GB (``VmRSS``; getrusage's
    ``ru_maxrss`` of a spawned process keeps its parent's peak)."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return kb * 1024 / 1e9


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dlrm_job(rank: int, dev: torch.device, job: Dict[str, Any]) -> Dict[str, Any]:
    """One DLRM job on this rank; see :func:`dlrm_rank`."""

    cfg = job["cfg"]
    mesh = make_hybrid_mesh(cfg.model_shards)
    model = DLRM(cfg, mesh=mesh)
    coll = model.collection
    out: Dict[str, Any] = {"rank": rank, "model_rank": mesh.model_rank}
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    _sync(dev)
    out["init_s"] = time.perf_counter() - t0
    rss = [_rss_gb()]
    if job.get("state_np") is not None:  # a stacked state (numpy tree): this rank's shard of it
        state = shard_state(convert.state_from_numpy(job["state_np"], device=dev),
                            model.state_specs(), mesh)
    out["host_process_bytes"] = sum(
        s.full.host_bytes() for n, s in state["emb"].slabs.items() if n in coll.cached_slabs)
    if job.get("restore"):
        state, _ = ckpt.restore(job["restore"], state, mesh=mesh, specs=model.state_specs())
    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)

    def batch(stream: int, i: int) -> Dict[str, np.ndarray]:
        return synth.sparse_batch(bspec, cfg.batch_size, stream, i)

    def on_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    if job.get("prepare"):  # plans and row movement only, over batches 0 .. n of stream 0
        emb = state["emb"]
        keys = ("exchange_bytes", "exchange_id_bytes", "exchange_row_bytes", "uniq_overflows")
        marks = []
        for i in range(job["prepare"] + 1):
            b = on_dev(batch(0, i))
            emb = coll.prepare(emb, model.features(b))[0]
            if i in (0, job["prepare"]):
                m = coll.metrics(emb)
                marks.append({k: float(m[k]) for k in keys})
        out["prepare_metrics"] = marks
        state = dict(state, emb=emb)
    count = job.get("count", False)  # kernel launches and rounds, on the card
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n_serve = job.get("serve", 0)
    if n_serve:
        pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
               "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
        engine = ServeEngine(model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad,
                             device=dev, mesh=mesh,
                             state_stats_fn=lambda s: coll.metrics(s["emb"], writeback=False))
        if job.get("warm_serve"):  # allocator, cuBLAS: not counted or timed
            engine.score(batch(0, n_serve + 1))
            engine.stats = type(engine.stats)()
        mesh.traffic.reset()
        if count:
            _zero_launches()
        scores, lat = [], []
        for i in range(n_serve):
            t0 = time.perf_counter()
            scores.append(engine.score(batch(0, i)))
            lat.append(1e3 * (time.perf_counter() - t0))
        out["scores"] = np.concatenate(scores)
        out["serve_ms"] = lat
        out["serve_traffic"] = dataclasses.asdict(mesh.traffic)
        if count:
            out["serve_launches"] = _launches()
        summary = engine.summary()
        out["serve_summary"] = {k: v for k, v in summary.items() if not isinstance(v, dict)}
        state = engine.state
        rss.append(_rss_gb())
        if job.get("check_dense"):  # cached logits against the uncached oracle
            b = on_dev(batch(0, n_serve))
            fb = model.features(b)
            emb, addr, rows = coll.lookup(state["emb"], fb, writeback=False)
            logits = model.fwd(state["params"], rows, b)
            ref = model.fwd(state["params"], _arena_image(coll, emb, addr,
                                                          coll.dense_reference(emb, fb)), b)
            out["dense_diff"] = float((logits - ref).abs().max())
            out["dense_close"] = bool(torch.allclose(logits, ref, rtol=job["check_dense"][0],
                                                     atol=job["check_dense"][1]))
            state = dict(state, emb=emb)
    n_train = job.get("train", 0)
    stream = 1
    if job.get("warm_train") and n_train:  # the step that warms the allocator and autograd
        warm = job.get("warm_index", n_train + 4)
        state, m = model.train_step(state, on_dev(batch(stream, warm)))
        float(m["loss"])
    mesh.traffic.reset()
    losses, step_ms, metrics = [], [], []
    rounds = _Rounds() if count else contextlib.nullcontext()
    if count:
        _zero_launches()
    with rounds:
        for i in range(n_train):
            b = on_dev(batch(stream, i))
            t0 = time.perf_counter()
            state, m = model.train_step(state, b)
            losses.append(float(m["loss"]))  # the step's one sync
            step_ms.append(1e3 * (time.perf_counter() - t0))
            metrics.append(count_metrics(m))
        out["train_traffic"] = dataclasses.asdict(mesh.traffic)  # the counted steps
        if job.get("flush", True) and n_train:
            t0 = time.perf_counter()
            state = model.flush(state)
            _sync(dev)
            out["flush_ms"] = 1e3 * (time.perf_counter() - t0)
    rss.append(_rss_gb())
    if count:
        out["train_launches"] = _launches()
        out["rounds"] = {"writeback": rounds.writeback, "flush": rounds.flushed}
    if job.get("census"):  # one more step's host syncs in the port, by site (on the card)
        b = on_dev(batch(stream, n_train + 5))
        _sync(dev)
        with sync_census() as c:
            state, m = model.train_step(state, b)
        _sync(dev)
        float(m["loss"])
        out["census"] = dict(c.summary(), port_sites=c.port_sites())
    out.update(losses=losses, step_ms=step_ms, metrics=metrics)
    if job.get("save"):
        ckpt.save(job["save"], n_train, state, mesh=mesh, specs=model.state_specs())
    if job.get("digests"):
        out["digests"] = shard_digests(state)
    if job.get("replicated"):  # every leaf the state's specs do not split
        split = sharded_paths(model.state_specs())
        out["replicated"] = {k: digest(v) for k, v in ckpt._flatten(state) if k not in split}
    if job.get("next_step"):  # one more step (after a save: the hand-off's)
        state, m = model.train_step(state, on_dev(batch(stream, job.get("next_index", n_train))))
        out["next_loss"] = float(m["loss"])
    if dev.type == "cuda":
        out["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    rss.append(_rss_gb())
    out["rss_gb"] = rss  # after init, serving, training and at the end
    out["device_bytes"] = {k: v for k, v in coll.device_bytes().items() if k != "per_slab"}
    for slab in state["emb"].slabs.values():
        if hasattr(slab, "full"):
            slab.full.close()
    return out


def count_metrics(m: Dict[str, Any]) -> Dict[str, Any]:
    """The count-valued metrics of a step, as Python numbers."""
    out = {}
    for k in ("cache_misses", "cache_evictions", "uniq_overflows", "exchange_id_bytes",
              "exchange_row_bytes", "exchange_bytes", "hit_rate"):
        if k in m:
            out[k] = float(m[k])
    for k in ("exchange_routed_lanes", "slab_hits", "host_moved_rows"):
        if k in m:
            out[k] = {n: int(v) for n, v in m[k].items()}
    if "exchange_per_shard_lanes" in m:
        out["exchange_per_shard_lanes"] = [int(v) for v in m["exchange_per_shard_lanes"]]
    return out


def dlrm_rank(rank: int, dev: torch.device, jobs: Sequence[Dict[str, Any]]) -> List[Dict]:
    """Each DLRM job in turn on this rank (a fresh model and state each).
    A job: ``cfg`` (a sharded ``DLRMConfig``; its ``model_shards`` is the
    world; the init from seed 0); ``serve`` batches of stream 0 through a
    ``ServeEngine`` (``warm_serve`` first, ``check_dense`` (rtol, atol)
    against ``dense_reference`` after); ``train`` steps of stream 1
    (``warm_train`` first, on batch ``warm_index``; ``census`` of one more
    step after the flush), then a flush (unless ``flush`` is False);
    ``state_np``, a stacked state (numpy tree) to start from; ``prepare``
    n: plans over batches 0 .. n alone, the exchange metrics after the
    first and the last; ``restore`` / ``save`` a checkpoint directory,
    ``next_step`` (batch ``next_index``, default ``train``); ``digests``
    of the rank's shard, ``replicated`` digests of the leaves every rank
    holds whole; ``count`` kernel launches and the rounds the plans imply;
    ``deterministic``.  A job with ``tables`` runs collection lookups
    instead (``_lookup_job``)."""
    out = []
    for job in jobs:
        ctx = deterministic() if job.get("deterministic") else contextlib.nullcontext()
        with ctx:
            out.append((_lookup_job if "tables" in job else _dlrm_job)(rank, dev, job))
    return out


# ----- collection lookups -------------------------------------------------------


def _lookup_job(rank: int, dev: torch.device, job: Dict[str, Any]) -> Dict[str, Any]:
    """Collection lookups on one shard: ``job`` holds ``tables``, ``S``,
    ``kw`` (``ShardedEmbeddingCollection.create`` keywords), ``counts``,
    ``state`` (a stacked state to take this rank's shard of; None: the init
    from seed 0) and ``steps`` (feature -> int32 ids, one dict a lookup).
    Returns each lookup's addresses and rows, the state after the last
    one (and after a flush), and the metrics."""

    mesh = make_hybrid_mesh(job["S"])
    coll = ShardedEmbeddingCollection.create(job["tables"], num_shards=job["S"], mesh=mesh,
                                             **job["kw"])
    state = coll.init(0, counts=job.get("counts"), device=dev)
    if job.get("state") is not None:  # a stacked state: this rank's shard of it
        state = shard_state(job["state"], coll.shard_specs(), mesh)
    steps = []
    for ids in job["steps"]:
        fb = FeatureBatch(ids={k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
                               for k, v in ids.items()})
        state, addr, rows = coll.lookup(state, fb)
        steps.append({"addresses": {k: v.cpu() for k, v in addr.items()},
                      "rows": {k: v.detach().cpu() for k, v in rows.items()}})
    m = coll.metrics(state)
    metrics = {k: (float(v) if not isinstance(v, dict) and torch.as_tensor(v).dim() == 0
                   else ({n: int(x) for n, x in v.items()} if isinstance(v, dict)
                         else torch.as_tensor(v).cpu()))
               for k, v in m.items()}
    before = {k: v.detach().cpu().clone() for k, v in ckpt._flatten(state)}
    flushed = coll.flush(state)
    after = {k: v.detach().cpu().clone() for k, v in ckpt._flatten(flushed)}
    return {"steps": steps, "metrics": metrics, "state": before, "flushed": after,
            "model_rank": mesh.model_rank, "traffic": dataclasses.asdict(mesh.traffic)}
