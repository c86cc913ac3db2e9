"""The rank jobs of the hybrid-parallel tests and of ``chip_smoke.py``'s
phase 19, run through ``repro_torch.dist.run.run_ranks``.

Not part of the package: ``test_torch_dist.py``, ``test_torch_cuda.py`` and
``chip_smoke.py`` import it from ``tests/`` (the smoke puts that directory
on ``sys.path``), and each spawned rank imports it by name on the parent's
``sys.path``.  It imports neither JAX nor the JAX package.

* :func:`dlrm_rank` runs a list of jobs, each on a fresh mesh (``(data =
  world / S, model = S)``; a rank feeds its data replica's rows of every
  global batch): a DLRM's init, a serve engine, train steps (serial, or
  a ``PipelinedTrainer`` group), a refresh and a forced rebalance across
  the ranks, a flush, a checkpoint save or restore, a step after it,
  digests of the rank's shard and of its replicated leaves, and on the
  card the kernel launches and host syncs of one step; or collection
  lookups (addresses, rows, state, metrics) on one shard.
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
from repro_torch.core import refresh as refresh_lib
from repro_torch.core import transmitter
from repro_torch.core.collection import FeatureBatch
from repro_torch.core.sharded import ShardedEmbeddingCollection, ShardedSlab
from repro_torch.core.transmitter import num_rounds
from repro_torch.data import synth
from repro_torch.dist.mesh import HybridMesh
from repro_torch.dist.partitioning import shard_state, sharded_paths
from repro_torch.kernels.cache_ops import kernel
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.launch.mesh import make_hybrid_mesh
from repro_torch.models.dlrm import DLRM
from repro_torch.serve.engine import ServeEngine
from repro_torch.store.arena import ArenaStore
from repro_torch.store.codec import get_codec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import PipelinedTrainer, TrainerConfig


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
            "gather_decode_encode": kernel.gather_decode.fused_launches,
            "embedding_bag": eb_kernel.embedding_bag_multi.launches}


def _zero_launches() -> None:
    kernel.bucketize.launches = kernel.bucketize.fused_launches = 0
    kernel.victim_threshold.launches = 0
    kernel.gather_decode.launches = kernel.gather_decode.fused_launches = 0
    eb_kernel.embedding_bag_multi.launches = 0


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


class _ArenaRounds:
    """The rounds of the row moves out of a tiered arena (one gather-decode
    launch each: the refresh's write-backs, the re-homing's flush), counted
    off ``transmitter.move_rows`` calls."""

    def __init__(self):
        self.move = transmitter.move_rows
        self.rounds = 0

    def __enter__(self):
        def move(src, dst, src_idx, dst_idx, active, *, buffer_rows, **kw):
            if isinstance(src, ArenaStore):
                self.rounds += num_rounds(int(active.sum()),
                                          max(1, min(buffer_rows, int(src_idx.shape[0]))))
            return self.move(src, dst, src_idx, dst_idx, active, buffer_rows=buffer_rows, **kw)

        transmitter.move_rows = move
        return self

    def __exit__(self, *exc):
        transmitter.move_rows = self.move


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

    t_job = time.perf_counter()
    cfg = job["cfg"]
    mesh = make_hybrid_mesh(cfg.model_shards)
    model = DLRM(cfg, mesh=mesh)
    coll = model.collection
    out: Dict[str, Any] = {"rank": rank, "model_rank": mesh.model_rank,
                           "data_rank": mesh.data_rank}
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

    def on_dev(b):  # this data replica's rows of a global batch, on the device
        return {k: torch.from_numpy(mesh.data_slice(v)).to(dev) for k, v in b.items()}

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
        if job.get("bag"):  # a bag step through pool's kernel route
            out.update(_dlrm_bag(model, state, mesh, dev, job["bag"], count))
            state = out.pop("state")
        if job.get("flush", True) and (n_train or job.get("bag")):
            t0 = time.perf_counter()
            state = model.flush(state)
            _sync(dev)
            out["flush_ms"] = 1e3 * (time.perf_counter() - t0)
            if job.get("check_flushed"):
                out["flushed_rows"] = check_flushed(coll, state["emb"])
    rss.append(_rss_gb())
    if count:
        out["train_launches"] = _launches()
        out["rounds"] = {"writeback": rounds.writeback, "flush": rounds.flushed}
    n_pipe = job.get("pipelined", 0)
    if n_pipe:  # a PipelinedTrainer (depth ``depth``) from a fresh init, on stream 1
        got, st = _pipelined(model, mesh, dev, lambda s: batch(1, s), n_pipe,
                             job.get("depth", 2), job.get("refresh_interval"), count,
                             lambda: model.init(0, device=dev))
        out.update(got)
        _close(st)
    if job.get("group"):  # one PipelinedTrainer group of that depth, from this state
        k = job["group"]
        got, state = _pipelined(model, mesh, dev, lambda s: batch(1, n_train + 10 + s), k, k,
                                None, count, lambda: state)
        out.update(got)
    if job.get("refresh") is not None:  # a refresh pass, then (optionally) a forced re-homing
        got, emb = _refresh(model, state, dev, on_dev, batch, job["refresh"], count)
        out.update(got)
        state = dict(state, emb=emb)
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
    if job.get("state_out"):  # every leaf, on the host
        out["state"] = {k: v.detach().cpu().clone() for k, v in ckpt._flatten(state)}
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
    _close(state)
    out["job_s"] = time.perf_counter() - t_job
    return out


def _close(state) -> None:
    for slab in state["emb"].slabs.values():
        if hasattr(slab, "full"):
            slab.full.close()


def global_bags(cfg, names, bags: int, lanes: int, step: int) -> Dict[str, Any]:
    """A global bag step of ``bags`` bags of ``lanes`` slots a feature, as
    ``chip_smoke.bag_batch`` makes one: a ``synth.sparse_batch`` of ``bags *
    lanes`` rows (stream 2) regrouped per field, each bag 1 to ``lanes``
    lanes long (the rest -1), and a cotangent ``[bags, dim]`` of the size
    a batch-mean loss gives a bag, from seed ``step`` (the same on every
    rank)."""
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    sparse = synth.sparse_batch(spec, bags * lanes, 2, step)["sparse"]
    rng = np.random.default_rng(step)
    ids = {}
    for j, name in enumerate(names):
        x = sparse[:, j].reshape(bags, lanes).copy()
        x[np.arange(lanes)[None, :] >= rng.integers(1, lanes + 1, size=bags)[:, None]] = -1
        ids[name] = x.reshape(-1)
    cot = {n: (rng.standard_normal((bags, cfg.embed_dim)) / bags).astype(np.float32)
           for n in names}
    return {"ids": ids, "bags": bags, "lanes": lanes, "cot": cot}


def _dlrm_bag(model, state, mesh, dev, spec: Dict[str, Any], count: bool) -> Dict[str, Any]:
    """One bag step (:func:`bag_step`, the kernel route only) on the DLRM's
    collection with ``spec`` (``bags``, ``lanes``, ``combiner``, ``step``;
    the update at the model's lr): digests of this replica's pooled rows
    and of the gradients, each launch's output against the kernel's plain
    version on the same gathered lanes (max |diff|, bitwise), its ms and
    traffic, and with ``count`` the launches of the step."""
    coll = model.collection
    step = global_bags(model.cfg, model.feature_names, spec["bags"], spec["lanes"],
                       spec.get("step", 0))
    fb = replica_bags(step, mesh, dev)
    cot = {f: torch.from_numpy(mesh.data_slice(v)).to(dev) for f, v in step["cot"].items()}
    if count:
        before = _launches()
    calls: List[Any] = []
    mesh.traffic.reset()
    _sync(dev)
    t0 = time.perf_counter()
    emb, got = bag_step(coll, state["emb"], fb, cot, spec["combiner"], spec["lanes"],
                        model.cfg.lr, capture=calls, plain=False)
    _sync(dev)
    out: Dict[str, Any] = {"bag_ms": 1e3 * (time.perf_counter() - t0),
                           "bag_traffic": dataclasses.asdict(mesh.traffic)}
    if count:
        out["bag_launches"] = {k: v - before[k] for k, v in _launches().items()}
    err, exact = 0.0, True
    for a, k, kern in calls:  # each slab's launch against the plain version on its inputs
        plain = eb_kernel.embedding_bag_multi_plain(*a, **k)
        err = max(err, float((kern - plain).abs().max()) if kern.numel() else 0.0)
        exact = exact and torch.equal(kern, plain)
    out["bag_calls"] = len(calls)
    out.update(bag_err=err, bag_exact=exact,
               bag_loss=float(got["loss"]),
               bag_pooled={f: digest(x) for f, x in got["pooled"].items()},
               bag_grads={k: digest(x) for k, x in got["grads"].items()},
               state=dict(state, emb=emb))
    return out


def check_flushed(coll, emb) -> int:
    """After a flush, each resident row of every cached slab on this rank:
    its host payload and sideband bitwise its host codec's encode of the
    arena row (shard by shard).  Returns the rows checked; raises on the
    first mismatch."""
    weights = coll.weights(emb)
    n = 0
    for sname in coll.cached_slabs:
        slab = emb.slabs[sname]
        codec = get_codec(slab.full.codec)
        for i in range(slab.cache.slot_to_row.shape[0]):
            rows = slab.cache.slot_to_row[i]
            slots = torch.nonzero(rows >= 0)[:, 0]
            idx = rows[slots].cpu().to(torch.int64)
            payload, side = codec.encode(weights[sname][i][slots])
            shard = slab.full.shard(i)
            ok = torch.equal(payload.cpu(), shard.data["weight"][idx])
            if side is not None:
                ok = ok and torch.equal(side.cpu(), shard.sideband["weight"][idx])
            if not ok:
                raise AssertionError(f"slab {sname} shard {i}: host rows != the "
                                     f"{slab.full.codec} encode of their arena rows after "
                                     f"the flush")
            n += int(slots.numel())
    return n


def _pipelined(model, mesh, dev, make_batch, n_steps, depth, refresh_interval, count, init_fn):
    """``n_steps`` of a ``PipelinedTrainer`` at ``depth`` from ``init_fn()``
    on ``make_batch``'s global batches: its losses, its ms and on the card
    the kernel launches of the run; and the state it ends in."""
    tc = TrainerConfig(max_steps=n_steps, pipeline_depth=depth, refresh_interval=refresh_interval,
                       assert_no_uniq_overflow=True)
    if count:
        _zero_launches()
    trainer = PipelinedTrainer(tc, init_fn=init_fn, plan_fn=model.plan_step,
                               compute_fn=model.compute_step, apply_fn=model.apply_step,
                               make_batch=make_batch, device=dev, mesh=mesh,
                               refresh_fn=model.refresh if refresh_interval else None)
    t0 = time.perf_counter()
    state = trainer.run()
    _sync(dev)
    out = {"pipe_losses": [h["loss"] for h in trainer.history],
           "pipe_ms": 1e3 * (time.perf_counter() - t0),
           "pipe_step_ms": [1e3 * h["time_s"] for h in trainer.history]}
    if count:
        out["pipe_launches"] = _launches()
    return out, state


def _refresh(model, state, dev, on_dev, batch, spec, count=False):
    """One refresh pass (``spec["cfg"]``: ``RefreshConfig`` keywords) and,
    with ``spec["rebalance"]``, a re-homing pass at that threshold, each
    with the state after it on the host (``spec["digests"]``: the leaves'
    digests), the state before the passes (with digests, on data rank 0
    only; with ``spec["cool_head"]`` the replicated head's scores set
    below every other rank's first, so the pass demotes it), the report
    and the ms (with ``count``, each pass's kernel launches and the rounds
    of its moves out of a tiered arena), and the rows of a lookup and of
    ``dense_reference`` on batch ``spec["probe"]`` of stream 1 after the
    passes; returns them and the collection state."""
    coll = model.collection
    emb = state["emb"]
    mesh = coll.mesh

    def leaves(e):  # the state's leaves, or (``spec["digests"]``) their digests
        if spec.get("digests"):
            return {k: digest(v) for k, v in ckpt._flatten(e)}
        return {k: v.detach().cpu().clone() for k, v in ckpt._flatten(e)}

    if spec.get("cool_head"):  # the replicated head made the coldest ranks: the pass demotes it
        for slab in emb.slabs.values():
            if isinstance(slab, ShardedSlab):  # a DEVICE table has no head
                slab.rep.score.fill_(-1.0)
    out: Dict[str, Any] = {}
    if not spec.get("digests") or mesh.data_rank == 0:  # one copy of each shard
        out["refresh_before"] = {k: v.detach().cpu().clone() for k, v in ckpt._flatten(emb)}
    _sync(dev)
    if count:
        _zero_launches()
    moved = _ArenaRounds()
    t0 = time.perf_counter()
    with moved if count else contextlib.nullcontext():
        emb, rep = coll.refresh(emb, refresh_lib.RefreshConfig(**spec["cfg"]))
    _sync(dev)
    out["refresh_ms"] = 1e3 * (time.perf_counter() - t0)
    if count:
        out["refresh_launches"], out["refresh_rounds"] = _launches(), moved.rounds
    out["refresh_report"] = dataclasses.asdict(rep)
    out["refresh_after"] = leaves(emb)
    if spec.get("rebalance") is not None:
        cfg = refresh_lib.RefreshConfig(max_swaps=0, rebalance_threshold=spec["rebalance"])
        mesh.traffic.reset()
        if count:
            _zero_launches()
        moved = _ArenaRounds()
        t0 = time.perf_counter()
        with moved if count else contextlib.nullcontext():
            emb, rep = coll.refresh(emb, cfg)
        _sync(dev)
        out["rebalance_ms"] = 1e3 * (time.perf_counter() - t0)
        if count:
            out["rebalance_launches"], out["rebalance_rounds"] = _launches(), moved.rounds
        out["rebalance_report"] = dataclasses.asdict(rep)
        out["rebalance_traffic"] = dataclasses.asdict(mesh.traffic)
        out["rebalance_after"] = leaves(emb)
    fb = model.features(on_dev(batch(1, spec.get("probe", 99))))
    dense = coll.dense_reference(emb, fb)
    emb, _, rows = coll.lookup(emb, fb)
    out["probe_dense"] = {k: v.detach().cpu() for k, v in dense.items()}
    out["probe_rows"] = {k: v.detach().cpu() for k, v in rows.items()}
    return out, emb


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
    step after the flush), then ``bag``, a bag step (:func:`_dlrm_bag`),
    then a flush (unless ``flush`` is False; ``check_flushed``: every
    resident row's host row the encode of its arena row after it);
    ``state_np``, a stacked state (numpy tree) to start from; ``prepare``
    n: plans over batches 0 .. n alone, the exchange metrics after the
    first and the last; ``restore`` / ``save`` a checkpoint directory,
    ``next_step`` (batch ``next_index``, default ``train``); ``digests``
    of the rank's shard, ``replicated`` digests of the leaves every rank
    holds whole; ``count`` kernel launches and the rounds the plans imply;
    ``deterministic``; each job's ``job_s``.  A job with ``tables`` runs
    collection lookups instead (``_lookup_job``), one with ``bags`` too bag
    steps (``_bag_job``)."""
    out = []
    for job in jobs:
        ctx = deterministic() if job.get("deterministic") else contextlib.nullcontext()
        with ctx:
            fn = _bag_job if "bags" in job else _lookup_job if "tables" in job else _dlrm_job
            out.append(fn(rank, dev, job))
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


# ----- bag steps ------------------------------------------------------------------


def replica_bags(step: Dict[str, Any], mesh, dev: torch.device) -> FeatureBatch:
    """This data replica's part of a global bag step (``step``: feature ->
    int32 ids ``[bags * lanes]``, ``lanes`` slots a bag, -1 padding, and
    ``bags``): its ``bags / data`` bags, their lanes and their segments
    counted from 0."""
    nb = step["bags"] // mesh.data
    ids = {f: torch.from_numpy(mesh.data_slice(np.asarray(v, np.int32))).to(dev)
           for f, v in step["ids"].items()}
    seg = torch.arange(nb, dtype=torch.int32, device=dev).repeat_interleave(step["lanes"])
    return FeatureBatch(ids=ids, segments={f: seg for f in ids}, num_segments=nb)


def bag_step(coll, state, fb, cot, combiner, max_bag, lr, capture=None, plain=True):
    """One bag step: plan (the global batch's at ``data > 1``) and apply,
    (with ``plain``) the rows gathered and ``pool``'s segment-sum route,
    ``pool``'s kernel route (``use_pallas``), loss ``sum_f <pooled_f,
    cot_f>`` differentiated w.r.t. the fast-tier weights, the gradients
    over the data axis as the train step takes them
    (``models.common._data_mean``), then ``apply_grads`` at ``lr`` (none at
    0).  ``capture`` (a list) receives each ``embedding_bag_multi`` call's
    arguments and output.  Returns (state, the step's addresses, rows and
    pooled outputs of both routes, loss and gradients)."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.models import common

    plan = coll.plan_prepare(state, fb)
    state = coll.apply_plan(state, plan)
    w = {k: v.detach().requires_grad_() for k, v in coll.weights(state).items()}
    rows = coll.gather(w, plan.addresses, fb) if plain else {}
    seg_route = coll.pool(rows, fb, combiner) if plain else {}
    multi = eb_ops.embedding_bag_multi
    if capture is not None:
        def watch(*a, **k):
            got = multi(*a, **k)
            capture.append((tuple(x.detach() if isinstance(x, torch.Tensor) else x for x in a),
                            k, got.detach()))
            return got

        eb_ops.embedding_bag_multi = watch
    try:
        pooled = coll.pool({}, fb, combiner, weights=w, addresses=plan.addresses,
                           use_pallas=True, max_bag=max_bag)
    finally:
        eb_ops.embedding_bag_multi = multi
    loss = sum(torch.sum(pooled[f] * cot[f]) for f in fb.segments)
    grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(w.items(), grads)}
    loss = loss.detach()
    mesh = getattr(coll, "mesh", None)
    if mesh is not None and mesh.data > 1:
        z = torch.zeros((1,), device=loss.device)
        _, grads, loss, _, _ = common._data_mean(coll, mesh, {}, grads, loss, z, z,
                                                 plan.grad_rows[0])
    if lr:
        state = coll.apply_grads(state, grads, lr)
    out = {"addresses": plan.addresses, "rows": rows, "pooled": pooled, "plain": seg_route,
           "loss": loss, "grads": grads}
    return state, {k: ({n: t.detach() for n, t in v.items()} if isinstance(v, dict)
                       else v.detach()) for k, v in out.items()}


def stacked_bag_step(coll, state, step, cot, D: int, combiner: str, max_bag: int, lr: float,
                     dev: torch.device):
    """The yardstick of a bag step of ``D`` data replicas in the one-process
    stacked layout: the global batch planned and applied, then each
    replica's bags pooled by the kernel route (and the segment-sum route)
    off the plan's addresses and differentiated alone; the gradients summed
    in data-rank order and scaled by ``1 / D`` as ``_data_mean`` does (the
    whole batch's sum would reassociate), then ``apply_grads`` at ``lr``.
    ``cot``: feature -> the global ``[bags, dim]`` cotangent (numpy).
    Returns (state, each replica's outputs, the gradients, the addresses)."""
    S = getattr(coll, "num_shards", 1)
    fb = replica_bags(step, HybridMesh.coordinate(S, 0), dev)
    plan = coll.plan_prepare(state, fb)
    state = coll.apply_plan(state, plan)
    w = {k: v.detach().requires_grad_() for k, v in coll.weights(state).items()}
    reps = []
    for d in range(D):
        mesh = HybridMesh.coordinate(S, 0, d, D)
        fb_d = replica_bags(step, mesh, dev)
        addr = {f: mesh.data_slice(a) for f, a in plan.addresses.items()}
        pooled = coll.pool({}, fb_d, combiner, weights=w, addresses=addr, use_pallas=True,
                           max_bag=max_bag)
        plain = coll.pool(coll.gather(w, addr, fb_d), fb_d, combiner)
        loss = sum(torch.sum(pooled[f] * torch.from_numpy(mesh.data_slice(cot[f])).to(dev))
                   for f in fb_d.segments)
        g = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        reps.append({"pooled": {f: x.detach() for f, x in pooled.items()},
                     "plain": {f: x.detach() for f, x in plain.items()},
                     "grads": {k: torch.zeros_like(v) if x is None else x
                               for (k, v), x in zip(w.items(), g)},
                     "loss": loss.detach()})
    if D == 1:
        grads = reps[0]["grads"]
    else:
        from repro_torch.dist.exchange import _ordered_sum

        grads = {k: torch.div(_ordered_sum(torch.stack([r["grads"][k] for r in reps])), D)
                 for k in w}
    if lr:
        state = coll.apply_grads(state, grads, lr)
    return state, reps, grads, plan.addresses


def _bag_job(rank: int, dev: torch.device, job: Dict[str, Any]) -> Dict[str, Any]:
    """Bag steps on one shard: ``job`` holds ``tables``, ``S``, ``kw``
    (``ShardedEmbeddingCollection.create`` keywords, a budget among them),
    ``counts``, ``state`` (a stacked state to take this rank's shard of;
    None: the init from seed 0), ``bags`` (global steps, see
    :func:`replica_bags`), ``cot`` (feature -> ``[bags, dim]`` cotangents
    of each global step), ``combiner``, ``max_bag`` and ``lr``.  Returns
    each step's outputs (this replica's), the state after the steps and
    its host precision per slab, the traffic and the mesh place."""
    mesh = make_hybrid_mesh(job["S"])
    coll = ShardedEmbeddingCollection.create(job["tables"], num_shards=job["S"], mesh=mesh,
                                             **job["kw"])
    state = coll.init(0, counts=job.get("counts"), device=dev)
    if job.get("state") is not None:
        state = shard_state(job["state"], coll.shard_specs(), mesh)
    mesh.traffic.reset()
    steps = []
    for step, cot in zip(job["bags"], job["cot"]):
        fb = replica_bags(step, mesh, dev)
        c = {f: torch.from_numpy(mesh.data_slice(np.asarray(v, np.float32))).to(dev)
             for f, v in cot.items()}
        state, got = bag_step(coll, state, fb, c, job["combiner"], job["max_bag"], job["lr"])
        steps.append({k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
                      for k, v in got.items()})
    return {"steps": steps, "state": {k: v.detach().cpu().clone() for k, v in ckpt._flatten(state)},
            "host_precision": dict(coll.host_precision), "model_rank": mesh.model_rank,
            "data_rank": mesh.data_rank, "rank": rank,
            "device_bytes": {k: v for k, v in coll.device_bytes().items() if k != "per_slab"},
            "traffic": dataclasses.asdict(mesh.traffic)}
