"""Training loops (port of ``repro.train.trainer``): the serial ``Trainer``
and the lookahead-pipelined ``PipelinedTrainer``.

* checkpoint / restart — async atomic checkpoints every N steps, the cache
  flushed first (``flush_fn``) so the host table is authoritative; on start
  the loop resumes from the newest complete checkpoint.
* straggler detection — per-step wall times feed an EWMA monitor; steps
  slower than ``straggler_factor`` x the smoothed time fire ``on_straggler``.
* overlap — host batch generation and its copy to the device run in a
  ``Prefetcher`` thread.
* one device-to-host sync per step for the loss (the step time is real),
  plus the unique-buffer overflow guard and one batched fetch each of the
  float telemetry and the exact int32 counters (rebuilt by ``MetricsHub``).

``PipelinedTrainer`` (``pipeline_depth`` k > 0) runs the model's split step
in groups of k off one merged cache plan, planning the next group before
the host blocks on any loss of this one.
* adaptive refresh — with ``refresh_interval`` N, ``refresh_fn`` (usually
  ``model.refresh``) re-ranks the cached slabs every N steps: the serial
  trainer after every N-th step, the pipelined one at the first group
  boundary at or past each multiple of N.  It is pure reindexing, so fp32
  losses are bitwise those of a run without it.
* ranks — with a ``mesh`` (``dist.mesh.HybridMesh``) every rank of the
  hybrid-parallel world steps, saves its shard of each checkpoint and
  resumes from it (``state_specs`` says which leaves are split); only
  rank 0 writes the observability stream and reports stragglers.  At
  ``data > 1`` ``make_batch`` gives the global batch and each rank feeds
  its replica's rows ``[d * B / data, (d + 1) * B / data)`` (the
  prefetcher, and with it the lookahead, holds the slices).
The trainers run on the CUDA card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.mesh import HybridMesh
from repro_torch.obs import NULL_TRACER, FixedHistogram, MetricsHub, Tracer
from repro_torch.train import checkpoint as ckpt_lib

__all__ = ["TrainerConfig", "Trainer", "PipelinedTrainer", "StragglerDetector"]


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time monitor; flags abnormal steps (slow host / bad card)."""

    factor: float = 3.0
    alpha: float = 0.1
    warmup: int = 5
    ewma: float = 0.0
    count: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            self.ewma = dt if self.ewma == 0 else (1 - self.alpha) * self.ewma + self.alpha * dt
            return False
        slow = dt > self.factor * max(self.ewma, 1e-9)
        if slow:
            self.flagged += 1
        else:  # stragglers don't poison the mean
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_keep: int = 3
    straggler_factor: float = 3.0
    prefetch_depth: int = 2
    assert_no_uniq_overflow: bool = True
    # 0: serial, one fused step_fn a step.  k >= 1: PipelinedTrainer, groups
    # of k steps off one merged plan, the next group planned ahead
    pipeline_depth: int = 0
    # None: the static frequency rank (the paper).  N: ``refresh_fn`` every
    # N steps (pipelined: at the first group boundary at or past each
    # multiple of N, so a merged plan never straddles a refresh)
    refresh_interval: Optional[int] = None
    # None: exact counters accumulate, nothing is written, spans are off.
    # A directory: per-step JSONL, span aggregate, step-time histogram and a
    # Chrome trace land there.
    obs_dir: Optional[str] = None
    obs_run: str = "train"
    obs_annotate: bool = False  # spans also label the torch.profiler timeline
    history_limit: Optional[int] = None  # keep only the last N records in memory


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``.  Non-blocking: from pageable memory the copy
    returns once the batch is staged, without waiting for the card's stream
    (a blocking copy would hold the prefetch thread until the step drains)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
            .to(device, non_blocking=True) for k, v in batch.items()}


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        init_fn: Callable[[], Any],  # () -> state
        step_fn: Callable[[Any, Dict], Any],  # (state, batch) -> (state, metrics)
        make_batch: Callable[[int], Dict],  # step -> host batch (numpy)
        flush_fn: Optional[Callable[[Any], Any]] = None,  # cache barrier before a checkpoint
        on_straggler: Optional[Callable[[int, float], None]] = None,
        device: DeviceLike = None,
        refresh_fn: Optional[Callable[[Any], Any]] = None,  # host-side re-rank between steps
        mesh: Optional[HybridMesh] = None,  # a rank of the hybrid-parallel world
        state_specs: Any = None,  # the state's partition specs under a mesh
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.flush_fn = flush_fn
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0  # logs and reports
        self.on_straggler = on_straggler if self.lead else None
        self.refresh_fn = refresh_fn
        self.detector = StragglerDetector(factor=cfg.straggler_factor)
        self.checkpointer = (
            ckpt_lib.Checkpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep, mesh=mesh, specs=state_specs)
            if cfg.ckpt_dir else None
        )
        self.history: List[Dict[str, float]] = []
        obs_dir = cfg.obs_dir if self.lead else None
        self.hub = MetricsHub(run_dir=obs_dir, run=cfg.obs_run)
        self.step_hist = FixedHistogram.latency()
        self.tracer = (
            Tracer(annotate=cfg.obs_annotate)
            if self.lead and (cfg.obs_dir or cfg.obs_annotate) else NULL_TRACER
        )
        self.trace_path: Optional[str] = None

    def _feed(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch (this replica's slice of it) on the device."""
        batch = self.make_batch(step)
        if self.mesh is not None:
            batch = {k: self.mesh.data_slice(v) for k, v in batch.items()}
        return _to_device(batch, self.device)

    def _bootstrap(self):
        state = self.init_fn()
        start = 0
        if self.checkpointer is not None:
            try:
                state, start = self.checkpointer.restore_latest(state)
            except FileNotFoundError:
                pass
        return state, start

    def _post_step(self, step_i: int, state: Any, metrics: Dict, t0: float) -> Any:
        """Block on the loss, record history, run the straggler and overflow
        monitors and the checkpoint cadence; returns the (possibly flushed)
        state."""
        cfg = self.cfg
        with self.tracer.span("host-transfer"):  # the step's one deliberate sync
            loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if self.detector.observe(dt) and self.on_straggler:
            self.on_straggler(step_i, dt)
        if cfg.assert_no_uniq_overflow and "uniq_overflows" in metrics:
            if int(metrics["uniq_overflows"]):
                raise RuntimeError(
                    f"cache unique-buffer overflow at step {step_i}: raise "
                    f"max_unique_per_step (exactness is violated otherwise)"
                )
        rec: Dict[str, Any] = {"step": step_i, "loss": loss, "time_s": dt}
        float_keys = [k for k in ("auc", "hit_rate", "cache_evictions", "shard_imbalance",
                                  "window_hit_rate", "refresh_swaps", "refresh_rows_moved")
                      if k in metrics]
        if float_keys:  # one fetch for all float telemetry
            vals = torch.stack([torch.as_tensor(metrics[k]).to(torch.float64).reshape(())
                                for k in float_keys]).cpu().tolist()
            rec.update(zip(float_keys, vals))
        rec.update(self.hub.observe_embedding_metrics(metrics))
        self.step_hist.observe(dt)
        self.hub.log("step", {k: v for k, v in rec.items() if k != "time_s"},
                     wall={"time_s": dt})
        self.history.append(rec)
        if cfg.history_limit is not None and len(self.history) > cfg.history_limit:
            del self.history[: len(self.history) - cfg.history_limit]
        last = step_i + 1 >= cfg.max_steps
        if self.checkpointer and ((step_i + 1) % cfg.ckpt_every == 0 or last):
            with self.tracer.span("checkpoint"):
                if self.flush_fn is not None:
                    state = self.flush_fn(state)  # a flushed state stays valid to train on
                self.checkpointer.save_async(step_i + 1, state)
        return state

    def _finish_obs(self) -> None:
        """Write the step-time histogram, span aggregate, counter summary and
        Chrome trace (also after a crash)."""
        self.hub.log_hist("step_time_s", self.step_hist)
        self.hub.log_spans(self.tracer)
        if self.cfg.obs_dir and self.lead:
            self.trace_path = self.tracer.export_chrome_trace(
                os.path.join(self.cfg.obs_dir, f"{self.cfg.obs_run}.trace.json")
            )
        self.hub.close()

    def run(self) -> Any:
        cfg = self.cfg
        state, start = self._bootstrap()
        if start >= cfg.max_steps:
            self._finish_obs()
            return state
        prefetch = Prefetcher(self._feed, start_step=start, depth=cfg.prefetch_depth)
        try:
            for step_i, batch in prefetch:
                if step_i >= cfg.max_steps:
                    break
                t0 = time.perf_counter()
                with self.tracer.span("step"):
                    state, metrics = self.step_fn(state, batch)
                state = self._post_step(step_i, state, metrics, t0)
                if (self.refresh_fn is not None and cfg.refresh_interval
                        and (step_i + 1) % cfg.refresh_interval == 0
                        and step_i + 1 < cfg.max_steps):
                    with self.tracer.span("refresh"):
                        state = self.refresh_fn(state)
            if self.checkpointer:
                self.checkpointer.wait()
        finally:
            prefetch.close()
            self._finish_obs()
        return state


class PipelinedTrainer(Trainer):
    """Lookahead-pipelined training over the model's three stages:

    * ``plan_fn(state, batch, future_batches) -> plan``: weight-free dedup,
      slot assignment and movement plan, with the window's ids merged in
      (their rows load early and stay pinned until used);
    * ``compute_fn(state, batch, addresses, grad_rows) -> (state,
      metrics)``: the dense forward and backward, the optimizer and the row
      update (``grad_rows``: the plan's for the batch, or None);
    * ``apply_fn(state, plan) -> state``: the planned row movement.

    Steps run in groups of ``pipeline_depth``: one merged plan admits the
    whole group's rows, so the plan and its movement are paid once a group.
    The next group's plan is made at the group's first compute, before the
    host blocks on any loss: planning reads only ids and the index tensors,
    which compute leaves alone (the arena and host table, which compute
    and apply update in place, are never read by it).  Its movement is
    applied after the group's last compute, so evictions write back fresh
    rows.  On the port's one CUDA stream the overlap is on the host: the
    plan's enqueue leaves the loss-to-loss path.

    With an fp32 host tier and arena, any depth gives the serial
    ``Trainer``'s losses bit for bit; with a quantized tier or arena the
    pins change which rows are requantized, so they agree to codec noise.
    A group runs off one plan only if every member's rows made residency:
    the plan's ``future_unresident`` is fetched once a group and a non-zero
    count raises with the remedy.  Cache hit and miss counters are recorded
    by the plans, so under grouping they sample the group leaders only, as
    in the reference.

    A refresh runs only at a group boundary (a merged plan's addresses
    belong to one index image): at the first boundary at or past each
    multiple of ``refresh_interval``, counted in absolute steps so that a
    restore resumes the cadence.  When one falls due after a group, the
    next group's plan is not made at the group's first compute: it is made
    after the refresh, from the refreshed index state."""

    def __init__(
        self,
        cfg: TrainerConfig,
        init_fn: Callable[[], Any],
        plan_fn: Callable[[Any, Dict, tuple], Any],  # (state, batch, window) -> plan
        compute_fn: Callable[[Any, Dict, Any, Any], Any],  # (state, batch, addresses, rows)
        apply_fn: Callable[[Any, Any], Any],  # (state, plan) -> state
        make_batch: Callable[[int], Dict],
        flush_fn: Optional[Callable[[Any], Any]] = None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        device: DeviceLike = None,
        refresh_fn: Optional[Callable[[Any], Any]] = None,
        mesh: Optional[HybridMesh] = None,
        state_specs: Any = None,
    ):
        super().__init__(cfg, init_fn, step_fn=None, make_batch=make_batch, flush_fn=flush_fn,
                         on_straggler=on_straggler, device=device, refresh_fn=refresh_fn,
                         mesh=mesh, state_specs=state_specs)
        self.plan_fn = plan_fn
        self.compute_fn = compute_fn
        self.apply_fn = apply_fn

    @staticmethod
    def _take(prefetch: Prefetcher, n: int) -> list:
        """Up to ``n`` (step, batch) pairs; a short list means the stream ended."""
        out = []
        for _ in range(n):
            try:
                out.append(next(prefetch))
            except StopIteration:
                break
        return out

    def _check_window(self, plan, group) -> None:
        """A group runs off one merged plan only if every member's rows
        made residency (the group's one fetch)."""
        if len(group) <= 1:
            return
        n = int(plan.future_unresident)
        if n:
            raise RuntimeError(
                f"pipelined group of {len(group)} steps needs all its unique rows resident at "
                f"once, but {n} lookahead lanes were dropped under capacity pressure: raise "
                f"the cache ratio or lower TrainerConfig.pipeline_depth"
            )

    def _plan(self, state, peek):
        with self.tracer.span("plan"):
            return self.plan_fn(state, peek[0][1], tuple(b for _, b in peek[1:]))

    def run(self) -> Any:
        cfg = self.cfg
        depth = max(1, cfg.pipeline_depth)
        state, start = self._bootstrap()
        if start >= cfg.max_steps:
            self._finish_obs()
            return state
        prefetch = Prefetcher(self._feed, start_step=start, depth=max(cfg.prefetch_depth, depth))
        try:
            group = self._take(prefetch, min(depth, cfg.max_steps - start))
            if not group:  # the stream ended before the first step
                return state
            plan = self._plan(state, group)  # the prologue: no shadow to plan under
            self._check_window(plan, group)
            with self.tracer.span("apply"):
                state = self.apply_fn(state, plan)
            every = cfg.refresh_interval if self.refresh_fn is not None else None
            next_refresh_at = (start // every + 1) * every if every else None
            while group:
                addrs = (plan.addresses,) + tuple(plan.future_addresses)
                rows = plan.grad_rows or (None,) * len(addrs)
                plan = None
                last = group[-1][0]
                n_next = min(depth, cfg.max_steps - (last + 1))
                refresh_now = bool(every) and last + 1 >= next_refresh_at and n_next > 0
                for j, (step_i, batch) in enumerate(group):
                    t0 = time.perf_counter()
                    if j == 0 and n_next > 0 and not refresh_now:
                        # the next group's plan, before blocking on any loss of
                        # this one; a short peek means the stream ended
                        peek = prefetch.lookahead(n_next)
                        n_next = len(peek)
                        if peek:
                            plan = self._plan(state, peek)
                    with self.tracer.span("compute"):
                        state, metrics = self.compute_fn(state, batch, addrs[j], rows[j])
                    if j == len(group) - 1 and plan is not None:
                        # after the group's last row update: evictions write back fresh rows
                        with self.tracer.span("apply"):
                            state = self.apply_fn(state, plan)
                    state = self._post_step(step_i, state, metrics, t0)
                if refresh_now:  # then the next group is planned on the refreshed state
                    with self.tracer.span("refresh"):
                        state = self.refresh_fn(state)
                    next_refresh_at = ((last + 1) // every + 1) * every
                    peek = prefetch.lookahead(n_next)
                    n_next = len(peek)
                    if peek:
                        plan = self._plan(state, peek)
                        with self.tracer.span("apply"):
                            state = self.apply_fn(state, plan)
                if plan is None:
                    break
                group = self._take(prefetch, n_next)
                self._check_window(plan, group)
            if self.checkpointer:
                self.checkpointer.wait()
        finally:
            prefetch.close()
            self._finish_obs()
        return state
