"""Serial training loop (port of ``repro.train.trainer``'s ``Trainer``):

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

The pipelined trainer (``pipeline_depth > 0``) and the adaptive refresh
(``refresh_interval``) arrive with their slices of the port.  The trainer
runs on the CUDA card unless given ``device="cpu"``.
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
from repro_torch.obs import NULL_TRACER, FixedHistogram, MetricsHub, Tracer
from repro_torch.train import checkpoint as ckpt_lib

__all__ = ["TrainerConfig", "Trainer", "StragglerDetector"]


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
    pipeline_depth: int = 0  # > 0: the port's pipelining slice
    refresh_interval: Optional[int] = None  # set: the port's refresh slice
    # None: exact counters accumulate, nothing is written, spans are off.
    # A directory: per-step JSONL, span aggregate, step-time histogram and a
    # Chrome trace land there.
    obs_dir: Optional[str] = None
    obs_run: str = "train"
    obs_annotate: bool = False  # spans also label the torch.profiler timeline
    history_limit: Optional[int] = None  # keep only the last N records in memory

    def __post_init__(self):
        if self.pipeline_depth > 0:
            raise NotImplementedError("pipeline_depth > 0: the pipelined trainer arrives "
                                      "with the port's pipelining slice")
        if self.refresh_interval:
            raise NotImplementedError("refresh_interval: the adaptive frequency refresh "
                                      "arrives with the port's refresh slice")


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v.to(device) for k, v in batch.items()}


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
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.flush_fn = flush_fn
        self.on_straggler = on_straggler
        self.detector = StragglerDetector(factor=cfg.straggler_factor)
        self.checkpointer = (
            ckpt_lib.Checkpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep) if cfg.ckpt_dir else None
        )
        self.history: List[Dict[str, float]] = []
        self.hub = MetricsHub(run_dir=cfg.obs_dir, run=cfg.obs_run)
        self.step_hist = FixedHistogram.latency()
        self.tracer = (
            Tracer(annotate=cfg.obs_annotate) if (cfg.obs_dir or cfg.obs_annotate) else NULL_TRACER
        )
        self.trace_path: Optional[str] = None

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
        if self.cfg.obs_dir:
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
        prefetch = Prefetcher(lambda s: _to_device(self.make_batch(s), self.device),
                              start_step=start, depth=cfg.prefetch_depth)
        try:
            for step_i, batch in prefetch:
                if step_i >= cfg.max_steps:
                    break
                t0 = time.perf_counter()
                with self.tracer.span("step"):
                    state, metrics = self.step_fn(state, batch)
                state = self._post_step(step_i, state, metrics, t0)
            if self.checkpointer:
                self.checkpointer.wait()
        finally:
            prefetch.close()
            self._finish_obs()
        return state
