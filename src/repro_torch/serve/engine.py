"""Batched serving engine (port of ``repro.serve.engine``).

The cache runs with ``writeback=False`` (read-only rows); misses still
fault rows in, so a cold engine warms itself from traffic.  Requests are
padded to the fixed batch size, moved to the engine's device, and scored by
a plain call of the score function (PyTorch runs eagerly; there is no
``jit``).  Copying the scores back to the host is the one deliberate sync
of a request: it IS the response.  Latency lands in the deterministic
fixed-bucket histogram and cache counters go through the exact-int hub.
With ``refresh_fn`` / ``refresh_every`` the engine re-ranks its cache
every N scored batches, between batches and never inside ``score``'s
span: scores are unchanged (pure reindexing), only hit rates move.
With a ``mesh`` (hybrid parallel over ranks, one shard a rank) every rank
scores each batch (the lookup's exchange needs them all).  At ``data ==
1`` the scores are the same on each; at ``data > 1`` each data replica
scores its own slice of the padded batch and the slices' scores are
gathered over the data axis, so every rank, the lead among them, holds
the whole batch's.  Rank 0's scores are the response, and only rank 0
writes the observability stream.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import exchange
from repro_torch.dist.mesh import HybridMesh
from repro_torch.obs import NULL_TRACER, FixedHistogram, MetricsHub, Tracer

__all__ = ["ServeEngine", "ServeStats"]


@dataclasses.dataclass
class ServeStats:
    """Latency telemetry with O(1) memory and deterministic percentiles
    (upper bounds from a fixed log-bucket histogram)."""

    requests: int = 0
    batches: int = 0
    total_latency_s: float = 0.0
    hist: FixedHistogram = dataclasses.field(default_factory=FixedHistogram.latency)

    def observe(self, dt: float) -> None:
        self.batches += 1
        self.total_latency_s += dt
        self.hist.observe(dt)

    def p(self, q: float) -> float:
        """Latency quantile bound in seconds (``q`` in percent)."""
        return self.hist.quantile(q / 100.0)

    def summary(self) -> Dict[str, float]:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_ms": 1e3 * self.total_latency_s / max(self.batches, 1),
            "p50_ms": 1e3 * self.p(50),
            "p95_ms": 1e3 * self.p(95),
            "p99_ms": 1e3 * self.p(99),
            "p999_ms": 1e3 * self.p(99.9),
        }


class ServeEngine:
    def __init__(
        self,
        score_fn: Callable[[Any, Dict], Any],  # (state, batch) -> (scores, emb_state|None)
        state: Any,
        batch_size: int,
        pad_example: Dict[str, np.ndarray],  # one padding row per field
        state_stats_fn: Optional[Callable[[Any], Dict[str, Any]]] = None,
        obs_dir: Optional[str] = None,
        obs_run: str = "serve",
        obs_annotate: bool = False,
        device: DeviceLike = None,
        refresh_fn: Optional[Callable[[Any], Any]] = None,
        refresh_every: Optional[int] = None,
        # ^ every ``refresh_every`` scored batches, ``refresh_fn`` (usually
        #   ``lambda s: model.refresh(s, writeback=False)``: a read-only
        #   cache's rows are clean) re-ranks the live state
        mesh: Optional[HybridMesh] = None,  # a rank of the hybrid-parallel world
    ):
        self.score_fn = score_fn
        self.state = state
        self.batch_size = batch_size
        self.pad_example = pad_example
        self.state_stats_fn = state_stats_fn
        self.refresh_fn = refresh_fn
        self.refresh_every = refresh_every
        self._batches_since_refresh = 0
        self.device = resolve_device(device)
        self.stats = ServeStats()
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0  # its scores are the response
        self.obs_dir = obs_dir if self.lead else None
        self.obs_run = obs_run
        self.hub = MetricsHub(run_dir=self.obs_dir, run=obs_run)
        self.tracer = (Tracer(annotate=obs_annotate)
                       if self.lead and (obs_dir or obs_annotate) else NULL_TRACER)
        self.trace_path: Optional[str] = None

    def summary(self) -> Dict[str, float]:
        """Latency stats plus (when wired) embedding-tier telemetry, the
        cumulative counters rebuilt exactly through the hub."""
        out: Dict[str, float] = dict(self.stats.summary())
        if self.state_stats_fn is not None:
            stats = self.state_stats_fn(self.state)
            # per-slab dicts and per-shard vectors stay internal
            scalars = {k: v for k, v in stats.items()
                       if not isinstance(v, dict) and torch.as_tensor(v).dim() == 0}
            if scalars:
                dev = next(iter(scalars.values())).device
                vals = torch.stack(
                    [torch.as_tensor(v, device=dev).to(torch.float64) for v in scalars.values()]
                ).cpu().tolist()
                out.update(zip(scalars, vals))
            exact = self.hub.observe_embedding_metrics(stats)
            out.update(exact)
            if "hit_rate_exact" in exact:
                out["hit_rate"] = exact["hit_rate_exact"]
        return out

    def close(self) -> None:
        """Flush the latency histogram, span aggregate, counters and trace."""
        self.hub.log_hist("serve_latency_s", self.stats.hist)
        self.hub.log_spans(self.tracer)
        if self.obs_dir:
            self.trace_path = self.tracer.export_chrome_trace(
                os.path.join(self.obs_dir, f"{self.obs_run}.trace.json")
            )
        self.hub.close()

    def _pad(self, batch: Dict[str, np.ndarray], n: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            pad_rows = self.batch_size - n
            if pad_rows > 0:
                pad = np.broadcast_to(self.pad_example[k], (pad_rows,) + v.shape[1:])
                v = np.concatenate([v, pad], axis=0)
            # staged without a wait on the card's stream: the response is the fetch
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
        return out

    def score(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Score up to ``batch_size`` requests; returns scores for real rows."""
        n = len(next(iter(batch.values())))
        if n > self.batch_size:
            raise ValueError(f"batch of {n} exceeds the engine's {self.batch_size}: split upstream")
        t0 = time.perf_counter()
        with self.tracer.span("score"):
            padded = self._pad(batch, n)
            if self.mesh is not None:  # this replica's slice; then every replica's scores
                padded = {k: self.mesh.data_slice(v) for k, v in padded.items()}
            scores, emb_state = self.score_fn(self.state, padded)
            if self.mesh is not None:
                scores = exchange.data_all_gather(scores, self.mesh, "scores").flatten(0, 1)
            scores = scores.cpu().numpy()[:n]
        if emb_state is not None:  # cache stays warm across requests
            self.state = dict(self.state, emb=emb_state)
        dt = time.perf_counter() - t0
        self.stats.requests += n
        self.stats.observe(dt)
        self.hub.log(
            "serve_batch",
            {"batch": self.stats.batches, "rows": n, "requests": self.stats.requests},
            wall={"latency_s": dt},
        )
        if self.refresh_fn is not None and self.refresh_every:
            self._batches_since_refresh += 1
            if self._batches_since_refresh >= self.refresh_every:
                with self.tracer.span("refresh"):
                    self.state = self.refresh_fn(self.state)
                self._batches_since_refresh = 0
        return scores
