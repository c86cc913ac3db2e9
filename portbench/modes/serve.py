"""Serving cells: the program's ``ServeEngine.score`` driven by one
closed-loop client, each request a full engine batch.

The client makes request ``i + 1`` on the card while request ``i`` runs
(``traffic.Ahead``) and copies it to numpy arrays, as a service receives
them, before that request's clock starts; a request's time runs from the
``score`` call to its numpy scores.  Set-up builds the program from the
benchmark's weights and scores ``WARM_REQUESTS`` requests of the stream,
which warm every shape the window uses; the window then scores requests
until ``--seconds`` have passed.  The traced run adds two profiled windows of
``TRACED_REQUESTS`` more each (``lib/trace.py``).

Every request's scores are kept.  After the window (and after
``memory_peak_bytes`` is read) the program's host table is compared, row
by row, with the initial table: a read-only cache writes nothing back, so
every row must be unchanged (``stray_rows``).  Then the program is freed
and the reference scores again a sample of ``CHECKED_REQUESTS`` requests
drawn from the seed (the warm-up, window and traced requests alike).
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench.lib import compare, flops, trace, traffic
from portbench.lib.harness import Run, sync

WARM_REQUESTS = 2
TRACED_REQUESTS = 8
CHECKED_REQUESTS = 256


def run(r: Run) -> dict:
    cfg, dev, ref = r.cfg, r.device, r.reference
    mlp = ref.draw_mlp(cfg, r.seed, dev)
    gen = traffic.make(cfg, r.mix, r.seed, dev)
    prog = r.model.Program(cfg, mlp, ref.table_chunks(cfg, r.seed, dev), dev,
                           counts=gen.counts())
    engine = prog.serve_engine()
    score = r.hooks["score"](engine) if "score" in r.hooks else engine.score
    feed = traffic.Ahead(gen)
    kept = []

    def one(i: int) -> float:
        """Request ``i``: its seconds from the call to the numpy scores."""
        with torch.profiler.record_function("client_request"):
            req = {k: v.cpu().numpy() for k, v in feed.get(i).items()}
        t = time.perf_counter()
        with torch.profiler.record_function("score"):
            kept.append(score(req))
        return time.perf_counter() - t

    for i in range(WARM_REQUESTS):
        one(i)
    sync(dev)
    setup_s = time.perf_counter() - r.t0
    if dev.type == "cuda":  # the peak of the served state, not of the weights' draw
        torch.cuda.reset_peak_memory_stats(dev)

    c0 = prog.counters(writeback=False)
    times, i = [], WARM_REQUESTS
    w0 = time.perf_counter()
    while True:
        times.append(one(i))
        i += 1
        if time.perf_counter() - w0 >= r.seconds:
            break
    window_s = time.perf_counter() - w0
    c1 = prog.counters(writeback=False)
    n_req = len(times)

    traced = None
    if r.trace:
        base = i
        traced = trace.profile(lambda k: one(base + k), TRACED_REQUESTS, dev)
        i += 2 * TRACED_REQUESTS
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the checks: the program's table unchanged, then every request's scores
    stray = 0
    for r0, rows in ref.table_chunks(cfg, r.seed, dev):
        stray += int((prog.host_block(r0, rows.shape[0]) != rows).any(1).sum())
    prog.close()
    table = ref.dense_table(cfg, r.seed, dev)
    rng = random.Random(traffic.stream_seed(r.seed, "checked"))
    gaps = {}
    for k in sorted(rng.sample(range(len(kept)), min(CHECKED_REQUESTS, len(kept)))):
        want = ref.scores(cfg, table, mlp, gen.batch_at(k))
        got = torch.from_numpy(np.asarray(kept[k], dtype=np.float32)).to(dev)
        gaps[k] = compare.score_gap(got, want) if got.shape == want.shape else float("inf")
    del table
    limit = r.limits["score_gap"]
    window = range(WARM_REQUESTS, WARM_REQUESTS + n_req)
    return {
        "kind": "serve", "setup_s": setup_s, "window_s": window_s, "times_s": times,
        "items": n_req * int(cfg["batch_size"]), "steps": n_req,
        "flops_per_step": flops.dlrm_flops(cfg, "serve"), "key_bytes": flops.victim_key_bytes(cfg),
        "counters": {k: (c1[k] - c0[k]) % (1 << 32) for k in ("hits", "misses", "moved_rows")},
        "row_bytes": c1["row_bytes"], "trace": traced, "memory_peak_bytes": memory_peak,
        "attempted": n_req, "failed": sum(not g <= limit for k, g in gaps.items() if k in window),
        "checks": {"score_gap": max(gaps.values()), "stray_rows": stray,
                   "requests_compared": len(gaps)},
    }


def control(r: Run, count: int = CHECKED_REQUESTS, variant: str = "tf32") -> dict:
    """The control: the reference in TF32, put in the program's place, read
    against the fp32 reference on the stream's first ``count`` requests (as
    many as a run compares)."""
    if variant != "tf32":
        raise ValueError(f"a serving cell's control is tf32, not {variant!r}")
    cfg, dev, ref = r.cfg, r.device, r.reference
    mlp = ref.draw_mlp(cfg, r.seed, dev)
    gen = traffic.make(cfg, r.mix, r.seed, dev)
    table = ref.dense_table(cfg, r.seed, dev)
    gaps = []
    for k in range(count):
        b = gen.batch_at(k)
        gaps.append(compare.score_gap(ref.scores(cfg, table, mlp, b, tf32=True),
                                      ref.scores(cfg, table, mlp, b)))
    return {"score_gap": max(gaps)}
