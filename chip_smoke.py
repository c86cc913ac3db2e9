"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--vocab-scale 1.0] [--batches 8] [--train-steps 8]

Phases (any failure exits non-zero, with no result line):

1. the card: ``nvidia-smi`` name and power limit; exits when CUDA is absent.
2. build: every CUDA source of the serving and training paths, from this
   checkout, in one ``build_all`` call (one ``nvcc`` per source, all started
   together).
3. kernels, each held bitwise against its plain PyTorch version on the card:
   the victim threshold on >= 20 seeded tie-heavy trials with the planner's
   sentinel keys and at the main path's shape (capacity 506 438, kv
   425 984); the tiered-arena gather-decode on 24 seeded fp16 / int8 cases
   (D 8, 16, 36, 128; slots at -1, H-1, H, H+T-1, H+T and far out of range)
   and at the paper shape (H 126 610, T 379 828, D 128, K 65 536).
4. serve: the paper's DLRM (``configs/dlrm_criteo.CONFIG``: 26 fields, dim
   128, MLPs 512-256-128 / 1024-1024-512-256-1, batch 16384) with
   ``use_pallas_plan=True``: a 33 762 577-row fp32 host table pinned in host
   memory, a 506 438-row arena on the card, cache warm-up, then
   ``ServeEngine.score`` on ``--batches`` Zipf batches.  Checks finite
   scores, no unique-buffer overflow, one threshold launch per plan, and the
   cache invariant: logits from cached rows equal logits from rows read
   straight out of the host table.  Then one more plan's eviction key is
   captured and the kernel held against its plain version on it.  The host
   table is unpinned and freed before the next phase.
5. train: the same DLRM with ``arena_precision="int8"`` (126 610 fp32 head
   slots, 379 828 int8 tail slots): init + warm-up, then ``--train-steps``
   ``DLRM.train_step`` calls on batches of 16384 with writeback on, then
   ``DLRM.flush``.  Checks finite losses, no overflow, one threshold launch
   per plan, one gather-decode launch per writeback round the plans implied
   plus one per flush round, the kernel bitwise = plain on the arguments of
   one live writeback, and, after the flush, rows gathered from the
   torch-decoded arena equal the host table's rows (written by the kernel)
   bitwise.  Then a synced stage breakdown and a profiled step.
6. timing: each kernel, its plain version (and ``torch.topk`` beside the
   threshold) by CUDA events over back-to-back calls, their summed device
   time per call from ``torch.profiler``, and the wrapper's host enqueue
   time, on the live inputs of the main paths.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  ``--vocab-scale`` < 1 cuts
only the vocabularies (never dim, widths, fields or batch) and says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
TOL_RTOL, TOL_ATOL = 1e-5, 1e-6  # cached vs uncached logits (fp32)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def rss_gb() -> float:
    """This process's resident host memory, GB."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return kb * 1024 / 1e9


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

_BIG = (2**31 - 1) // 2


def _tie_heavy(rng, c):
    pool = np.concatenate([rng.integers(-4, 4, size=c), np.array([_BIG, -_BIG, -(_BIG // 2)])])
    return rng.choice(pool, size=c).astype(np.int32)


def _freq_lfu_keys(rng, c, vocab, n_protect):
    """Eviction keys as the paper's planner builds them: the resident row's
    rank per slot, -BIG for slots the batch needs, +BIG for empty slots."""
    key = rng.choice(vocab, size=c, replace=False).astype(np.int32)
    key[rng.permutation(c)[:n_protect]] = -_BIG
    key[rng.random(c) < 0.001] = _BIG
    return key


def kernel_phase(dev, capacity, kv, vocab):
    from repro_torch.kernels.cache_ops import kernel, ops, ref

    rng = np.random.default_rng(0)
    cases = []
    for trial in range(24):
        c = int(rng.integers(1, 200_000))
        k = int(rng.integers(1, c + 1))
        if trial % 3 == 0:
            key = rng.integers(-(2**31), 2**31 - 1, size=c, dtype=np.int64).astype(np.int32)
        else:
            key = _tie_heavy(rng, c)
        cases.append((key, k))
    main_key = _freq_lfu_keys(rng, capacity, vocab, n_protect=capacity // 5)
    cases.append((main_key, kv))
    cases.append((_tie_heavy(rng, capacity), kv))
    max_err = 0
    for i, (key_np, k) in enumerate(cases):
        key = torch.from_numpy(key_np).to(dev)
        t, n_gt = kernel.victim_threshold(key, k)
        t_p, n_p = kernel.victim_threshold_plain(key, k)
        err = max(abs(int(t) - int(t_p)), abs(int(n_gt) - int(n_p)))
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"threshold case {i}: kernel ({int(t)}, {int(n_gt)}) != "
                                 f"plain ({int(t_p)}, {int(n_p)})")
        got = ops.victim_topk_impl(key, k)
        if not torch.equal(got, ref.victim_topk(key, k)):
            raise AssertionError(f"victim_topk case {i}: kernel route != plain route")
        if i >= len(cases) - 2:  # main-path shapes: also the full stable argsort
            want = torch.argsort(key, descending=True, stable=True)[:k].to(torch.int32)
            if not torch.equal(got, want):
                raise AssertionError(f"victim_topk case {i}: != argsort oracle")
    log(f"kernel phase: {len(cases)} cases bitwise equal (max_abs_err {max_err}), "
        f"main shape capacity={capacity} kv={kv}")
    return max_err


def check_threshold(key, kv, what):
    """The kernel against its plain version (bitwise) and the victim order
    against the full stable argsort, on one key vector; returns max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel, ops

    t, n_gt = kernel.victim_threshold(key, kv)
    t_p, n_p = kernel.victim_threshold_plain(key, kv)
    err = max(abs(int(t) - int(t_p)), abs(int(n_gt) - int(n_p)))
    if err:
        raise AssertionError(f"{what}: kernel ({int(t)}, {int(n_gt)}) != plain ({int(t_p)}, {int(n_p)})")
    want = torch.argsort(key, descending=True, stable=True)[:kv].to(torch.int32)
    if not torch.equal(ops.victim_topk_impl(key, kv), want):
        raise AssertionError(f"{what}: victim_topk != argsort oracle")
    return err


def device_ms(fn, iters: int = 20):
    """Mean device time per call of ``fn`` (kernels, copies and memsets summed,
    from torch.profiler) and that time by device op; (None, {}) where the
    profiler cannot trace the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    try:
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"profiler: not measured ({e})")
        return None, {}
    by_op = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            by_op[e.key[:60]] = by_op.get(e.key[:60], 0.0) + us / 1e3 / iters
    return (sum(by_op.values()) if by_op else None), by_op


def host_ms(fn, iters: int = 10) -> float:
    """Mean host time to enqueue one call of ``fn`` (no sync inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def time_threshold(key, kv, max_err, launches_by_path):
    """Times the kernel, its plain version and torch.topk on one key vector
    of the main path: back-to-back CUDA-event time (what a caller pays on the
    stream), summed device time per call, and the kernel wrapper's host
    enqueue time."""
    from repro_torch.kernels.cache_ops import kernel

    n = key.shape[0]
    calls = {"kernel": lambda: kernel.victim_threshold(key, kv),
             "plain": lambda: kernel.victim_threshold_plain(key, kv),
             "topk": lambda: torch.topk(key, kv)}
    ev = {name: cuda_ms(fn) for name, fn in calls.items()}
    dev, by_op = {}, {}
    for name, fn in calls.items():
        dev[name], by_op[name] = device_ms(fn)
    enqueue = host_ms(calls["kernel"])
    n_bytes = n * 4 + 8 + 4  # keys read once; t and n_gt written once
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    log(f"victim_threshold on the serve plan's key [{n}] kv={kv}: event-timed ms kernel "
        f"{ev['kernel']}, plain {ev['plain']}, torch.topk {ev['topk']}; device ms per call "
        f"kernel {dev['kernel']}, plain {dev['plain']}, torch.topk {dev['topk']}; kernel "
        f"host enqueue {enqueue} ms per call; bound {bound_ms} ms (1 read of {n_bytes} B); "
        f"this design reads the keys 33 times ({33 * n * 4} B)")
    log(f"kernel device ms per call by op: {json.dumps(by_op['kernel'])}")
    return {
        "name": "victim_threshold",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/victim_threshold.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:79",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max_err,
        "ms": ev["kernel"],
        "plain_ms": ev["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": ev["topk"],
        "device_ms": dev["kernel"],
        "plain_device_ms": dev["plain"],
        "library_device_ms": dev["topk"],
        "host_enqueue_ms": enqueue,
    }


# ---------------------------------------------------------------------------
# phase 4: serve the paper's DLRM through the cache
# ---------------------------------------------------------------------------


def serve_phase(dev, vocab_scale, n_batches):
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.engine import ServeEngine

    cfg = _scaled(vocab_scale)
    model = DLRM(cfg)
    spec = model.collection.cached_slabs["__shared__"]
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs["__shared__"]
    log(f"init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x {spec.dim} fp32 "
        f"= {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; arena {spec.capacity} "
        f"rows = {spec.capacity * spec.dim * 4 / 1e6} MB on {torch.cuda.get_device_name(0)}")

    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    # measured, invariant check, 3 breakdown, profiled, warm-up
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 0, i) for i in range(n_batches + 6)]
    pad = {"dense": np.zeros((cfg.n_dense,), np.float32),
           "sparse": np.zeros((cfg.n_sparse,), np.int32), "label": np.zeros((), np.float32)}
    engine = ServeEngine(
        model.serve_step, state, batch_size=cfg.batch_size, pad_example=pad, device=dev,
        state_stats_fn=lambda s: model.collection.metrics(s["emb"], writeback=False),
        obs_annotate=True,
    )
    engine.score(batches[n_batches + 5])  # first call: library handles, allocator, cuBLAS
    engine.stats = type(engine.stats)()  # latency of the measured batches only
    base = engine.summary()  # cumulative counters so far (warm-up batch)

    # --- the main path: counts at 0, n_batches scored requests, counts read ---
    kernel.victim_threshold.launches = 0
    lat, all_scores = [], []
    for b in batches[:n_batches]:
        t0 = time.perf_counter()
        all_scores.append(engine.score(b))
        lat.append(1e3 * (time.perf_counter() - t0))
    launches = kernel.victim_threshold.launches
    summary = engine.summary()
    hits = summary["cache_hits"] - base["cache_hits"]
    misses = summary["cache_misses"] - base["cache_misses"]
    wire = summary["host_wire_bytes"] - base["host_wire_bytes"]

    scores = np.concatenate(all_scores)
    if scores.shape != (n_batches * cfg.batch_size,) or not np.isfinite(scores).all():
        raise AssertionError(f"scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if summary["uniq_overflows"] != 0:
        raise AssertionError(f"uniq_overflows = {summary['uniq_overflows']}")
    if launches != n_batches:
        raise AssertionError(f"victim_threshold launched {launches} times for {n_batches} plans")
    log(f"serve: {n_batches} batches of {cfg.batch_size}; per-batch ms {lat}")
    log(f"serve summary: {json.dumps(summary, sort_keys=True)}")
    log(f"serve (measured batches): p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms "
        f"(histogram bounds), requests/s {summary['requests'] / (sum(lat) / 1e3)}, "
        f"hit rate {hits / max(hits + misses, 1)} ({hits} id hits, {misses} row misses), "
        f"host wire bytes {wire}, kernel launches {launches}")
    log(f"score span: {json.dumps(engine.tracer.stage_summary())}")

    # --- cache invariant on the card: cached rows == host-table rows --------
    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_batches].items()}
    logits, emb = model.serve_step(engine.state, b)
    ref_rows = model.collection.dense_reference(emb, model.features(b))
    ref_logits = model.fwd(engine.state["params"], {k: v.to(dev) for k, v in ref_rows.items()}, b)
    diff = float((logits - ref_logits).abs().max())
    if not torch.allclose(logits, ref_logits, rtol=TOL_RTOL, atol=TOL_ATOL):
        raise AssertionError(f"cached vs uncached logits differ by {diff}")
    log(f"cache invariant: max |cached - uncached| logit = {diff} "
        f"(tolerance rtol {TOL_RTOL} atol {TOL_ATOL})")

    # --- stage by stage with syncs, three batches: where the time goes ------
    st = dict(engine.state, emb=emb)
    coll = model.collection
    for i in range(n_batches + 1, n_batches + 4):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}
        fb, t_feat = sync_ms(lambda: model.features(b))
        plan, t_plan = sync_ms(lambda: coll.plan_prepare(st["emb"], fb, writeback=False))
        emb2, t_apply = sync_ms(lambda: coll.apply_plan(st["emb"], plan))
        rows, t_gather = sync_ms(lambda: coll.gather(coll.weights(emb2), plan.addresses, fb))
        logits, t_dense = sync_ms(lambda: model.fwd(st["params"], rows, b))
        _, t_resp = sync_ms(lambda: logits.cpu())
        st = dict(st, emb=emb2)
        log(f"breakdown ms (synced, batch {i}): features {t_feat}, plan_prepare {t_plan}, "
            f"apply_plan {t_apply}, gather {t_gather}, dense {t_dense}, response copy {t_resp}")
    engine.state = st

    # --- the kernel on a real plan's eviction key ----------------------------
    # plan_prepare is pure: re-plan one batch against the live state and keep
    # the int32 key the planner hands to victim selection
    from repro_torch.kernels.cache_ops import ops

    captured = []
    select = ops.victim_topk_impl

    def capture(key, kv):
        captured.append((key.clone(), kv))
        return select(key, kv)

    b = {k: torch.from_numpy(v).to(dev) for k, v in batches[n_batches + 1].items()}
    ops.victim_topk_impl = capture
    try:
        coll.plan_prepare(st["emb"], model.features(b), writeback=False)
    finally:
        ops.victim_topk_impl = select
    if len(captured) != 1:
        raise AssertionError(f"plan_prepare selected victims {len(captured)} times, not once")
    key, kv = captured[0]
    err = check_threshold(key, kv, "serve plan key")
    log(f"serve plan key [{key.shape[0]}] kv={kv}: kernel bitwise = plain, victim order = "
        f"argsort; protected {int((key == -_BIG).sum())}, empty {int((key == _BIG).sum())}, "
        f"distinct {int(torch.unique(key).numel())}")

    spans = set(engine.tracer.stage_summary())
    profile_call("one score call", lambda: engine.score(batches[n_batches + 4]), skip=spans)
    slab.full.close()
    return launches, key, kv, err


# ---------------------------------------------------------------------------
# phase 3b: tiered-arena gather-decode vs its plain version
# ---------------------------------------------------------------------------

PAPER_H, PAPER_T, PAPER_K = 126_610, 379_828, 65_536  # head / tail of 506 438 slots


def _gd_inputs(rng, dev, codec, h, t, d, k):
    """Head, encoded tail (+ sideband), and slots with every edge lane."""
    from repro_torch.store.codec import get_codec

    head = torch.randn((h, d), generator=rng, device=dev)
    rows = torch.randn((t, d), generator=rng, device=dev) * 3
    payload, side = get_codec(codec).encode(rows)
    edges = torch.tensor([-1, h - 1, h, h + t - 1, h + t, 2**31 - 1, -(2**31), h + t + 1000],
                         dtype=torch.int32, device=dev)
    rand = torch.randint(-2, h + t + 2, (k - edges.numel(),), generator=rng, device=dev,
                         dtype=torch.int32)
    return head, payload.contiguous(), side, torch.cat([edges, rand])


def check_gather_decode(args, codec, what):
    """The kernel against its plain version on one input, bitwise; returns
    max_abs_err."""
    from repro_torch.kernels.cache_ops import kernel

    got = kernel.gather_decode(*args, codec)
    want = kernel.gather_decode_plain(*args, codec)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"gather_decode {what}: kernel != plain (max |diff| {err})")
    return err


def gather_decode_phase(dev):
    rng = torch.Generator(device=dev).manual_seed(0)
    sizes = np.random.default_rng(0)
    cases = 0
    max_err = 0.0
    for codec in ("fp16", "int8"):
        for d in (8, 16, 36, 128):
            for _ in range(3):
                h, t, k = (int(x) for x in sizes.integers(1, 5000, size=3))
                args = _gd_inputs(rng, dev, codec, h, t, d, k + 8)
                max_err = max(max_err, check_gather_decode(args, codec, f"{codec} D={d}"))
                cases += 1
        args = _gd_inputs(rng, dev, codec, PAPER_H, PAPER_T, 128, PAPER_K)
        max_err = max(max_err, check_gather_decode(args, codec, f"{codec} paper shape"))
        cases += 1
    log(f"gather_decode phase: {cases} cases bitwise equal (max_abs_err {max_err}), incl. the "
        f"paper shape H={PAPER_H} T={PAPER_T} D=128 K={PAPER_K} for fp16 and int8")
    return max_err


# ---------------------------------------------------------------------------
# phase 5: train the paper's DLRM through an int8-tiered arena
# ---------------------------------------------------------------------------


def _scaled(vocab_scale):
    from repro_torch.configs.dlrm_criteo import CONFIG

    vocabs = CONFIG.vocab_sizes
    if vocab_scale != 1.0:
        vocabs = tuple(max(1, int(v * vocab_scale)) for v in vocabs)
        log(f"CUT: vocabularies scaled by {vocab_scale} (total {sum(vocabs)} rows, "
            f"full {sum(CONFIG.vocab_sizes)}); dim, widths, fields and batch unchanged")
    return dataclasses.replace(CONFIG, vocab_sizes=vocabs, use_pallas_plan=True)


def train_phase(dev, vocab_scale, n_steps):
    from repro_torch.core.collection import SHARED_ARENA
    from repro_torch.data import synth
    from repro_torch.kernels.cache_ops import kernel, ops
    from repro_torch.models.dlrm import DLRM
    from repro_torch.obs.hub import fetch_ints

    cfg = dataclasses.replace(_scaled(vocab_scale), arena_precision="int8")
    model = DLRM(cfg)
    coll = model.collection
    spec = coll.cached_slabs[SHARED_ARENA]
    t0 = time.perf_counter()
    state = model.init(0, device=dev)
    torch.cuda.synchronize()
    slab = state["emb"].slabs[SHARED_ARENA]
    arena = slab.cache.cached_rows
    log(f"train init+warmup {time.perf_counter() - t0} s: host table {spec.vocab} x {spec.dim} "
        f"fp32 = {slab.full.host_bytes() / 1e9} GB pinned={slab.full.pinned}; int8 arena "
        f"{arena.capacity} slots = {arena.head_capacity} fp32 head + "
        f"{arena.capacity - arena.head_capacity} int8 tail: device_bytes {arena.device_bytes()} "
        f"vs fp32_equiv_bytes {arena.fp32_equiv_bytes()} "
        f"({arena.fp32_equiv_bytes() / arena.device_bytes()}x); collection device_bytes "
        f"{json.dumps(coll.device_bytes())}; host RSS {rss_gb()} GB")

    bspec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    # warm-up, measured, breakdown (3), profiled
    batches = [synth.sparse_batch(bspec, cfg.batch_size, 1, i) for i in range(n_steps + 5)]

    def dev_batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}

    state, m = model.train_step(state, dev_batch(n_steps + 4))  # allocator, cuBLAS, autograd
    float(m["loss"])
    counters = ("cache_evictions", "cache_misses", "uniq_overflows", "slab_hits",
                "slab_tier_promotions", "slab_tier_demotions", "host_moved_rows")
    prev = fetch_ints({k: m[k] for k in counters})

    captured = []
    impl = ops.arena_gather_impl

    def capture(head, tail, sideband, slots, codec):  # the first writeback's arguments
        if not captured:
            captured.append(tuple(None if x is None else x.clone()
                                  for x in (head, tail, sideband, slots)))
        return impl(head, tail, sideband, slots, codec)

    # --- the main path: counts at 0, n_steps train steps + flush, counts read
    ops.arena_gather_impl = capture
    kernel.victim_threshold.launches = 0
    kernel.gather_decode.launches = 0
    try:
        step_ms, losses, per_step = [], [], []
        for i in range(n_steps):
            b = dev_batch(i)
            t0 = time.perf_counter()
            state, m = model.train_step(state, b)
            losses.append(float(m["loss"]))  # the step's one sync
            step_ms.append(1e3 * (time.perf_counter() - t0))
            cur = fetch_ints({k: m[k] for k in counters})
            per_step.append({k: (cur[k] - prev[k]) if not isinstance(cur[k], dict) else
                             sum(cur[k].values()) - sum(prev[k].values()) for k in counters})
            per_step[-1]["hit_rate"] = float(m["hit_rate"])
            prev = cur
        ops.arena_gather_impl = impl  # the flush's gathers are not captured
        resident = int((state["emb"].slabs[SHARED_ARENA].cache.slot_to_row >= 0).sum())
        t0 = time.perf_counter()
        state = model.flush(state)
        torch.cuda.synchronize()
        flush_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        ops.arena_gather_impl = impl
    thr_launches = kernel.victim_threshold.launches
    gd_launches = kernel.gather_decode.launches

    rows_per_round = min(spec.cache_config().buffer_rows,
                         min(spec.unique_size(cfg.batch_size * cfg.n_sparse), spec.capacity))
    wb_rounds = sum(-(-p["cache_evictions"] // rows_per_round) for p in per_step)
    flush_rounds = -(-resident // min(spec.cache_config().buffer_rows, spec.capacity))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(p["uniq_overflows"] for p in per_step):
        raise AssertionError(f"unique-buffer overflow: {per_step}")
    if thr_launches != n_steps:
        raise AssertionError(f"victim_threshold launched {thr_launches} times for {n_steps} plans")
    if gd_launches != wb_rounds + flush_rounds or not gd_launches:
        raise AssertionError(f"gather_decode launched {gd_launches} times; the plans imply "
                             f"{wb_rounds} writeback rounds + {flush_rounds} flush rounds")
    if not captured:
        raise AssertionError("no live writeback went through arena_gather_impl")
    live_err = check_gather_decode(captured[0], "int8", "live writeback")
    wb_slots = captured[0][3]
    log(f"train: {n_steps} steps of {cfg.batch_size}; losses {losses}; step ms {step_ms}; "
        f"p50 {np.percentile(step_ms, 50)} ms, p99 {np.percentile(step_ms, 99)} ms "
        f"(numpy percentiles of {n_steps} samples); flush {flush_ms} ms")
    log(f"train per step (evictions, misses, hits, tier promotions / demotions, host rows "
        f"moved, hit rate): {json.dumps(per_step)}")
    moved = sum(p["host_moved_rows"] for p in per_step)
    log(f"train totals: host wire bytes {moved * slab.full.row_wire_bytes()} "
        f"({moved} rows x {slab.full.row_wire_bytes()} B), threshold launches {thr_launches} "
        f"(1 per plan), gather_decode launches {gd_launches} = {wb_rounds} writeback rounds "
        f"+ {flush_rounds} flush rounds of <= {rows_per_round} lanes; live writeback "
        f"[{wb_slots.numel()} lanes, {int((wb_slots < arena.head_capacity).sum())} head] "
        f"kernel bitwise = plain; host RSS {rss_gb()} GB")

    # --- after the flush: torch-decoded arena rows == host rows the kernel wrote
    b = dev_batch(n_steps - 1)
    fb = model.features(b)
    plan = coll.plan_prepare(state["emb"], fb)  # pure: the resident slots of the batch
    rows = coll.gather(coll.weights(state["emb"]), plan.addresses, fb)
    ref_rows = coll.dense_reference(state["emb"], fb)
    bad = [f for f in fb.features if not torch.equal(rows[f].cpu(), ref_rows[f])]
    if bad:
        f = bad[0]
        diff = float((rows[f].cpu() - ref_rows[f]).abs().max())
        raise AssertionError(f"post-flush gather != dense_reference on {len(bad)} features, "
                             f"e.g. {f}: max |diff| {diff}")
    log(f"post-flush: gather(weights) == dense_reference bitwise on all {len(fb.features)} "
        f"features of the last trained batch ({cfg.batch_size} rows each)")

    # --- stage by stage with syncs, three steps: where the time goes --------
    grads_ms = []
    apply_grads = coll.apply_grads

    def timed_apply_grads(*a, **k):
        out, ms = sync_ms(lambda: apply_grads(*a, **k))
        grads_ms.append(ms)
        return out

    coll.apply_grads = timed_apply_grads
    try:
        for i in range(n_steps, n_steps + 3):
            b = dev_batch(i)
            plan, t_plan = sync_ms(lambda: model.plan_step(state, b))
            state, t_apply = sync_ms(lambda: model.apply_step(state, plan))
            (state, m), t_compute = sync_ms(lambda: model.compute_step(state, b, plan.addresses))
            log(f"train breakdown ms (synced, step {i}): plan_prepare {t_plan}, apply_plan "
                f"(writeback + load) {t_apply}, fwd+bwd+dense SGD {t_compute - grads_ms[-1]}, "
                f"apply_grads (decode, SGD, re-encode) {grads_ms[-1]}")
    finally:
        del coll.apply_grads
    b = dev_batch(n_steps + 3)
    profile_call("one train step", lambda: model.train_step(state, b))
    return {"launches": gd_launches, "thr_launches": thr_launches, "captured": captured[0],
            "live_err": live_err, "arena": state["emb"].slabs[SHARED_ARENA].cache.cached_rows,
            "full": slab.full}


def _gd_bytes(head, tail, side, slots):
    """Bytes the gather-decode must move for these slots: each slot read,
    each lane's head row or tail payload (+ sideband) read, each output row
    written (out-of-range lanes read no row)."""
    h, d = head.shape
    t = tail.shape[0]
    n_head = int(((slots >= 0) & (slots < h)).sum())
    n_tail = int(((slots >= h) & (slots < h + t)).sum())
    tail_row = d * tail.element_size() + (0 if side is None else 2 * side.element_size())
    k = slots.numel()
    return k * 4 + n_head * d * head.element_size() + n_tail * tail_row + k * d * 4


def time_gather_decode(live, arena, max_err, launches):
    """Times the kernel and its plain version by CUDA events and profiler
    device time, and the wrapper's host enqueue, on the live writeback's
    arguments (the main path's call), on one all-tail flush-size round and on
    a whole-arena gather of the trained arena."""
    from repro_torch.kernels.cache_ops import kernel

    h = arena.head_capacity
    t = arena.capacity - h
    args = (arena.head["weight"], arena.tail["weight"], arena.sideband["weight"])
    dev = args[0].device
    g = torch.Generator(device=dev).manual_seed(1)
    k = min(PAPER_K, t)
    tail_round = h + torch.randperm(t, generator=g, device=dev)[:k].to(torch.int32)
    whole = torch.arange(arena.capacity, dtype=torch.int32, device=dev)
    out = {}
    for what, inp in (("live writeback", live),
                      ("all-tail round", args + (tail_round,)),
                      ("whole arena", args + (whole,))):
        check_gather_decode(inp, "int8", what)
        calls = {"kernel": lambda inp=inp: kernel.gather_decode(*inp, "int8"),
                 "plain": lambda inp=inp: kernel.gather_decode_plain(*inp, "int8")}
        ev = {n: cuda_ms(fn) for n, fn in calls.items()}
        dv = {n: device_ms(fn)[0] for n, fn in calls.items()}
        n_bytes = _gd_bytes(*inp)
        r = {"lanes": inp[3].numel(), "ms": ev["kernel"], "plain_ms": ev["plain"],
             "device_ms": dv["kernel"], "plain_device_ms": dv["plain"],
             "host_enqueue_ms": host_ms(calls["kernel"]), "bytes": n_bytes,
             "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S}
        out[what] = r
        log(f"gather_decode on the {what} [{r['lanes']} lanes]: event-timed ms kernel "
            f"{r['ms']}, plain {r['plain_ms']}; device ms kernel {r['device_ms']}, plain "
            f"{r['plain_device_ms']}; host enqueue {r['host_enqueue_ms']} ms; bound "
            f"{r['bound_ms']} ms ({n_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s)")
    live_r = out["live writeback"]
    return {
        "name": "gather_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cache_ops/csrc/gather_decode.cu",
        "replaces": "src/repro/kernels/cache_ops/kernel.py:178",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": live_r["ms"],
        "plain_ms": live_r["plain_ms"],
        "bound_ms": live_r["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call gathers and decodes a tiered arena
        "device_ms": live_r["device_ms"],
        "plain_device_ms": live_r["plain_device_ms"],
        "host_enqueue_ms": live_r["host_enqueue_ms"],
        "lanes": live_r["lanes"],
        "all_tail_round": out["all-tail round"],
        "whole_arena": out["whole arena"],
    }


def profile_call(what, fn, skip=()):
    """Device time by kernel over one call of ``fn`` (torch.profiler); a
    machine where the profiler cannot trace the card reports it as not
    measured.  ``skip`` names span annotations to leave out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    try:
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    except RuntimeError as e:
        log(f"profiler: not measured ({e})")
        return None

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels and copies): CPU ops would count their
    # kernels twice, and span annotations cover whole calls
    events = prof.key_averages()
    rows = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.key not in skip),
                  key=lambda e: -dev_us(e))
    busy = sum(dev_us(e) for e in rows) / 1e3
    top = [(e.key[:60], e.count, dev_us(e) / 1e3) for e in rows[:12]]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU and e.key not in skip),
                  key=lambda e: -e.self_cpu_time_total)
    top_host = [(e.key[:40], e.count, e.self_cpu_time_total / 1e3) for e in host[:10]]
    log(f"profiler: {what} {wall} ms wall, device busy {busy} ms (sum of kernel and copy "
        f"times; idle share {1 - busy / wall}); top device (name, calls, ms): {top}; "
        f"top host ops by self time (name, calls, ms): {top_host}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab-scale", type=float, default=1.0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_ops import kernel

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the DLRM computes in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    reports = build.build_all([kernel.SOURCE, kernel.GATHER_DECODE_SOURCE])
    log(f"build {time.perf_counter() - t0} s: " + " | ".join(
        f"{src.name}: {' '.join(r.split())}" for src, r in reports.items()))

    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.models.dlrm import DLRM

    spec = DLRM(CONFIG).collection.cached_slabs["__shared__"]  # the main path's geometry
    max_err = kernel_phase(dev, spec.capacity, spec.unique_size(), spec.vocab)
    gd_err = gather_decode_phase(dev)
    log(f"host RSS before serve {rss_gb()} GB")
    serve_launches, key, kv, err = serve_phase(dev, args.vocab_scale, args.batches)
    gc.collect()
    log(f"host RSS after serve (table unpinned and freed) {rss_gb()} GB")
    train = train_phase(dev, args.vocab_scale, args.train_steps)
    thr = time_threshold(key, kv, max(max_err, err),
                         {"serve": serve_launches, "train": train["thr_launches"]})
    gd = time_gather_decode(train["captured"], train["arena"], max(gd_err, train["live_err"]),
                            train["launches"])
    train["full"].close()

    log(json.dumps({"kernels": [thr, gd]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": 1}}))


if __name__ == "__main__":
    main()
