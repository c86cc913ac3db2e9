"""Does ``torch.profiler`` keep recording the port's kernel launches as a
process ages?  A check of ``chip_smoke.py``'s profiled measurements.

    python3 scripts/profiler_probe.py [--idle-s 60] [--rounds 6] [--idle-only] [--windows 10]

Needs one CUDA card.  It builds the victim-threshold and FM kernels and
takes snapshots:

* first in a fresh process;
* after each piece of state that the smoke's refresh phases leave behind:
  a ``deterministic()`` block, the RSS sampler thread, the refresh clock's
  patches, then (without ``--idle-only``) bench_drift's SMOKE run and a cut
  unsharded refresh phase;
* then every ``--idle-s`` seconds with the card idle, ``--rounds`` times.

Each snapshot prints one JSON line: the device ops that one short profile
of 20 back-to-back calls (of the threshold kernel, of ``torch.topk``, of
the FM kernel) saw and their summed ms a call; how many of ``--windows``
bare windows of 20 kernel calls, and of as many windows fenced by
``chip_smoke.profiled``'s guard kernels, came back whole (every call's
event there); the card's clocks and power; and from one long profile (a
~5 ms ``torch.cuda._sleep`` before 20 threshold calls) the device events
by name, the skew of each traced launch (device start minus its runtime
call's host start, µs, by correlation id) and the device events' first
start and last end against the host window, µs.  A kernel that is traced
in a fresh process and lost later, with the card idle in between, is lost
to the process's age, not to the state of the program.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kineto_skew(fn):
    """One profile of ``fn``: device events by name, and per traced kernel
    launch the device start minus the host start of its runtime call (µs);
    the device events' span against the host window (µs)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    dev = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    launches = {e.correlation_id(): e for e in host if "aunch" in e.name()}
    by_name = {}
    for e in dev:
        by_name[e.name()[:48]] = by_name.get(e.name()[:48], 0) + 1
    skew = [(e.start_ns() - launches[e.correlation_id()].start_ns()) / 1e3
            for e in dev if e.correlation_id() in launches]
    h0 = min((e.start_ns() for e in host), default=0)
    h1 = max((e.start_ns() + e.duration_ns() for e in host), default=0)
    d0 = min((e.start_ns() for e in dev), default=None)
    d1 = max((e.start_ns() + e.duration_ns() for e in dev), default=None)
    return {"device_events": by_name,
            "launch_skew_us": [min(skew), float(np.median(skew)), max(skew)] if skew else None,
            "device_first_minus_host_first_us": None if d0 is None else (d0 - h0) / 1e3,
            "device_last_minus_host_last_us": None if d1 is None else (d1 - h1) / 1e3}


def clocks():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,pstate",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def whole_windows(cs, fn, n, guarded, iters=20):
    """How many of ``n`` profiles of ``iters`` calls of ``fn`` saw every
    call's device event, bare or fenced by ``cs.profiled``'s guards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    whole = 0
    for _ in range(n):
        ctx = (cs.profiled() if guarded
               else profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        with ctx as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        counts = [e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and cs.GUARD_KERNEL not in e.key]
        whole += bool(counts) and all(c % iters == 0 for c in counts)
    return whole


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--idle-s", type=float, default=60.0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--idle-only", action="store_true", help="skip the refresh phases")
    ap.add_argument("--windows", type=int, default=10, help="bare and guarded windows a kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiler_probe: no CUDA device available")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.kernels.fm_interaction import kernel as fm_kernel

    t_start = time.perf_counter()
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    build.build_all([kernel.SOURCE, fm_kernel.SOURCE])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    key = torch.from_numpy(cs._tie_heavy(rng, 506_438)).to(dev)
    kv = 425_984
    v = torch.rand((65_536, 40, 10), device=dev)
    kernels = {"threshold": lambda: kernel.victim_threshold(key, kv),
               "fm": lambda: fm_kernel.fm_interaction(v)}

    def snapshot(label):
        short = {}
        for name, fn in (*kernels.items(), ("topk", lambda: torch.topk(key, kv))):
            ms, ops = cs.device_ms(fn, tries=1)
            short[name] = {"device_ms": ms, "ops": sorted(ops)}
        whole = {f"{name} {'guarded' if g else 'bare'}": whole_windows(cs, fn, args.windows, g)
                 for name, fn in kernels.items() for g in (False, True)}

        def long_window():
            torch.cuda._sleep(10_000_000)
            for _ in range(20):
                kernel.victim_threshold(key, kv)

        cs.log(json.dumps({"label": label, "t_s": time.perf_counter() - t_start,
                           "short": short, "whole_windows_of": args.windows, "whole": whole,
                           "clocks": clocks(), "long": kineto_skew(long_window)}))

    snapshot("fresh process")
    with cs.deterministic():
        torch.topk(key, kv)
    snapshot("after a deterministic() block")
    with cs._PeakRSS():
        time.sleep(2.0)
    snapshot("after the RSS sampler thread")
    with cs._RefreshClock():
        pass
    snapshot("after the refresh clock's patches")
    if not args.idle_only:
        cs.drift_phase(dev, "smoke")
        snapshot("after bench_drift's SMOKE run (phase 5h at SMOKE)")
        cs.refresh_phase(dev, 0.02, n_steps=7, n_serve=4)
        snapshot("after phase 5f at vocab scale 0.02")
    for r in range(args.rounds):
        time.sleep(args.idle_s)
        snapshot(f"after {(r + 1) * args.idle_s} s idle")


if __name__ == "__main__":
    main()
