"""The traced part of a ``--trace 1`` run: a short profiled window over the
card and its reduction to the device's busy time, the longest device ops
and the idle gaps named by what the host was doing.

``profile`` runs calls of a step under ``torch.profiler``, fenced on both
sides by tiny spin kernels after which the card is synchronised: the
window runs from the last fence before the step's device work to the
first fence after it (the profiler drops a few device events at a
window's edges, and the fences are what it drops; readers leave them out).
On the CPU (the tests) a ``portbench.window`` annotation bounds it.  The
trace is exported as Chrome JSON to the run's temporary directory, read,
and deleted.

``reduce`` works on that JSON's events alone, so tests feed it made-up
traces:

* busy: the union of the device's kernel, memcpy and memset intervals
  clipped to the window (overlapping streams count once);
* ``device_ops``: device time by op name, the longest first;
* ``idle_gaps``: the window's time with no device op, each gap named by
  the host event that began last among those running at its middle (the
  innermost: a torch op, a CUDA runtime call, or one of the benchmark's
  own spans), summed by name;
* ``kernels``: launches and total time by device op name, for rooflines.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch

__all__ = ["WINDOW", "GUARD_KERNEL", "profile", "reduce"]

WINDOW = "portbench.window"
GUARD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
GUARD_LAUNCHES, GUARD_CYCLES = 32, 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def _traced(step: Callable[[int], object], ks: range, device: torch.device, host: bool):
    """The Chrome trace events of ``step(k)`` for ``k`` in ``ks``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    from torch.profiler import record_function

    cuda = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=acts) as prof:
        for _ in range(GUARD_LAUNCHES if cuda else 0):
            torch.cuda._sleep(GUARD_CYCLES)
        if cuda:
            torch.cuda.synchronize(device)
        with record_function(WINDOW):
            for k in ks:
                step(k)
            if cuda:
                torch.cuda.synchronize(device)
        for _ in range(GUARD_LAUNCHES if cuda else 0):
            torch.cuda._sleep(GUARD_CYCLES)
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def profile(step: Callable[[int], object], n: int, device: torch.device) -> Dict[str, object]:
    """Profile ``step(0) .. step(2n - 1)``: the first ``n`` with the device's
    activity alone (the busy and window seconds, the device ops and kernels:
    recording every host op would stretch the host's share), the next ``n``
    with the host's ops too (the names of the idle gaps; their seconds are
    those of that stretched window)."""
    out = reduce(_traced(step, range(n), device, host=False))
    out["idle_gaps"] = reduce(_traced(step, range(n, 2 * n), device, host=True))["idle_gaps"]
    return out


def _union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _top(by_name: Mapping[str, float], k: int = 10) -> List[List[object]]:
    return [[name, s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]


def reduce(events: Sequence[Mapping]) -> Dict[str, object]:
    """Busy and window seconds, the top device ops, the named idle gaps and
    per-op launch counts of a Chrome trace's events (times in us)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ops_all = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e) for e in xs
               if e.get("cat") in DEVICE_CATS]
    guards = [(a, b) for a, b, e in ops_all if GUARD_KERNEL in e["name"]]
    work = [(a, b, e) for a, b, e in ops_all if GUARD_KERNEL not in e["name"]]
    first = min((w[0] for w in work), default=None)
    last = max((w[1] for w in work), default=None)
    before = [b for a, b in guards if first is not None and b <= first]
    after = [a for a, b in guards if last is not None and a >= last]
    if before and after:  # from the last fence before the work to the first after
        w0, w1 = max(before), min(after)
    else:
        win = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if len(win) != 1:
            raise ValueError(f"the trace holds no fences around its work and {len(win)} "
                             f"{WINDOW} spans")
        w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    dev = [(max(a, w0), min(b, w1), e) for a, b, e in work if min(b, w1) > max(a, w0)]
    busy = _union([(a, b) for a, b, _ in dev])
    ops: Dict[str, float] = {}
    kernels: Dict[str, List[float]] = {}
    for a, b, e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) / 1e6
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e["dur"]) / 1e6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for span in busy for x in span] + [w1]
    open_, j = [], 0  # host events begun, the latest-begun on top
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(open_, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while open_ and open_[0][1] <= mid:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else "host (no traced op)"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": _top(ops),
        "idle_gaps": _top(gaps),
        "kernels": {name: (int(c), s) for name, (c, s) in kernels.items()},
    }
