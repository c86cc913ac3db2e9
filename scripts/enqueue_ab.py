"""The host enqueue, CUDA-event and device time of one tree's gather-decode
and bucketize wrappers on the card: an A/B of a change to their launch
path.  Run it on the parent's tree and the change's in turns (parent,
change, change, parent) in one call, so that both read the same card and
host:

    python3 scripts/enqueue_ab.py --src PATH/TO/TREE/src [--label NAME]

Needs one CUDA card; imports the ``repro_torch`` under ``--src`` (its
kernels are built into that tree's ``build/kernels``).  The inputs are
seeded and shaped as the main paths' calls: one write-back of 25 512 lanes
(a tenth of them head slots) from an arena of 126 610 fp32 head and
379 828 int8 tail slots of dim 128, and the router's image of 425 984
lanes over 4 shards.  Enqueue is the median over 7 warmed windows of the
mean of 100 back-to-back calls, the event time the mean of 200
back-to-back calls between CUDA events, the device time the profiler's
summed device ops a call over 20 calls.  Prints one JSON line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def host_ms(fn, iters=100, windows=7):
    for _ in range(10):
        fn()
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append(1e3 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    return float(np.median(per))


def event_ms(fn, iters=200):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("enqueue_ab: no CUDA device available")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.store.codec import get_codec

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    h, t, d, k = 126_610, 379_828, 128, 25_512
    head = torch.randn((h, d), generator=g, device=dev)
    payload, side = get_codec("int8").encode(torch.randn((t, d), generator=g, device=dev))
    slots = torch.cat([torch.randint(0, h, (k // 10,), generator=g, device=dev),
                       h + torch.randint(0, t, (k - k // 10,), generator=g, device=dev)])
    slots = slots.to(torch.int32)
    u, s = 425_984, 4
    owner = torch.randint(-1, s, (u,), generator=g, device=dev, dtype=torch.int32)
    local = torch.randint(-1, 1 << 23, (u,), generator=g, device=dev, dtype=torch.int32)
    calls = {"gather_decode": lambda: kernel.gather_decode(head, payload, side, slots, "int8"),
             "bucketize": lambda: kernel.bucketize(owner, local, s)}
    out = {"label": args.label or args.src, "card": torch.cuda.get_device_name(0)}
    for name, fn in calls.items():
        out[name] = {"host_enqueue_ms": host_ms(fn), "ms": event_ms(fn),
                     "device_ms": device_ms(fn)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
