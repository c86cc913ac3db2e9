"""Where a cache-op wrapper's host enqueue goes on the card's host: the
median cost of each piece of a launch, measured on its own, beside the
empty-launch floor (``scripts/empty_launch.cu``) and the wrappers of
``kernels/cache_ops`` end to end (gather-decode, its fused host encode,
bucketize and its fused route, with and without owner and local).

    python3 scripts/launch_breakdown.py [--reps 2]

Needs one CUDA card.  Every piece runs in 7 warmed windows of 300
back-to-back calls, the card synchronised between windows; the line of a
piece gives the median, least and greatest window in microseconds a call.
No profiler runs in the process.  The shapes are the main paths': a
write-back of 25 512 lanes from an arena of 126 610 fp32 head and 379 828
int8 tail slots of dim 128, and the router's 425 984 lanes over 4 shards.
Prints one JSON line a piece and repetition.
"""
import argparse
import json
import os
import statistics
import struct
import sys
import time
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, iters=300, windows=7, warmup=50):
    for _ in range(warmup):
        fn()
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append(1e6 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    return statistics.median(per), min(per), max(per)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("launch_breakdown: no CUDA device available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_ops import kernel
    from repro_torch.store.codec import get_codec

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    h, t, d, k, u, s = 126_610, 379_828, 128, 25_512, 425_984, 4
    head = torch.randn((h, d), generator=g, device=dev)
    payload, side = get_codec("int8").encode(torch.randn((t, d), generator=g, device=dev))
    slots = (h + torch.randint(0, t, (k,), generator=g, device=dev)).to(torch.int32)
    table = torch.randint(0, s, (1 << 20,), generator=g, device=dev, dtype=torch.int32)
    uniq = torch.randint(0, 1 << 20, (u,), generator=g, device=dev, dtype=torch.int32)
    block = torch.empty((s + 2, u), dtype=torch.int32, device=dev)
    empty = build.Kernel(Path(ROOT) / "scripts" / "empty_launch.cu", "empty_launch", 1)
    x = torch.empty((1,), device=dev)
    ptr = x.data_ptr()
    empty(0, ptr)  # built and bound
    raw, stream = empty._fn, torch._C._cuda_getCurrentRawStream(0)
    pack10 = struct.Struct("10q").pack
    pieces = {
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "struct pack of 10 fields": lambda: pack10(*range(10)),
        "ctypes call of the empty launch (packed pointer, stream)":
            lambda: raw(struct.pack("q", ptr), stream),
        "the floor: build.Kernel's empty launch": lambda: empty(0, ptr),
        "torch.empty fp32 [K, D]": lambda: torch.empty((k, d), dtype=torch.float32, device=dev),
        "torch.empty int8 [K, D] + fp32 [K, 2]":
            lambda: (torch.empty((k, d), dtype=torch.int8, device=dev),
                     torch.empty((k, 2), dtype=torch.float32, device=dev)),
        "torch.empty int32 [S + 2, U]":
            lambda: torch.empty((s + 2, u), dtype=torch.int32, device=dev),
        "three views of one block": lambda: (block[s], block[s + 1], block[:s]),
        "the gather-decode checks": lambda: kernel._gd_card(head, payload, side, slots, "int8",
                                                            "gather_decode"),
        "gather_decode": lambda: kernel.gather_decode(head, payload, side, slots, "int8"),
        "gather_decode_encode": lambda: kernel.gather_decode_encode(head, payload, side, slots,
                                                                    "int8", "int8"),
        "bucketize": lambda: kernel.bucketize(uniq, uniq, s),
        "route_bucketize": lambda: kernel.route_bucketize(uniq, table, table, 2048, s),
        "route_image (the sharded plan's call)":
            lambda: kernel.route_image(uniq, table, table, 2048, s),
    }
    card = torch.cuda.get_device_name(0)
    for rep in range(args.reps):
        for name, fn in pieces.items():
            med, lo, hi = per_call_us(fn)
            print(json.dumps({"rep": rep, "piece": name, "us_median": med, "us_min": lo,
                              "us_max": hi, "card": card}), flush=True)


if __name__ == "__main__":
    main()
