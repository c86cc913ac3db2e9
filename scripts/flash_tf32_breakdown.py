"""Where the 3xTF32 flash kernel's time goes, on one CUDA card.

    python3 scripts/flash_tf32_breakdown.py [--b 2 --s 4096 --hq 15 --hkv 5 --d 64]

Builds ``flash_attention_tf32.cu`` as it is and variants of it with one
part cut out (their outputs are wrong; only their times mean anything),
each with ``nvcc`` for ``sm_90a`` into ``build/flash_tf32_variants/``,
and times them in turns by CUDA events on seeded random fp32 inputs of
the fp32 SmolLM-360M's prefill layer (B 2, S 4096, 15 query heads over 5
KV heads, d 64, causal).  The difference between the kernel and a variant
is what that part costs where nothing else hides it:

* ``one_term``: S and P V issue only hi * hi (one TF32 product, not three);
* ``no_s`` / ``no_pv``: the S / P V products are not issued;
* ``no_exp``: p = s and corr = 1, no ``expf``;
* ``split_only`` / ``attention_only``: one of the two launches alone.

Prints the card's name and power limit, then one JSON line of ms by
variant for each round.  Needs ``nvcc`` and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402

VARIANTS = {  # name: (text, replacement) pairs applied to the source
    "kernel": [],
    "one_term": [("for (int t = 0; t < 3; ++t)  // Q_hi", "for (int t = 2; t < 3; ++t)  // Q_hi"),
                 ("for (int t = 0; t < 3; ++t)  // p_lo", "for (int t = 2; t < 3; ++t)  // p_lo"),
                 ("t > 0 || kk > 0", "t > 2 || kk > 0")],
    "no_s": [("mma_ss(s,", "if (0) mma_ss(s,")],
    "no_pv": [("mma_rs(pv,", "if (0) mma_rs(pv,")],
    "no_exp": [("const float p = expf(s[e] - m[(e >> 1) & 1]);", "const float p = s[e];"),
               ("corr[i] = expf(m[i] - m_new);", "corr[i] = 1.f;")],
    "split_only": [("  flash_tf32x3_kernel<NA><<<", "  if (0) flash_tf32x3_kernel<NA><<<")],
    "attention_only": [("  flash_tf32x3_split_kernel<NA><<<",
                        "  if (0) flash_tf32x3_split_kernel<NA><<<")],
}


def build_variants(out_dir: Path):
    """Compiles every variant at once; returns their bound C entries."""
    source = fa_kernel.TF32_SOURCE.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attention_tf32x3_fwd
        fn.argtypes = list(fa_kernel.ARGTYPES) + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def event_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main():
    ap = argparse.ArgumentParser()
    for name, default in (("b", 2), ("s", 4096), ("hq", 15), ("hkv", 5), ("d", 64),
                          ("iters", 10), ("rounds", 2)):
        ap.add_argument(f"--{name}", type=int, default=default)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_tf32_breakdown: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    entries = build_variants(ROOT / "build" / "flash_tf32_variants")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, d = args.b, args.s, args.d
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).transpose(1, 2)
               for h in (args.hq, args.hkv, args.hkv))  # [B, H, S, D] views, as the model's
    out = torch.empty_like(q)
    dp = 64 if d <= 64 else 128
    tiles = torch.empty((b, args.hkv, -(-s // 64), 4 * 64 * dp), device=dev)

    def call(fn):
        def run():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, args.hq,
                     args.hkv, s, s, d, *q.stride(), *k.stride(), *v.stride(), *out.stride(),
                     1.0 / math.sqrt(d), 1, 0, 0, tiles.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return run

    print(f"card: {card}; shape B {b} x S {s}, {args.hq}/{args.hkv} heads, d {d}, causal; "
          f"event ms a call, {args.iters} calls a reading")
    for _ in range(args.rounds):
        print(json.dumps({name: event_ms(call(fn), args.iters) for name, fn in entries.items()}),
              flush=True)


if __name__ == "__main__":
    main()
