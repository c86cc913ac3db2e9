"""The controls of the benchmark's checks, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--variant tf32|half|field|program]

For each seed, the cell's plain reference computed in TF32 (the precision
below the fp32 the configurations state) is put in the program's place and
read by the cell's own comparison against the fp32 reference: a training
cell's first steps, a serving cell's first requests (as many as a run
compares).  ``--variant half`` and ``--variant field`` read a training
cell's faults instead: the reference with half of each batch left out, or
with the smallest field's rows never written back.  ``--variant program``
reads the program's own numbers: a whole run of the cell per seed, with a
window of ``--seconds``, in this one process.  Each line is one seed's
numbers beside the cell's limits.  Not run by the benchmark's own runs;
without a CUDA card it exits non-zero.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="tf32")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from portbench.lib import harness

    if not torch.cuda.is_available():
        print("the controls are read on a CUDA card; this machine has none", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), args.workload)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.variant == "program":
            line = harness.execute(cell, seed, args.seconds, False, dev, t)
            got = {k: c["value"] for k, c in line["checks"].items()}
            got.update(line["notes"], attempted=line["attempted"], failed=line["failed"],
                       metrics={k: m["value"] for k, m in line["metrics"].items()})
        else:
            r = harness.Run(workload=args.workload, cfg=cell["cfg"], mix=cell["mix"],
                            limits=cell["limits"], model=cell["model"],
                            reference=cell["reference"], seed=seed, seconds=0.0, trace=False,
                            device=dev, t0=t)
            got = cell["mode"].control(r, variant=args.variant)
        fails = sorted(k for k, lim in cell["limits"].items() if k in got and got[k] > lim)
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": args.variant,
                          "readings": got, "limits": cell["limits"], "fails": fails,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
