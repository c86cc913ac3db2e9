"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``, on a machine
with the CUDA card(s) the cell asks for.  The last line of standard output
is the result (one JSON object); the last lines of standard error are the
numbers that decided ``correct``, each beside its limit.  See
``portbench/README.md``.
"""
import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench.lib import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
