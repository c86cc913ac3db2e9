"""``chip_smoke.py``'s GatedGCN phases 17a-17d alone, on one CUDA card:
full_graph_sm (logits and a train step against the CPU, two deterministic
runs bitwise, serve and train timings), minibatch_lg, molecule and
ogb_products (served at the largest edge share that fits), each with its
p50 / p99, nodes/s, peak device memory and a profiled step's idle share.

    python3 scripts/gnn_phases.py

Needs one CUDA card and builds no kernel (none lies on the graph path);
~90 s on an H100, a third of it building ogb_products' batch on the host.
"""
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("gnn_phases: no CUDA device available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    t0 = time.perf_counter()
    launches = cs._kernel_launches()
    for what, phase in (("17a", cs.gnn_full_graph_phase), ("17b", cs.gnn_minibatch_phase),
                        ("17c", cs.gnn_molecule_phase), ("17d", cs.gnn_ogb_phase)):
        cs.timed(what, phase, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if cs._kernel_launches() != launches:
        raise AssertionError("a kernel of the port launched on the GNN path")
    cs.log(f"17a-17d {time.perf_counter() - t0} s")


if __name__ == "__main__":
    main()
