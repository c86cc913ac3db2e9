"""Hybrid-parallel scaling demo of the PyTorch port (paper §4.4; port of
``examples/multi_device_scaling.py``): the sharded EmbeddingCollection on a
``(data=2, model=4)`` mesh of 8 ranks over ``torch.distributed``.  The
dense/MLP params train data-parallel, each of the 4 model shards owns its
own frequency-aware cache arena and HostStore slice, ids route to their
owner shard and rows come back through the exchange.  Exactness is
preserved: the loss trajectory matches the single-device collection.

Each rank is a process (``dist.run.run_ranks``; gloo by default: CPU ranks
with ``--device cpu``, or ranks sharing the card(s)), builds its mesh with
``launch.mesh.make_hybrid_mesh(4)`` and feeds its data replica's half of
each global batch of 512.  On the card every plan launches the
victim-threshold and route-bucketize CUDA kernels.  Rank 0's numbers are
printed.

Run:  PYTHONPATH=src python examples/torch_multi_device_scaling.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import freq as freq_lib
from repro_torch.core.collection import SHARED_ARENA
from repro_torch.data import synth
from repro_torch.device import resolve_device
from repro_torch.dist import run
from repro_torch.dist.partitioning import shard_state
from repro_torch.kernels import counters
from repro_torch.launch.mesh import make_hybrid_mesh
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.obs.hub import fetch_ints

MODEL_SHARDS = 4
WORLD = 8  # (data=2, model=4)
STEPS = 5
CFG = DLRMConfig(vocab_sizes=(100_000, 50_000), embed_dim=32, batch_size=512,
                 cache_ratio=0.05, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                 model_shards=MODEL_SHARDS, use_pallas_plan=True)
SPEC = synth.ZipfSparseSpec(vocab_sizes=CFG.vocab_sizes, n_dense=13)
_EXACT = ("cache_misses", "cache_evictions", "uniq_overflows", "slab_hits", "host_moved_rows")


def counts() -> np.ndarray:
    """The id counts of 20 batches: they drive BOTH the cache layout and the
    RecShard-style device assignment (balance expected hot-row traffic per
    shard)."""
    return freq_lib.collect_counts(
        (synth.sparse_batch(SPEC, 512, 0, s)["sparse"]
         + freq_lib.concat_table_offsets(CFG.vocab_sizes)[None, :]
         for s in range(20)),
        vocab=sum(CFG.vocab_sizes),
    )


def rank_main(rank: int, dev: torch.device, init_state=None):
    """One rank: its shard of the DLRM, five steps, its numbers."""
    mesh = make_hybrid_mesh(MODEL_SHARDS)
    model = DLRM(CFG, mesh=mesh)
    if init_state is None:
        state = model.init(0, counts=counts(), device=dev)
    else:  # a stacked state (numpy tree): this rank's shard of it, placed as init places it
        model.collection.assign(model.collection.split_concat_counts(counts()))
        state = shard_state(convert.state_from_numpy(init_state, device=dev),
                            model.state_specs(), mesh)
    steps = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(mesh.data_slice(v)).to(dev)
                 for k, v in synth.sparse_batch(SPEC, 512, 0, i).items()}
        t0 = time.perf_counter()
        state, metrics = model.train_step(state, batch)
        rec = {"loss": float(metrics["loss"])}  # the step's one sync
        rec["ms"] = 1e3 * (time.perf_counter() - t0)
        rec.update({k: float(metrics[k]) for k in ("hit_rate", "exchange_bytes",
                                                   "shard_imbalance")})
        rec.update(fetch_ints({k: metrics[k] for k in _EXACT}))
        steps.append(rec)
    w = state["emb"].slabs[SHARED_ARENA].cache.cached_rows["weight"]
    out = {"rank": rank, "mesh": (mesh.data, mesh.model), "backend": mesh.backend,
           "shard_shape": tuple(w.shape), "steps": steps,
           "assignments": {n: (a.shard_rows.tolist(), a.imbalance())
                           for n, a in model.collection.assignments.items()},
           "device_bytes": {k: v for k, v in model.collection.device_bytes().items()
                            if k != "per_slab"},
           "launches": counters.launch_counts()}  # a spawned rank starts from 0
    for slab in state["emb"].slabs.values():
        if hasattr(slab, "full"):
            slab.full.close()
    return out


def main(argv=None, init_state=None):
    """Spawn the 8 ranks, print rank 0's numbers and return every rank's.
    ``init_state``: a stacked initial state (a numpy tree, as
    ``convert.state_from_numpy`` reads) for every rank to take its shard
    of, in place of the port's own init."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="gloo: CPU ranks or ranks sharing the card(s); nccl: one card a rank")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    t0 = time.perf_counter()
    ranks = run.run_ranks(rank_main, WORLD, args.backend, args.device, (init_state,),
                          threads=1)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"mesh: (data={r0['mesh'][0]}, model={r0['mesh'][1]}) over {WORLD} "
          f"{r0['backend']} ranks")
    for sname, (rows, imb) in r0["assignments"].items():
        print(f"slab {sname}: rows/shard {rows}, traffic imbalance {imb:.3f}x")
    for i, s in enumerate(r0["steps"]):
        print(f"step {i}: loss={s['loss']:.4f} hit_rate={s['hit_rate']:.2%} "
              f"exchange={s['exchange_bytes']/1e6:.2f} MB cum "
              f"imbalance={s['shard_imbalance']:.2f}x")
    print(f"cached weight shard on rank 0: {r0['shard_shape']} "
          f"-> one cache arena per 'model' rank (hybrid parallel)")
    db = r0["device_bytes"]
    print(f"per-shard device bytes: {db['device_per_shard']/1e6:.2f} MB "
          f"(total {db['device_total']/1e6:.2f} MB over {MODEL_SHARDS} shards)")
    return {"ranks": ranks, "world_s": world_s,
            "p50_ms": float(np.median([s["ms"] for s in r0["steps"]]))}


if __name__ == "__main__":
    main()
