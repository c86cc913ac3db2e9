"""Serving launcher: batched scoring with the cache in read-only mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mind --requests 2000
  PYTHONPATH=src python -m repro_torch.launch.serve --arch din --refresh-interval 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-criteo --arena-precision int8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-criteo --model-shards 2 --ranks 2 --backend gloo --device cpu

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.  Each arch is
the reference launcher's config (MIND, the default, and DIN over histories
of 50 from 200 000 items; a two-field DLRM); victim selection always goes
through the bounded top-K route, whose threshold is the CUDA kernel on the
card (bit-identical to the full argsort route).  ``--model-shards S``
splits the DLRM's arena over S shards; ``--ranks R --backend
{gloo,nccl}`` puts one in each of R processes on a ``(data = R / S, model
= S)`` mesh, as ``launch/train.py`` does: each data replica scores its
slice of every batch, the slices' scores are gathered, rank 0 reports.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.policies import Policy
from repro_torch.data import synth
from repro_torch.dist import group
from repro_torch.dist.mesh import HybridMesh
from repro_torch.launch.mesh import make_hybrid_mesh
from repro_torch.launch.train import check_ranks
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.recsys_models import DINConfig, DINModel, MINDConfig, MINDModel
from repro_torch.serve.engine import ServeEngine


def pad_example(cfg) -> dict:
    """One padding request of the DIN / DIEN (with categories) or MIND
    schema: an empty history, item, category and user 0, label 0."""
    pad = {"hist_items": np.zeros((cfg.seq_len,), np.int32), "hist_len": np.zeros((), np.int32),
           "target_item": np.zeros((), np.int32), "user": np.zeros((), np.int32),
           "label": np.zeros((), np.float32)}
    if hasattr(cfg, "n_cates"):
        pad.update(hist_cates=np.zeros((cfg.seq_len,), np.int32),
                   target_cate=np.zeros((), np.int32))
    return pad


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mind", choices=["mind", "din", "dlrm-criteo"])
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--arena-precision", default="fp32",
                    choices=["fp32", "fp16", "int8", "auto"],
                    help="device-arena codec: fp32 = raw arena; fp16/int8 tier it (the hot "
                         "head stays fp32, the cold resident tail is stored encoded); auto = "
                         "PrecisionPolicy from head coverage")
    ap.add_argument("--cache-policy", default=None, choices=[p.value for p in Policy],
                    help="cache eviction policy; default = the model's (freq_lfu)")
    ap.add_argument("--obs-dir", default=None,
                    help="stream per-batch JSONL and a Chrome trace to this directory; render "
                         "with `python -m repro_torch.obs.report <dir>/serve.jsonl`")
    ap.add_argument("--refresh-interval", type=int, default=0,
                    help="0 = the static rank; N = re-rank the read-only cache from its "
                         "online decayed counters every N scored batches (scores unchanged)")
    ap.add_argument("--model-shards", type=int, default=0,
                    help="dlrm-criteo: 0 = one collection; S = the arena split over S shards")
    ap.add_argument("--ranks", type=int, default=0,
                    help="0 = one process; R = one cache shard a process (dlrm-criteo, R a "
                         "multiple of --model-shards S: a (data=R/S, model=S) mesh): R "
                         "spawned ranks, or torchrun's world")
    ap.add_argument("--backend", default=None, choices=group.BACKENDS,
                    help="with --ranks: gloo (CPU ranks, or ranks sharing the card) or nccl "
                         "(one card a rank)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.model_shards and not args.arch.startswith("dlrm"):
        raise SystemExit(f"--model-shards is wired for dlrm-criteo; {args.arch} builds an "
                         f"unsharded collection")
    check_ranks(args)
    if args.ranks:
        from repro_torch.dist import run

        return run.launch("serve", args.ranks, args.backend, args.device, argv)
    return _serve(args)


def run_rank(argv: Sequence[str], dev) -> Dict[str, Any]:
    """This process's rank of a ``--ranks`` run (its world is up): the
    engine on its shard; returns the summary."""
    args = _parser().parse_args(list(argv))
    return _serve(args, make_hybrid_mesh(args.model_shards), dev)


def _serve(args, mesh: Optional[HybridMesh] = None, device=None) -> Dict[str, Any]:
    device = args.device if device is None else device
    lead = mesh is None or mesh.rank == 0
    policy = Policy(args.cache_policy) if args.cache_policy else None

    if args.arch == "mind":
        cfg = MINDConfig(n_items=200_000, n_users=20_000, embed_dim=32, seq_len=50,
                         batch_size=args.batch, cache_ratio=0.05,
                         arena_precision=args.arena_precision, policy=policy,
                         use_pallas_plan=True)
        model, pad = MINDModel(cfg), pad_example(cfg)

        def make(s):
            return synth.recsys_batch(cfg.n_items, cfg.n_users, cfg.seq_len, args.batch, 1, s)
    elif args.arch == "din":
        cfg = DINConfig(n_items=200_000, n_cates=20_000, n_users=20_000, embed_dim=18,
                        seq_len=50, batch_size=args.batch, cache_ratio=0.05,
                        arena_precision=args.arena_precision, policy=policy,
                        use_pallas_plan=True)
        model, pad = DINModel(cfg), pad_example(cfg)

        def make(s):
            return synth.recsys_batch(cfg.n_items, cfg.n_users, cfg.seq_len, args.batch, 1, s,
                                      n_cates=cfg.n_cates)
    else:
        cfg = DLRMConfig(vocab_sizes=(100_000, 50_000), embed_dim=32, batch_size=args.batch,
                         cache_ratio=0.05, bottom_mlp=(64, 32), top_mlp=(64,), policy=policy,
                         arena_precision=args.arena_precision, use_pallas_plan=True,
                         model_shards=args.model_shards)
        model = DLRM(cfg, mesh=mesh)
        pad = {"dense": np.zeros((13,), np.float32), "sparse": np.zeros((2,), np.int32),
               "label": np.zeros((), np.float32)}
        spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)

        def make(s):
            return synth.sparse_batch(spec, args.batch, 1, s)

    state = model.init(0, device=device)
    engine = ServeEngine(
        model.serve_step, state, batch_size=args.batch, pad_example=pad,
        state_stats_fn=lambda s: model.collection.metrics(s["emb"], writeback=False),
        obs_dir=args.obs_dir, device=device, mesh=mesh,
        # read-only cache: resident rows are clean, the re-rank skips write-backs
        refresh_fn=(lambda s: model.refresh(s, writeback=False)) if args.refresh_interval
        else None,
        refresh_every=args.refresh_interval or None,
    )
    n = step = 0
    while n < args.requests:
        engine.score(make(step))
        n += args.batch
        step += 1
    summary = engine.summary()
    engine.close()
    for slab in engine.state["emb"].slabs.values():
        slab.full.close()
    if not lead:
        return summary
    print("stats:", summary)
    if mesh is not None:
        t = mesh.traffic
        print(f"ranks: {mesh.world} on a (data={mesh.data}, model={mesh.model}) mesh; rank 0 "
              f"sent {t.bytes_sent / 1e6:.2f} MB over the model axis and "
              f"{t.data_bytes_sent / 1e6:.2f} MB over the data axis; bytes by leg "
              f"{dict(sorted(t.legs.items()))}")
    print(f"cache hit rate: {summary['hit_rate']:.1%} | "
          f"host<->device traffic: {summary['host_wire_bytes']/1e6:.2f} MB")
    return summary


if __name__ == "__main__":
    main()
