"""Training launcher: the serial or pipelined trainer on synthetic Zipf
batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-criteo --steps 50 --arena-precision int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 50 --host-precision int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch din --steps 20 --pipeline-depth 2
  PYTHONPATH=src python -m repro_torch.launch.train --model-shards 4 --replicate-top-k 64
  PYTHONPATH=src python -m repro_torch.launch.train --model-shards 2 --ranks 2 --backend gloo --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --model-shards 2 --ranks 4 --backend gloo --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --pipeline-depth 2 --chunk-rows 8
  PYTHONPATH=src python -m repro_torch.launch.train --refresh-interval 5 --model-shards 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-avazu --cache-policy lru
  PYTHONPATH=src python -m repro_torch.launch.train --obs-dir /tmp/obs --history-limit 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch gatedgcn --steps 20

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.  Every arch
builds the reference launcher's CPU-scale config: every ``dlrm*`` arch the
same small DLRM, ``fm`` six fields of 100 000 rows, ``din`` / ``dien`` /
``mind`` histories of 50 over 200 000 items (DIEN with 36 GRU units), and
each LM arch (``grok-1-314b``, ``olmoe-1b-7b``, ``gemma3-27b``,
``smollm-360m``, ``internlm2-20b``) its SMOKE config at lr 1e-3 on token
batches of 8 x 64, and ``gatedgcn`` an 8-layer GatedGCN of width 32 on
neighbour-sampled blocks (256 seeds, fanouts 10 and 5) of a 20 000-node,
100 000-edge random graph.  An LM or a GNN has no embedding cache: the cache
flags exit.

``--ranks R --backend {gloo,nccl}`` (dlrm archs, with ``--model-shards
S``, ``R`` a multiple of ``S``) runs the sharded DLRM one shard a process
on a ``(data = R / S, model = S)`` mesh: the launcher refuses a world the
backend cannot run, and a global ``--batch`` that does not split over the
``data`` replicas, before any rank starts, then spawns R ranks
(``dist.run``; they meet through a ``FileStore`` in a temp dir), or, where
``RANK`` and ``WORLD_SIZE`` are set, joins torchrun's world as that rank.
Each rank draws the global batch from the seed and feeds its replica's
rows.  ``--pipeline-depth`` and ``--refresh-interval`` run under ranks.
gloo runs CPU ranks (``--device cpu``) or ranks sharing the card(s);
nccl one card a rank.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policies import Policy
from repro_torch.data import graphs, synth
from repro_torch.dist import group
from repro_torch.dist.mesh import HybridMesh, check_mesh_shape
from repro_torch.launch.mesh import make_hybrid_mesh
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.gatedgcn import GatedGCNConfig, GatedGCNModel
from repro_torch.models.lm import LMModel
from repro_torch.models.recsys_models import (DIENConfig, DIENModel, DINConfig, DINModel,
                                               FMConfig, FMModel, MINDConfig, MINDModel)
from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig


def build(arch: str, batch: int, arena_precision: str, model_shards: int = 0,
          replicate_top_k: int = 0, exchange_codec: str = "fp32", max_routed_per_shard: int = 0,
          host_precision: str = "fp32", chunk_rows: int = 0, policy: Optional[Policy] = None,
          mesh: Optional[HybridMesh] = None,
          ) -> Tuple[object, Callable[[int], Dict[str, np.ndarray]]]:
    """The reference launcher's config of ``arch``: (model, step -> batch).
    Victim selection always goes through the bounded top-K route, whose
    threshold is the CUDA kernel on the card (bit-identical to the full
    argsort route); a sharded DLRM's router builds its per-shard image with
    the bucketize kernel there."""
    if model_shards and not arch.startswith("dlrm"):
        raise SystemExit(f"--model-shards is wired for dlrm archs; {arch} builds an "
                         f"unsharded collection")
    if (replicate_top_k or exchange_codec != "fp32" or max_routed_per_shard) and not model_shards:
        raise SystemExit("--replicate-top-k / --exchange-codec / --max-routed-per-shard shape "
                         "the sharded exchange; they need --model-shards >= 1")
    if arch.startswith("dlrm"):
        cfg = DLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=batch,
                         cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                         host_precision=host_precision, arena_precision=arena_precision,
                         policy=policy,
                         use_pallas_plan=True, chunk_rows=chunk_rows, model_shards=model_shards,
                         replicate_top_k=replicate_top_k,
                         exchange_codec=exchange_codec,
                         max_routed_per_shard=max_routed_per_shard)
        spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
        return DLRM(cfg, mesh=mesh), lambda s: synth.sparse_batch(spec, batch, 0, s)
    shared = dict(batch_size=batch, host_precision=host_precision,
                  arena_precision=arena_precision, policy=policy, use_pallas_plan=True,
                  chunk_rows=chunk_rows)
    if arch == "fm":  # trains through the sum-square torch ops: the FM kernel has no backward
        cfg = FMConfig(vocab_sizes=(100_000,) * 6, embed_dim=10, cache_ratio=0.02, **shared)
        spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes)
        return FMModel(cfg), lambda s: synth.sparse_batch(spec, batch, 0, s)
    if arch == "mind":
        cfg = MINDConfig(n_items=200_000, n_users=20_000, embed_dim=32, seq_len=50,
                         cache_ratio=0.05, **shared)
        return MINDModel(cfg), lambda s: synth.recsys_batch(cfg.n_items, cfg.n_users,
                                                            cfg.seq_len, batch, 0, s)
    kw = dict(n_items=200_000, n_cates=20_000, n_users=20_000, embed_dim=18, seq_len=50,
              cache_ratio=0.05, **shared)
    cfg = DINConfig(**kw) if arch == "din" else DIENConfig(gru_dim=36, **kw)
    model = DINModel(cfg) if arch == "din" else DIENModel(cfg)
    return model, lambda s: synth.recsys_batch(cfg.n_items, cfg.n_users, cfg.seq_len, batch, 0,
                                               s, n_cates=cfg.n_cates)


LM_ARCHS = ("grok-1-314b", "olmoe-1b-7b", "gemma3-27b", "smollm-360m", "internlm2-20b")


def build_lm(arch: str) -> Tuple[LMModel, Callable[[int], Dict[str, np.ndarray]]]:
    """The reference launcher's reduced LM: (model, step -> batch)."""
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return LMModel(mod.SMOKE, lr=1e-3), lambda s: synth.seq_batch(mod.SMOKE.vocab, 8, 64, 0, s)


def build_gnn() -> Tuple[GatedGCNModel, Callable[[int], Dict[str, np.ndarray]]]:
    """The reference launcher's GatedGCN: (model, step -> sampled block)."""
    model = GatedGCNModel(GatedGCNConfig(d_feat=32, n_classes=8, n_layers=8, d_hidden=32))
    indptr, indices, _ = graphs.random_graph_csr(20_000, 100_000, 0)
    feats = np.random.default_rng(0).normal(size=(20_000, 32)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.int32)
    return model, lambda s: graphs.sampled_batch(indptr, indices, feats, labels, 256, (10, 5),
                                                 0, s)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-criteo",
                    choices=["dlrm-criteo", "dlrm-avazu", "fm", "din", "dien", "mind",
                             *LM_ARCHS, "gatedgcn"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--obs-dir", default=None,
                    help="stream per-step JSONL and a Chrome trace to this directory; render "
                         "with `python -m repro_torch.obs.report <dir>/train.jsonl`")
    ap.add_argument("--obs-annotate", action="store_true",
                    help="also enter torch.profiler.record_function per stage span, so "
                         "profiler captures carry the same stage names")
    ap.add_argument("--history-limit", type=int, default=0,
                    help="0 = keep the whole step history in memory; N = keep the last N "
                         "step records (the full stream is on disk with --obs-dir)")
    ap.add_argument("--host-precision", default="fp32", choices=["fp32", "fp16", "int8", "auto"],
                    help="host-tier codec: fp32 = bit-exact; fp16/int8 shrink host bytes and "
                         "host<->device traffic; auto = PrecisionPolicy from frequency stats")
    ap.add_argument("--arena-precision", default="fp32",
                    choices=["fp32", "fp16", "int8", "auto"],
                    help="device-arena codec: fp32 = raw arena; fp16/int8 tier it (the hot "
                         "head stays fp32, the cold resident tail is stored encoded); auto = "
                         "PrecisionPolicy from head coverage")
    ap.add_argument("--model-shards", type=int, default=0,
                    help="0 = one collection; S >= 1 = hybrid parallel: the cached slab is "
                         "split over S shards, each with its own arena and host-table slice "
                         "(dlrm archs; on one card, the stacked layout)")
    ap.add_argument("--replicate-top-k", type=int, default=0,
                    help="sharded: the K hottest ranks live in a replicated arena and never "
                         "enter the exchange")
    ap.add_argument("--exchange-codec", default="fp32", choices=["fp32", "fp16", "int8"],
                    help="sharded: codec of the exchange's row leg (fp32 = exact)")
    ap.add_argument("--max-routed-per-shard", type=int, default=0,
                    help="sharded: per-shard plan width bound (0 = full width); lanes past "
                         "it raise through the overflow guard")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="0 = serial; k >= 1 = pipelined groups of k steps off one merged "
                         "cache plan, the next group planned ahead")
    ap.add_argument("--chunk-rows", type=int, default=0,
                    help="0 = host staging in rows; N = in contiguous N-row chunks (bitwise "
                         "the same; a table whose rows do not divide by N moves rows)")
    ap.add_argument("--refresh-interval", type=int, default=0,
                    help="0 = the static frequency rank (the paper); N = re-rank the cached "
                         "slabs from their online decayed counters every N steps (pipelined "
                         "runs refresh at group boundaries); fp32 losses are bitwise the same")
    ap.add_argument("--cache-policy", default=None, choices=[p.value for p in Policy],
                    help="cache eviction policy: freq_lfu = the paper's static frequency rank "
                         "(default), lru / uvm_row = recency, runtime_lfu = online counters")
    ap.add_argument("--ranks", type=int, default=0,
                    help="0 = one process; R = one cache shard a process (dlrm archs, R a "
                         "multiple of --model-shards S: a (data=R/S, model=S) mesh): R "
                         "spawned ranks, or torchrun's world")
    ap.add_argument("--backend", default=None, choices=group.BACKENDS,
                    help="with --ranks: gloo (CPU ranks, or ranks sharing the card) or nccl "
                         "(one card a rank)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def check_ranks(args) -> None:
    """Refuse a ranked run the port cannot make, before any rank starts;
    each message names what was asked for."""
    if not args.ranks:
        if args.backend:
            raise SystemExit(f"--backend {args.backend} picks the ranks' backend; it needs --ranks")
        return
    if not args.arch.startswith("dlrm"):
        raise SystemExit(f"--ranks {args.ranks} puts one cache shard in each process of a sharded "
                         f"DLRM; {args.arch} is not a dlrm arch")
    if not args.backend:
        raise SystemExit(f"--ranks {args.ranks} needs --backend gloo or nccl")
    try:
        check_mesh_shape(args.model_shards, args.ranks)
        group.check_world(args.backend, args.ranks, args.device)
    except ValueError as e:
        raise SystemExit(f"--ranks {args.ranks} --model-shards {args.model_shards} --backend "
                         f"{args.backend}: {e}") from None
    data = args.ranks // args.model_shards
    if args.batch % data:
        raise SystemExit(f"--ranks {args.ranks} --model-shards {args.model_shards}: a global "
                         f"--batch {args.batch} does not split over data={data} replicas")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    check_ranks(args)
    if args.ranks:
        from repro_torch.dist import run

        return run.launch("train", args.ranks, args.backend, args.device, argv)
    if args.arch in LM_ARCHS or args.arch == "gatedgcn":
        return _train_without_cache(args)
    return _train(args)


def run_rank(argv: Sequence[str], dev) -> Dict[str, Any]:
    """This process's rank of a ``--ranks`` run (its world is up): the run
    on its shard; returns the step history."""
    args = _parser().parse_args(list(argv))
    trainer = _train(args, make_hybrid_mesh(args.model_shards), dev)
    return {"history": trainer.history}


def _train(args, mesh: Optional[HybridMesh] = None, device=None):
    """A collection-backed arch through the serial or pipelined trainer;
    under a mesh this rank's shard, and only rank 0 reports."""
    device = args.device if device is None else device
    lead = mesh is None or mesh.rank == 0
    model, make_batch = build(args.arch, args.batch, args.arena_precision, args.model_shards,
                        args.replicate_top_k, args.exchange_codec, args.max_routed_per_shard,
                        args.host_precision, args.chunk_rows,
                        Policy(args.cache_policy) if args.cache_policy else None, mesh)
    tc = TrainerConfig(max_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=25,
                       obs_dir=args.obs_dir, obs_annotate=args.obs_annotate,
                       history_limit=args.history_limit or None,
                       pipeline_depth=args.pipeline_depth,
                       refresh_interval=args.refresh_interval or None)
    kw = dict(
        init_fn=lambda: model.init(0, device=device),
        make_batch=make_batch,
        flush_fn=model.flush,
        refresh_fn=model.refresh if args.refresh_interval else None,
        on_straggler=lambda s, dt: print(f"[straggler] step {s}: {dt * 1e3:.0f} ms"),
        device=device,
        mesh=mesh,
        state_specs=model.state_specs() if mesh is not None else None,
    )
    if args.pipeline_depth > 0:  # every arch is collection-backed (split plan/compute)
        trainer = PipelinedTrainer(tc, plan_fn=model.plan_step, compute_fn=model.compute_step,
                                   apply_fn=model.apply_step, **kw)
    else:
        trainer = Trainer(tc, step_fn=model.train_step, **kw)
    state = trainer.run()
    for slab in state["emb"].slabs.values():
        slab.full.close()
    if not lead:
        return trainer
    h = trainer.history
    print(f"\narch={args.arch} steps={h[-1]['step'] + 1} "
          f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    print(f"cache hit rate: {h[-1]['hit_rate']:.1%}")
    if args.refresh_interval:
        print(f"adaptive refresh: {h[-1]['refresh_swaps']:.0f} rank swaps, "
              f"{h[-1]['refresh_rows_moved']:.0f} host rows moved, "
              f"window hit rate {h[-1]['window_hit_rate']:.1%}")
    db = model.collection.device_bytes()
    print(f"host tier ({args.host_precision}): {db['slow_tier_bytes'] / 1e6:.1f} MB "
          f"(saved {db['host_bytes_saved'] / 1e6:.1f} MB vs fp32)")
    if args.arena_precision != "fp32":
        print(f"arena tier ({args.arena_precision}): saved "
              f"{db['arena_bytes_saved'] / 1e6:.2f} MB HBM vs fp32")
    print(f"host<->device traffic: {h[-1]['host_wire_bytes'] / 1e6:.1f} MB total")
    if mesh is not None:
        t = mesh.traffic
        print(f"ranks: {mesh.world} ({mesh.backend}) on a (data={mesh.data}, model="
              f"{mesh.model}) mesh, one shard each; rank 0 sent {t.bytes_sent / 1e6:.2f} MB "
              f"over the model axis in {t.collectives} collectives ({t.seconds * 1e3:.1f} ms "
              f"host time) and {t.data_bytes_sent / 1e6:.2f} MB over the data axis in "
              f"{t.data_collectives} ({t.data_seconds * 1e3:.1f} ms); bytes by leg "
              f"{dict(sorted(t.legs.items()))}")
    if args.model_shards:
        print(f"hybrid parallel: {args.model_shards} shards, "
              f"exchange {h[-1]['exchange_bytes'] / 1e6:.1f} MB total "
              f"(ids {h[-1]['exchange_id_bytes'] / 1e6:.1f} MB + rows "
              f"{h[-1]['exchange_row_bytes'] / 1e6:.1f} MB [{args.exchange_codec}], "
              f"top-{args.replicate_top_k} replicated), live imbalance "
              f"{h[-1]['shard_imbalance']:.2f}x")
    if args.obs_dir:
        print(f"observability: {trainer.hub.jsonl_path} (render: python -m "
              f"repro_torch.obs.report {trainer.hub.jsonl_path}) | chrome trace: "
              f"{trainer.trace_path}")
    return trainer


def _train_without_cache(args):
    """An LM arch or the GNN through the serial ``Trainer``; the cache flags
    exit with the reference launcher's messages."""
    if args.cache_policy:
        raise SystemExit(f"--cache-policy needs a collection-backed arch; "
                         f"{args.arch} has no embedding cache")
    if args.refresh_interval:
        raise SystemExit(f"--refresh-interval needs a collection-backed arch; "
                         f"{args.arch} has no cached slabs to re-rank")
    if args.pipeline_depth > 0:
        raise SystemExit(f"--pipeline-depth needs a collection-backed arch; "
                         f"{args.arch} has no split plan/compute step")
    model, make_batch = build_gnn() if args.arch == "gatedgcn" else build_lm(args.arch)
    tc = TrainerConfig(max_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=25,
                       obs_dir=args.obs_dir, obs_annotate=args.obs_annotate,
                       history_limit=args.history_limit or None)
    trainer = Trainer(tc, step_fn=model.train_step, init_fn=lambda: model.init(0, args.device),
                      make_batch=make_batch,
                      on_straggler=lambda s, dt: print(f"[straggler] step {s}: {dt * 1e3:.0f} ms"),
                      device=args.device)
    trainer.run()
    h = trainer.history
    print(f"\narch={args.arch} steps={h[-1]['step'] + 1} "
          f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    if args.obs_dir:
        print(f"observability: {trainer.hub.jsonl_path} (render: python -m "
              f"repro_torch.obs.report {trainer.hub.jsonl_path}) | chrome trace: "
              f"{trainer.trace_path}")
    return trainer


if __name__ == "__main__":
    main()
