"""Training launcher: the serial trainer on synthetic Zipf batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-criteo --steps 50 --arena-precision int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 50

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.  DIN, DIEN and
MIND, the reference launcher's other architectures, come with their models
in a later slice of the port.
"""
from __future__ import annotations

import argparse

from repro_torch.data import synth
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.recsys_models import FMConfig, FMModel
from repro_torch.train.trainer import Trainer, TrainerConfig


def build(arch: str, batch: int, arena_precision: str):
    """The reference launcher's config of ``arch``: (model, batch spec).
    Victim selection always goes through the bounded top-K route, whose
    threshold is the CUDA kernel on the card (bit-identical to the full
    argsort route)."""
    if arch == "dlrm-criteo":
        cfg = DLRMConfig(vocab_sizes=(100_000, 50_000, 20_000), embed_dim=32, batch_size=batch,
                         cache_ratio=0.02, lr=0.3, bottom_mlp=(64, 32), top_mlp=(64,),
                         arena_precision=arena_precision, use_pallas_plan=True)
        return DLRM(cfg), synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=13)
    # fm trains through the sum-square torch ops: the FM kernel has no backward
    cfg = FMConfig(vocab_sizes=(100_000,) * 6, embed_dim=10, batch_size=batch, cache_ratio=0.02,
                   arena_precision=arena_precision, use_pallas_plan=True)
    return FMModel(cfg), synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-criteo", choices=["dlrm-criteo", "fm"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--obs-dir", default=None,
                    help="stream per-step JSONL and a Chrome trace to this directory")
    ap.add_argument("--arena-precision", default="fp32", choices=["fp32", "fp16", "int8"],
                    help="device-arena codec: fp32 = raw arena; fp16/int8 tier it (the hot "
                         "head stays fp32, the cold resident tail is stored encoded)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    model, spec = build(args.arch, args.batch, args.arena_precision)
    tc = TrainerConfig(max_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=25,
                       obs_dir=args.obs_dir)
    trainer = Trainer(
        tc,
        init_fn=lambda: model.init(0, device=args.device),
        step_fn=model.train_step,
        make_batch=lambda s: synth.sparse_batch(spec, args.batch, 0, s),
        flush_fn=model.flush,
        on_straggler=lambda s, dt: print(f"[straggler] step {s}: {dt * 1e3:.0f} ms"),
        device=args.device,
    )
    state = trainer.run()
    for slab in state["emb"].slabs.values():
        slab.full.close()
    h = trainer.history
    print(f"\narch={args.arch} steps={h[-1]['step'] + 1} "
          f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")
    print(f"cache hit rate: {h[-1]['hit_rate']:.1%}")
    db = model.collection.device_bytes()
    print(f"host tier (fp32): {db['slow_tier_bytes'] / 1e6:.1f} MB")
    if args.arena_precision != "fp32":
        print(f"arena tier ({args.arena_precision}): saved "
              f"{db['arena_bytes_saved'] / 1e6:.2f} MB HBM vs fp32")
    print(f"host<->device traffic: {h[-1]['host_wire_bytes'] / 1e6:.1f} MB total")
    if args.obs_dir:
        print(f"observability: {trainer.hub.jsonl_path} | chrome trace: {trainer.trace_path}")
    return trainer


if __name__ == "__main__":
    main()
