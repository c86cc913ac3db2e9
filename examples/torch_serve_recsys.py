"""Serving example of the PyTorch port: batched online inference
(serve_p99 style) and bulk retrieval scoring with a MIND multi-interest
model (port of ``examples/serve_recsys.py``).

The cache runs read-only (writeback=False): misses fault rows in from the
pinned host tier, so the engine warms itself from live traffic; watch the
p99 drop.  Victims are chosen by the victim-threshold CUDA kernel on the
card (bit-identical to a full argsort).

Run:  PYTHONPATH=src python examples/torch_serve_recsys.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data import synth
from repro_torch.device import resolve_device
from repro_torch.models.recsys_models import MINDConfig, MINDModel
from repro_torch.obs.hub import fetch_ints
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = MINDConfig(n_items=200_000, n_users=20_000, embed_dim=32, seq_len=50,
                     batch_size=256, cache_ratio=0.05, use_pallas_plan=True)
    model = MINDModel(cfg)
    state = model.init(0, device=dev)

    pad = {
        "hist_items": np.zeros((cfg.seq_len,), np.int32),
        "hist_len": np.zeros((), np.int32),
        "user": np.zeros((), np.int32),
        "target_item": np.zeros((), np.int32),
        "label": np.zeros((), np.float32),
    }
    engine = ServeEngine(model.serve_step, state, batch_size=256, pad_example=pad, device=dev)

    batch_ms = []
    for i in range(8):
        b = synth.recsys_batch(cfg.n_items, cfg.n_users, cfg.seq_len, 200, seed=1, step=i)
        t0 = time.perf_counter()
        scores = engine.score(b)  # the scores are fetched: the batch is done
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    summary = engine.stats.summary()
    print("online scoring:", summary)
    m = model.collection.metrics(engine.state["emb"])
    hit = float(m["hit_rate"])
    print(f"cache hit rate after traffic: {hit:.1%}")
    ints = fetch_ints({k: m[k] for k in ("slab_hits", "cache_misses", "cache_evictions")})

    # ---- retrieval: one user against 100k candidates (batched dot, no loop) ---
    b = synth.recsys_batch(cfg.n_items, cfg.n_users, cfg.seq_len, 1, seed=2, step=0)
    ret = {k: torch.from_numpy(b[k]).to(dev) for k in ("hist_items", "hist_len", "user")}
    ret["candidates"] = torch.arange(100_000, dtype=torch.int32, device=dev)
    scores, _ = model.retrieval_score(engine.state, ret)
    scores = scores.cpu().numpy()
    top = np.argsort(scores)[::-1][:5]
    print("retrieval top-5 candidates:", top.tolist())
    engine.close()
    for slab in engine.state["emb"].slabs.values():
        slab.full.close()
    return {"summary": summary, "batch_ms": batch_ms, "hit_rate": hit,
            "hits": sum(ints["slab_hits"].values()), "misses": ints["cache_misses"],
            "evictions": ints["cache_evictions"], "retrieval_scores": scores,
            "top5": top.tolist()}


if __name__ == "__main__":
    main()
