"""Quickstart of the PyTorch port: the frequency-aware software cache in 60
lines (port of ``examples/quickstart.py``).

Builds a 100k-row embedding table whose slow tier lives in pinned host
memory, serves it through a 2%-capacity cache on the card, and shows the
three paper claims in miniature: exact lookups, high hit rate on skewed
traffic, bounded per-step transfer.  Victims are chosen by the bounded
top-K route, whose threshold is the victim-threshold CUDA kernel on the
card (bit-identical to a full argsort).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import cached_embedding as ce
from repro_torch.core import freq
from repro_torch.device import resolve_device

VOCAB, DIM, BATCH = 100_000, 64, 4096


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- static module: scan the dataset once for id frequencies (paper §4.2) --
    rng = np.random.default_rng(0)
    train_ids = (rng.zipf(1.3, size=(200, BATCH)) % VOCAB).astype(np.int64)
    counts = freq.collect_counts(iter(train_ids), VOCAB)
    skew = freq.coverage(counts, [0.01])[0.01]
    print(f"skew: top 1% of ids = {skew:.0%} of accesses")

    cfg = ce.CachedEmbeddingConfig(
        vocab_sizes=(VOCAB,), dim=DIM, ids_per_step=BATCH,
        cache_ratio=0.02,            # 2% of rows live on-device
        buffer_rows=1024,            # bounded transmitter buffer (paper §4.3)
        use_pallas_plan=True,        # victims by the threshold kernel on the card
    )
    state = ce.init_state(cfg, 0, counts=counts, device=dev)
    print(f"cache: {cfg.capacity} / {cfg.vocab} rows on the fast tier")

    # --- training-style loop through the cache -----------------------------
    def lookup(state, ids):
        state, slots = ce.prepare_ids(cfg, state, ids)   # Algorithm 1 (on device)
        return state, ce.gather_slots(state, slots)      # differentiable gather

    step_ms = []
    for step in range(30):
        ids = torch.from_numpy(train_ids[step % len(train_ids)]).to(dev, torch.int32)
        t0 = time.perf_counter()
        state, emb = lookup(state, ids)
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))

    c = state.cache
    hits, misses, evictions = int(c.hits), int(c.misses), int(c.evictions)
    hit_rate = float(c.hit_rate())
    print(f"hit rate after 30 steps: {hit_rate:.1%}")
    print(f"rows moved host->device: {misses}")
    print(f"rows evicted device->host: {evictions}")

    # --- exactness: flush and compare against the dense table ----------------
    # the port updates in place: the flushed state is the one looked up next
    state = ce.flush_state(cfg, state)
    ids = torch.from_numpy(train_ids[0]).to(dev, torch.int32)
    state, emb = lookup(state, ids)
    ref = ce.dense_reference_lookup(state, ids[:16, None])[:, 0]
    exact = bool(torch.allclose(emb[:16], ref))
    print("cache == dense table:", exact)
    state.full.close()
    return {"skew": skew, "capacity": cfg.capacity, "hits": hits, "misses": misses,
            "evictions": evictions, "hit_rate": hit_rate, "exact": exact,
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
