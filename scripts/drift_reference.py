"""The reference numbers of the drift run that ``chip_smoke.py``'s phase 5h
holds the port to: ``benchmarks/bench_drift.py``'s stream, table and
refresh cadence through the JAX package, with and without the refresh,
each from the same init; per mode the steady hit rates before and after
the drift (the benchmark's windows), the trough after the first drift,
the swaps, the rows moved and the total hit and miss counts.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/drift_reference.py [--smoke]

Prints one JSON object.  Hit and miss counts depend only on the ids and
the planning decisions, which the port makes bitwise as the reference does
on the CPU, so they do not depend on the device.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import collection as col
from repro.core.refresh import RefreshConfig
from repro.data import synth

SHAPES = {  # bench_drift's: vocab, dim, batch, drift_every, cache ratio, refresh every, max_swaps
    "smoke": (20_000, 8, 512, 40, 0.04, 2, 512),
    "full": (400_000, 32, 8192, 150, 0.02, 5, 4096),
}


def drift_summary(hits, misses, drift_every):
    """bench_drift's windows over the per-step hit rates."""
    rates, ph, pm = [], 0, 0
    for h, m in zip(hits, misses):
        dh, dm = h - ph, m - pm
        ph, pm = h, m
        rates.append(dh / (dh + dm) if dh + dm else None)

    def steady(lo, hi):
        window = [r for r in rates[lo:hi] if r is not None]
        return float(np.mean(window)) if window else 0.0

    steps = len(rates)
    return {"hit_pre": steady(drift_every - drift_every // 3, drift_every),
            "hit_post": steady(steps - drift_every // 2, steps),
            "trough": min(r for r in rates[drift_every:] if r is not None),
            "hits": hits[-1], "misses": misses[-1]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    vocab, dim, batch, drift_every, ratio, every, max_swaps = SHAPES[
        "smoke" if args.smoke else "full"]
    spec = synth.DriftingZipfSpec(base=synth.ZipfSparseSpec(vocab_sizes=(vocab,)),
                                  drift_every=drift_every)
    table = col.TableConfig("items", vocab, dim, ids_per_step=batch, cache_ratio=ratio,
                            freq_half_life=max(drift_every // 8, 1))
    counts = np.zeros((vocab,), np.int64)
    for s in range(drift_every):
        np.add.at(counts, synth.drifting_sparse_batch(spec, batch, 0, s)["sparse"].reshape(-1), 1)
    out = {}
    for mode in ("no_refresh", "refresh"):
        coll = col.EmbeddingCollection.create([table], cache_ratio=ratio)
        state = coll.init(jax.random.PRNGKey(0), counts={"items": counts})
        prep = jax.jit(lambda st, fb: coll.prepare(st, fb))
        hits, misses = [], []
        for s in range(3 * drift_every):
            ids = synth.drifting_sparse_batch(spec, batch, 0, s)["sparse"]
            state, _ = prep(state, col.FeatureBatch.from_onehot(("items",), jnp.asarray(ids)))
            cache = state.slabs[col.SHARED_ARENA].cache
            hits.append(int(cache.hits))
            misses.append(int(cache.misses))
            if mode == "refresh" and (s + 1) % every == 0:
                state, _ = coll.refresh(state, RefreshConfig(max_swaps=max_swaps, min_gain=0.25))
        m = coll.metrics(state)
        out[mode] = {**drift_summary(hits, misses, drift_every),
                     "swaps": int(m["refresh_swaps"]), "rows_moved": int(m["refresh_rows_moved"])}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
