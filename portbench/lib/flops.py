"""The yardstick's arithmetic: useful operations of a step, bytes a kernel
must move, and the card's published peaks.

``dlrm_flops`` is the DLRM branch of ``repro_torch.launch.model_flops``,
copied so that the yardstick stays where later changes to the program
cannot move it: the useful flops of a perfect implementation, a training
step counted as three forwards (the backward as two).  For the paper's
Criteo config that is 241.68 GFLOP a training step and 80.56 GFLOP a
served batch; for Avazu 834.20 and 278.07.

``victim_key_bytes`` is what the eviction-threshold kernel
(``threshold_grid``) has to move at the least: one read of the plan's
int32 eviction key, one int32 per arena slot, and its two results (8 and
4 bytes) written once.  It is counted from the key's shape, whatever
implements the selection.
"""
from __future__ import annotations

from typing import Mapping, Optional

__all__ = ["PEAKS", "arena_slots", "dlrm_flops", "peak", "victim_key_bytes"]

# NVIDIA's data sheet for the H100 SXM (dense, at the full 700 W): fp32
# outside the tensor cores, and HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_kind: str, what: str) -> Optional[float]:
    """A published peak of the card by its name; None for a card not listed."""
    return PEAKS.get(device_kind, {}).get(what)


def dlrm_flops(cfg: Mapping, kind: str) -> float:
    """Useful flops of one batch: ``kind`` "train" (3 forwards) or "serve"."""
    f1 = len(cfg["vocab_sizes"]) + 1
    d = cfg["embed_dim"]
    bottom = tuple(cfg["bottom_mlp"])
    top = tuple(cfg["top_mlp"])
    bot = 2 * sum(a * b for a, b in zip((cfg["n_dense"],) + bottom[:-1], bottom))
    inter = 2 * f1 * f1 * d
    top_in = d + f1 * (f1 - 1) // 2
    top_fl = 2 * sum(a * b for a, b in zip((top_in,) + top, top + (1,)))
    mult = {"train": 3, "serve": 1}[kind]
    return float(mult * cfg["batch_size"] * (bot + inter + top_fl))


def arena_slots(cfg: Mapping) -> int:
    """Slots of the one shared arena: the configured share of the table,
    raised to a step's bound on distinct rows, at most the table."""
    vocab = sum(cfg["vocab_sizes"])
    unique = min(cfg["batch_size"] * len(cfg["vocab_sizes"]), vocab)
    if cfg.get("max_unique_per_step"):
        unique = min(unique, cfg["max_unique_per_step"])
    return min(max(int(cfg["cache_ratio"] * vocab), unique), vocab)


def victim_key_bytes(cfg: Mapping) -> int:
    """Bytes the threshold kernel must move for one plan."""
    return 4 * arena_slots(cfg) + 8 + 4
