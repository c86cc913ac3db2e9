"""Eviction policies (port of ``repro.core.policies``).

The paper's policy is FREQ_LFU: rows are statically ordered by dataset
frequency, so "least frequently used" == "largest row index".  The other
policies differ only in the per-slot eviction key (higher key = evicted
earlier).
"""
from __future__ import annotations

import enum

import torch

__all__ = ["Policy", "eviction_key"]

_BIG = (2**31 - 1) // 2


class Policy(enum.Enum):
    FREQ_LFU = "freq_lfu"  # the paper: static frequency rank (row index)
    LRU = "lru"  # least-recently-used (runtime recency)
    RUNTIME_LFU = "runtime_lfu"  # classical LFU with runtime counters
    UVM_ROW = "uvm_row"  # TorchRec-UVM stand-in: LRU keys + row-granular transfer


def eviction_key(
    policy: Policy,
    slot_to_row: torch.Tensor,
    last_used: torch.Tensor,
    use_count: torch.Tensor,
) -> torch.Tensor:
    """Per-slot int32 eviction key; a stable descending sort gives the victims."""
    if policy is Policy.FREQ_LFU:
        return slot_to_row.to(torch.int32)
    if policy in (Policy.LRU, Policy.UVM_ROW):
        return -(last_used.to(torch.int32))
    if policy is Policy.RUNTIME_LFU:
        return -(use_count.to(torch.int32))
    raise ValueError(policy)
