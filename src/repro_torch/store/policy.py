"""``PrecisionPolicy``: frequency-driven host-precision assignment (port of
``repro.store.policy``; numpy only).

When the cache's capacity covers most accesses, the host copy of a table is
cold storage: decoded rows are rare and int8 is safe.  When coverage is
poor the host tier is on the hot path and keeps fp16 or fp32.  Coverage
thresholds pick a codec per slab; an optional host-byte budget demotes the
best-covered (coldest host tier) slabs first, one rung of ``fp32 -> fp16 ->
int8`` at a time, until the encoded total fits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.store.codec import get_codec

__all__ = ["SlabGeometry", "PrecisionPolicy"]

_LADDER = ("fp32", "fp16", "int8")  # demotion order under a host budget


@dataclasses.dataclass(frozen=True)
class SlabGeometry:
    """The static facts the policy needs about one slab's host tier."""

    name: str
    vocab: int
    dim: int
    capacity: int  # cached rows (the fast tier)
    dtype_itemsize: int = 4


def _host_bytes(g: SlabGeometry, codec_name: str) -> int:
    dt = {4: torch.float32, 2: torch.float16}.get(g.dtype_itemsize, torch.float32)
    return g.vocab * get_codec(codec_name).row_bytes((g.dim,), dt)


def _coverage(counts: Optional[np.ndarray], capacity: int) -> Optional[float]:
    """Access share of the ``capacity`` hottest ids (the paper's Fig. 2
    statistic); None without counts or with no accesses."""
    if counts is None:
        return None
    counts = np.asarray(counts, dtype=np.float64)
    tot = counts.sum()
    if tot <= 0:
        return None
    top = np.sort(counts)[::-1][: max(int(capacity), 1)]
    return float(top.sum() / tot)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Pick a host codec per slab from cache coverage and a host-byte budget.

    Without counts the policy answers ``no_stats`` (fp16: half the bytes at
    a ~1e-3 relative error)."""

    int8_coverage: float = 0.75  # the cache absorbs >= 75 % of accesses -> int8
    fp16_coverage: float = 0.40
    no_stats: str = "fp16"
    host_budget_bytes: Optional[int] = None

    def _by_coverage(self, cov: float) -> str:
        if cov >= self.int8_coverage:
            return "int8"
        if cov >= self.fp16_coverage:
            return "fp16"
        return "fp32"

    def choose(self, geom: SlabGeometry, counts: Optional[np.ndarray] = None) -> str:
        """The host codec of one slab from its cache coverage."""
        cov = _coverage(counts, geom.capacity)
        return self.no_stats if cov is None else self._by_coverage(cov)

    def choose_arena(
        self, geom: SlabGeometry, head_capacity: int, counts: Optional[np.ndarray] = None
    ) -> str:
        """The device-tail codec of a tiered arena (``arena_precision="auto"``):
        the same thresholds, on the fp32 head's share of the traffic that
        lands in the arena at all (the ``head_capacity`` hottest ids among
        the ``capacity`` hottest)."""
        if counts is None:
            return self.no_stats
        counts = np.asarray(counts, dtype=np.float64)
        resident = np.sort(counts)[::-1][: max(int(geom.capacity), 1)]
        tot = resident.sum()
        if tot <= 0:
            return self.no_stats
        return self._by_coverage(float(resident[: max(int(head_capacity), 1)].sum() / tot))

    def assign(
        self,
        slabs: Sequence[SlabGeometry],
        counts: Optional[Mapping[str, np.ndarray]] = None,
        host_budget_bytes: Optional[int] = None,
    ) -> Dict[str, str]:
        """Codec per slab; deterministic and budget-aware.  Under a budget
        the best-covered slab demotes first (unknown coverage last, ties by
        name), one rung at a time; a budget that even all-int8 cannot meet
        raises."""
        budget = host_budget_bytes or self.host_budget_bytes
        out: Dict[str, Tuple[str, float]] = {}
        for g in slabs:
            c = counts.get(g.name) if counts else None
            cov = _coverage(c, g.capacity)
            out[g.name] = (self.choose(g, c), -1.0 if cov is None else cov)
        if budget is not None:
            geoms = {g.name: g for g in slabs}
            order = sorted(out, key=lambda n: (-out[n][1], n))
            while sum(_host_bytes(geoms[n], out[n][0]) for n in out) > budget:
                for n in order:
                    i = _LADDER.index(out[n][0])
                    if i + 1 < len(_LADDER):
                        out[n] = (_LADDER[i + 1], out[n][1])
                        break
                else:
                    need = sum(_host_bytes(geoms[n], out[n][0]) for n in out)
                    raise ValueError(
                        f"host budget {budget} B cannot hold the table set even at int8 "
                        f"(needs >= {need} B)"
                    )
        return {n: c for n, (c, _) in out.items()}
