"""Declarative hot-path contract registry (port of ``repro.analysis.contracts``).

An entry point of the hot path declares its invariants where it is defined::

    @contract(in_place=("full_rows", "state"), int_counters=INT_COUNTERS,
              max_sort_size=0, allowed_syncs=3)
    def apply_plan(cfg, full_rows, state, plan): ...

``@contract`` does not wrap the function, so it costs nothing at run time:
it records a :class:`Contract` in the module-level registry keyed by
``module.qualname`` and tags the callable with ``__contract__``.  The gate
(``repro_torch.analysis.run``) imports the covered modules, walks the
registry and runs each entry once at the smoke shapes of
``repro_torch.analysis.smoke``.

Where the reference's XLA entries donate their large buffers, the port
updates the arena, the host table and the tiered arena in place:
``in_place`` names the arguments whose table leaves (:data:`TABLE_LEAVES`)
must come back as the same storage.  ``allowed_syncs`` counts the
documented host syncs (:data:`DOCUMENTED_SYNCS`) one call may make at the
smoke shapes; any other sync is a finding.

This module is standard library only: ``core`` and ``kernels`` import it,
never the reverse.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = ["Contract", "Violation", "contract", "registry", "INT_COUNTERS",
           "METRICS_INT_COUNTERS", "TABLE_LEAVES", "DOCUMENTED_SYNCS", "HOST_SIDE"]

# The exact-counter contract: every telemetry and index leaf stays int32 or
# uint32, matched against output tree paths (a dataclass field renders as
# ``.name``, a dict key as ``['key']``, as ``jax.tree_util.keystr`` does).
INT_COUNTERS: Tuple[str, ...] = (
    r"\.(step|hits|misses|evictions|uniq_overflows|last_used|use_count"
    r"|slot_to_row|row_to_slot|last_touch|refresh_swaps|refresh_rows"
    r"|routed_lanes|tier_promotions|tier_demotions)$",
)

# The same contract over a ``metrics()`` dict: the per-slab counter families
# the obs hub reconstructs and the cumulative totals.
METRICS_INT_COUNTERS: Tuple[str, ...] = (
    r"\['slab_(hits|misses|refresh_swaps|refresh_rows"
    r"|tier_promotions|tier_demotions)'\]",
    r"\['host_(moved_rows|row_bytes)'\]",
    r"\['exchange_(routed_lanes|lane_bytes|id_lane_bytes|row_lane_bytes"
    r"|per_shard_lanes)'\]",
    r"\['(cache_misses|cache_evictions|uniq_overflows|refresh_swaps"
    r"|refresh_rows_moved)'\]$",
)

# The leaves an ``in_place`` argument must keep: the arena (raw or tiered),
# the host table (payload and sideband), a DEVICE table and the replicated
# arena.  Index tensors are rebuilt by every plan, as in the reference.
TABLE_LEAVES = (r"(^|\.)(data|sideband)\[|\.cached_rows|\.full\b|\.weight$|\.rep\.rows$"
                r"|^\['weight'\]$")

# Host syncs that the port makes on purpose, by the function that makes
# them (``path under repro_torch:qualname``).  One call of such a function
# counts once against a contract's ``allowed_syncs``, whatever it runs.
DOCUMENTED_SYNCS: Dict[str, str] = {
    "core/transmitter.py:_active_lanes":
        "the transmitter's lane copy: the host packs the rows the plan names (ROADMAP K5)",
    "core/transmitter.py:_staging_sync":
        "a write-back's staging block lands in pinned memory before the host scatters it",
}

# Functions that run on host copies of the lanes, after the lane copy: their
# ops never touch the card, so the CPU recorder does not read them as syncs.
HOST_SIDE: Tuple[str, ...] = (
    "core/transmitter.py:_chunk_plan",
    "core/transmitter.py:_scatter_chunked",
)


@dataclasses.dataclass(frozen=True)
class Contract:
    """The checked invariants of one hot-path entry point.

    ``max_sort_size`` is quoted at the smoke shapes of ``analysis.smoke``: it
    bounds the largest sort, top-k or unique operand the call may run
    there, so a full-capacity argsort trips it (a hand-written kernel's
    sort is inside the kernel, out of the recorder's sight).
    ``int_counters`` are regexes over output tree paths whose leaves stay
    int32 / uint32.  ``in_place`` names the arguments whose table leaves
    are updated in place.  ``allowed_syncs`` is the number of documented
    host syncs one call may make at the smoke shapes."""

    name: str  # "module.qualname" registry key
    no_host_transfer: bool = True
    no_f64: bool = True
    in_place: Tuple[str, ...] = ()
    int_counters: Tuple[str, ...] = ()
    max_sort_size: Optional[int] = None
    stable_signature: bool = True
    allowed_syncs: int = 0


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding.  ``(check, entry, device)`` is the baseline key: the
    detail may drift between torch versions without invalidating a known
    entry.  ``device`` is where the run was made (``cpu`` or ``cuda``)."""

    check: str  # "host-transfer" | "documented-sync" | "f64" | "int-counter" | ...
    entry: str  # registry key, or "path:line" for AST findings
    detail: str
    device: str = "any"

    def to_dict(self) -> Dict[str, str]:
        return {"check": self.check, "entry": self.entry, "device": self.device,
                "detail": self.detail}


_REGISTRY: Dict[str, Tuple[Callable, Contract]] = {}


def registry() -> Dict[str, Tuple[Callable, Contract]]:
    """Every registered entry point: key -> (callable, contract).  Filled as
    the covered modules are imported (``analysis.smoke`` imports them all)."""
    return dict(_REGISTRY)


def contract(
    *,
    no_host_transfer: bool = True,
    no_f64: bool = True,
    in_place: Tuple[str, ...] = (),
    int_counters: Tuple[str, ...] = (),
    max_sort_size: Optional[int] = None,
    stable_signature: bool = True,
    allowed_syncs: int = 0,
    name: Optional[str] = None,
) -> Callable:
    """Register the decorated callable's contract (see the module doc).  A
    method's key is ``module.Class.method``; ``name`` overrides it."""

    def deco(fn: Callable) -> Callable:
        qual = name or f"{fn.__module__}.{fn.__qualname__}"
        c = Contract(name=qual, no_host_transfer=no_host_transfer, no_f64=no_f64,
                     in_place=tuple(in_place), int_counters=tuple(int_counters),
                     max_sort_size=max_sort_size, stable_signature=stable_signature,
                     allowed_syncs=int(allowed_syncs))
        _REGISTRY[qual] = (fn, c)
        fn.__contract__ = c
        return fn

    return deco
