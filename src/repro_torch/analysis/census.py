"""Host syncs on the CUDA card, counted by the site in the port that made them.

``sync_census()`` runs its block under ``torch.cuda.set_sync_debug_mode
("warn")``: torch then warns at every operation that blocks the host on the
card (``.item()``, ``int()`` / ``float()`` / ``bool()`` of a tensor, ``if
tensor:``, ``nonzero``, a boolean-mask index, ``unique``, a copy between
pageable host memory and the card, a stream or device synchronize).  Each
warning is recorded with the stack of its thread, and its site is the
innermost frame inside ``repro_torch`` (``path:line``, the path under the
package); a sync with no such frame is the caller's.  A sync inside an
autograd backward reaches Python when the backward returns, so its site is
the ``backward()`` / ``autograd.grad`` call.  Every warning is shown, not
once per location (the default filter's rule), so the counts are exact; the
previous mode is restored when the block ends, also when it raises.

The gate (``analysis.run --device cuda``) counts each smoke case's syncs
with it, and ``chip_smoke.py`` counts one step of each full-width path.
:func:`port_stack` also gives the CPU recorder (``analysis.checks``) its
sites.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import threading
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.contracts import DOCUMENTED_SYNCS, HOST_SIDE

__all__ = ["Frame", "SyncCensus", "SyncEvent", "port_stack", "sync_census"]

_PKG = "/repro_torch/"
_SELF = "analysis/"  # the gate's own frames are never a site


@dataclasses.dataclass(frozen=True)
class Frame:
    path: str  # under repro_torch/, e.g. "core/transmitter.py"
    line: int
    qualname: str

    @property
    def site(self) -> str:
        return f"{self.path}:{self.line}"

    @property
    def function(self) -> str:
        return f"{self.path}:{self.qualname}"


def port_stack(frame=None) -> Tuple[List[Frame], List[object], Optional[str]]:
    """The ``repro_torch`` frames of the current thread, innermost first (the
    gate's own left out), the frame objects themselves, and the innermost
    frame outside torch as ``file:line`` (the caller's site when the port
    has none)."""
    f = frame or sys._getframe(1)
    out, objs, outside = [], [], None
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        i = name.rfind(_PKG)
        if i >= 0:
            path = name[i + len(_PKG):]
            if not path.startswith(_SELF):
                out.append(Frame(path, f.f_lineno, f.f_code.co_qualname))
                objs.append(f)
        elif outside is None and "/torch/" not in name and "/warnings" not in name:
            outside = f"{name.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return out, objs, outside


def documented(stack: List[Frame]) -> Optional[int]:
    """Index in ``stack`` of the innermost frame of a documented sync
    function (``contracts.DOCUMENTED_SYNCS``), or None."""
    return next((i for i, fr in enumerate(stack) if fr.function in DOCUMENTED_SYNCS), None)


def host_side(stack: List[Frame]) -> bool:
    """Whether the stack runs inside a function that works on host copies
    of the lanes (``contracts.HOST_SIDE``)."""
    return any(fr.function in HOST_SIDE for fr in stack)


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    site: str  # "path:line" in repro_torch, or "<caller> file:line"
    function: str  # "path:qualname" of the site's frame ("" for the caller's)
    documented: Optional[str]  # the DOCUMENTED_SYNCS key it falls under
    thread: str


@dataclasses.dataclass
class SyncCensus:
    events: List[SyncEvent] = dataclasses.field(default_factory=list)

    def add(self, stack: List[Frame], outside: Optional[str]) -> None:
        j = documented(stack)
        if stack:
            site, fn = stack[0].site, stack[0].function
        else:
            site, fn = f"<caller> {outside}", ""
        self.events.append(SyncEvent(site, fn, None if j is None else stack[j].function,
                                     threading.current_thread().name))

    def by_site(self) -> Dict[str, int]:
        """Sync count by site, most first."""
        return dict(collections.Counter(e.site for e in self.events).most_common())

    def port_sites(self) -> Dict[str, str]:
        """site -> the function it lies in, for the sites inside the port."""
        return {e.site: e.function for e in self.events if e.function}

    def summary(self) -> Dict[str, object]:
        threads = collections.Counter(e.thread for e in self.events)
        return {"syncs": len(self.events), "by_site": self.by_site(),
                "documented": sum(e.documented is not None for e in self.events),
                "by_thread": dict(threads)}


_SYNC_WARNING = "synchronizing CUDA operation"


@contextlib.contextmanager
def sync_census():
    """Record every host sync that the block makes on the CUDA card (see the
    module doc); yields the :class:`SyncCensus` that fills up."""
    census = SyncCensus()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                stack, _, outside = port_stack(sys._getframe(1))
                census.add(stack, outside)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield census
        finally:
            torch.cuda.set_sync_debug_mode(prev)
