"""Run-time contract checks: each smoke case runs once under a recorder.

The counterpart of the reference's ``jaxpr_checks`` and ``hlo_checks``.  The
port runs eagerly, so the checks watch a real call: a
``TorchDispatchMode`` records the aten operations the entry runs, and on
the card ``census.sync_census`` records the host syncs.

* **host-transfer** on the CPU, from the operations: ``_local_scalar_dense``
  (``.item()``, ``int()`` / ``float()`` / ``bool()`` of a tensor, ``if
  tensor:``), ``nonzero``, a boolean-mask ``index`` / ``index_put``,
  ``masked_select``, ``unique``, ``repeat_interleave`` by a tensor, and
  ``lift_fresh`` (a tensor built from Python data, a blocking copy when
  its device is the card).  ``.tolist()``, ``.cpu()`` and ``.numpy()`` of a
  CPU tensor reach no operation; the AST pass (``ast_lint``) covers them.
  Operations inside a function that works on host copies of the lanes
  (``contracts.HOST_SIDE``) are not syncs on the card and are skipped.
* **host-transfer** on the card: the census of the call's syncs.
  Either way a sync under a documented function
  (``contracts.DOCUMENTED_SYNCS``) counts once per call of that function
  against ``allowed_syncs`` and is reported as **documented-sync** (its
  baseline entry names the ROADMAP item that would remove it); more than
  allowed, or any other sync, is a host-transfer finding.
* **f64**: no float64 / complex128 tensor made by an operation of the entry.
* **int-counter**: output leaves whose tree path matches the contract's
  ``int_counters`` stay int32 / uint32.
* **sort-bound**: the largest ``sort`` / ``topk`` / ``kthvalue`` /
  ``unique`` operand along its dimension is at most ``max_sort_size``.  A
  hand-written kernel's work is invisible to the recorder: on the card the
  sort is inside the kernel.
* **stable-signature**: every tensor leaf of the arguments at step t and
  at t + 1 (after the case's ``advance``) has the same shape, dtype and
  device, which a CUDA-graph replay needs.  The port compiles nothing, so
  there is no recompile counter to read.
* **in-place**: the table leaves (``contracts.TABLE_LEAVES``) of the
  arguments that ``in_place`` names come back with the same ``data_ptr()``,
  shape and dtype.
"""
from __future__ import annotations

import collections
import dataclasses
import re
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import census as census_lib
from repro_torch.analysis.contracts import TABLE_LEAVES, Contract, Violation
from repro_torch.store.host_store import HostStore

__all__ = ["Recorder", "check_case", "tree_leaves", "signature"]

_SYNC_OPS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
             "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
             "aten::unique_dim_consecutive", "aten::lift_fresh"}
_INDEX_OPS = {"aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"}
_SORT_OPS = {"aten::sort", "aten::topk", "aten::kthvalue", "aten::_unique2", "aten::unique_dim",
             "aten::unique_consecutive", "aten::unique_dim_consecutive"}
_F64 = (torch.float64, torch.complex128)
_INT_OK = (torch.int32, torch.uint32)


def _arg(func, args, kwargs, name, default=None):
    """Argument ``name`` of an aten call, positional or keyword."""
    if name in kwargs:
        return kwargs[name]
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else default
    return default


def _bool_index(indices) -> bool:
    return any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
               for t in (indices or ()))


def _sort_size(op: str, func, args, kwargs) -> int:
    x = args[0]
    if op == "aten::_unique2" or (op == "aten::unique_consecutive"
                                  and _arg(func, args, kwargs, "dim") is None):
        return x.numel()
    dim = _arg(func, args, kwargs, "dim", -1)
    return x.shape[dim] if x.dim() else 1


def _outputs(out) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _outputs(o)


@dataclasses.dataclass
class _Seen:
    syncs: Dict[str, int] = dataclasses.field(default_factory=collections.Counter)  # by site
    documented: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)  # function -> calls
    f64: Dict[str, int] = dataclasses.field(default_factory=collections.Counter)
    sorts: List[Tuple[int, str]] = dataclasses.field(default_factory=list)  # (size, site)


class Recorder(TorchDispatchMode):
    """Records the operations of a block that the checks read: host
    transfers (kept only when ``host_transfer``, i.e. on the CPU), float64
    results and sorts, each with its site in the port."""

    def __init__(self, host_transfer: bool = True):
        super().__init__()
        self.host_transfer = host_transfer
        self.seen = _Seen()
        self._calls: Dict[int, object] = {}  # the documented calls' frames, kept alive

    def _site(self):
        stack, objs, outside = census_lib.port_stack()
        return stack, objs, (stack[0].site if stack else f"<caller> {outside}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = func._schema.name
        sync = self.host_transfer and (
            op in _SYNC_OPS or (op in _INDEX_OPS
                                and _bool_index(_arg(func, args, kwargs, "indices")))
            or (op == "aten::repeat_interleave" and isinstance(args[0], torch.Tensor)
                and _arg(func, args, kwargs, "output_size") is None))
        f64 = any(t.dtype in _F64 for t in _outputs(out))
        if sync or f64 or op in _SORT_OPS:
            stack, objs, site = self._site()
            if sync and not census_lib.host_side(stack):
                j = census_lib.documented(stack)
                if j is None:
                    self.seen.syncs[site] += 1
                elif id(objs[j]) not in self._calls:  # once per call
                    self._calls[id(objs[j])] = objs[j]
                    self.seen.documented[stack[j].function] += 1
            if f64:
                self.seen.f64[f"{op} at {site}"] += 1
            if op in _SORT_OPS:
                self.seen.sorts.append((_sort_size(op, func, args, kwargs), f"{op} at {site}"))
        return out


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------


def _walk(obj: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, node) of every node under dicts, tuples, lists and dataclass
    fields (private fields left out), with ``keystr`` paths."""
    yield path, obj
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(v, f"{path}[{k!r}]")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if not f.name.startswith("_"):
                yield from _walk(getattr(obj, f.name), f"{path}.{f.name}")


def tree_leaves(obj: Any) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf of ``obj``."""
    return ((p, t) for p, t in _walk(obj) if isinstance(t, torch.Tensor))


def close_hosts(obj: Any) -> None:
    """Unpin every host table under ``obj``: a smoke case's pinned pages must
    be free before the next case pins its own."""
    for _, node in _walk(obj):
        if isinstance(node, HostStore):
            node.close()


def signature(args: Tuple[Any, ...]) -> Dict[str, Tuple]:
    """path -> (shape, dtype, device) of every tensor leaf of ``args``."""
    return {p: (tuple(t.shape), t.dtype, t.device.type) for p, t in tree_leaves(tuple(args))}


def _table_leaves(arg: Any) -> Dict[str, Tuple]:
    pat = re.compile(TABLE_LEAVES)
    return {p: (t.data_ptr(), tuple(t.shape), t.dtype)
            for p, t in tree_leaves(arg) if pat.search(p)}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _v(check: str, c: Contract, detail: str, device: str) -> Violation:
    return Violation(check, c.name, detail, device)


def _host_transfer(c: Contract, seen: _Seen, device: str) -> List[Violation]:
    out = []
    n_doc = sum(seen.documented.values())
    doc = dict(seen.documented)
    if n_doc:
        out.append(_v("documented-sync", c, f"{n_doc} documented syncs (allowed "
                      f"{c.allowed_syncs}): {doc}", device))
    if not c.no_host_transfer:
        return out
    if n_doc > c.allowed_syncs:
        out.append(_v("host-transfer", c, f"{n_doc} documented syncs, the contract allows "
                      f"{c.allowed_syncs}: {doc}", device))
    if seen.syncs:
        out.append(_v("host-transfer", c, f"{sum(seen.syncs.values())} host syncs by site: "
                      f"{dict(seen.syncs)}", device))
    return out


def _int_counters(c: Contract, result: Any, device: str) -> List[Violation]:
    pats = [re.compile(p) for p in c.int_counters]
    bad = {p: str(t.dtype) for p, t in tree_leaves(result)
           if any(r.search(p) for r in pats) and t.dtype not in _INT_OK}
    return [_v("int-counter", c, f"counter leaves not int32/uint32: {bad}", device)] if bad else []


def _sort_bound(c: Contract, seen: _Seen, device: str) -> List[Violation]:
    if c.max_sort_size is None or not seen.sorts:
        return []
    size, where = max(seen.sorts)
    if size <= c.max_sort_size:
        return []
    return [_v("sort-bound", c, f"largest sort operand {size} > max_sort_size "
               f"{c.max_sort_size} ({where})", device)]


def _stable_signature(c: Contract, case, device: str) -> List[Violation]:
    if not c.stable_signature or case.advance is None:
        return []
    args = case.make_args()
    before = signature(args)
    after = signature(case.advance(*args))
    close_hosts(args)
    diff = {p: (before.get(p), after.get(p)) for p in set(before) | set(after)
            if before.get(p) != after.get(p)}
    if not diff:
        return []
    shown = dict(sorted(diff.items())[:4])
    return [_v("stable-signature", c, f"{len(diff)} argument leaves change from step t to "
               f"t + 1 (shape, dtype, device): {shown}", device)]


def _in_place(c: Contract, case, before: Dict[int, Dict], result: Any,
              device: str) -> List[Violation]:
    if len(case.in_place) != len(c.in_place):
        return [_v("in-place", c, f"the smoke case names {len(case.in_place)} in-place "
                   f"arguments, the contract {len(c.in_place)} {c.in_place}", device)]
    if not any(before.values()):
        return [_v("in-place", c, f"no table leaf under the in-place arguments {c.in_place}",
                   device)]
    kept = {(t.data_ptr(), tuple(t.shape), t.dtype) for _, t in tree_leaves(result)}
    lost = [f"{c.in_place[n]}{p}" for n, i in enumerate(case.in_place)
            for p, v in before[i].items() if v not in kept]
    return [_v("in-place", c, f"table leaves not updated in place: {sorted(lost)[:6]}",
               device)] if lost else []


def check_case(case, c: Contract, device: str, run: Optional[Callable] = None
               ) -> Tuple[List[Violation], Dict[str, Any]]:
    """Every check of contract ``c`` on one smoke case.  ``run(fn)`` wraps
    the measured call (the gate passes the kernel-launch counter).  Returns
    the findings and what was seen (sync counts, sorts, f64 sites)."""
    args = case.make_args()
    before = {i: _table_leaves(args[i]) for i in case.in_place}
    rec = Recorder(host_transfer=device == "cpu")
    call = (lambda: case.fn(*args)) if run is None else (lambda: run(lambda: case.fn(*args)))
    if device == "cuda":
        with census_lib.sync_census() as cen, rec:
            result = call()
        torch.cuda.synchronize()  # a fault of the call surfaces here, outside the census
        for e in cen.events:  # each warning is one sync
            if e.documented is not None:
                rec.seen.documented[e.documented] += 1
            else:
                rec.seen.syncs[e.site] += 1
    else:
        with rec:
            result = call()
    out = _host_transfer(c, rec.seen, device)
    if c.no_f64 and rec.seen.f64:
        out.append(_v("f64", c, f"float64 results by op and site: {dict(rec.seen.f64)}",
                      device))
    out += _int_counters(c, result, device)
    out += _sort_bound(c, rec.seen, device)
    out += _in_place(c, case, before, result, device) if c.in_place else []
    close_hosts((args, result))
    out += _stable_signature(c, case, device)
    seen = {"syncs": dict(rec.seen.syncs),
            "documented": dict(rec.seen.documented),
            "largest_sort": max(rec.seen.sorts)[0] if rec.seen.sorts else 0}
    return out, seen

