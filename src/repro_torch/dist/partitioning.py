"""Sharding rules and a rank's slice of a state (port of the hybrid part of
``repro.dist.partitioning``).

The reference binds logical axis names to mesh axes (:func:`hybrid_rules`)
and places each leaf by a ``PartitionSpec`` tree that mirrors the state
(``ShardedEmbeddingCollection.shard_specs``).  The port's :class:`P` is
that spec (one mesh axis name, or None, per dim), and the same tree says
which leaves a rank keeps a slice of:

* :func:`shard_state` keeps ``leaf[s : s + 1]`` of every leaf whose spec
  splits its first dim over the model axis (shard ``s`` of the stacked
  ``[S, ...]`` layout, the leading dim kept), and every other leaf whole;
* :func:`unshard_state` stacks the ranks' slices back into one state.

Both copy, so a slice never aliases the stacked table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

import torch

from repro_torch.dist.mesh import HybridMesh
from repro_torch.store.host_store import HostStore

__all__ = ["P", "hybrid_rules", "shard_state", "sharded_paths", "spec_leaves", "unshard_state"]

MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dim; ``P()``
    replicates a scalar."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def hybrid_rules(data_axis: str = "data", model_axis: str = MODEL_AXIS) -> Dict[str, Tuple[str]]:
    """The hybrid-parallel rule table: the batch over ``data`` (dense
    params replicate), the stacked slabs' leading shard dim over ``model``."""
    return {"batch": (data_axis,), "shard": (model_axis,)}


def _fields(tree: Any) -> List[str]:
    return [f.name for f in dataclasses.fields(tree) if not f.name.startswith("_")]


def spec_leaves(specs: Any, path: str = "") -> List[Tuple[str, P]]:
    """``(key, spec)`` pairs in ``train.checkpoint``'s leaf order and key
    format (dict keys sorted, dataclass fields in declaration order)."""
    if isinstance(specs, P):
        return [(path, specs)]
    if isinstance(specs, dict):
        return [kv for k in sorted(specs) for kv in spec_leaves(specs[k], f"{path}[{k!r}]")]
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return [kv for n in _fields(specs) for kv in spec_leaves(getattr(specs, n), f"{path}.{n}")]
    return []


def sharded_paths(specs: Any) -> Set[str]:
    """The checkpoint keys of the leaves whose first dim splits over the
    model axis."""
    return {k for k, p in spec_leaves(specs) if _split(p)}


def _map(fn: Callable[[torch.Tensor, Any], Any], tree: Any, specs: Any) -> Any:
    """``tree`` with each tensor leaf ``t`` replaced by ``fn(t, spec)`` (spec
    None where the spec tree has none); a host store's copy is unpinned."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs if isinstance(specs, P) else None)
    if isinstance(tree, dict):
        sub = specs if isinstance(specs, dict) else {}
        return {k: _map(fn, v, sub.get(k)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = dataclasses.replace(tree, **{
            n: _map(fn, getattr(tree, n), getattr(specs, n, None)) for n in _fields(tree)})
        if isinstance(out, HostStore):
            out.pinned, out._ring, out._owner = False, None, None
        return out
    return tree


def _split(spec: Any) -> bool:
    return spec is not None and len(spec) > 0 and spec[0] == MODEL_AXIS


def shard_state(state: Any, specs: Any, mesh: HybridMesh) -> Any:
    """Rank ``mesh``'s copy of a stacked state: shard ``mesh.model_rank`` of
    every leaf split over the model axis (leading dim kept), the rest whole."""
    s = mesh.model_rank

    def keep(t: torch.Tensor, spec) -> torch.Tensor:
        return t[s : s + 1].clone() if _split(spec) else t.clone()

    return _map(keep, state, specs)


def unshard_state(states: Sequence[Any], specs: Any) -> Any:
    """The stacked state of the ranks' states (in model-rank order): the
    split leaves concatenated, the others taken from rank 0."""
    flat = [_leaves(s) for s in states]
    it = iter(range(len(flat[0])))

    def join(t: torch.Tensor, spec) -> torch.Tensor:
        i = next(it)
        if _split(spec):
            return torch.cat([f[i] for f in flat])
        return t.clone()

    return _map(join, states[0], specs)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(lambda t, _: out.append(t), tree, None)
    return out
