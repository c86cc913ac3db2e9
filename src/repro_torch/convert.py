"""Carry a model state (serve or train: DLRM, FM, DIN, DIEN, MIND; the
single-table ``CachedEmbeddingState``; LM parameters and train states;
GatedGCN train states)
between the JAX package and the port.

The JAX side is given as nested dicts of numpy arrays under the JAX field
names (a dataclass becomes a dict of its fields), e.g.::

    {"params": {"bottom": {"l0": {"w": ..., "b": ...}}, "top": ...},  # DLRM
     "emb": {"slabs": {"__shared__": {
         "full": {"data": {"weight": ...}, "sideband": {}, "codec": "fp32", ...},
         "cache": {"cached_rows": {"weight": ...}, "slot_to_row": ..., ...,
                   "tracker": {"score": ..., ...}},
         "idx_map": ...}}},
     "opt": (),
     "step": ...}

where ``params`` is any nested dict of arrays: FM's ``{"bias"}``, DIN's
``{"attn": {"l0": ..}, "mlp": {"l0": ..}}``, DIEN's ``{"gru1": {"wx", "wh",
"b"}, "gru2": .., "attn_proj": {"w"}, "mlp": ..}``, MIND's ``{"s_matrix"}``;
a tiered arena's ``cached_rows`` is an ``ArenaStore`` dict
``{"head": {...}, "tail": {...}, "sideband": {...}, "raw": {...},
"codec": "int8", "out_dtype": "float32"}``, an encoded host tier's ``full``
holds the payload in its codec's dtype and a non-empty ``sideband`` (int8's
``[vocab, 2]`` (scale, zp)), and a DEVICE table's slab is ``{"weight":
[vocab, dim]}``.  A sharded slab (``model_shards``
> 0) adds ``rank_owner``, ``rank_local``, ``routed_lanes`` and ``rep`` (the
replicated arena's fields), and its ``full`` and ``cache`` leaves lead with
the shard dim.

:func:`state_from_numpy` builds the port's state from that (params,
the optimizer state — empty for SGD without momentum — the ``HostStore``
payload and sideband, each DEVICE table, every ``CacheState`` field with
its fp32 dict or ``ArenaStore`` arena, the ``FreqTracker`` and
``idx_map``); :func:`cached_embedding_state_from_numpy` builds the
single-table adapter's state (its host store, cache state, ``idx_map``
and ``offsets``); :func:`lm_params_from_numpy` builds an LM's parameter
tree (``embed`` / ``groups`` / ``rem`` / ``final_norm`` / ``head``, dense
or MoE layers, copied leaf for leaf); :func:`lm_state_from_numpy` an LM
train state (those parameters, the AdamW ``m`` / ``v`` trees, ``step`` and
the int8 ``Compressor``'s error-feedback tree ``comp``);
:func:`gatedgcn_state_from_numpy` a GatedGCN train state (its parameters
with the layers stacked ``[L, ...]``, Adam's ``m`` / ``v`` and ``step``);
:func:`to_numpy`
turns a port state back into the same layout so the two can be compared
leaf by leaf.

bf16 leaves (``ml_dtypes.bfloat16`` on the JAX side, which
``torch.from_numpy`` cannot read) cross as their 16 raw bits: into the port
through an int16 view, and out of it by :func:`to_numpy` as ``uint16``
arrays, which the caller views as ``ml_dtypes.bfloat16``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.cache import CacheState
from repro_torch.core.cached_embedding import CachedEmbeddingState
from repro_torch.core.collection import (
    CachedSlab,
    CollectionState,
    DeviceSlab,
    EmbeddingCollection,
)
from repro_torch.core.freq import FreqTracker
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.arena import ArenaStore
from repro_torch.store.host_store import HostStore

__all__ = ["adopt_codecs", "cached_embedding_state_from_numpy", "collection_state_from_numpy",
           "gatedgcn_state_from_numpy", "lm_params_from_numpy", "lm_state_from_numpy",
           "state_from_numpy", "to_numpy"]


def _t(x: Any, device: torch.device) -> torch.Tensor:
    x = np.array(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes: the same bits through int16
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _tree(d: Mapping[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: _tree(v, device) if isinstance(v, Mapping) else _t(v, device) for k, v in d.items()}


def _arena(d: Mapping[str, Any], device: torch.device):
    """An fp32 arena dict, or an ``ArenaStore`` from its field dict."""
    if "codec" not in d:
        return _tree(d, device)
    return ArenaStore(
        **{k: _tree(d[k], device) for k in ("head", "tail", "sideband", "raw")},
        codec=d["codec"], out_dtype=d["out_dtype"],
    )


def _cache_state(d: Mapping[str, Any], device: torch.device) -> CacheState:
    fields = {f.name for f in dataclasses.fields(CacheState)} - {"cached_rows", "tracker"}
    tracker = FreqTracker(**{f.name: _t(d["tracker"][f.name], device)
                             for f in dataclasses.fields(FreqTracker)})
    return CacheState(
        cached_rows=_arena(d["cached_rows"], device),
        tracker=tracker,
        **{f: _t(d[f], device) for f in fields},
    )


def _host_store(d: Mapping[str, Any], pin: bool) -> HostStore:
    """The host tier as stored: payload leaves in the codec's dtype and the
    sideband (int8's ``[vocab, 2]`` (scale, zp)), pinned on request."""
    store = HostStore(
        data={k: torch.from_numpy(np.array(v)) for k, v in d["data"].items()},
        sideband={k: torch.from_numpy(np.array(v)) for k, v in d.get("sideband", {}).items()},
        codec=d.get("codec", "fp32"), out_dtype=d.get("out_dtype", "float32"),
    )
    if pin:
        store.pin()
    return store


def _slab(s: Mapping[str, Any], dev: torch.device):
    """A ``DeviceSlab`` (a ``weight`` alone), a ``CachedSlab``, or a
    ``ShardedSlab`` (its stacked ``[S, ...]`` host table pinned whole, every
    cache leaf stacked, the routing maps, the routed-lane counts and the
    replicated arena)."""
    if "full" not in s:
        return DeviceSlab(weight=_t(s["weight"], dev))
    full = _host_store(s["full"], pin=dev.type == "cuda")
    cache = _cache_state(s["cache"], dev)
    if "rank_owner" not in s:
        return CachedSlab(full=full, cache=cache, idx_map=_t(s["idx_map"], dev))
    from repro_torch.core.sharded import RepArena, ShardedSlab

    return ShardedSlab(
        full=full, cache=cache,
        **{k: _t(s[k], dev) for k in ("idx_map", "rank_owner", "rank_local", "routed_lanes")},
        rep=RepArena(**{f.name: _t(s["rep"][f.name], dev) for f in dataclasses.fields(RepArena)}),
    )


def adopt_codecs(collection: EmbeddingCollection, state: CollectionState) -> None:
    """Record each cached slab's codecs as ``state`` holds them (the
    reference's ``init`` resolved any "auto") in ``collection``: its
    ``host_precision`` / ``arena_precision`` and the slab's arena config,
    so that every later cache config builds the state's arena container."""
    for sname, spec in collection.cached_slabs.items():
        slab = state.slabs[sname]
        arena = slab.cache.cached_rows
        arena_codec = arena.codec if isinstance(arena, ArenaStore) else "fp32"
        collection.host_precision[sname] = slab.full.codec
        collection.arena_precision[sname] = arena_codec
        collection.cached_slabs[sname] = dataclasses.replace(spec, arena=dataclasses.replace(
            spec.arena, host_precision=slab.full.codec, arena_precision=arena_codec))


def collection_state_from_numpy(
    tree: Mapping[str, Any], device: DeviceLike = None,
    collection: Optional[EmbeddingCollection] = None,
) -> CollectionState:
    """The port's ``CollectionState`` from a JAX one's numpy tree (``emb``),
    sharded or not; with ``collection``, its per-slab codecs are set to the
    state's (:func:`adopt_codecs`)."""
    dev = resolve_device(device)
    state = CollectionState(slabs={name: _slab(s, dev) for name, s in tree["slabs"].items()})
    if collection is not None:
        adopt_codecs(collection, state)
    return state


def cached_embedding_state_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None
                                      ) -> CachedEmbeddingState:
    """The port's ``CachedEmbeddingState`` from a JAX one's numpy tree
    (``full`` / ``cache`` / ``idx_map`` / ``offsets``): the host table
    (pinned on a CUDA device), the cache state and both maps on ``device``."""
    dev = resolve_device(device)
    return CachedEmbeddingState(
        full=_host_store(tree["full"], pin=dev.type == "cuda"),
        cache=_cache_state(tree["cache"], dev),
        idx_map=_t(tree["idx_map"], dev),
        offsets=_t(tree["offsets"], dev),
    )


def state_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None,
                     collection: Optional[EmbeddingCollection] = None) -> Dict[str, Any]:
    """The port's model state from the JAX state's numpy tree: any model
    whose state is ``params`` / ``opt`` / ``emb`` / ``step`` (DLRM, FM, DIN,
    DIEN, MIND).  A
    serve state has no ``opt``; SGD without momentum has an empty one.
    Pass the model's ``collection`` to carry codecs that the reference
    resolved from "auto"."""
    dev = resolve_device(device)
    state = {
        "params": _tree(tree["params"], dev),
        "emb": collection_state_from_numpy(tree["emb"], dev, collection),
        "step": _t(tree["step"], dev),
    }
    if "opt" in tree:
        opt = tree["opt"]
        state["opt"] = _tree(opt, dev) if isinstance(opt, Mapping) else ()
    return state


def lm_params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The port's LM parameters from the JAX tree of numpy leaves (fp32 or
    bf16), leaf for leaf, stacked group leaves included."""
    return _tree(tree, resolve_device(device))


def lm_state_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The port's ``LMModel`` train state from the JAX one's numpy tree:
    ``params``, ``opt`` (``{"m": ..., "v": ...}``), ``step`` and, for the
    int8 compressor, ``comp``."""
    dev = resolve_device(device)
    state = {"params": _tree(tree["params"], dev), "opt": _tree(tree["opt"], dev),
             "step": _t(tree["step"], dev)}
    if "comp" in tree:
        state["comp"] = _tree(tree["comp"], dev)
    return state


def gatedgcn_state_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None
                              ) -> Dict[str, Any]:
    """The port's ``GatedGCNModel`` train state from the JAX one's numpy tree:
    ``params`` (the layers stacked ``[L, ...]``), ``opt`` (Adam's ``{"m",
    "v"}``) and ``step``, the layout of an LM's train state without
    ``comp``."""
    return lm_state_from_numpy(tree, device)


def to_numpy(obj: Any) -> Any:
    """Port state -> nested dicts of numpy arrays under the JAX field names
    (host-store bookkeeping that the JAX side lacks is left out); a bf16
    tensor becomes the ``uint16`` array of its bits, tuples stay tuples."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            return obj.detach().cpu().view(torch.int16).numpy().view(np.uint16)
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        return tuple(to_numpy(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return {
            f.name: to_numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not f.name.startswith("_") and f.name != "pinned"
        }
    if isinstance(obj, Mapping):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj
