"""Atomic, async checkpoints of a training state (port of
``repro.train.checkpoint``), in numpy files.

Layout::

    <dir>/step_000000123/
        manifest.json       # step, leaf index (key -> file, shape, dtype)
        0000.npy ...
    <dir>/LATEST            # names the newest complete checkpoint

A state is nested dicts, tuples and dataclasses (``CollectionState``,
``CachedSlab``, ``HostStore``, ``CacheState``, ``ArenaStore``, ...) with
tensor leaves.  Leaves are keyed by their path (``['emb'].slabs['__shared__']
.cache.cached_rows.head['weight']``); non-tensor fields (a codec name, a
flag) and private fields are structure, not leaves.

* atomicity — writes land in ``step_N.tmp`` and are renamed after the
  manifest is fsynced; a crash mid-save leaves the previous checkpoint.
* validation — ``restore`` checks every leaf's shape and dtype against the
  template and refuses missing or surplus leaves: a tiered-arena checkpoint
  restored into an fp32 template (or the reverse), or an encoded host tier
  (int8 payload and sideband, fp16 payload) into a template of another
  host codec, fails loudly.
* in place — ``restore`` copies the loaded values into the template's own
  tensors (so a pinned host table stays pinned and the arena stays on the
  card) and returns the template.
* async — ``Checkpointer.save_async`` copies the leaves to host memory
  synchronously (the arena and the host table change in place afterwards)
  and writes them on a background thread.
* ranks — under a hybrid mesh (``mesh=``, with the state's partition
  ``specs``) each rank writes its shard's leaves (those whose spec splits
  over the model axis, ``[1, ...]`` on the rank) under
  ``step_N/shard_<s>/``, and rank 0 writes the replicated leaves and the
  manifest, which lists the split keys and the shard count; the ranks
  meet at a barrier before rank 0 publishes and again after, so the save
  is a collective (``save_async`` saves in place under a mesh).  ``restore``
  reads either layout into either template: a rank's own shard, or every
  shard concatenated into one process's stacked ``[S, ...]`` leaves, or a
  stacked checkpoint's leaf sliced to the rank's ``[1, ...]`` (the
  reference's elastic restore onto another topology; the file is mapped and
  a rank reads only its shard's rows).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.partitioning import sharded_paths
from repro_torch.dist.mesh import HybridMesh

__all__ = ["save", "restore", "latest_step", "Checkpointer"]


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(key, tensor) leaves in a fixed order: dict keys sorted, dataclass
    fields in declaration order, tuple items by index."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree) if not f.name.startswith("_")
                for kv in _flatten(getattr(tree, f.name), f"{path}.{f.name}")]
    return []  # static structure (codec names, flags, None)


def _host_copy(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", copy=True).numpy()


def save(directory: str | os.PathLike, step: int, tree: Any, keep: int = 3,
         mesh: Optional[HybridMesh] = None, specs: Any = None) -> pathlib.Path:
    """Blocking atomic save of a state (a collective of the mesh's ranks
    when ``mesh`` is given)."""
    leaves = [(k, _host_copy(v)) for k, v in _flatten(tree)]
    if mesh is not None:
        return _write_ranked(pathlib.Path(directory), step, leaves, keep, mesh,
                             sharded_paths(specs))
    return _write(pathlib.Path(directory), step, leaves, keep)


def _write_leaves(d: pathlib.Path, step: int, leaves, extra: Optional[dict] = None) -> None:
    """The leaves as ``.npy`` files under ``d`` and their fsynced manifest."""
    index = []
    for i, (key, arr) in enumerate(leaves):
        fname = f"{i:04d}.npy"
        np.save(d / fname, arr, allow_pickle=False)
        index.append({"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(d / "manifest.json", "w") as f:
        json.dump({"step": step, "leaves": index, **(extra or {})}, f)
        f.flush()
        os.fsync(f.fileno())


def _write(directory: pathlib.Path, step: int, leaves, keep: int) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    _write_leaves(tmp, step, leaves)
    return _publish(directory, final, tmp, keep)


def _write_ranked(directory: pathlib.Path, step: int, leaves, keep: int, mesh: HybridMesh,
                  sharded: set) -> pathlib.Path:
    """A rank's part of a split save: its shard's leaves under
    ``shard_<s>/``; rank 0 also the replicated leaves, the manifest and the
    publish, between two barriers."""
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    mine = tmp / f"shard_{mesh.model_rank:04d}"
    if mine.exists():
        shutil.rmtree(mine)
    mine.mkdir(parents=True)
    _write_leaves(mine, step, [(k, a) for k, a in leaves if k in sharded])
    _barrier(mesh)  # every shard is on disk
    if mesh.model_rank == 0:
        keys = sorted(k for k, _ in leaves if k in sharded)
        _write_leaves(tmp, step, [(k, a) for k, a in leaves if k not in sharded],
                      {"shards": mesh.model, "sharded": keys})
        _publish(directory, final, tmp, keep)
    _barrier(mesh)  # published before any rank reads it
    return final


def _barrier(mesh: HybridMesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def _publish(directory: pathlib.Path, final: pathlib.Path, tmp: pathlib.Path,
             keep: int) -> pathlib.Path:
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    (directory / "LATEST.tmp").write_text(final.name)
    (directory / "LATEST.tmp").rename(directory / "LATEST")
    ckpts = sorted(d for d in directory.glob("step_*")
                   if d.is_dir() and not d.name.endswith(".tmp"))
    for d in ckpts[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = pathlib.Path(directory)
    marker = directory / "LATEST"
    if marker.exists():
        name = marker.read_text().strip()
        if (directory / name / "manifest.json").exists():
            return int(name.split("_")[1])
    best = None  # LATEST may be missing after a crash: scan
    for d in sorted(directory.glob("step_*")):
        if d.is_dir() and (d / "manifest.json").exists():
            best = int(d.name.split("_")[1])
    return best


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


class _Disk:
    """A checkpoint's leaves by key, in either layout: one manifest, or a
    split save's replicated manifest and one per shard."""

    def __init__(self, d: pathlib.Path):
        self.d = d
        self.manifest = json.loads((d / "manifest.json").read_text())
        self.whole = {e["key"]: e for e in self.manifest["leaves"]}
        self.shards = int(self.manifest.get("shards", 0))
        self.parts = [
            {e["key"]: e for e in json.loads(
                (d / f"shard_{i:04d}" / "manifest.json").read_text())["leaves"]}
            for i in range(self.shards)]

    def keys(self) -> set:
        return set(self.whole) | (set(self.parts[0]) if self.parts else set())

    def shape_dtype(self, key: str):
        """(shape, dtype) of the whole leaf, or None when it is not on disk."""
        if key in self.whole:
            e = self.whole[key]
            return tuple(e["shape"]), np.dtype(e["dtype"])
        if self.parts and key in self.parts[0]:
            e = self.parts[0][key]
            return (e["shape"][0] * self.shards,) + tuple(e["shape"][1:]), np.dtype(e["dtype"])
        return None

    def load(self, key: str, shard: Optional[int] = None) -> np.ndarray:
        """The whole leaf, or only its rows of shard ``shard`` (``[1, ...]``):
        a whole leaf is mapped, and only that shard's rows are read."""
        if key in self.whole:
            f = self.d / self.whole[key]["file"]
            if shard is None:
                return np.load(f, allow_pickle=False)
            return np.array(np.load(f, mmap_mode="r", allow_pickle=False)[shard : shard + 1])
        if shard is not None:
            return np.load(self.d / f"shard_{shard:04d}" / self.parts[shard][key]["file"],
                           allow_pickle=False)
        return np.concatenate([np.load(self.d / f"shard_{i:04d}" / p[key]["file"],
                                       allow_pickle=False) for i, p in enumerate(self.parts)])


def restore(
    directory: str | os.PathLike, tree_like: Any, step: Optional[int] = None,
    mesh: Optional[HybridMesh] = None, specs: Any = None,
) -> Tuple[Any, int]:
    """Load a checkpoint into ``tree_like``'s tensors, in place, after
    validating every leaf's shape and dtype; returns ``(tree_like, step)``.
    Under a ``mesh`` (with the state's ``specs``) the template is a rank's:
    its split leaves take their shard's rows."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:09d}"
    disk = _Disk(d)
    split = sharded_paths(specs) if mesh is not None else set()
    shard = mesh.model_rank if mesh is not None else None
    leaves = _flatten(tree_like)
    for key, like in leaves:
        e = disk.shape_dtype(key)
        if e is None:
            raise ValueError(
                f"checkpoint {d} has no leaf {key!r}: the on-disk state was saved with a "
                f"different structure than the restore template (e.g. another host_precision "
                f"or arena_precision)"
            )
        shape, dtype = tuple(like.shape), _numpy_dtype(like)
        disk_shape, disk_dtype = e
        if key in split:  # the rank's [1, ...] rows of an [S, ...] leaf
            if disk_shape[:1] != (mesh.model,):
                raise ValueError(f"checkpoint leaf {key!r} holds {disk_shape[:1]} shards, the "
                                 f"mesh {mesh.model}")
            disk_shape = (1,) + disk_shape[1:]
        if disk_shape != shape or disk_dtype != dtype:
            hint = ""
            if ".cached_rows." in key and any(t in key for t in (".head", ".tail", ".sideband")):
                hint = ("  The leaf belongs to a tiered device arena: the checkpoint was saved "
                        "under a different arena_precision (or arena_head_ratio) than the "
                        "restore template expects.")
            elif ".full." in key:
                hint = ("  The leaf belongs to a host store: the checkpoint was saved under a "
                        "different host-precision codec than the restore template expects; "
                        "restore into a template built with the saved host_precision.")
            raise ValueError(
                f"checkpoint leaf {key!r} mismatch: on disk {disk_shape}/{disk_dtype}, "
                f"template expects {shape}/{dtype}." + hint
            )
    surplus = sorted(disk.keys() - {k for k, _ in leaves})
    if surplus:
        raise ValueError(
            f"checkpoint {d} holds {len(surplus)} leaves the restore template does not "
            f"(e.g. {surplus[:3]}): restoring would silently drop state"
        )
    with torch.no_grad():
        for key, like in leaves:
            like.copy_(torch.from_numpy(disk.load(key, shard if key in split else None)))
    return tree_like, disk.manifest["step"]


class Checkpointer:
    """Async checkpoint manager with at most one save in flight.  Under a
    mesh (a save is a collective of the ranks) it saves in place."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 mesh: Optional[HybridMesh] = None, specs: Any = None):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.mesh = mesh
        self.specs = specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        if self.mesh is not None:
            save(self.directory, step, tree, self.keep, self.mesh, self.specs)
            return
        leaves = [(k, _host_copy(v)) for k, v in _flatten(tree)]

        def work():
            try:
                _write(self.directory, step, leaves, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore_latest(self, tree_like: Any):
        return restore(self.directory, tree_like, mesh=self.mesh, specs=self.specs)
