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


def save(directory: str | os.PathLike, step: int, tree: Any, keep: int = 3) -> pathlib.Path:
    """Blocking atomic save of a state."""
    leaves = [(k, _host_copy(v)) for k, v in _flatten(tree)]
    return _write(pathlib.Path(directory), step, leaves, keep)


def _write(directory: pathlib.Path, step: int, leaves, keep: int) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    index = []
    for i, (key, arr) in enumerate(leaves):
        fname = f"{i:04d}.npy"
        np.save(tmp / fname, arr, allow_pickle=False)
        index.append({"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(tmp / "manifest.json", "w") as f:
        json.dump({"step": step, "leaves": index}, f)
        f.flush()
        os.fsync(f.fileno())
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


def restore(
    directory: str | os.PathLike, tree_like: Any, step: Optional[int] = None
) -> Tuple[Any, int]:
    """Load a checkpoint into ``tree_like``'s tensors, in place, after
    validating every leaf's shape and dtype; returns ``(tree_like, step)``."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_key = {e["key"]: e for e in manifest["leaves"]}
    leaves = _flatten(tree_like)
    for key, like in leaves:
        e = by_key.get(key)
        if e is None:
            raise ValueError(
                f"checkpoint {d} has no leaf {key!r}: the on-disk state was saved with a "
                f"different structure than the restore template (e.g. another host_precision "
                f"or arena_precision)"
            )
        shape, dtype = tuple(like.shape), _numpy_dtype(like)
        disk_shape, disk_dtype = tuple(e["shape"]), np.dtype(e["dtype"])
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
    surplus = sorted(set(by_key) - {k for k, _ in leaves})
    if surplus:
        raise ValueError(
            f"checkpoint {d} holds {len(surplus)} leaves the restore template does not "
            f"(e.g. {surplus[:3]}): restoring would silently drop state"
        )
    with torch.no_grad():
        for key, like in leaves:
            like.copy_(torch.from_numpy(np.load(d / by_key[key]["file"], allow_pickle=False)))
    return tree_like, manifest["step"]


class Checkpointer:
    """Async checkpoint manager with at most one save in flight."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
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
        return restore(self.directory, tree_like)
