"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``.  Libraries are named by a hash
of their source, so an edited kernel is rebuilt and an unchanged one is
built once.  Nothing here runs when a module is imported: the first call of
a kernel builds it, and :func:`build_all` builds several in parallel (one
``nvcc`` per source, all started together).

:class:`Kernel` is the lean launch path of a wrapper: the C entry bound once
per process, its arguments packed into one struct, the current stream's
handle taken on each launch, and the device switched only for a tensor off
the current card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "Kernel", "build_all", "entry", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[Path, ctypes.CDLL] = {}  # by source path: loaded once per process
_entries: Dict[Tuple[Path, str], ctypes._CFuncPtr] = {}  # bound C entry points


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build_all(sources: Iterable[Path]) -> Dict[Path, str]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    at once.  Returns each built source's ptxas report (registers, spills);
    raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for src in sources:
        src = Path(src)
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports: Dict[Path, str] = {}
    failed = []
    for src, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[src] = log
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use.  Later calls
    return the same library without reading or hashing the source, so an
    edit of the checkout never starts ``nvcc`` in a running process."""
    source = Path(source).resolve()
    if source not in _loaded:
        build_all([source])
        _loaded[source] = ctypes.CDLL(str(_target(source)))
    return _loaded[source]


def entry(source: Path, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``source``'s library with its argument
    types set and an ``int`` (CUDA error) result, bound on first use.  Runs
    on every launch, so it touches no file once bound (callers pass the
    same ``source`` object each time)."""
    key = (source, name)
    if key not in _entries:
        fn = getattr(load(source), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return _entries[key]


class Kernel:
    """One C entry point of a CUDA source, launched on the current stream of
    a card: the wrappers' lean launch path.

    The entry takes a pointer to its arguments, one C struct of ``fields``
    8-byte fields (pointers and integers, in the struct's order; 0 for a
    NULL pointer), and the stream, and returns the CUDA error of its
    launch.  Packing the fields in one ``struct.pack`` call costs the host
    a fraction of what ctypes takes to convert as many arguments one by
    one.  The entry is bound on the first launch (which builds the
    library); a launch then runs the pack, the ctypes call, the stream
    lookup and, only for a card other than the current one, a device
    switch.  The stream comes from ``torch._C._cuda_getCurrentRawStream``
    (the current stream's handle, as Triton launches on it): building
    ``torch.cuda.current_stream()``'s Python object cost the host more
    than the launch itself."""

    def __init__(self, source: Path, name: str, fields: int):
        self.source, self.name = source, name
        self._pack = struct.Struct(f"{int(fields)}q").pack
        self._fn = None

    def __call__(self, device: int, *fields: int) -> None:
        """Launch on card ``device`` (its index); raises on a CUDA error."""
        fn = self._fn
        if fn is None:
            fn = self._fn = entry(self.source, self.name, [ctypes.c_char_p, ctypes.c_void_p])
        if device == torch.cuda.current_device():
            err = fn(self._pack(*fields), torch._C._cuda_getCurrentRawStream(device))
        else:
            with torch.cuda.device(device):
                err = fn(self._pack(*fields), torch._C._cuda_getCurrentRawStream(device))
        if err:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
