"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``.  Libraries are named by a hash
of their source, so an edited kernel is rebuilt and an unchanged one is
built once.  Nothing here runs when a module is imported: the first call of
a kernel builds it, and :func:`build_all` builds several in parallel (one
``nvcc`` per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "entry", "load"]

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
