"""Victim threshold for bounded top-K eviction: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces ``repro/kernels/cache_ops/kernel.py::victim_threshold_pallas``.
Both versions take the int32 eviction keys, work in the order-preserving
uint32 domain (``u = key ^ 0x80000000``), and return ``(t, n_gt)``: ``t``
the kv-th largest ``u`` (an int64 0-dim tensor holding the uint32 value)
and ``n_gt`` the count of keys strictly above it (int32 0-dim).  Both stay
on the tensor's device; nothing syncs the host.

* :func:`victim_threshold_plain` — int64 keys offset by 2**31 and the same
  33 rounds (32 bit rounds of "count keys >= candidate", then one count of
  keys > t) as torch ops.
* :func:`victim_threshold` — on a CUDA tensor it launches the hand-written
  kernel in ``csrc/victim_threshold.cu`` (bound by bytes: 33 reads of the
  keys; see the note there) or raises; on a CPU tensor it takes the plain
  version.  ``victim_threshold.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

__all__ = ["SOURCE", "victim_threshold", "victim_threshold_plain"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "victim_threshold.cu"
_SIGN = 2**31


def victim_threshold_plain(key: torch.Tensor, kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, n_gt) by 33 masked counts over int64 keys offset by 2**31."""
    kv = int(kv)
    u = key.to(torch.int64) + _SIGN
    t = torch.zeros((), dtype=torch.int64, device=key.device)
    for b in range(32):
        cand = t | (1 << (31 - b))
        cnt = (u >= cand).sum()
        t = torch.where(cnt >= kv, cand, t)
    return t, (u > t).sum().to(torch.int32)


_entry = None  # the bound C entry point, resolved on the first launch


def _launcher():
    global _entry
    if _entry is None:
        from repro_torch.kernels import build

        fn = build.load(SOURCE).victim_threshold
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def victim_threshold(key: torch.Tensor, kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, n_gt) of the int32 keys: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    kv = int(kv)
    if key.device.type == "cpu":
        return victim_threshold_plain(key, kv)
    if not key.is_cuda:
        raise ValueError(f"victim_threshold: unsupported device {key.device}")
    if key.dtype != torch.int32 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError(
            f"victim_threshold takes contiguous int32 [n] keys, got {key.dtype} {tuple(key.shape)}"
        )
    n = key.shape[0]
    if not 1 <= kv <= n:
        raise ValueError(f"victim_threshold: kv={kv} outside [1, {n}]")
    t = torch.empty((1,), dtype=torch.int64, device=key.device)
    n_gt = torch.empty((1,), dtype=torch.int32, device=key.device)
    scratch = torch.empty((4,), dtype=torch.int32, device=key.device)
    launch = _launcher()
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = launch(
            key.data_ptr(), n, kv, t.data_ptr(), n_gt.data_ptr(), scratch.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"victim_threshold kernel launch failed: CUDA error {err}")
    victim_threshold.launches += 1
    return t[0], n_gt[0]


victim_threshold.launches = 0
