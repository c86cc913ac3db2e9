"""The cache hot path's CUDA kernels: their wrappers and their plain
PyTorch versions.

**Victim threshold** — replaces
``repro/kernels/cache_ops/kernel.py::victim_threshold_pallas``.  Both
versions take the int32 eviction keys, work in the order-preserving uint32
domain (``u = key ^ 0x80000000``), and return ``(t, n_gt)``: ``t`` the
kv-th largest ``u`` (an int64 0-dim tensor holding the uint32 value) and
``n_gt`` the count of keys strictly above it (int32 0-dim).  Both stay on
the tensor's device; nothing syncs the host.

* :func:`victim_threshold_plain` — int64 keys offset by 2**31 and the same
  33 rounds (32 bit rounds of "count keys >= candidate", then one count of
  keys > t) as torch ops.
* :func:`victim_threshold` — on a CUDA tensor it launches the hand-written
  kernel in ``csrc/victim_threshold.cu`` (one launch: a radix select of 4
  8-bit digit passes over the keys held in shared memory, the CTAs'
  histograms merged across a cooperative grid; see the note there) or
  raises; on a CPU tensor it takes the plain version.
  ``victim_threshold.launches`` counts kernel launches.

**Tiered-arena gather + decode** — replaces
``repro/kernels/cache_ops/kernel.py::gather_decode_pallas``.  Given the fp32
head ``[H, D]``, the fp16 / int8 tail ``[T, D]`` (int8 with its ``[T, 2]``
``(scale, zp)`` sideband) and int32 slots ``[K]``, both versions return the
fp32 ``[K, D]`` rows: head rows as stored, tail rows decoded, zero rows for
slots outside ``[0, H + T)``.

* :func:`gather_decode_plain` — ``ref.arena_gather`` with the store codec's
  eager decode (``q * scale + zp`` as two torch ops).
* :func:`gather_decode` — on CUDA tensors it launches the hand-written
  kernel in ``csrc/gather_decode.cu`` (bound by bytes: one read of each
  lane's row, one write of its output row) or raises; on CPU tensors it
  takes the plain version.  ``gather_decode.launches`` counts kernel
  launches.  The kernel decodes without a fused multiply-add, so it is
  bitwise the plain version.

**Bucketize** — replaces ``repro/kernels/cache_ops/kernel.py::bucketize_pallas``.
Given int32 ``owner[U]`` and ``local[U]`` (-1 on padding and replicated
lanes) and the shard count ``S``, both versions return the int32 ``[S, U]``
routing image: ``out[s, i] = local[i]`` where ``owner[i] == s`` and
``local[i] >= 0``, else -1.

* :func:`bucketize_plain` — the where-image as three torch ops.
* :func:`bucketize` — on CUDA tensors it launches the hand-written kernel
  in ``csrc/bucketize.cu`` (one pass over the lanes for all S rows, 16 B
  loads and stores; bound by bytes) or raises; on CPU tensors it takes the
  plain version.  ``bucketize.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = [
    "BUCKETIZE_SOURCE",
    "GATHER_DECODE_SOURCE",
    "SOURCE",
    "bucketize",
    "bucketize_plain",
    "gather_decode",
    "gather_decode_plain",
    "victim_threshold",
    "victim_threshold_plain",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "victim_threshold.cu"
GATHER_DECODE_SOURCE = SOURCE.with_name("gather_decode.cu")
BUCKETIZE_SOURCE = SOURCE.with_name("bucketize.cu")
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


_THRESHOLD_SCRATCH = 2 + 512  # int64 words: t, n_gt, then 4 x 256 uint32 histograms
_threshold_entry = None


def victim_threshold(key: torch.Tensor, kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, n_gt) of the int32 keys: the CUDA kernel on a CUDA tensor (one
    launch), the plain version on a CPU tensor."""
    global _threshold_entry
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
    if _threshold_entry is None:
        _threshold_entry = build.entry(SOURCE, "victim_threshold", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p])
    # one allocation: t, n_gt and the kernel's scratch are views of it
    buf = torch.empty((_THRESHOLD_SCRATCH,), dtype=torch.int64, device=key.device)
    ptr = buf.data_ptr()
    args = (key.data_ptr(), n, kv, ptr, ptr + 8, ptr + 16)
    if key.device.index == torch.cuda.current_device():
        err = _threshold_entry(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(key.device):
            err = _threshold_entry(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"victim_threshold kernel launch failed: CUDA error {err}")
    victim_threshold.launches += 1
    return buf[0], buf[1:2].view(torch.int32)[0]


victim_threshold.launches = 0


_GD_CODECS = {"fp16": (0, torch.float16), "int8": (1, torch.int8)}


def gather_decode_plain(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
) -> torch.Tensor:
    """fp32 ``[K, D]`` rows of ``slots``: masked takes of head, tail and
    sideband, the codec's eager decode, then a per-lane select."""
    from repro_torch.kernels.cache_ops.ref import arena_gather  # ref imports this module
    from repro_torch.store.codec import get_codec

    return arena_gather(head, tail, sideband, slots, get_codec(codec).decode, torch.float32)


def gather_decode(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
) -> torch.Tensor:
    """fp32 ``[K, D]`` rows of ``slots``: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if codec not in _GD_CODECS:
        raise ValueError(f"gather_decode supports fp16/int8, got {codec!r}")
    args = [head, tail, slots] + ([] if sideband is None else [sideband])
    if all(a.device.type == "cpu" for a in args):
        return gather_decode_plain(head, tail, sideband, slots, codec)
    dev = head.device
    if not all(a.is_cuda and a.device == dev for a in args):
        raise ValueError(f"gather_decode: tensors on mixed or unsupported devices "
                         f"{sorted({str(a.device) for a in args})}")
    code, payload_dtype = _GD_CODECS[codec]
    if head.dtype != torch.float32 or head.dim() != 2:
        raise ValueError(f"gather_decode: head must be fp32 [H, D], got {head.dtype} "
                         f"{tuple(head.shape)}")
    h, d = head.shape
    if tail.dtype != payload_dtype or tail.dim() != 2 or tail.shape[1] != d:
        raise ValueError(f"gather_decode: {codec} tail must be {payload_dtype} [T, {d}], "
                         f"got {tail.dtype} {tuple(tail.shape)}")
    t = tail.shape[0]
    if codec == "int8":
        if sideband is None or sideband.dtype != torch.float32 or tuple(sideband.shape) != (t, 2):
            raise ValueError(f"gather_decode: int8 needs an fp32 [{t}, 2] sideband")
    elif sideband is not None:
        raise ValueError("gather_decode: fp16 takes no sideband")
    if slots.dtype != torch.int32 or slots.dim() != 1:
        raise ValueError(f"gather_decode: slots must be int32 [K], got {slots.dtype} "
                         f"{tuple(slots.shape)}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("gather_decode: every tensor must be contiguous")
    k = slots.shape[0]
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    launch = build.entry(GATHER_DECODE_SOURCE, "gather_decode", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            head.data_ptr(), h, tail.data_ptr(), t,
            None if sideband is None else sideband.data_ptr(),
            slots.data_ptr(), k, d, code, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_decode kernel launch failed: CUDA error {err}")
    gather_decode.launches += 1
    return out


gather_decode.launches = 0


def bucketize_plain(owner: torch.Tensor, local: torch.Tensor, num_shards: int) -> torch.Tensor:
    """int32 ``[S, U]`` routing image by a shard-id column, a mask and a
    select."""
    sids = torch.arange(int(num_shards), dtype=torch.int32, device=owner.device)[:, None]
    mine = (owner[None, :] == sids) & (local[None, :] >= 0)
    return torch.where(mine, local[None, :], -1).to(torch.int32)


def bucketize(owner: torch.Tensor, local: torch.Tensor, num_shards: int) -> torch.Tensor:
    """int32 ``[S, U]`` routing image: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    num_shards = int(num_shards)
    if owner.device.type == "cpu" and local.device.type == "cpu":
        return bucketize_plain(owner, local, num_shards)
    dev = owner.device
    if not (owner.is_cuda and local.device == dev):
        raise ValueError(f"bucketize: tensors on mixed or unsupported devices "
                         f"{owner.device}, {local.device}")
    if num_shards < 1:
        raise ValueError(f"bucketize: num_shards must be >= 1, got {num_shards}")
    for name, x in (("owner", owner), ("local", local)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"bucketize: {name} must be contiguous int32 [U], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError(f"bucketize: {name} must start on a 16 B boundary")
    if owner.shape != local.shape:
        raise ValueError(f"bucketize: owner {tuple(owner.shape)} != local {tuple(local.shape)}")
    u = owner.shape[0]
    out = torch.empty((num_shards, u), dtype=torch.int32, device=dev)
    if u == 0:
        return out
    launch = build.entry(BUCKETIZE_SOURCE, "bucketize", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(owner.data_ptr(), local.data_ptr(), u, num_shards, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bucketize kernel launch failed: CUDA error {err}")
    bucketize.launches += 1
    return out


bucketize.launches = 0
