"""The flash-attention CUDA kernels: their wrapper and their plain PyTorch version.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
Both versions take ``q`` ``[B, Hq, Sq, D]`` and ``k``, ``v`` ``[B, Hkv, Sk,
D]`` (fp32 or bf16; ``Hkv`` divides ``Hq``, query head ``h`` reads KV head
``h // (Hq // Hkv)``) and return ``softmax(mask(q k^T / sqrt(D))) v`` in
``q``'s dtype, with the causal mask and the optional sliding window
``q_pos - k_pos < window``.

* :func:`flash_attention_plain` — ``attention_ref``'s dense masked softmax in
  fp32, one block of 256 query rows at a time, so its scores take
  ``O(256 * Sk)`` memory per head (the dense ``[B, H, S, S]`` scores of a
  32 768-token prefill would take 64 GB).  The CPU tests and the CPU route
  of the wrapper use it; on the card only ``chip_smoke.py``'s checks do.
* :func:`flash_attention` — on CUDA tensors it launches a hand-written
  kernel (bound by operations) or raises; :func:`route` picks it from the
  dtype and the head width:

  - ``"wgmma"``: bf16, the tensor-core kernel in
    ``csrc/flash_attention_sm90.cu`` (wgmma, cp.async, P @ V by a bf16
    ``hi + lo`` split of p);
  - ``"tf32x3"``: fp32 heads of up to 128 columns, the tensor-core kernel
    in ``csrc/flash_attention_tf32.cu`` (wgmma on TF32 operands, each fp32
    product issued as three TF32 products of a ``hi + lo`` split).  A call
    enqueues its split pass (k and v split once, laid out as the kernel's
    shared-memory stages in scratch the wrapper allocates) and then the
    attention kernel: two launches, counted as one;
  - ``"simt"``: fp32 heads of 129 to 256 columns, the SIMT kernel in
    ``csrc/flash_attention.cu`` (the TF32 kernel's shared-memory plan does
    not fit a wider head).

  On CPU tensors it takes the plain version.  ``flash_attention.launches``
  counts kernel launches, and ``flash_attention.route_launches`` counts
  them by route.  The kernels read ``q``, ``k`` and ``v`` through their
  strides and write their output in ``q``'s layout, so the model's
  ``[B, S, H, D]`` tensors pass as transposed views and nothing is copied;
  the bf16 route needs a head-dim stride of 1 and raises on another, the
  fp32 routes take any strides.

Every route accepts exactly the shapes the reference accepts: its wrapper
asserts ``S % min(256, S) == 0`` for the query and key lengths (its block
size), and here that is a ``ValueError``.  The kernels take any ``D <= 256``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["BLOCK", "SOURCE", "SM90_SOURCE", "TF32_SOURCE", "flash_attention",
           "flash_attention_plain", "route"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"  # fp32, SIMT
SM90_SOURCE = SOURCE.with_name("flash_attention_sm90.cu")  # bf16, tensor cores
TF32_SOURCE = SOURCE.with_name("flash_attention_tf32.cu")  # fp32, tensor cores (3xTF32)
BLOCK = 256  # the reference's block_q / block_k: min(BLOCK, S) must divide S
MAX_D = 256  # the kernels' widest head
TF32_MAX_D = 128  # the 3xTF32 kernel's widest head
ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 16
            + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int))
_ROUTES = {  # route: (source, C entry, extra argument types before the stream)
    "wgmma": (SM90_SOURCE, "flash_attention_bf16_fwd", (ctypes.c_int,)),
    "tf32x3": (TF32_SOURCE, "flash_attention_tf32x3_fwd", (ctypes.c_void_p,)),
    "simt": (SOURCE, "flash_attention_fwd", ()),
}


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head width launches."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype != torch.float32:
        raise ValueError(f"flash_attention takes fp32 or bf16 q, k, v, got {dtype}")
    return "tf32x3" if d <= TF32_MAX_D else "simt"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, Hq, Sq, D] and k, v [B, Hkv, Sk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)} "
                         "(same B and D, Hkv dividing Hq)")
    for name, s in (("query", sq), ("key", k.shape[2])):
        if s < 1 or s % min(BLOCK, s):
            raise ValueError(f"flash_attention: {name} length {s} is not a multiple of "
                             f"min({BLOCK}, {s}), as the reference's block size requires")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``attention_ref`` one block of 256 query rows at a time."""
    _check(q, k, v)
    return torch.cat([attention_ref(q[:, :, q0:q0 + BLOCK], k, v, causal, window, q0)
                      for q0 in range(0, q.shape[2], BLOCK)], dim=2)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``[B, Hq, Sq, D]`` attention of ``q`` over ``k``, ``v``: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k and v must lie on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention takes fp32 or bf16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_D:
        raise ValueError(f"flash_attention: the kernel takes head dims up to {MAX_D}, got {d}")
    kind = route(q.dtype, d)
    source, name, extra = _ROUTES[kind]
    if kind == "wgmma" and any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"flash_attention: the bf16 kernel reads rows with head-dim stride 1, "
                         f"got strides {q.stride()}, {k.stride()}, {v.stride()}")
    out = torch.empty_like(q)  # q's layout: a [B, S, H, D] tensor's view comes back as one
    if out.numel() == 0:
        return out
    # a window of sq or more masks nothing, one of -sk or less masks every key
    has_window, w = window is not None, 0 if window is None else max(-sk, min(window, sq))
    args = [1.0 / math.sqrt(d), int(causal), int(has_window), w]
    if kind == "wgmma":
        args.append(_copy_bytes(d, q, k, v, out))
    elif kind == "tf32x3":  # the split K/V tiles: 64 keys of k and v^T, hi and lo, a stage
        dp = 64 if d <= 64 else 128
        tiles = torch.empty((b, hkv, -(-sk // 64), 4 * 64 * dp), dtype=torch.float32,
                            device=q.device)
        args.append(tiles.data_ptr())
    launch = build.entry(source, name, ARGTYPES + extra + (ctypes.c_void_p,))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk,
                     d, *q.stride(), *k.stride(), *v.stride(), *out.stride(), *args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[kind] += 1
    return out


def _copy_bytes(d: int, *tensors: torch.Tensor) -> int:
    """The widest copy (16, 8 or 4 bytes, else 2: ordinary loads) that
    divides a bf16 row of ``d`` and every tensor's address and b/h/s stride
    in bytes: a ``[B, S, H, D]`` view's rows need not be 16-byte aligned."""
    byte_offsets = [2 * d] + [t.data_ptr() for t in tensors] + [
        2 * s for t in tensors for s in t.stride()[:3]]
    return next((w for w in (16, 8, 4) if all(x % w == 0 for x in byte_offsets)), 2)


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "tf32x3": 0, "simt": 0}
