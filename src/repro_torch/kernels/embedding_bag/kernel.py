"""The embedding-bag CUDA kernel: its wrapper and its plain PyTorch version.

Replaces ``repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``
together with the densify and mean combiner of its wrapper
(``repro/kernels/embedding_bag/ops.py``).  Both versions take a table
``[V, D]`` (fp32 or bf16), int32 flat ids ``[N]`` (-1 = padding) and int32
segment ids ``[N]`` sorted non-decreasing (the caller's contract, as in the
reference: it cannot be checked without a host sync), and return
``[num_segments, D]`` in the table's dtype.  Bag ``s`` keeps its first
``max_bag`` lanes by position (``max_bag <= 0``: all of them); a negative id
adds nothing, an id >= V adds a zero row; the ``mean`` combiner divides by
the kept lanes with ``id >= 0`` (at least 1).  Both accumulate in the
table's dtype, lane by lane in bag order, as the Pallas body does (a bf16
bag is rounded to bf16 after every add), so the kernel equals the plain
version bit for bit.

* :func:`embedding_bag_plain` — the reference's densify as a gather: a
  masked dense ``[S, max_bag]`` id matrix from each bag's start, then for
  each position in order a masked ``[S, D]`` row gather
  (``lanes.take_fill``) added to the sum.
* :func:`embedding_bag_multi` — F features in one call: their flat ids and
  segment ids concatenated, int32 ``[ΣN]``, feature ``f`` owning lanes
  ``[lane_offsets[f], lane_offsets[f+1])`` (host ints: the lane counts are
  shapes, known without a sync; features may differ in lane count), all
  ``num_segments`` bags per feature; returns ``[F, S, D]``.  On CUDA
  tensors it launches the hand-written kernel in ``csrc/embedding_bag.cu``
  ONCE for all F features (bound by bytes: each kept row read once, the
  output written once; each bag's lanes found by the kernel itself, by a
  warp-wide search of the feature's sorted segment ids: no
  ``searchsorted``, no ``[S + 1]`` tensor) or raises; on CPU tensors it
  takes :func:`embedding_bag_multi_plain`, the plain version per feature,
  stacked.  ``embedding_bag_multi.launches`` counts kernel launches.
* :func:`embedding_bag` — one feature: :func:`embedding_bag_multi` over
  ``lane_offsets = (0, N)``, counted there.

No backward here: :mod:`repro_torch.kernels.embedding_bag.ops` wraps the
forward in a ``torch.autograd.Function`` whose backward is the reference's
(XLA) backward as torch ops.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.core.lanes import take_fill
from repro_torch.kernels import build

__all__ = [
    "SOURCE",
    "bag_starts",
    "embedding_bag",
    "embedding_bag_multi",
    "embedding_bag_multi_plain",
    "embedding_bag_plain",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = {"sum": 0, "mean": 1}
_MAX_FEATURES = 256  # features per launch (csrc/embedding_bag.cu's kMaxFeatures)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_entry = None  # the bound C entry, once built


def bag_starts(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int32 ``[S + 1]``: bag ``s`` is lanes ``[starts[s], starts[s+1])`` of
    the sorted segment ids (lanes outside ``[0, S)`` belong to no bag)."""
    seg = segment_ids.to(torch.int32).contiguous()
    probe = torch.arange(num_segments + 1, dtype=torch.int32, device=seg.device)
    return torch.searchsorted(seg, probe, out_int32=True)


def embedding_bag_plain(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[S, D]`` by a masked dense ``[S, max_bag]`` id matrix and one row
    gather and add per position.  With ``max_bag <= 0`` the dense width is
    the longest bag (read on the host: this version is for the CPU and for
    checks only)."""
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag combiner must be sum or mean, got {combiner!r}")
    starts = bag_starts(segment_ids, num_segments).to(torch.int64)
    lengths = starts[1:] - starts[:-1]
    if max_bag <= 0:
        max_bag = max(int(lengths.max()) if num_segments else 0, 1)
    pos = torch.arange(max_bag, device=table.device)
    if flat_ids.shape[0]:
        dense = take_fill(flat_ids, starts[:-1, None] + pos, -1)  # [S, max_bag]
    else:  # no lanes: every bag empty
        dense = torch.full((num_segments, max_bag), -1, dtype=torch.int32, device=table.device)
    dense = torch.where(pos < lengths[:, None], dense, -1)
    out = torch.zeros((num_segments, table.shape[1]), dtype=table.dtype, device=table.device)
    for t in range(max_bag):  # in bag order, rounded to the table's dtype per add
        out = out + take_fill(table, dense[:, t], 0)
    if combiner == "mean":
        cnt = torch.clamp_min((dense >= 0).sum(dim=1), 1).to(table.dtype)
        out = out / cnt[:, None]
    return out


def embedding_bag_multi_plain(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    lane_offsets: Sequence[int],
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[F, S, D]``: :func:`embedding_bag_plain` of each feature's lanes,
    stacked (for the CPU and for checks)."""
    return torch.stack([
        embedding_bag_plain(table, flat_ids[lo:hi], segment_ids[lo:hi], num_segments, combiner,
                            max_bag)
        for lo, hi in zip(lane_offsets[:-1], lane_offsets[1:])
    ])


def embedding_bag_multi(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    lane_offsets: Sequence[int],
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[F, S, D]`` pooled bags of F features: the CUDA kernel on CUDA
    tensors (one launch), the plain version on CPU tensors.  The arguments
    are checked from their metadata only."""
    global _entry
    offsets = tuple(int(o) for o in lane_offsets)
    if table.device.type == "cpu" and flat_ids.device.type == "cpu" and \
            segment_ids.device.type == "cpu":
        return embedding_bag_multi_plain(table, flat_ids, segment_ids, offsets, num_segments,
                                         combiner, max_bag)
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag combiner must be sum or mean, got {combiner!r}")
    dev = table.device
    if not (table.is_cuda and flat_ids.device == dev and segment_ids.device == dev):
        raise ValueError(f"embedding_bag: tensors on mixed or unsupported devices "
                         f"{sorted({str(a.device) for a in (table, flat_ids, segment_ids)})}")
    if table.dtype not in _DTYPES or table.dim() != 2:
        raise ValueError(f"embedding_bag: table must be fp32 or bf16 [V, D], got {table.dtype} "
                         f"{tuple(table.shape)}")
    v, d = table.shape
    if d > 0 and table.stride(1) != 1:
        raise ValueError(f"embedding_bag: the table needs a unit column stride, got strides "
                         f"{table.stride()}")
    n = offsets[-1]
    for name, x in (("flat_ids", flat_ids), ("segment_ids", segment_ids)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n or not x.is_contiguous():
            raise ValueError(f"embedding_bag: {name} must be contiguous int32 [{n}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if offsets[0] != 0 or any(a > b for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"embedding_bag: lane offsets must rise from 0, got {list(offsets)}")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"embedding_bag: num_segments={num_segments} outside [0, 2**31)")
    f = len(offsets) - 1
    out = torch.empty((f, num_segments, d), dtype=table.dtype, device=dev)
    if num_segments == 0 or d == 0 or f == 0:
        return out
    if _entry is None:
        _entry = build.entry(SOURCE, "embedding_bag_multi", _ARGTYPES)
    args = (table.data_ptr(), v, d, table.stride(0), _DTYPES[table.dtype], flat_ids.data_ptr(),
            segment_ids.data_ptr(), (ctypes.c_int * (f + 1))(*offsets), f, num_segments,
            max_bag if max_bag > 0 else 2**31 - 1, _COMBINERS[combiner], out.data_ptr())
    if dev.index == torch.cuda.current_device():
        err = _entry(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _entry(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    embedding_bag_multi.launches += -(-f // _MAX_FEATURES)
    return out


embedding_bag_multi.launches = 0


def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[S, D]`` pooled bags of one feature: :func:`embedding_bag_multi`
    over ``lane_offsets = (0, N)``."""
    return embedding_bag_multi(table, flat_ids, segment_ids, (0, flat_ids.shape[0]),
                               num_segments, combiner, max_bag)[0]
