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
* :func:`embedding_bag` — on CUDA tensors it launches the hand-written
  kernel in ``csrc/embedding_bag.cu`` (bound by bytes: each kept row read
  once, the output written once) or raises; on CPU tensors it takes the
  plain version.  Each bag's start comes from ``torch.searchsorted`` on the
  card: no host sync, no ``[S, max_bag]`` matrix.
  ``embedding_bag.launches`` counts kernel launches.

No backward here: :mod:`repro_torch.kernels.embedding_bag.ops` wraps the
forward in a ``torch.autograd.Function`` whose backward is the reference's
(XLA) backward as torch ops.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.lanes import take_fill
from repro_torch.kernels import build

__all__ = ["SOURCE", "bag_starts", "embedding_bag", "embedding_bag_plain"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = {"sum": 0, "mean": 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p)


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
    dense = take_fill(flat_ids, starts[:-1, None] + pos, -1)  # [S, max_bag]
    dense = torch.where(pos < lengths[:, None], dense, -1)
    out = torch.zeros((num_segments, table.shape[1]), dtype=table.dtype, device=table.device)
    for t in range(max_bag):  # in bag order, rounded to the table's dtype per add
        out = out + take_fill(table, dense[:, t], 0)
    if combiner == "mean":
        cnt = torch.clamp_min((dense >= 0).sum(dim=1), 1).to(table.dtype)
        out = out / cnt[:, None]
    return out


def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
    max_bag: int = 0,
) -> torch.Tensor:
    """``[S, D]`` pooled bags: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag combiner must be sum or mean, got {combiner!r}")
    args = (table, flat_ids, segment_ids)
    if all(a.device.type == "cpu" for a in args):
        return embedding_bag_plain(table, flat_ids, segment_ids, num_segments, combiner, max_bag)
    dev = table.device
    if not all(a.is_cuda and a.device == dev for a in args):
        raise ValueError(f"embedding_bag: tensors on mixed or unsupported devices "
                         f"{sorted({str(a.device) for a in args})}")
    if table.dtype not in _DTYPES or table.dim() != 2:
        raise ValueError(f"embedding_bag: table must be fp32 or bf16 [V, D], got {table.dtype} "
                         f"{tuple(table.shape)}")
    v, d = table.shape
    if d > 0 and table.stride(1) != 1:
        raise ValueError(f"embedding_bag: the table needs a unit column stride, got strides "
                         f"{table.stride()}")
    n = flat_ids.shape[0] if flat_ids.dim() == 1 else -1
    for name, x in (("flat_ids", flat_ids), ("segment_ids", segment_ids)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n or not x.is_contiguous():
            raise ValueError(f"embedding_bag: {name} must be contiguous int32 [N] like flat_ids, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if num_segments < 0:
        raise ValueError(f"embedding_bag: num_segments={num_segments} < 0")
    out = torch.empty((num_segments, d), dtype=table.dtype, device=dev)
    if num_segments == 0 or d == 0:
        return out
    starts = bag_starts(segment_ids, num_segments)
    launch = build.entry(SOURCE, "embedding_bag", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(table.data_ptr(), v, d, table.stride(0), _DTYPES[table.dtype],
                     flat_ids.data_ptr(), starts.data_ptr(), num_segments,
                     max_bag if max_bag > 0 else 2**31 - 1, _COMBINERS[combiner],
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
