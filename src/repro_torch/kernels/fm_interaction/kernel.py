"""The FM-interaction CUDA kernel: its wrapper and its plain PyTorch version.

Replaces ``repro/kernels/fm_interaction/kernel.py::fm_interaction_pallas``.
Both versions take ``v`` ``[B, F, D]`` (fp32 or bf16), compute
``0.5 * sum_d((sum_f v)^2 - sum_f v^2)`` per sample in fp32, and return
``[B]`` in ``v``'s dtype.

* :func:`fm_interaction_plain` — the sum-square trick as torch ops on the
  fp32 upcast of ``v``.
* :func:`fm_interaction` — on a CUDA tensor it launches the hand-written
  kernel in ``csrc/fm_interaction.cu`` (bound by bytes: one read of ``v``)
  or raises; on a CPU tensor it takes the plain version.
  ``fm_interaction.launches`` counts kernel launches.  ``v`` may be a
  strided view (FM slices ``[..., :D]`` out of a ``[B, F, D+1]`` stack): the
  kernel takes the B and F strides and needs a unit stride on ``d`` only, so
  the wrapper never copies.

The kernel has no backward, as the Pallas kernel has none (``jax.grad``
through it fails to linearise): the wrapper raises when autograd would
record it, on either device, instead of handing back a result with no
graph.  FM trains through ``nn.recsys.fm_interaction(use_pallas=False)``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.analysis.contracts import contract
from repro_torch.kernels import build
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

__all__ = ["SOURCE", "fm_interaction", "fm_interaction_plain"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fm_interaction.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


def fm_interaction_plain(v: torch.Tensor) -> torch.Tensor:
    """[B] in ``v``'s dtype: the sum-square trick over the fp32 upcast."""
    return fm_interaction_ref(v.to(torch.float32)).to(v.dtype)


@contract(max_sort_size=0)
def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """[B] FM interaction of ``v`` [B, F, D]: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if torch.is_grad_enabled() and v.requires_grad:
        raise RuntimeError(
            "fm_interaction: the FM kernel has no backward (the reference's Pallas kernel "
            "cannot be differentiated either); train through "
            "nn.recsys.fm_interaction(use_pallas=False)"
        )
    if v.dim() != 3:
        raise ValueError(f"fm_interaction takes v [B, F, D], got {tuple(v.shape)}")
    if v.device.type == "cpu":
        return fm_interaction_plain(v)
    if not v.is_cuda:
        raise ValueError(f"fm_interaction: unsupported device {v.device}")
    if v.dtype not in _DTYPES:
        raise ValueError(f"fm_interaction takes fp32 or bf16, got {v.dtype}")
    b, f, d = v.shape
    if d < 1 or v.stride(2) != 1:
        raise ValueError(f"fm_interaction needs a unit stride on d, got strides {v.stride()} "
                         f"for shape {tuple(v.shape)}")
    out = torch.empty((b,), dtype=v.dtype, device=v.device)
    if b == 0:
        return out
    launch = build.entry(SOURCE, "fm_interaction", _ARGTYPES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = launch(v.data_ptr(), b, f, d, v.stride(0), v.stride(1), _DTYPES[v.dtype],
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fm_interaction kernel launch failed: CUDA error {err}")
    fm_interaction.launches += 1
    return out


fm_interaction.launches = 0
