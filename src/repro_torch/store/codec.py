"""Row codecs (port of ``repro.store.codec``).

* ``fp32`` — bit-exact passthrough.
* ``fp16`` — cast on encode, upcast on decode.
* ``int8`` — row-wise affine: ``scale = max(mx - mn, 1e-12) / 254``,
  ``zp = (mx + mn) / 2``, ``q = clip(round((x - zp) / scale), -127, 127)``
  with a per-row ``[n, 2]`` fp32 ``(scale, zp)`` sideband.  The row's min and
  max land exactly on -127 / +127, so decode -> encode of an untouched row
  gives back the identical payload (the stable-projection property).

Every op runs in the reference's order as one eager torch op each
(``torch.round`` rounds half to even, as ``jnp.round`` does), so a codec
applied here is bitwise the reference's applied eagerly, on the CPU and on
the card alike.  The decode ``q * scale + zp`` is two roundings, never a
fused multiply-add.

The device arena (:mod:`repro_torch.store.arena`) and the host tier
(:class:`~repro_torch.store.host_store.HostStore`) use all three; on the
card the transmitter encodes and decodes the host tier's rows with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["Codec", "Fp32Codec", "Fp16Codec", "Int8Codec", "CODECS", "get_codec"]

_EPS = 1e-12
DType = Union[torch.dtype, str]


def as_dtype(dt: DType) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"float32"``)."""
    return getattr(torch, dt) if isinstance(dt, str) else dt


@dataclasses.dataclass(frozen=True)
class Codec:
    """Bit-exact passthrough: the base of every codec (``Fp32Codec`` is it
    under its own name, ``CODECS["fp32"]``)."""

    name: str = "fp32"

    def encodes(self, leaf: torch.Tensor) -> bool:
        """Only per-row float vectors are re-coded; everything else stays raw."""
        return leaf.is_floating_point() and leaf.dim() >= 2

    def encode(self, rows: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """[n, ...] float rows -> (payload, sideband or None)."""
        return rows, None

    def decode(
        self, payload: torch.Tensor, sideband: Optional[torch.Tensor], out_dtype: DType
    ) -> torch.Tensor:
        return payload

    def payload_dtype(self, orig_dtype: torch.dtype) -> torch.dtype:
        return orig_dtype

    def sideband_row_shape(self) -> Optional[Tuple[int, ...]]:
        """Per-row sideband shape, or None when the codec needs none."""
        return None

    def row_bytes(self, row_shape: Tuple[int, ...], orig_dtype: torch.dtype) -> int:
        """Encoded bytes per row (payload + fp32 sideband): what crosses the link."""
        n = int(np.prod(row_shape)) if row_shape else 1
        b = n * self.payload_dtype(orig_dtype).itemsize
        side = self.sideband_row_shape()
        if side is not None:
            b += int(np.prod(side, dtype=np.int64)) * 4
        return b


@dataclasses.dataclass(frozen=True)
class Fp32Codec(Codec):
    name: str = "fp32"


@dataclasses.dataclass(frozen=True)
class Fp16Codec(Codec):
    name: str = "fp16"

    def encode(self, rows):
        return rows.to(torch.float16), None

    def decode(self, payload, sideband, out_dtype):
        return payload.to(as_dtype(out_dtype))

    def payload_dtype(self, orig_dtype):
        return torch.float16


@dataclasses.dataclass(frozen=True)
class Int8Codec(Codec):
    """Row-wise affine int8 with a ``[n, 2]`` fp32 ``(scale, zp)`` sideband."""

    name: str = "int8"

    def encode(self, rows):
        x = rows.to(torch.float32)
        red = tuple(range(1, x.dim()))
        mn = torch.amin(x, dim=red)
        mx = torch.amax(x, dim=red)
        # a tensor divisor: CUDA divides by a CPU scalar as a multiply by its
        # reciprocal, which is not the reference's division
        scale = torch.clamp_min(mx - mn, _EPS) / torch.full((), 254.0, device=x.device)
        zp = 0.5 * (mx + mn)
        bshape = (-1,) + (1,) * (x.dim() - 1)
        q = torch.clamp(
            torch.round((x - zp.reshape(bshape)) / scale.reshape(bshape)), -127, 127
        ).to(torch.int8)
        return q, torch.stack([scale, zp], dim=-1)

    def decode(self, payload, sideband, out_dtype):
        # sideband is [...batch, 2]; payload may carry extra trailing row dims
        extra = payload.dim() - (sideband.dim() - 1)
        bshape = tuple(sideband.shape[:-1]) + (1,) * extra
        scale = sideband[..., 0].reshape(bshape)
        zp = sideband[..., 1].reshape(bshape)
        return (payload.to(torch.float32) * scale + zp).to(as_dtype(out_dtype))

    def payload_dtype(self, orig_dtype):
        return torch.int8

    def sideband_row_shape(self):
        return (2,)


CODECS: Dict[str, Codec] = {"fp32": Fp32Codec(), "fp16": Fp16Codec(), "int8": Int8Codec()}


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; known: {sorted(CODECS)}") from None
