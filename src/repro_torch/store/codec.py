"""Row codecs of the host-tier store (port of ``repro.store.codec``).

This slice ports the ``fp32`` codec only: a bit-exact passthrough.  The
fp16 and int8 codecs come with the mixed-precision slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["Codec", "get_codec"]

_LATER = "the fp16/int8 codecs arrive with the port's mixed-precision slice"


@dataclasses.dataclass(frozen=True)
class Codec:
    """Bit-exact passthrough (the ``fp32`` codec)."""

    name: str = "fp32"

    def row_bytes(self, row_shape: Tuple[int, ...], dtype: torch.dtype) -> int:
        """Encoded bytes per row: what crosses the host link."""
        n = int(np.prod(row_shape)) if row_shape else 1
        return n * torch.empty((), dtype=dtype).element_size()


def get_codec(name: str) -> Codec:
    if name == "fp32":
        return Codec()
    if name in ("fp16", "int8", "auto"):
        raise NotImplementedError(f"host codec {name!r}: {_LATER}")
    raise ValueError(f"unknown host-store codec {name!r}")
