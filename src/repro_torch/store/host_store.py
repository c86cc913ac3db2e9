"""``HostStore``: the host tier that holds the full table (port of
``repro.store.host_store``).

The reference emulates this tier with device arrays.  The port keeps it
where the paper keeps it: in host memory, page-locked when the arena lives
on a CUDA card so that the transmitter's staging blocks cross PCIe with
non-blocking copies.  The table is pinned in place with
``cudaHostRegister`` rather than allocated through PyTorch's pinned
allocator, which rounds each allocation up to a power of two (a 17.3 GB
Criteo table would take 32 GB).

The host tier is fp32 only; fp16/int8/auto host codecs arrive with the
port's host-precision slice (the device arena's codecs are in
:mod:`repro_torch.store.codec`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lanes import take_fill
from repro_torch.store.codec import get_codec

__all__ = ["HostStore", "StagingRing"]


class StagingRing:
    """Two pinned ``[rows, ...]`` staging blocks per leaf, used in turn.

    A block is handed out again only after the event recorded behind its
    last host-to-device copy has completed, so a refill can never overwrite
    rows that are still crossing the link."""

    def __init__(self, leaves: Dict[str, torch.Tensor], rows: int):
        self.rows = rows
        self.blocks: List[Dict[str, torch.Tensor]] = [
            {
                k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype, pin_memory=True)
                for k, v in leaves.items()
            }
            for _ in range(2)
        ]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def acquire(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        i = self.turn
        self.turn ^= 1
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        return i, self.blocks[i]

    def release_after_copy(self, i: int) -> None:
        """Mark block ``i`` busy until the copies enqueued so far are done."""
        ev = torch.cuda.Event()
        ev.record()
        self.events[i] = ev


@dataclasses.dataclass
class HostStore:
    """Full-table container: ``data`` leaves [vocab, ...] on the host."""

    data: Dict[str, torch.Tensor]
    sideband: Dict[str, torch.Tensor]
    codec: str = "fp32"
    out_dtype: str = "float32"
    pinned: bool = False  # data leaves page-locked for async copies
    _ring: Optional[StagingRing] = dataclasses.field(default=None, repr=False, compare=False)
    # the store whose table a view (``view`` / ``shard``) reads: it holds the
    # pin and the staging ring that all its views share
    _owner: Optional["HostStore"] = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def create(
        cls, full_tree: Dict[str, torch.Tensor], codec: str = "fp32", pin: bool = False
    ) -> "HostStore":
        """Wrap a raw full-table dict of CPU tensors (one codec per store).
        ``pin`` page-locks every leaf in place for non-blocking transfers."""
        if codec != "fp32":
            raise NotImplementedError(
                f"host codec {codec!r}: fp16/int8/auto host stores arrive with the "
                "port's host-precision slice"
            )
        data = {k: v.contiguous() for k, v in full_tree.items()}
        for k, v in data.items():
            if v.device.type != "cpu":
                raise ValueError(f"HostStore leaf {k!r} must live on the host, got {v.device}")
        store = cls(data=data, sideband={}, codec=codec)
        if pin:
            cudart = torch.cuda.cudart()
            for v in data.values():
                err = int(cudart.cudaHostRegister(v.data_ptr(), v.numel() * v.element_size(), 0))
                if err != 0:
                    raise RuntimeError(f"cudaHostRegister failed with CUDA error {err}")
            store.pinned = True
        return store

    def view(self, reshape) -> "HostStore":
        """A store over the same memory with every leaf reshaped by
        ``reshape`` (a view: writes land in this store's table).  The sharded
        collection keeps one stacked ``[S, rows, ...]`` table and reads it
        through per-shard and flat ``[S * rows, ...]`` views."""
        owner = self._owner or self
        return HostStore(
            data={k: reshape(v) for k, v in self.data.items()},
            sideband={k: reshape(v) for k, v in self.sideband.items()},
            codec=self.codec, out_dtype=self.out_dtype, pinned=owner.pinned, _owner=owner,
        )

    def shard(self, s: int) -> "HostStore":
        """Shard ``s`` of a stacked ``[S, rows, ...]`` store, as a view."""
        return self.view(lambda v: v[s])

    def close(self) -> None:
        """Unpin the table (safe to call twice; a view closes its owner)."""
        if self._owner is not None:
            self._owner.close()
            self.pinned = False
            return
        if self.pinned:
            cudart = torch.cuda.cudart()
            for v in self.data.values():
                cudart.cudaHostUnregister(v.data_ptr())
            self.pinned = False
        self._ring = None

    def staging(self, rows: int) -> StagingRing:
        """The store's staging ring of ``rows``-row blocks (built on first
        use), shared by the owner's views; blocks take this store's row
        shape."""
        home = self._owner or self
        if home._ring is None or home._ring.rows != rows:
            home._ring = StagingRing(self.data, rows)
        return home._ring

    # ----- reads ---------------------------------------------------------------

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.data[key]

    def decode_rows(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Rows ``idx`` of every leaf, decoded (fp32: as stored); negative /
        out-of-range lanes are zero rows."""
        return {k: take_fill(v, idx, 0) for k, v in self.data.items()}

    # ----- accounting ------------------------------------------------------------

    def row_wire_bytes(self, batch_dims: int = 1) -> int:
        """Encoded bytes per row across all leaves: one transmitter lane."""
        total = 0
        for leaf in self.data.values():
            total += get_codec(self.codec).row_bytes(tuple(leaf.shape[batch_dims:]), leaf.dtype)
        return total

    def host_bytes(self) -> int:
        return sum(
            int(np.prod(v.shape, dtype=np.int64)) * v.element_size()
            for v in list(self.data.values()) + list(self.sideband.values())
        )
