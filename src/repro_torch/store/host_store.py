"""``HostStore``: the host tier that holds the full table, encoded by one
row codec (port of ``repro.store.host_store``).

The reference emulates this tier with device arrays.  The port keeps it
where the paper keeps it: in host memory, page-locked when the arena lives
on a CUDA card so that the transmitter's staging blocks cross PCIe with
non-blocking copies.  Every leaf is pinned in place with
``cudaHostRegister`` rather than allocated through PyTorch's pinned
allocator, which rounds each allocation up to a power of two (a 17.3 GB
Criteo table would take 32 GB).

A store holds each per-row float leaf encoded by its codec (fp32: raw;
fp16: half precision; int8: row-wise affine with an ``[n, 2]`` fp32
``(scale, zp)`` sideband) and every other leaf raw.  The transmitter moves
the *encoded* payload and sideband across the link and decodes or encodes
on the device side (``decode_block`` / ``encode_block``); ``decode_rows``
and ``decode_leaf`` are the oracle reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lanes import take_fill
from repro_torch.store.codec import Codec, as_dtype, get_codec

__all__ = ["HostStore", "StagingRing"]

Tree = Dict[str, torch.Tensor]


class StagingRing:
    """Two pinned staging blocks, used in turn; a block is a pair of dicts
    (``[rows, ...]`` payload leaves, ``[rows, 2]`` sideband leaves).

    A block is handed out again only after the event recorded behind its
    last host-to-device copy has completed, so a refill can never overwrite
    rows that are still crossing the link."""

    def __init__(self, data: Tree, sideband: Tree, rows: int):
        self.rows = rows

        def pinned(leaves: Tree) -> Tree:
            return {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype, pin_memory=True)
                    for k, v in leaves.items()}

        self.blocks: List[Tuple[Tree, Tree]] = [(pinned(data), pinned(sideband)) for _ in range(2)]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def acquire(self) -> Tuple[int, Tuple[Tree, Tree]]:
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


def _register(leaves: List[torch.Tensor]) -> None:
    cudart = torch.cuda.cudart()
    for v in leaves:
        if v.numel() == 0:
            continue
        err = int(cudart.cudaHostRegister(v.data_ptr(), v.numel() * v.element_size(), 0))
        if err != 0:
            raise RuntimeError(f"cudaHostRegister failed with CUDA error {err}")


@dataclasses.dataclass
class HostStore:
    """Full-table container: ``data`` leaves [vocab, ...] on the host in the
    codec's storage dtype, ``sideband`` the per-row codec metadata of the
    encoded leaves (int8's ``[vocab, 2]`` (scale, zp); empty for fp32 and
    fp16)."""

    data: Tree
    sideband: Tree
    codec: str = "fp32"
    out_dtype: str = "float32"
    pinned: bool = False  # every leaf page-locked for async copies
    _ring: Optional[StagingRing] = dataclasses.field(default=None, repr=False, compare=False)
    # the store whose table a view (``view`` / ``shard``) reads: it holds the
    # pin and the staging ring that all its views share
    _owner: Optional["HostStore"] = dataclasses.field(default=None, repr=False, compare=False)

    # ----- construction -----------------------------------------------------

    @staticmethod
    def _out_dtype(codec: Codec, shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]) -> str:
        """The one decode dtype of the tree's encoded leaves: a store decodes
        to ONE dtype, so a tree that mixes float dtypes among them is
        rejected instead of decoding the minority leaf to the wrong type."""
        probe = {k: torch.empty((0,) * len(s), dtype=dt) for k, (s, dt) in shapes.items()}
        dts = {str(v.dtype).removeprefix("torch.") for v in probe.values() if codec.encodes(v)}
        if len(dts) > 1:
            raise ValueError(
                f"HostStore encodes all leaves to one decode dtype, but the tree mixes "
                f"{sorted(dts)}: split the table into one store per dtype"
            )
        return dts.pop() if dts else "float32"

    @classmethod
    def allocate(
        cls, like: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], codec: str = "fp32"
    ) -> "HostStore":
        """An uninitialised host store of the codec's layout for leaves of
        the given (shape, dtype); fill it with :meth:`write_rows`."""
        c = get_codec(codec)
        out_dtype = cls._out_dtype(c, like)
        data: Tree = {}
        sideband: Tree = {}
        for k, (shape, dt) in like.items():
            probe = torch.empty((0,) * len(shape), dtype=dt)
            if c.encodes(probe):
                data[k] = torch.empty(shape, dtype=c.payload_dtype(dt))
                srow = c.sideband_row_shape()
                if srow is not None:
                    sideband[k] = torch.empty((shape[0],) + srow, dtype=torch.float32)
            else:
                data[k] = torch.empty(shape, dtype=dt)
        return cls(data=data, sideband=sideband, codec=codec, out_dtype=out_dtype)

    @classmethod
    def create(cls, full_tree: Tree, codec: str = "fp32", pin: bool = False) -> "HostStore":
        """Encode a raw full-table dict of CPU tensors (one codec per store).
        Leaves the codec keeps raw are wrapped in place, not copied.  ``pin``
        page-locks every leaf for non-blocking transfers."""
        for k, v in full_tree.items():
            if v.device.type != "cpu":
                raise ValueError(f"HostStore leaf {k!r} must live on the host, got {v.device}")
        c = get_codec(codec)
        out_dtype = cls._out_dtype(c, {k: (tuple(v.shape), v.dtype) for k, v in full_tree.items()})
        data: Tree = {}
        sideband: Tree = {}
        for k, leaf in full_tree.items():
            if c.encodes(leaf) and codec != "fp32":
                payload, side = c.encode(leaf)
                data[k] = payload.contiguous()
                if side is not None:
                    sideband[k] = side.contiguous()
            else:
                data[k] = leaf.contiguous()
        store = cls(data=data, sideband=sideband, codec=codec, out_dtype=out_dtype)
        if pin:
            store.pin()
        return store

    def write_rows(self, r0: int, block: Tree) -> None:
        """Store full-precision rows ``r0 ..`` of every leaf, encoded where
        ``block`` lives (on the card when drawn there), then copied to the
        host leaves."""
        data, side = self.encode_block(block)
        for k, v in data.items():
            self.data[k][r0 : r0 + v.shape[0]].copy_(v)
        for k, v in side.items():
            self.sideband[k][r0 : r0 + v.shape[0]].copy_(v)

    def write_at(self, idx: torch.Tensor, block: Tree) -> None:
        """Store full-precision rows at the host rows ``idx`` (int64,
        unique), encoded where ``block`` lives, then copied to the host
        leaves."""
        data, side = self.encode_block(block)
        for k, v in data.items():
            self.data[k].index_copy_(0, idx, v.cpu())
        for k, v in side.items():
            self.sideband[k].index_copy_(0, idx, v.cpu())

    def pin(self) -> None:
        """Page-lock every payload and sideband leaf in place."""
        if not self.pinned:
            _register([*self.data.values(), *self.sideband.values()])
            self.pinned = True

    def view(self, reshape: Callable[[torch.Tensor], torch.Tensor]) -> "HostStore":
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
            for v in [*self.data.values(), *self.sideband.values()]:
                if v.numel():
                    cudart.cudaHostUnregister(v.data_ptr())
            self.pinned = False
        self._ring = None

    def staging(self, rows: int) -> StagingRing:
        """The store's staging ring of blocks of at least ``rows`` rows
        (built on first use, rebuilt only to grow), shared by the owner's
        views; blocks take this store's row shape, sideband included."""
        home = self._owner or self
        if home._ring is None or home._ring.rows < rows:
            home._ring = StagingRing(self.data, self.sideband, rows)
        return home._ring

    # ----- codec plumbing ------------------------------------------------------

    def __getitem__(self, key: str) -> torch.Tensor:
        """The stored payload leaf (for fp32 the raw table; encoded readers
        want :meth:`decode_leaf`)."""
        return self.data[key]

    @property
    def _codec(self) -> Codec:
        return get_codec(self.codec)

    @property
    def _out(self) -> torch.dtype:
        return as_dtype(self.out_dtype)

    def is_encoded(self, key: str) -> bool:
        """True when ``data[key]`` holds the codec's low-precision form (a
        sideband entry, or a payload dtype other than the decode target)."""
        if self.codec == "fp32":
            return False
        if key in self.sideband:
            return True
        return self.data[key].dtype != self._out and self._out.is_floating_point

    def decode_block(self, block: Tree, side: Tree) -> Tree:
        """A gathered ``(payload, sideband)`` block back to full precision,
        by eager torch ops on the block's device."""
        c = self._codec
        return {k: c.decode(v, side.get(k), self._out) if self.is_encoded(k) else v
                for k, v in block.items()}

    def encode_block(self, block: Tree) -> Tuple[Tree, Tree]:
        """A full-precision block encoded for the trip to the host, on the
        block's device: ``(payload, sideband)``."""
        c = self._codec
        data: Tree = {}
        side: Tree = {}
        for k, v in block.items():
            if self.is_encoded(k):
                payload, s = c.encode(v)
                data[k] = payload
                if s is not None:
                    side[k] = s
            else:
                data[k] = v
        return data, side

    # ----- reads ---------------------------------------------------------------

    def decode_rows(self, idx: torch.Tensor) -> Tree:
        """Rows ``idx`` of every leaf, decoded; negative / out-of-range lanes
        are zero rows."""
        block = {k: take_fill(v, idx, 0) for k, v in self.data.items()}
        side = {k: take_fill(v, idx, 0) for k, v in self.sideband.items()}
        return self.decode_block(block, side)

    def decode_leaf(self, key: str) -> torch.Tensor:
        """The whole leaf, decoded (fp32: the stored tensor itself)."""
        if not self.is_encoded(key):
            return self.data[key]
        return self._codec.decode(self.data[key], self.sideband.get(key), self._out)

    # ----- accounting ------------------------------------------------------------

    def row_wire_bytes(self, batch_dims: int = 1) -> int:
        """Encoded bytes per row across all leaves: what one transmitter lane
        moves over the link.  ``batch_dims`` counts the leading non-row dims
        (2 for a shard-stacked ``[S, rows, ...]`` store)."""
        total = 0
        for k, leaf in self.data.items():
            row = tuple(leaf.shape[batch_dims:])
            if self.is_encoded(k):
                total += self._codec.row_bytes(row, self._out)
            else:
                total += int(np.prod(row, dtype=np.int64)) * leaf.element_size()
        return total

    def host_bytes(self) -> int:
        """Total host-tier footprint (payload + sideband)."""
        return sum(
            int(np.prod(v.shape, dtype=np.int64)) * v.element_size()
            for v in list(self.data.values()) + list(self.sideband.values())
        )

    def fp32_equiv_bytes(self) -> int:
        """What the same table would take stored raw."""
        n = 0
        for k, leaf in self.data.items():
            item = self._out.itemsize if self.is_encoded(k) else leaf.element_size()
            n += int(np.prod(leaf.shape, dtype=np.int64)) * item
        return n

    def bytes_saved(self) -> int:
        return self.fp32_equiv_bytes() - self.host_bytes()
