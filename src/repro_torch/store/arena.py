"""``ArenaStore``: the frequency-tiered device cache arena (port of
``repro.store.arena``).

The same device-memory budget holds 2-4x more resident rows when only the
hot head of the arena stays fp32 and the colder resident tail is stored
encoded ("Mixed-Precision Embedding Using a Cache", arXiv 2010.11305):

* slots ``[0, head_capacity)`` — the fp32 ``head``: raw rows, bit-exact,
  updated by SGD as they are;
* slots ``[head_capacity, capacity)`` — the encoded ``tail`` (fp16, or
  row-wise int8 with its ``[tail, 2]`` ``(scale, zp)`` ``sideband``).

Warm-up fills slot i with frequency rank i and FREQ_LFU's eviction key is
the resident rank, so hot rows gravitate to the head and cold residents to
the tail without extra bookkeeping.  Leaves the codec does not transform
(per-row scalars, integer leaves) stay ``raw`` at full capacity.

Unlike the functional reference, :meth:`ArenaStore.scatter_slots` and
:meth:`ArenaStore.replace_leaf` update the store's tensors in place (with
no host sync) and return the store.  Row reads go through
``kernels.cache_ops.ops.arena_gather_impl``: the hand-written CUDA
gather + decode on the card, its plain torch version on the CPU; a
write-back into an encoded host tier reads through
``arena_gather_encode_impl``, the same kernel's entry that encodes for the
host in the same launch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lanes import scatter_rows_, take_fill
from repro_torch.kernels.cache_ops import ops as cache_ops
from repro_torch.store.codec import Codec, as_dtype, get_codec

__all__ = ["ArenaStore", "tiered_arena_bytes"]


def tiered_arena_bytes(
    capacity: int, head_capacity: int, dim: int, dtype: torch.dtype, codec: str
) -> int:
    """Device footprint of one tiered weight leaf: fp32 head rows + encoded
    tail payload + tail sideband (``codec="fp32"``: the raw arena)."""
    if codec == "fp32":
        return capacity * dim * dtype.itemsize
    head = min(max(int(head_capacity), 0), int(capacity))
    tail = int(capacity) - head
    return head * dim * dtype.itemsize + tail * get_codec(codec).row_bytes((dim,), dtype)


@dataclasses.dataclass
class ArenaStore:
    """Tiered fast-tier container (see the module docstring)."""

    head: Dict[str, torch.Tensor]  # [head_capacity, dim] fp32 rows
    tail: Dict[str, torch.Tensor]  # [capacity - head_capacity, dim] payload
    sideband: Dict[str, torch.Tensor]  # [tail, 2] (scale, zp) per int8 tail row
    raw: Dict[str, torch.Tensor]  # untransformed leaves, [capacity, ...]
    codec: str = "fp16"
    out_dtype: str = "float32"

    # ----- construction -----------------------------------------------------

    @staticmethod
    def _tiers(codec: Codec, leaf: torch.Tensor) -> bool:
        """Only per-row vectors ([slots, dim]) are tiered."""
        return codec.encodes(leaf) and leaf.dim() == 2

    @classmethod
    def create(
        cls, full_tree: Dict[str, torch.Tensor], head_capacity: int, codec: str
    ) -> "ArenaStore":
        """Split a raw ``[capacity, ...]`` arena dict into head + encoded tail."""
        if codec == "fp32":
            raise ValueError("ArenaStore is the tiered container; an fp32 arena stays a raw dict")
        c = get_codec(codec)
        dts = {str(v.dtype).removeprefix("torch.") for v in full_tree.values() if cls._tiers(c, v)}
        if len(dts) != 1:
            raise ValueError(
                f"ArenaStore needs per-row vector leaves of one dtype, got {sorted(dts)}"
            )
        head, tail, sideband, raw = {}, {}, {}, {}
        for k, leaf in full_tree.items():
            if cls._tiers(c, leaf):
                h = min(max(int(head_capacity), 0), int(leaf.shape[0]))
                head[k] = leaf[:h].clone()
                payload, side = c.encode(leaf[h:])
                tail[k] = payload.contiguous()
                if side is not None:
                    sideband[k] = side.contiguous()
            else:
                raw[k] = leaf
        return cls(head=head, tail=tail, sideband=sideband, raw=raw, codec=codec,
                   out_dtype=dts.pop())

    # ----- geometry ---------------------------------------------------------

    @property
    def head_capacity(self) -> int:
        """Slots below this index are fp32."""
        return int(next(iter(self.head.values())).shape[-2])

    @property
    def capacity(self) -> int:
        return self.head_capacity + int(next(iter(self.tail.values())).shape[-2])

    @property
    def _codec(self) -> Codec:
        return get_codec(self.codec)

    @property
    def _out(self) -> torch.dtype:
        return as_dtype(self.out_dtype)

    # ----- slot ops (the transmitter's gather/scatter surface) --------------

    def gather_slots(self, slots: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Decoded rows at ``slots`` (int32 [K]); negative / OOB lanes give
        zero rows.  Head lanes are exact reads, tail lanes decode payload +
        sideband (the gather-decode kernel on the card)."""
        out = {
            k: cache_ops.arena_gather_impl(hleaf, self.tail[k], self.sideband.get(k), slots,
                                           self.codec)
            for k, hleaf in self.head.items()
        }
        for k, leaf in self.raw.items():
            out[k] = take_fill(leaf, slots, 0)
        return out

    def gather_encoded_slots(
        self, slots: torch.Tensor, host_codec: str
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """:meth:`gather_slots` for a write-back into a host tier of
        ``host_codec`` (fp16 / int8): each head leaf comes back as that tier
        stores it, its payload and its sideband, from one
        gather-decode-encode launch on the card (no fp32 rows in between).
        Returns ``(rows of the raw leaves, payload, sideband)``."""
        payload: Dict[str, torch.Tensor] = {}
        side: Dict[str, torch.Tensor] = {}
        for k, hleaf in self.head.items():
            payload[k], s = cache_ops.arena_gather_encode_impl(
                hleaf, self.tail[k], self.sideband.get(k), slots, self.codec, host_codec)
            if s is not None:
                side[k] = s
        rows = {k: take_fill(leaf, slots, 0) for k, leaf in self.raw.items()}
        return rows, payload, side

    def scatter_slots(
        self,
        slots: torch.Tensor,
        block: Dict[str, torch.Tensor],
        active: Optional[torch.Tensor] = None,
        payload_block: Optional[Dict[str, torch.Tensor]] = None,
        side_block: Optional[Dict[str, torch.Tensor]] = None,
    ) -> "ArenaStore":
        """In place: full-precision ``block`` rows land at ``slots`` where
        ``active`` holds (unique slots there): head lanes raw, tail lanes
        encoded on the device first.  OOB lanes are dropped.  When the rows
        came from a host store of this codec, ``payload_block`` /
        ``side_block`` carry them still encoded and the tail lanes take
        those bits verbatim."""
        ok = (slots >= 0) & (slots < self.capacity)
        if active is not None:
            ok = ok & active
        h = self.head_capacity
        in_tail = slots >= h
        c = self._codec
        for k, hleaf in self.head.items():
            scatter_rows_([hleaf], slots, [block[k].to(hleaf.dtype)], ok & ~in_tail)
            if payload_block is not None and k in payload_block:
                payload, side = payload_block[k], (side_block or {}).get(k)
            else:
                payload, side = c.encode(block[k])
            leaves, blocks = [self.tail[k]], [payload.to(self.tail[k].dtype)]
            if k in self.sideband:
                leaves.append(self.sideband[k])
                blocks.append(side.to(self.sideband[k].dtype))
            scatter_rows_(leaves, slots - h, blocks, ok & in_tail)
        for k, leaf in self.raw.items():
            scatter_rows_([leaf], slots, [block[k].to(leaf.dtype)], ok)
        return self

    # ----- whole-leaf views (weights() / apply_grads surface) ---------------

    def decode_leaf(self, key: str) -> torch.Tensor:
        """The full decoded ``[capacity, dim]`` view of one leaf, by eager
        torch ops (what ``weights()`` hands the differentiable gather)."""
        if key in self.raw:
            return self.raw[key]
        tail = self._codec.decode(self.tail[key], self.sideband.get(key), self._out)
        return torch.cat([self.head[key].to(self._out), tail], dim=-2)

    def replace_leaf(self, key: str, full: torch.Tensor) -> "ArenaStore":
        """In place: set leaf ``key`` from a full decoded ``[..., capacity,
        dim]`` array (a sharded arena leads with its shard dim) — the head
        slice lands raw, the tail slice re-encodes with a fresh per-row
        scale.  Untouched rows re-encode to the identical payload (the
        codec's stable projection)."""
        if key in self.raw:
            self.raw[key].copy_(full)
            return self
        h = self.head_capacity
        self.head[key].copy_(full[..., :h, :])
        tail = full[..., h:, :]
        # a sharded arena stacks [S, slots, dim]: encode per row, not per shard
        payload, side = self._codec.encode(tail.reshape((-1,) + tuple(tail.shape[-1:])))
        self.tail[key].copy_(payload.reshape(tail.shape))
        if key in self.sideband:
            self.sideband[key].copy_(side.reshape(self.sideband[key].shape))
        return self

    # ----- accounting -------------------------------------------------------

    def device_bytes(self) -> int:
        """Device footprint of the container (all tiers + sideband)."""
        leaves = [*self.head.values(), *self.tail.values(), *self.sideband.values(),
                  *self.raw.values()]
        return sum(int(np.prod(v.shape, dtype=np.int64)) * v.element_size() for v in leaves)

    def fp32_equiv_bytes(self) -> int:
        """The raw-arena footprint of the same resident set."""
        n = sum(self.capacity * int(v.shape[-1]) * self._out.itemsize for v in self.head.values())
        return n + sum(int(np.prod(v.shape, dtype=np.int64)) * v.element_size()
                       for v in self.raw.values())
