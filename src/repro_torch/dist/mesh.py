"""The hybrid-parallel mesh over ``torch.distributed`` ranks: a rank's
place in it and the traffic its exchange sends (``launch.mesh.
make_hybrid_mesh`` builds one over the initialised world).

The reference lays a ``(data, model)`` ``jax.sharding.Mesh`` over devices:
``model`` takes exactly the shard count of a ``ShardedEmbeddingCollection``
(one shard of the stacked state per device), ``data`` the rest.  The port's
mesh is over processes: rank ``r`` sits at ``(r // model, r % model)``, holds
shard ``r % model`` of every cached slab and talks to the other shards over
the process group of its model axis.

This slice runs ``data == 1`` only: every rank sees the whole batch, owns
one shard and computes the dense part as a replica.  ``data > 1`` (each
replica of a shard planning on the global ids, the dense gradients
all-reduced) is ROADMAP item 13b and raises here.

A mesh can also be a coordinate alone (``HybridMesh.coordinate``), with no
process group: a rank's ``init`` and the tests build states with it.  Such
a mesh exchanges nothing, so it runs a collection only at ``model == 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["ITEM_13B", "HybridMesh", "Traffic", "check_mesh_shape"]

ITEM_13B = "ROADMAP item 13b"


@dataclasses.dataclass
class Traffic:
    """What the exchange put on the wire: collectives issued, the bytes this
    rank sent to the other ranks, and the host seconds spent in the calls."""

    collectives: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.collectives, self.bytes_sent, self.seconds = 0, 0, 0.0


@dataclasses.dataclass
class HybridMesh:
    """One rank's place in the ``(data, model)`` mesh."""

    data: int
    model: int
    rank: int  # the global rank
    group: Optional[Any] = None  # the model axis' process group (None: a coordinate alone)
    backend: Optional[str] = None
    traffic: Traffic = dataclasses.field(default_factory=Traffic)

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> Tuple[int, int]:
        """``(data_rank, model_rank)``."""
        return divmod(self.rank, self.model)

    @property
    def model_rank(self) -> int:
        """The shard this rank holds."""
        return self.rank % self.model

    @classmethod
    def coordinate(cls, model_shards: int, model_rank: int) -> "HybridMesh":
        """The mesh of shard ``model_rank`` of ``model_shards``, with no
        process group."""
        check_mesh_shape(model_shards, model_shards)
        if not 0 <= model_rank < model_shards:
            raise ValueError(f"model rank {model_rank} outside the {model_shards} shards")
        return cls(data=1, model=model_shards, rank=model_rank)


def check_mesh_shape(model_shards: int, n_ranks: int) -> None:
    """Refuse a world that does not split into ``model_shards`` shards (as
    the reference does), and ``data > 1`` (item 13b)."""
    if model_shards < 1 or n_ranks < 1 or n_ranks % model_shards:
        raise ValueError(f"{n_ranks} ranks not divisible into model={model_shards} shards")
    if n_ranks // model_shards > 1:
        raise ValueError(
            f"{n_ranks} ranks over model={model_shards} shards make data="
            f"{n_ranks // model_shards} replicas of each shard; data > 1 (every replica "
            f"planning on the global ids, the dense gradients all-reduced) waits for {ITEM_13B}")
