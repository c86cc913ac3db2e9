"""The hybrid-parallel mesh over ``torch.distributed`` ranks: a rank's
place in it and the traffic its exchange sends (``launch.mesh.
make_hybrid_mesh`` builds one over the initialised world).

The reference lays a ``(data, model)`` ``jax.sharding.Mesh`` over devices:
``model`` takes exactly the shard count of a ``ShardedEmbeddingCollection``
(one shard of the stacked state per device), ``data`` the rest.  The port's
mesh is over processes: rank ``r`` sits at ``(r // model, r % model)``,
holds shard ``r % model`` of every cached slab and talks to two process
groups:

* ``group``, the model group of its data replica (ranks ``d * model ...
  d * model + model - 1``): the shards exchange slots and rows over it;
* ``data_group``, the data group of its shard (ranks ``s, s + model,
  ...``): the ``data`` replicas of one shard gather the batch's ids and
  sum their gradients over it (None when ``data == 1``).

Each data replica holds ``1 / data`` of the global batch; every replica of
a shard plans on the global ids, so the replicas keep equal copies of the
shard.

A mesh can also be a coordinate alone (``HybridMesh.coordinate``), with no
process group: a rank's ``init`` and the tests build states with it.  Such
a mesh exchanges nothing, so it runs a collection only at ``model == 1``
and ``data == 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["HybridMesh", "Traffic", "check_mesh_shape"]


@dataclasses.dataclass
class Traffic:
    """What the exchange put on the wire, by axis: collectives made, the
    bytes this rank sent to the other ranks and the host seconds spent in
    the calls over the model group (``collectives`` / ``bytes_sent`` /
    ``seconds``) and over the data group (``data_*``); ``legs`` splits the
    bytes sent by leg (``slot``, ``row``, ``counters``, ``ids``, ``grads``,
    ...) and ``parts`` names parts of a leg's bytes (``grads.device``, the
    DEVICE tables' rows in ``grads``), counted in their leg too."""

    collectives: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0
    data_collectives: int = 0
    data_bytes_sent: int = 0
    data_seconds: float = 0.0
    legs: Dict[str, int] = dataclasses.field(default_factory=dict)
    parts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.collectives, self.bytes_sent, self.seconds = 0, 0, 0.0
        self.data_collectives, self.data_bytes_sent, self.data_seconds = 0, 0, 0.0
        self.legs, self.parts = {}, {}

    def part(self, name: str, nbytes: int) -> None:
        """``nbytes`` of a leg already counted, named ``name``."""
        self.parts[name] = self.parts.get(name, 0) + nbytes

    def add(self, leg: str, nbytes: int, seconds: float, data: bool = False) -> None:
        """One collective of ``leg`` that sent ``nbytes`` from this rank."""
        if data:
            self.data_collectives += 1
            self.data_bytes_sent += nbytes
            self.data_seconds += seconds
        else:
            self.collectives += 1
            self.bytes_sent += nbytes
            self.seconds += seconds
        self.legs[leg] = self.legs.get(leg, 0) + nbytes


@dataclasses.dataclass
class HybridMesh:
    """One rank's place in the ``(data, model)`` mesh."""

    data: int
    model: int
    rank: int  # the global rank
    group: Optional[Any] = None  # the model group of this data replica (None: a coordinate)
    backend: Optional[str] = None
    traffic: Traffic = dataclasses.field(default_factory=Traffic)
    data_group: Optional[Any] = None  # the data group of this shard (None at data == 1)

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

    @property
    def data_rank(self) -> int:
        """This rank's data replica: it holds rows ``[data_rank * B / data,
        (data_rank + 1) * B / data)`` of a global batch of ``B``."""
        return self.rank // self.model

    def data_slice(self, t):
        """This replica's rows ``[data_rank * B / data, (data_rank + 1) * B /
        data)`` of a global ``[B, ...]`` tensor or array (the whole of it at
        ``data == 1``)."""
        if self.data == 1:
            return t
        n = t.shape[0]
        if n % self.data:
            raise ValueError(f"a global batch of {n} rows does not split over data={self.data} "
                             f"replicas")
        b = n // self.data
        return t[self.data_rank * b : (self.data_rank + 1) * b]

    @classmethod
    def coordinate(cls, model_shards: int, model_rank: int, data_rank: int = 0,
                   data: Optional[int] = None) -> "HybridMesh":
        """The mesh of shard ``model_rank`` of ``model_shards`` in data
        replica ``data_rank`` of ``data`` (default ``data_rank + 1``), with
        no process group."""
        data = data_rank + 1 if data is None else int(data)
        check_mesh_shape(model_shards, model_shards * data)
        if not 0 <= model_rank < model_shards:
            raise ValueError(f"model rank {model_rank} outside the {model_shards} shards")
        if not 0 <= data_rank < data:
            raise ValueError(f"data rank {data_rank} outside the {data} replicas")
        return cls(data=data, model=model_shards, rank=data_rank * model_shards + model_rank)


def check_mesh_shape(model_shards: int, n_ranks: int) -> None:
    """Refuse a world that does not split into ``model_shards`` shards, as
    the reference does; the rest of the ranks are ``n_ranks //
    model_shards`` data replicas."""
    if model_shards < 1 or n_ranks < 1 or n_ranks % model_shards:
        raise ValueError(f"{n_ranks} ranks not divisible into model={model_shards} shards")
