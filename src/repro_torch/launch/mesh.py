"""The hybrid-parallel mesh of the initialised world (port of
``repro.launch.mesh.make_hybrid_mesh``).

The reference lays a ``(data, model)`` ``jax.sharding.Mesh`` over devices;
the port's mesh (``dist.mesh.HybridMesh``) is over processes, one cache
shard a rank.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.dist.mesh import HybridMesh, check_mesh_shape

__all__ = ["make_hybrid_mesh"]


def make_hybrid_mesh(model_shards: int, n_ranks: Optional[int] = None) -> HybridMesh:
    """The ``(data, model)`` mesh of the initialised process group
    (``dist.group.init_ranks``): ``model`` gets exactly ``model_shards``
    ranks.  ``n_ranks`` defaults to the world size and must equal it."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs an initialised process group "
                           "(repro_torch.dist.group.init_ranks); HybridMesh.coordinate "
                           "builds a mesh without one")
    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    check_mesh_shape(model_shards, n)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: the model axis spans "
                         f"the whole world")
    return HybridMesh(data=1, model=int(model_shards), rank=dist.get_rank(),
                      group=dist.group.WORLD, backend=dist.get_backend())
