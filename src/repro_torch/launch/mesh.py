"""The hybrid-parallel mesh of the initialised world (port of
``repro.launch.mesh.make_hybrid_mesh``).

The reference lays a ``(data, model)`` ``jax.sharding.Mesh`` over devices;
the port's mesh (``dist.mesh.HybridMesh``) is over processes, one cache
shard a rank, ``data = world // model_shards`` replicas of each shard.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.dist.mesh import HybridMesh, check_mesh_shape

__all__ = ["make_hybrid_mesh"]


def make_hybrid_mesh(model_shards: int, n_ranks: Optional[int] = None) -> HybridMesh:
    """The ``(data, model)`` mesh of the initialised process group
    (``dist.group.init_ranks``): ``model`` gets exactly ``model_shards``
    ranks and ``data`` the rest.  ``n_ranks`` defaults to the world size
    and must equal it.

    At ``data == 1`` the model group is the world.  Else every rank
    creates every group (``new_group`` is a collective of the world), in
    one fixed order: the ``data`` model groups (ranks ``d * S ... d * S +
    S - 1``), then the ``S`` data groups (ranks ``s, s + S, ...``); each
    rank keeps its own two."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs an initialised process group "
                           "(repro_torch.dist.group.init_ranks); HybridMesh.coordinate "
                           "builds a mesh without one")
    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    check_mesh_shape(model_shards, n)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: the mesh spans the "
                         f"whole world")
    S = int(model_shards)
    D = world // S
    mesh = HybridMesh(data=D, model=S, rank=dist.get_rank(), group=dist.group.WORLD,
                      backend=dist.get_backend())
    if D > 1:
        d, s = mesh.coords
        model_groups = [dist.new_group(list(range(i * S, (i + 1) * S))) for i in range(D)]
        data_groups = [dist.new_group(list(range(j, world, S))) for j in range(S)]
        mesh.group, mesh.data_group = model_groups[d], data_groups[s]
    return mesh
