"""DLRM (Naumov et al. 2019), the paper's evaluation model, trained and
served through the frequency-aware cache (port of the single-arena part of
``repro.models.dlrm``).

Paper §5.1 configuration: embedding dim 128 for every table, bottom MLP
512-256-128 over 13 dense features, dot-product feature interaction, top MLP
1024-1024-512-256-1, SGD with a constant learning rate.

Placement: with ``device_budget_bytes=None`` every sparse field is GROUPED
into one shared cache arena (the paper's one-big-table layout); with
``model_shards`` > 0 that arena is split over shards (hybrid parallel,
``core.sharded``).  With a budget, the ``PlacementPlanner`` makes the
small tables DEVICE and gives each large one its own CACHED slab.  The
arena is fp32 or frequency-tiered (``arena_precision`` fp16 / int8 /
auto), the host tier fp32 or encoded (``host_precision`` fp16 / int8 /
auto).  ``DLRM(cfg, mesh=)`` puts one shard in this process (hybrid
parallel over ranks, ``dist.mesh``; with a budget, one shard of each
cached slab and the DEVICE tables whole); the MLPs are replicas, made the
same on every rank by a broadcast from rank 0 over the world, and
``cfg.batch_size`` is the global batch (a data replica feeds ``1 /
data`` of it).  ``use_pallas_plan`` and ``chunk_rows`` reach every cached slab
(the reference sets them on the shared arena only; each is bit-identical
either way).  The
model computes in fp32; float32 matmuls run in full fp32 (``allow_tf32``
stays False).  ``train_step`` / ``plan_step`` / ``apply_step`` / ``compute_step``
come from :class:`~repro_torch.models.common.CollectionModelMixin`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collection as col
from repro_torch.core.policies import Policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.mesh import HybridMesh
from repro_torch.models import common
from repro_torch.nn.layers import Dtypes, mlp, mlp_init
from repro_torch.optim import optimizers as opt_lib

__all__ = ["DLRMConfig", "DLRM"]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: Tuple[int, ...]  # 26 sparse features (Criteo)
    n_dense: int = 13
    embed_dim: int = 128
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256)
    batch_size: int = 16384
    cache_ratio: float = 0.015
    buffer_rows: int = 65536
    max_unique_per_step: int = 0
    lr: float = 1.0  # paper: 1.0 (Criteo)
    policy: Optional[Policy] = None  # None -> FREQ_LFU
    dtypes: Dtypes = Dtypes(param=torch.float32, compute=torch.float32)
    use_pallas_plan: bool = False  # bounded top-K victim selection (the kernel)
    chunk_rows: int = 0  # host-side staging in whole chunks (0 = rows)
    device_budget_bytes: Optional[int] = None  # None: the paper's single arena
    # host-tier codec of the cached slabs: fp32 (bit-exact), fp16, int8
    # (row-wise scale / zero point) or auto (PrecisionPolicy from the counts)
    host_precision: str = "fp32"
    # device-arena codec: fp32 keeps the raw arena; fp16/int8 tier it (the
    # hot head stays fp32, the cold resident tail is stored encoded); auto
    # lets PrecisionPolicy pick from the head's coverage
    arena_precision: str = "fp32"
    arena_head_ratio: float = 0.25  # fp32 head share of a tiered arena
    # 0: one collection; S >= 1: hybrid parallel, the cached slab split over
    # S shards (each its own arena and host-table slice; on one card the
    # stacked [S, ...] layout)
    model_shards: int = 0
    replicate_top_k: int = 0  # sharded: K hottest ranks in a replicated arena
    exchange_codec: str = "fp32"  # sharded: row-leg wire codec (fp32 / fp16 / int8)
    max_routed_per_shard: int = 0  # sharded: per-shard plan width bound (0 = full width)

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


class DLRM(common.CollectionModelMixin):
    def __init__(self, cfg: DLRMConfig, mesh: Optional[HybridMesh] = None):
        self.cfg = cfg
        if mesh is not None and cfg.model_shards < 1:
            raise ValueError("a mesh holds shards of a sharded DLRM: set model_shards")
        self.mesh = mesh
        f = cfg.n_sparse + 1  # embeddings + bottom-MLP output
        self.top_in = cfg.embed_dim + f * (f - 1) // 2
        self.optimizer = opt_lib.sgd(cfg.lr)
        self.feature_names = tuple(f"f{i}" for i in range(cfg.n_sparse))
        policy = cfg.policy or Policy.FREQ_LFU
        tables = [
            col.TableConfig(
                name=n, vocab=v, dim=cfg.embed_dim, ids_per_step=cfg.batch_size,
                cache_ratio=cfg.cache_ratio, policy=policy, buffer_rows=cfg.buffer_rows,
                max_unique_per_step=cfg.max_unique_per_step, dtype=cfg.dtypes.param,
                use_pallas_plan=cfg.use_pallas_plan, chunk_rows=cfg.chunk_rows,
            )
            for n, v in zip(self.feature_names, cfg.vocab_sizes)
        ]
        arena_kw = dict(
            budget_bytes=cfg.device_budget_bytes,
            host_precision=cfg.host_precision,
            cache_ratio=cfg.cache_ratio,
            policy=policy,
            buffer_rows=cfg.buffer_rows,
            max_unique_per_step=cfg.max_unique_per_step,
            use_pallas_plan=cfg.use_pallas_plan,
            chunk_rows=cfg.chunk_rows,
            arena_precision=cfg.arena_precision,
            arena_head_ratio=cfg.arena_head_ratio,
        )
        if cfg.model_shards > 0:
            from repro_torch.core.sharded import ShardedEmbeddingCollection

            self.collection = ShardedEmbeddingCollection.create(
                tables, num_shards=cfg.model_shards, replicate_top_k=cfg.replicate_top_k,
                exchange_codec=cfg.exchange_codec,
                max_routed_per_shard=cfg.max_routed_per_shard, mesh=mesh, **arena_kw,
            )
        else:
            self.collection = col.EmbeddingCollection.create(tables, **arena_kw)

    # ----- params ----------------------------------------------------------
    def init(
        self, seed: int, counts: Optional[np.ndarray] = None, device: DeviceLike = None
    ) -> Dict[str, Any]:
        """Random weights from ``seed`` (the MLPs from ``seed``, the table
        from ``seed + 1``) on ``device`` (the CUDA card unless told
        otherwise; no silent CPU fallback).  Under a mesh the MLPs are
        rank 0's on every rank of the world."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = {
            "bottom": mlp_init(gen, (cfg.n_dense,) + cfg.bottom_mlp, cfg.dtypes, dev),
            "top": mlp_init(gen, (self.top_in,) + cfg.top_mlp + (1,), cfg.dtypes, dev),
        }
        if self.mesh is not None:
            from repro_torch.dist import exchange

            opt_lib.tree_map(lambda p: exchange.broadcast_(p, self.mesh), params)
        by_table = (self.collection.split_concat_counts(np.asarray(counts))
                    if counts is not None else None)
        emb = self.collection.init(int(seed) + 1, counts=by_table, device=dev)
        return {
            "params": params,
            "opt": self.optimizer.init(params),
            "emb": emb,
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def state_specs(self) -> Dict[str, Any]:
        """The partition specs of the state's sharded part (``emb``; every
        other leaf replicates), for a checkpoint under a mesh."""
        return {"emb": self.collection.shard_specs()} if self.cfg.model_shards > 0 else {}

    def features(self, batch) -> col.FeatureBatch:
        return col.FeatureBatch.from_onehot(self.feature_names, batch["sparse"])

    def flush(self, state):
        """Cache barrier (pre-checkpoint): the host table becomes authoritative."""
        return common.flush_embeddings(self.collection, state)

    # ----- forward ----------------------------------------------------------
    def interact(self, dense_vec: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """Dot-product interaction: pairwise dots of [dense_vec] + embeddings,
        upper triangle in row-major order (as ``jnp.triu_indices(f, k=1)``)."""
        z = torch.cat([dense_vec[:, None, :], emb], dim=1)  # [B, F+1, D]
        zz = torch.bmm(z, z.transpose(1, 2))
        f = z.shape[1]
        iu, ju = torch.triu_indices(f, f, 1, device=z.device)
        return zz[:, iu, ju]  # [B, F*(F-1)/2]

    def fwd(self, params, rows: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        cfg = self.cfg
        emb = torch.stack([rows[n] for n in self.feature_names], dim=1)  # [B, F, D]
        dense_vec = mlp(params["bottom"], batch["dense"].to(cfg.dtypes.compute), cfg.dtypes,
                        final_act=True)
        x = torch.cat([dense_vec, self.interact(dense_vec, emb)], dim=-1)
        return mlp(params["top"], x, cfg.dtypes)[:, 0]

    def serve_step(self, state, batch):
        """Inference: the cache read path without writeback."""
        emb_state, _, rows = self.collection.lookup(state["emb"], self.features(batch), writeback=False)
        return self.fwd(state["params"], rows, batch), emb_state
