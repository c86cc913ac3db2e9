"""Recsys models served and trained through the frequency-aware cache (port
of the FM part of ``repro.models.recsys_models``; DIN, DIEN and MIND come in
a later slice).  ``FMModel.retrieval_score`` scores one user against a set
of candidates of the last field.

FM (Rendle ICDM'10): one table per field, every table GROUPED into one
shared cache arena (the paper's concatenated-table layout).  A table row
is ``embed_dim + 1`` wide: columns ``[0:embed_dim]`` are the factors,
column ``embed_dim`` the linear weight, so one cache tier moves both
together.  Batch schema: ``sparse [B, fields]`` int32, ``label [B]``.

``FMConfig.use_pallas`` routes the interaction through the FM kernel, which
has no backward (nor has the reference's Pallas kernel): serve with it,
train without it (``train_step`` with it raises).  ``train_step`` /
``plan_step`` / ``apply_step`` / ``compute_step`` come from
:class:`~repro_torch.models.common.CollectionModelMixin`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collection as col
from repro_torch.core.policies import Policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.nn import recsys as R
from repro_torch.optim import optimizers as opt_lib

__all__ = ["FMConfig", "FMModel"]


@dataclasses.dataclass(frozen=True)
class FMConfig:
    vocab_sizes: Tuple[int, ...]  # one table per field
    embed_dim: int = 10
    batch_size: int = 65536
    cache_ratio: float = 0.015
    max_unique_per_step: int = 0
    lr: float = 0.05
    use_pallas: bool = False  # the FM kernel (serving only: no backward)
    emb_dtype: torch.dtype = torch.float32
    protect_via_inverse: bool = True
    buffer_rows: int = 65536
    host_precision: str = "fp32"  # host-tier codec (fp32 / fp16 / int8 / auto)
    arena_precision: str = "fp32"  # device-arena tail codec (fp32 / fp16 / int8 / auto)
    arena_head_ratio: float = 0.25  # fp32 head share of a tiered arena
    use_pallas_plan: bool = False  # bounded top-K victim selection (the kernel)
    chunk_rows: int = 0  # host-side staging in whole chunks (0 = rows)
    policy: Optional[Policy] = None  # None -> FREQ_LFU


class FMModel(common.CollectionModelMixin):
    def __init__(self, cfg: FMConfig):
        self.cfg = cfg
        self.optimizer = opt_lib.sgd(cfg.lr)
        self.feature_names = tuple(f"f{i}" for i in range(len(cfg.vocab_sizes)))
        tables = [
            col.TableConfig(name=n, vocab=v, dim=cfg.embed_dim + 1,
                            ids_per_step=cfg.batch_size, dtype=cfg.emb_dtype)
            for n, v in zip(self.feature_names, cfg.vocab_sizes)
        ]
        self.collection = col.EmbeddingCollection.create(
            tables,
            cache_ratio=cfg.cache_ratio,
            max_unique_per_step=cfg.max_unique_per_step,
            protect_via_inverse=cfg.protect_via_inverse,
            buffer_rows=cfg.buffer_rows,
            host_precision=cfg.host_precision,
            arena_precision=cfg.arena_precision,
            arena_head_ratio=cfg.arena_head_ratio,
            use_pallas_plan=cfg.use_pallas_plan,
            chunk_rows=cfg.chunk_rows,
            policy=cfg.policy or Policy.FREQ_LFU,
        )

    def init(
        self, seed: int, counts: Optional[np.ndarray] = None, device: DeviceLike = None
    ) -> Dict[str, Any]:
        """A zero bias and a host table of random rows drawn from ``seed``,
        with the arena on ``device`` (the CUDA card unless told otherwise;
        no silent CPU fallback)."""
        dev = resolve_device(device)
        params = {"bias": torch.zeros((), dtype=torch.float32, device=dev)}
        by_table = (self.collection.split_concat_counts(np.asarray(counts))
                    if counts is not None else None)
        emb = self.collection.init(int(seed), counts=by_table, device=dev)
        return {"params": params, "opt": self.optimizer.init(params), "emb": emb,
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def features(self, batch) -> col.FeatureBatch:
        names = self.feature_names[: batch["sparse"].shape[1]]
        return col.FeatureBatch.from_onehot(names, batch["sparse"])

    def flush(self, state):
        """Cache barrier (pre-checkpoint): the host table becomes authoritative."""
        return common.flush_embeddings(self.collection, state)

    def fwd(self, params, rows: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        c = self.cfg
        names = self.feature_names[: batch["sparse"].shape[1]]
        stacked = torch.stack([rows[n] for n in names], dim=1)  # [B, F, D+1]
        v, w = stacked[..., : c.embed_dim], stacked[..., c.embed_dim]
        return params["bias"] + w.sum(-1) + R.fm_interaction(v, use_pallas=c.use_pallas)

    def serve_step(self, state, batch):
        """Inference: the cache read path without writeback."""
        emb_state, _, rows = self.collection.lookup(
            state["emb"], self.features(batch), writeback=False
        )
        return self.fwd(state["params"], rows, batch), emb_state

    def retrieval_score(self, state, batch):
        """One user's context fields (``sparse [1, fields - 1]``) against
        ``candidates [n]`` local ids of the last field: the context rows
        through the cache (read-only), the candidates' rows straight from
        their authoritative tier (``full_lookup``, a bulk scan past the
        cache bookkeeping), then the FM terms that involve the candidate
        plus the context-only terms, in torch ops.  Returns ``(scores [n],
        emb_state)``."""
        c = self.cfg
        ctx = batch["sparse"]
        emb_state, _, rows = self.collection.lookup(state["emb"], self.features(batch),
                                                    writeback=False)
        ctx_rows = torch.stack([rows[n][0] for n in self.feature_names[: ctx.shape[1]]])
        vc, wc = ctx_rows[:, : c.embed_dim], ctx_rows[:, c.embed_dim]
        cand = self.collection.full_lookup(emb_state, self.feature_names[-1], batch["candidates"])
        vk, wk = cand[:, : c.embed_dim], cand[:, c.embed_dim]
        s_ctx = vc.sum(0)
        ctx_pair = 0.5 * ((s_ctx * s_ctx).sum() - (vc * vc).sum())
        scores = state["params"]["bias"] + wc.sum() + ctx_pair + wk + vk @ s_ctx
        return scores, emb_state

    def input_specs(self, batch_size: int, n_candidates: int = 0) -> Dict[str, torch.Tensor]:
        """Shape and dtype of each batch field, as ``meta`` tensors; with
        ``n_candidates``, the retrieval batch (one user's context fields and
        the candidates of the last field)."""
        n = len(self.cfg.vocab_sizes)
        if n_candidates:
            return {
                "sparse": torch.empty((1, n - 1), dtype=torch.int32, device="meta"),
                "candidates": torch.empty((n_candidates,), dtype=torch.int32, device="meta"),
            }
        return {
            "sparse": torch.empty((batch_size, n), dtype=torch.int32, device="meta"),
            "label": torch.empty((batch_size,), dtype=torch.float32, device="meta"),
        }
