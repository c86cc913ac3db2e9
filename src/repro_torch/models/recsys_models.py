"""Recsys models served and trained through the frequency-aware cache (port
of ``repro.models.recsys_models``): FM, DIN, DIEN and MIND.  Each declares
logical tables and the features that hit them, and every table is GROUPED
into one shared cache arena (the paper's concatenated-table layout).
``train_step`` / ``plan_step`` / ``apply_step`` / ``compute_step`` come from
:class:`~repro_torch.models.common.CollectionModelMixin`; ``init(seed,
counts=None, device=None)`` builds the state on ``device`` (the CUDA card
unless told otherwise; no silent CPU fallback).

Batch schemas (synthetic Criteo / Amazon / Taobao-like):
  FM:       sparse [B, fields] int32, label [B]
  DIN/DIEN: hist_items [B, T], hist_cates [B, T], hist_len [B], target_item [B],
            target_cate [B], user [B], label [B]
  MIND:     hist_items [B, T], hist_len [B], target_item [B], user [B], label [B]
History lanes past ``hist_len`` become -1 (padding: no cache traffic, zero rows).

FM (Rendle ICDM'10): one table per field.  A table row is ``embed_dim + 1``
wide: columns ``[0:embed_dim]`` are the factors, column ``embed_dim`` the
linear weight, so one cache tier moves both together.
``FMConfig.use_pallas`` routes the interaction through the FM kernel, which
has no backward (nor has the reference's Pallas kernel): serve with it,
train without it (``train_step`` with it raises).

DIN (arXiv:1706.06978) and DIEN (arXiv:1809.03672): tables items / cates /
users; the history and target features share the item and category tables
through ``feature_names``.  MIND (arXiv:1904.08030): items / users.  Their
attention, GRUs and capsules are torch ops (the reference has no kernel for
them); their plans go through the victim-threshold kernel with
``use_pallas_plan``.

``retrieval_score`` scores one user against a set of candidates: the user's
rows through the cache (read-only), the candidates' rows straight from
their authoritative tier (``full_lookup``, a bulk scan past the cache
bookkeeping).  The reference's sharding hooks (``constrain`` /
``split_params``) have no counterpart on one card.
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
from repro_torch.nn.layers import Dtypes, mlp, mlp_init
from repro_torch.optim import optimizers as opt_lib

__all__ = ["FMConfig", "FMModel", "DINConfig", "DINModel", "DIENConfig", "DIENModel", "MINDConfig",
           "MINDModel"]

F32 = Dtypes(param=torch.float32, compute=torch.float32)


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


# ===========================================================================
# DIN: target attention over behaviour history; tables items, categories and
# users (embed_dim 18 each), the history and target features sharing the
# item and category tables.
# ===========================================================================


def _arena_kw(cfg) -> Dict[str, Any]:
    return dict(cache_ratio=cfg.cache_ratio, max_unique_per_step=cfg.max_unique_per_step,
                host_precision=cfg.host_precision, arena_precision=cfg.arena_precision,
                arena_head_ratio=cfg.arena_head_ratio, use_pallas_plan=cfg.use_pallas_plan,
                chunk_rows=cfg.chunk_rows, policy=cfg.policy or Policy.FREQ_LFU)


def _hist_mask(batch, seq_len: int) -> torch.Tensor:
    """[B, T] bool: the first ``hist_len`` positions of each history."""
    hist_len = batch["hist_len"]
    return torch.arange(seq_len, device=hist_len.device)[None, :] < hist_len[:, None]


def _state(model, params, seed: int, counts, dev) -> Dict[str, Any]:
    """Params, optimizer state, the tables drawn from ``seed + 1`` and step 0."""
    by_table = (model.collection.split_concat_counts(np.asarray(counts))
                if counts is not None else None)
    emb = model.collection.init(int(seed) + 1, counts=by_table, device=dev)
    return {"params": params, "opt": model.optimizer.init(params), "emb": emb,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _zeros1(batch) -> torch.Tensor:
    return torch.zeros((1,), dtype=torch.int32, device=batch["hist_len"].device)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    """A batch field's shape and dtype, as a ``meta`` tensor."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class DINConfig:
    n_items: int = 10_000_000
    n_cates: int = 1_000_000
    n_users: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    batch_size: int = 65536
    cache_ratio: float = 0.015
    max_unique_per_step: int = 0
    lr: float = 0.05
    dtypes: Dtypes = F32
    host_precision: str = "fp32"  # host-tier codec (fp32 / fp16 / int8 / auto)
    arena_precision: str = "fp32"  # device-arena tail codec (fp32 / fp16 / int8 / auto)
    arena_head_ratio: float = 0.25  # fp32 head share of a tiered arena
    use_pallas_plan: bool = False  # bounded top-K victim selection (the kernel)
    chunk_rows: int = 0  # host-side staging in whole chunks (0 = rows)
    policy: Optional[Policy] = None  # None -> FREQ_LFU


class DINModel(common.CollectionModelMixin):
    def __init__(self, cfg: DINConfig):
        self.cfg = cfg
        self.optimizer = opt_lib.sgd(cfg.lr)
        lanes = cfg.batch_size * (cfg.seq_len + 1)
        tables = [
            col.TableConfig("items", cfg.n_items, cfg.embed_dim, lanes,
                            feature_names=("hist_items", "target_item")),
            col.TableConfig("cates", cfg.n_cates, cfg.embed_dim, lanes,
                            feature_names=("hist_cates", "target_cate")),
            col.TableConfig("users", cfg.n_users, cfg.embed_dim, cfg.batch_size,
                            feature_names=("user",)),
        ]
        self.collection = col.EmbeddingCollection.create(tables, **_arena_kw(cfg))

    @property
    def vocab_sizes(self) -> Tuple[int, ...]:
        c = self.cfg
        return (c.n_items, c.n_cates, c.n_users)

    def init(
        self, seed: int, counts: Optional[np.ndarray] = None, device: DeviceLike = None
    ) -> Dict[str, Any]:
        """The attention and top MLPs from ``seed``, the tables from
        ``seed + 1``, on ``device``."""
        c = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        d = c.embed_dim
        params = {
            "attn": R.din_attention_init(gen, 2 * d, c.attn_mlp, c.dtypes, dev),
            "mlp": mlp_init(gen, (d + 2 * (2 * d),) + c.mlp + (1,), c.dtypes, dev),
        }
        return _state(self, params, seed, counts, dev)

    def features(self, batch) -> col.FeatureBatch:
        mask = _hist_mask(batch, self.cfg.seq_len)
        ids = {
            "hist_items": torch.where(mask, batch["hist_items"], -1),
            "hist_cates": torch.where(mask, batch["hist_cates"], -1),
            "target_item": batch["target_item"],
            "target_cate": batch["target_cate"],
            "user": batch["user"],
        }
        return col.FeatureBatch(ids={k: v.to(torch.int32) for k, v in ids.items()})

    def flush(self, state):
        """Cache barrier (pre-checkpoint): the host table becomes authoritative."""
        return common.flush_embeddings(self.collection, state)

    def fwd(self, params, rows: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        c = self.cfg
        hist = torch.cat([rows["hist_items"], rows["hist_cates"]], dim=-1)  # [B, T, 2D]
        target = torch.cat([rows["target_item"], rows["target_cate"]], dim=-1)  # [B, 2D]
        mask = _hist_mask(batch, c.seq_len)
        pooled = R.din_attention(params["attn"], hist, target, mask, c.dtypes)  # [B, 2D]
        x = torch.cat([rows["user"], pooled, target], dim=-1)
        return mlp(params["mlp"], x, c.dtypes)[:, 0]

    def serve_step(self, state, batch):
        """Inference: the cache read path without writeback."""
        emb_state, _, rows = self.collection.lookup(
            state["emb"], self.features(batch), writeback=False
        )
        return self.fwd(state["params"], rows, batch), emb_state

    def _user_rows(self, state, batch):
        """One user's rows through the cache, read-only (a zero target)."""
        b1 = {k: v for k, v in batch.items() if k not in ("candidates", "candidate_cates")}
        b1.setdefault("target_item", _zeros1(batch))
        b1.setdefault("target_cate", _zeros1(batch))
        emb_state, _, rows = self.collection.lookup(state["emb"], self.features(b1),
                                                    writeback=False)
        hist = torch.cat([rows["hist_items"], rows["hist_cates"]], dim=-1)  # [1, T, 2D]
        return emb_state, rows, hist, _hist_mask(batch, self.cfg.seq_len)

    def _candidate_rows(self, emb_state, batch) -> torch.Tensor:
        ti = self.collection.full_lookup(emb_state, "items", batch["candidates"])
        tc = self.collection.full_lookup(emb_state, "cates", batch["candidate_cates"])
        return torch.cat([ti, tc], dim=-1)  # [N, 2D]

    def retrieval_score(self, state, batch):
        """One user's history (``[1, T]`` fields, ``hist_len [1]``, ``user
        [1]``) against ``candidates [N]`` items with ``candidate_cates
        [N]``: the user side broadcast over the candidates, then DIN's
        attention and MLP.  Returns ``(scores [N], emb_state)``."""
        c = self.cfg
        emb_state, rows, hist, mask = self._user_rows(state, batch)
        targets = self._candidate_rows(emb_state, batch)
        n = targets.shape[0]
        pooled = R.din_attention(state["params"]["attn"], hist.expand((n,) + hist.shape[1:]),
                                 targets, mask.expand(n, c.seq_len), c.dtypes)
        x = torch.cat([rows["user"].expand(n, c.embed_dim), pooled, targets], dim=-1)
        return mlp(state["params"]["mlp"], x, c.dtypes)[:, 0], emb_state

    def input_specs(self, batch_size: int, n_candidates: int = 0) -> Dict[str, torch.Tensor]:
        """Shape and dtype of each batch field, as ``meta`` tensors; with
        ``n_candidates``, the retrieval batch."""
        c = self.cfg
        base = {
            "hist_items": _meta((batch_size, c.seq_len)),
            "hist_cates": _meta((batch_size, c.seq_len)),
            "hist_len": _meta((batch_size,)),
            "target_item": _meta((batch_size,)),
            "target_cate": _meta((batch_size,)),
            "user": _meta((batch_size,)),
        }
        if n_candidates:
            del base["target_item"], base["target_cate"]
            base["candidates"] = _meta((n_candidates,))
            base["candidate_cates"] = _meta((n_candidates,))
            return base
        base["label"] = _meta((batch_size,), torch.float32)
        return base


# ===========================================================================
# DIEN: GRU interest extraction + AUGRU evolution over DIN's tables.
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class DIENConfig(DINConfig):
    gru_dim: int = 108


class DIENModel(DINModel):
    def init(
        self, seed: int, counts: Optional[np.ndarray] = None, device: DeviceLike = None
    ) -> Dict[str, Any]:
        """Both GRUs, the target projection and the top MLP from ``seed``,
        the tables from ``seed + 1``, on ``device``."""
        c: DIENConfig = self.cfg  # type: ignore[assignment]
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        d = c.embed_dim
        proj = torch.randn((2 * d, c.gru_dim), generator=gen, dtype=c.dtypes.param, device=dev)
        params = {
            "gru1": R.gru_init(gen, 2 * d, c.gru_dim, c.dtypes, dev),
            "gru2": R.gru_init(gen, c.gru_dim, c.gru_dim, c.dtypes, dev),
            "attn_proj": {"w": proj * (1.0 / np.sqrt(2 * d))},
            "mlp": mlp_init(gen, (d + 2 * d + c.gru_dim,) + c.mlp + (1,), c.dtypes, dev),
        }
        return _state(self, params, seed, counts, dev)

    def fwd(self, params, rows: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        c: DIENConfig = self.cfg  # type: ignore[assignment]
        hist = torch.cat([rows["hist_items"], rows["hist_cates"]], dim=-1)
        target = torch.cat([rows["target_item"], rows["target_cate"]], dim=-1)
        mask = _hist_mask(batch, c.seq_len)
        interest = R.gru(params["gru1"], hist, c.dtypes)  # [B, T, H]
        # attention of the target on the interest states
        tq = target @ params["attn_proj"]["w"].to(c.dtypes.compute)  # [B, H]
        att = torch.einsum("bh,bth->bt", tq, interest) / np.sqrt(c.gru_dim)
        att = torch.softmax(torch.where(mask, att, -1e30), dim=-1)
        att = torch.where(mask, att, 0.0)
        final = R.augru(params["gru2"], interest, att, c.dtypes)[:, -1]  # [B, H]
        x = torch.cat([rows["user"], target, final], dim=-1)
        return mlp(params["mlp"], x, c.dtypes)[:, 0]

    def retrieval_score(self, state, batch):
        """Bulk candidate scoring: GRU1's interest extraction runs once (it
        does not depend on the target) and each candidate is scored by its
        attention over those states; the AUGRU evolution is skipped, as in
        the reference (a per-candidate AUGRU is a ranking-stage cost)."""
        c: DIENConfig = self.cfg  # type: ignore[assignment]
        params = state["params"]
        emb_state, _, hist, mask = self._user_rows(state, batch)
        interest = R.gru(params["gru1"], hist, c.dtypes)[0]  # [T, H]
        targets = self._candidate_rows(emb_state, batch)
        tq = targets @ params["attn_proj"]["w"].to(c.dtypes.compute)  # [N, H]
        att = (tq @ interest.T) / np.sqrt(c.gru_dim)  # [N, T]
        att = torch.softmax(torch.where(mask[0][None, :], att, -1e30), dim=-1)
        pooled = att @ interest  # [N, H]
        return torch.einsum("nh,nh->n", tq, pooled), emb_state


# ===========================================================================
# MIND: multi-interest capsule routing over items / users.
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    n_items: int = 4_000_000
    n_users: int = 1_000_000
    embed_dim: int = 64
    seq_len: int = 100
    n_interests: int = 4
    capsule_iters: int = 3
    batch_size: int = 65536
    cache_ratio: float = 0.015
    max_unique_per_step: int = 0
    label_pow: float = 2.0  # label-aware attention sharpness
    lr: float = 0.05
    dtypes: Dtypes = F32
    host_precision: str = "fp32"  # host-tier codec (fp32 / fp16 / int8 / auto)
    arena_precision: str = "fp32"  # device-arena tail codec (fp32 / fp16 / int8 / auto)
    arena_head_ratio: float = 0.25  # fp32 head share of a tiered arena
    use_pallas_plan: bool = False  # bounded top-K victim selection (the kernel)
    chunk_rows: int = 0  # host-side staging in whole chunks (0 = rows)
    policy: Optional[Policy] = None  # None -> FREQ_LFU


class MINDModel(common.CollectionModelMixin):
    def __init__(self, cfg: MINDConfig):
        self.cfg = cfg
        self.optimizer = opt_lib.sgd(cfg.lr)
        tables = [
            col.TableConfig("items", cfg.n_items, cfg.embed_dim,
                            cfg.batch_size * (cfg.seq_len + 1),
                            feature_names=("hist_items", "target_item")),
            col.TableConfig("users", cfg.n_users, cfg.embed_dim, cfg.batch_size,
                            feature_names=("user",)),
        ]
        self.collection = col.EmbeddingCollection.create(tables, **_arena_kw(cfg))

    @property
    def vocab_sizes(self) -> Tuple[int, ...]:
        return (self.cfg.n_items, self.cfg.n_users)

    def init(
        self, seed: int, counts: Optional[np.ndarray] = None, device: DeviceLike = None
    ) -> Dict[str, Any]:
        """The bilinear map from ``seed``, the tables from ``seed + 1``, on
        ``device``."""
        c = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        s = torch.randn((c.embed_dim, c.embed_dim), generator=gen, dtype=torch.float32,
                        device=dev)
        return _state(self, {"s_matrix": s * (1.0 / np.sqrt(c.embed_dim))}, seed, counts, dev)

    def features(self, batch) -> col.FeatureBatch:
        mask = _hist_mask(batch, self.cfg.seq_len)
        ids = {
            "hist_items": torch.where(mask, batch["hist_items"], -1),
            "target_item": batch["target_item"],
            "user": batch["user"],
        }
        return col.FeatureBatch(ids={k: v.to(torch.int32) for k, v in ids.items()})

    def flush(self, state):
        """Cache barrier (pre-checkpoint): the host table becomes authoritative."""
        return common.flush_embeddings(self.collection, state)

    def interests(self, params, hist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return R.capsule_routing(hist, mask, params["s_matrix"].to(hist.dtype), c.n_interests,
                                 c.capsule_iters)  # [B, K, D]

    def fwd(self, params, rows: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        c = self.cfg
        hist, target, user = rows["hist_items"], rows["target_item"], rows["user"]
        caps = self.interests(params, hist, _hist_mask(batch, c.seq_len))  # [B, K, D]
        caps = caps + user[:, None, :] * 0.0  # the user takes part through its id only
        # label-aware attention: the interests weighted by target affinity^pow
        aff = torch.einsum("bkd,bd->bk", caps, target)
        w = torch.softmax(c.label_pow * aff, dim=-1)
        u = torch.einsum("bk,bkd->bd", w, caps)
        return torch.einsum("bd,bd->b", u, target)

    def serve_step(self, state, batch):
        """Inference: the cache read path without writeback."""
        emb_state, _, rows = self.collection.lookup(
            state["emb"], self.features(batch), writeback=False
        )
        return self.fwd(state["params"], rows, batch), emb_state

    def retrieval_score(self, state, batch):
        """One user's history against ``candidates [N]`` items: the best of
        the user's interests by dot product.  Returns ``(scores [N],
        emb_state)``."""
        c = self.cfg
        b1 = {k: v for k, v in batch.items() if k != "candidates"}
        b1["target_item"] = _zeros1(batch)
        emb_state, _, rows = self.collection.lookup(state["emb"], self.features(b1),
                                                    writeback=False)
        mask = _hist_mask(batch, c.seq_len)
        caps = self.interests(state["params"], rows["hist_items"], mask)[0]  # [K, D]
        cand = self.collection.full_lookup(emb_state, "items", batch["candidates"])  # [N, D]
        return torch.max(cand @ caps.T, dim=-1).values, emb_state

    def input_specs(self, batch_size: int, n_candidates: int = 0) -> Dict[str, torch.Tensor]:
        """Shape and dtype of each batch field, as ``meta`` tensors; with
        ``n_candidates``, the retrieval batch."""
        c = self.cfg
        base = {
            "hist_items": _meta((batch_size, c.seq_len)),
            "hist_len": _meta((batch_size,)),
            "user": _meta((batch_size,)),
        }
        if n_candidates:
            base["candidates"] = _meta((n_candidates,))
            return base
        base["target_item"] = _meta((batch_size,))
        base["label"] = _meta((batch_size,), torch.float32)
        return base
