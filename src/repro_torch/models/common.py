"""Shared model scaffolding (port of the collection part of
``repro.models.common``): losses, metrics, and the cached-embedding train
step (plan -> apply -> differentiable gather -> synchronous row update).

``EmbTrainStep`` is the single-arena step of the ``core.cached_embedding``
adapter: prepare outside the gradient, a gather of the cached weight
(padding lanes give zero rows), gradients to the dense parameters and the
cached weight, the optimizer, then ``apply_row_grads``.

``CollectionTrainStep`` is the reference's step, fused (``__call__``) and
split into the pipelined trainer's three stages: a ``FeatureBatch`` goes
through ``EmbeddingCollection.plan_prepare`` / ``apply_plan`` outside the
gradient, the loss is differentiated with ``torch.autograd`` w.r.t. the
dense parameters and ``collection.weights`` (the fast tier: each cached
slab's arena and each DEVICE table, marked as autograd leaves), the
optimizer steps the dense parameters, and ``apply_grads`` performs the
synchronous row update with each slab's dense gradient (``[capacity, dim]``
for an arena, ``[vocab, dim]`` for a DEVICE table).  The arena and the host table are updated in
place, so a state passed to a step must not be used again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.analysis.contracts import INT_COUNTERS, contract
from repro_torch.core import cached_embedding as ce
from repro_torch.core.collection import CollectionPlan, EmbeddingCollection, FeatureBatch
from repro_torch.core.lanes import take_fill
from repro_torch.optim.optimizers import Optimizer, tree_map

__all__ = [
    "bce_with_logits",
    "softmax_xent",
    "auc_proxy",
    "flush_embeddings",
    "EmbTrainStep",
    "CollectionTrainStep",
    "CollectionModelMixin",
]


def flush_embeddings(collection: EmbeddingCollection, state: Dict[str, Any]) -> Dict[str, Any]:
    """The pre-checkpoint barrier: flush every cached slab under ``emb``."""
    return dict(state, emb=collection.flush(state["emb"]))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, by the reference's formula."""
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``logits`` [..., V] (in fp32) against
    integer ``labels`` [...]."""
    z = logits.to(torch.float32)
    ll = torch.gather(z, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(torch.logsumexp(z, dim=-1) - ll)


def auc_proxy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Pairwise-ranking AUC estimate (exact when no score ties)."""
    s = logits.detach().to(torch.float32).reshape(-1)
    y = labels.to(torch.float32).reshape(-1)
    order = torch.argsort(s, stable=True)
    ranks = torch.zeros_like(s)
    ranks[order] = torch.arange(1, s.numel() + 1, dtype=torch.float32, device=s.device)
    n_pos = torch.sum(y)
    n_neg = y.numel() - n_pos
    auc = (torch.sum(ranks * y) - n_pos * (n_pos + 1) / 2) / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, 0.5)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _grads(loss: torch.Tensor, params: Any, extra: List[torch.Tensor]):
    """Gradients of ``loss`` as (a tree like ``params``, one per ``extra``)."""
    p_leaves = _leaves(params)
    grads = torch.autograd.grad(loss, p_leaves + extra)
    it = iter(grads[: len(p_leaves)])
    return tree_map(lambda _: next(it), params), list(grads[len(p_leaves):])


@dataclasses.dataclass(frozen=True)
class EmbTrainStep:
    """The cached-embedding train step of the single-table adapter.

    ``collect_ids(batch)`` gives the flat int32 global ids (-1 pad);
    ``fwd(dense_params, emb_rows, batch) -> (logits, aux)`` gets the rows
    gathered from the cached weight, so gradients reach the cached rows."""

    emb_cfg: ce.CachedEmbeddingConfig
    optimizer: Optimizer
    collect_ids: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    fwd: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = bce_with_logits
    emb_lr: float = 0.05

    def __call__(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        emb_state, slots = ce.prepare_ids(self.emb_cfg, state["emb"], self.collect_ids(batch))
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        cached_w = emb_state.cache.cached_rows["weight"].detach().requires_grad_()
        logits, aux = self.fwd(params, take_fill(cached_w, slots, 0), batch)
        loss = self.loss(logits, batch["label"])
        p_grads, (w_grad,) = _grads(loss, params, [cached_w])
        new_params, opt_state = self.optimizer.update(
            p_grads, state["opt"], state["params"], state["step"]
        )
        emb_state = ce.apply_row_grads(self.emb_cfg, emb_state, w_grad, self.emb_lr)
        cache = emb_state.cache
        metrics = {
            "loss": loss.detach(),
            "auc": auc_proxy(logits, batch["label"]),
            "hit_rate": cache.hit_rate(),
            "cache_misses": cache.misses,
            "uniq_overflows": cache.uniq_overflows,
            **aux,
        }
        new_state = dict(state, params=new_params, opt=opt_state, emb=emb_state,
                         step=state["step"] + 1)
        return new_state, metrics


@dataclasses.dataclass(frozen=True)
class CollectionTrainStep:
    """Train step over an ``EmbeddingCollection``, fused (``__call__``) and
    split into ``plan_step`` / ``apply_step`` / ``compute_step``.

    ``fwd(dense_params, rows, batch) -> logits`` receives the keyed gather
    output (feature name -> [.., dim] rows)."""

    collection: EmbeddingCollection
    optimizer: Optimizer
    features: Callable[[Dict[str, torch.Tensor]], FeatureBatch]
    fwd: Callable[..., torch.Tensor]
    loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = bce_with_logits
    emb_lr: float = 0.05

    def plan_step(
        self,
        state: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        future_batches: Tuple[Dict[str, torch.Tensor], ...] = (),
    ) -> CollectionPlan:
        """Weight-free planning half: dedup, slot assignment, movement plan
        for ``batch``, with ``future_batches``' ids merged as a lookahead
        window (their rows load now and stay pinned; see
        ``EmbeddingCollection.plan_prepare``)."""
        fut = tuple(self.features(b) for b in future_batches)
        return self.collection.plan_prepare(state["emb"], self.features(batch), fb_future=fut)

    def apply_step(self, state: Dict[str, Any], plan: CollectionPlan) -> Dict[str, Any]:
        """Execute a plan's row movement (writeback first, then loads)."""
        return dict(state, emb=self.collection.apply_plan(state["emb"], plan))

    @contract(in_place=("state",), int_counters=INT_COUNTERS, max_sort_size=64)
    def compute_step(
        self,
        state: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        addresses: Dict[str, torch.Tensor],
    ):
        """Dense fwd/bwd + optimizer + synchronous row update, given the
        addresses planned for ``batch`` (whose rows are resident)."""
        fb = self.features(batch)
        emb_state = state["emb"]
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        weights = {k: w.detach().requires_grad_()
                   for k, w in self.collection.weights(emb_state).items()}
        rows = self.collection.gather(weights, addresses, fb)
        logits = self.fwd(params, rows, batch)
        loss = self.loss(logits, batch["label"])
        p_grads, w_list = _grads(loss, params, list(weights.values()))
        w_grads = dict(zip(weights, w_list))
        new_params, opt_state = self.optimizer.update(
            p_grads, state["opt"], state["params"], state["step"]
        )
        emb_state = self.collection.apply_grads(emb_state, w_grads, self.emb_lr)
        metrics = {
            "loss": loss.detach(),
            "auc": auc_proxy(logits, batch["label"]),
            **self.collection.metrics(emb_state),
        }
        new_state = dict(state, params=new_params, opt=opt_state, emb=emb_state,
                         step=state["step"] + 1)
        return new_state, metrics

    def __call__(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        plan = self.plan_step(state, batch)
        state = self.apply_step(state, plan)
        return self.compute_step(state, batch, plan.addresses)


class CollectionModelMixin:
    """The step surface of a model whose embeddings live in an
    ``EmbeddingCollection`` (expects ``self.collection`` /
    ``self.optimizer`` / ``self.features`` / ``self.fwd`` and the embedding
    learning rate at ``cfg.lr``)."""

    @property
    def emb_lr(self) -> float:
        return self.cfg.lr

    def _train_step(self) -> CollectionTrainStep:
        return CollectionTrainStep(
            collection=self.collection,
            optimizer=self.optimizer,
            features=self.features,
            fwd=self.fwd,
            emb_lr=self.emb_lr,
        )

    def train_step(self, state, batch):
        return self._train_step()(state, batch)

    def plan_step(self, state, batch, future_batches=()):
        return self._train_step().plan_step(state, batch, future_batches)

    def apply_step(self, state, plan):
        return self._train_step().apply_step(state, plan)

    def compute_step(self, state, batch, addresses):
        return self._train_step().compute_step(state, batch, addresses)

    def refresh(self, state, cfg=None, writeback: bool = True):
        """Adaptive frequency refresh: re-rank the collection's cached slabs
        from their online decayed counters (``EmbeddingCollection.refresh``).
        Host-side pure reindexing, between steps: the trainers wire it as
        ``refresh_fn`` under ``TrainerConfig.refresh_interval``; serving
        passes ``writeback=False`` for its read-only cache states."""
        new_emb, _ = self.collection.refresh(state["emb"], cfg, writeback=writeback)
        return dict(state, emb=new_emb)
