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
for an arena, ``[vocab, dim]`` for a DEVICE table).  Under a mesh of
``data > 1`` replicas, each replica's gradients, loss, logits and labels
cross the data axis before the update (``_data_mean``): every replica
steps on the global batch's mean.  A weight's gradient crosses at the rows
the plan's ``grad_rows`` name (``pick_grad_rows``): an arena's at its
shard's distinct rows of the global plan, a DEVICE table's at the global
batch's distinct ids of the table (its whole gradient where its vocab is
no larger than its lanes), in ascending order; no other row of a
replica's gradient is nonzero.  The arena
and the host table are updated in place, so a state passed to a step
must not be used again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.contracts import INT_COUNTERS, contract
from repro_torch.core import cached_embedding as ce
from repro_torch.core.collection import CollectionPlan, EmbeddingCollection, FeatureBatch
from repro_torch.core.lanes import take_fill
from repro_torch.dist import exchange
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


def _data_mean(collection, mesh, p_grads, w_grads, loss, logits, labels, grad_rows):
    """The global batch's mean from the data replicas' (``data > 1``), in
    one collective over the data axis (``exchange.data_sum``): the dense
    gradients, the loss and each weight's part (an arena's and a DEVICE
    table's at the plan's ``grad_rows``: ``pick_grad_rows``) summed in
    data-rank order and scaled by ``1 / data`` (a replica's loss is the
    mean over its ``B / data`` rows), the logits and labels gathered.  The
    same bits on every replica.  ``mesh.traffic`` names the DEVICE tables'
    and the arenas' parts of the bytes sent."""
    if grad_rows is None:
        raise ValueError(f"a step on {mesh.data} data replicas needs its plan's grad_rows")
    dense = _leaves(p_grads)
    parts = collection.pick_grad_rows(w_grads, grad_rows)
    sums, (logits, labels) = exchange.data_sum(dense + [loss] + list(parts.values()), mesh,
                                               (logits, labels))
    for name, keys in (("grads.device", collection.device_slabs),
                       ("grads.arenas", collection.cached_slabs)):  # float32 on the wire
        mesh.traffic.part(name, 4 * (mesh.data - 1) * sum(parts[k].numel() for k in keys
                                                           if k in parts))
    sums = [torch.div(x, mesh.data) for x in sums]
    it = iter(sums[: len(dense)])
    p_grads = tree_map(lambda _: next(it), p_grads)
    w_grads = collection.place_grad_rows(w_grads, dict(zip(parts, sums[len(dense) + 1 :])),
                                         grad_rows)
    return p_grads, w_grads, sums[len(dense)], logits, labels


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
        grad_rows: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """Dense fwd/bwd + optimizer + synchronous row update, given the
        addresses planned for ``batch`` (whose rows are resident) and, at
        ``data > 1``, the plan's ``grad_rows`` for it."""
        fb = self.features(batch)
        emb_state = state["emb"]
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        weights = {k: w.detach().requires_grad_()
                   for k, w in self.collection.weights(emb_state).items()}
        rows = self.collection.gather(weights, addresses, fb)
        logits = self.fwd(params, rows, batch)
        labels = batch["label"]
        loss = self.loss(logits, labels)
        p_grads, w_list = _grads(loss, params, list(weights.values()))
        w_grads = dict(zip(weights, w_list))
        loss, logits = loss.detach(), logits.detach()
        mesh = getattr(self.collection, "mesh", None)
        if mesh is not None and mesh.data > 1:
            p_grads, w_grads, loss, logits, labels = _data_mean(
                self.collection, mesh, p_grads, w_grads, loss, logits, labels, grad_rows)
        new_params, opt_state = self.optimizer.update(
            p_grads, state["opt"], state["params"], state["step"]
        )
        emb_state = self.collection.apply_grads(emb_state, w_grads, self.emb_lr)
        metrics = {
            "loss": loss,
            "auc": auc_proxy(logits, labels),
            **self.collection.metrics(emb_state),
        }
        new_state = dict(state, params=new_params, opt=opt_state, emb=emb_state,
                         step=state["step"] + 1)
        return new_state, metrics

    def __call__(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        plan = self.plan_step(state, batch)
        state = self.apply_step(state, plan)
        return self.compute_step(state, batch, plan.addresses,
                                 plan.grad_rows[0] if plan.grad_rows else None)


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

    def compute_step(self, state, batch, addresses, grad_rows=None):
        return self._train_step().compute_step(state, batch, addresses, grad_rows)

    def refresh(self, state, cfg=None, writeback: bool = True):
        """Adaptive frequency refresh: re-rank the collection's cached slabs
        from their online decayed counters (``EmbeddingCollection.refresh``).
        Host-side pure reindexing, between steps: the trainers wire it as
        ``refresh_fn`` under ``TrainerConfig.refresh_interval``; serving
        passes ``writeback=False`` for its read-only cache states."""
        new_emb, _ = self.collection.refresh(state["emb"], cfg, writeback=writeback)
        return dict(state, emb=new_emb)
