"""Optimizers (port of ``repro.optim.optimizers``): SGD, Adam(W), Adagrad,
the global norm and clipping by it.

API, as in the reference: ``opt = sgd(lr=...)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params, step)``.  ``lr`` is a
float or a schedule ``f(step) -> float``.  Parameters are nested dicts of
tensors; ``update`` is functional (it returns new tensors); the fp32 learning
rate is a 0-dim CPU tensor, which torch applies to CUDA tensors as a
scalar, with no copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

__all__ = ["Optimizer", "adagrad", "adam", "adamw", "clip_by_global_norm", "global_norm", "sgd",
           "tree_leaves", "tree_map", "tree_pick"]

Schedule = Union[float, Callable[[Any], Any]]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and tuples) of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in the reference's order: ``jax.tree_util`` flattens a
    dict by its sorted keys, a tuple in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA takes it: the card's
    ``sqrt`` is; torch's vectorised CPU ``sqrt`` is not, so there it is
    taken in float64 and rounded (exact: double rounding cannot change a
    square root)."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _lr_at(lr: Schedule, step) -> torch.Tensor:
    """The learning rate at ``step`` as an fp32 scalar, like the reference's
    ``jnp.asarray(lr, float32)``: a schedule's tensor as it is, a float
    filled into a CPU scalar (no tensor built from Python data)."""
    v = lr(step) if callable(lr) else lr
    return v.to(torch.float32) if isinstance(v, torch.Tensor) else torch.full(
        (), v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (params, state)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves
    summed in the reference's order (:func:`tree_leaves`)."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled by ``min(1, max_norm / norm)`` in fp32, each back in its
    dtype; the norm)."""
    n = global_norm(grads)
    # a float over a tensor is torch's reciprocal times the float: divide tensors
    scale = torch.clamp_max(torch.full((), max_norm, dtype=torch.float32, device=n.device)
                            / torch.clamp_min(n, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), n


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum when ``momentum > 0`` (fp32 buffers)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype), params, grads
            )
            return new_params, state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        new_params = tree_map(
            lambda p, m: (p.float() - lr_t * m).to(p.dtype), params, new_m
        )
        return new_params, new_m

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction, and decoupled weight decay when
    ``weight_decay`` > 0 (AdamW): fp32 moments ``m`` and ``v`` a leaf.

    The corrections ``1 - b**t`` take ``b**t`` as a float64 power rounded to
    fp32.  XLA's fp32 power (glibc's ``powf``, not correctly rounded)
    gives the same value at the default betas for every step below 872
    (``b2``; 684 for ``b1``, where ``b1**t`` is below 1e-31), and within one
    ulp of the power after."""

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        step = torch.as_tensor(step)
        t = step.to(torch.float32) + 1.0

        def correction(b):
            # filled on the card: no blocking host-to-device copy
            power = torch.pow(torch.full((), float(np.float32(b)), dtype=torch.float64,
                                         device=t.device), t.to(torch.float64))
            return 1.0 - power.to(torch.float32)

        bc1, bc2 = correction(b1), correction(b2)

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            u = (m2 / bc1) / (_sqrt_rn(v2 / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), m2, v2

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return tree_pick(params, out, 0), {"m": tree_pick(params, out, 1),
                                            "v": tree_pick(params, out, 2)}

    return Optimizer(init, update)


def tree_pick(like: Any, tree: Any, i: int) -> Any:
    """The ``i``-th member of the tuple that ``tree`` holds at each of
    ``like``'s leaves (a ``tree_map`` that returned tuples, unzipped)."""
    if isinstance(like, dict):
        return {k: tree_pick(v, tree[k], i) for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(tree_pick(v, tree[j], i) for j, v in enumerate(like))
    return tree[i]


def adamw(lr: Schedule, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def adagrad(lr: Schedule, eps: float = 1e-10) -> Optimizer:
    """Adagrad: an fp32 accumulator of squared gradients a leaf, the step
    ``lr * g / (sqrt(acc) + eps)``.  The root is taken in float64 and
    rounded: torch's vectorised CPU ``sqrt`` is not correctly rounded (the
    reference's is), and double rounding is exact for a square root."""

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        new_acc = tree_map(lambda a, g: a + torch.square(g.float()), state, grads)

        def upd(p, g, a):
            root = torch.sqrt(a.to(torch.float64)).to(torch.float32)
            return (p.float() - lr_t * g.float() / (root + eps)).to(p.dtype)

        return tree_map(upd, params, grads, new_acc), new_acc

    return Optimizer(init, update)
