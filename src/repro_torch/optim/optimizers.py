"""Optimizers (port of the SGD and Adagrad part of ``repro.optim.optimizers``).

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

import torch

__all__ = ["Optimizer", "adagrad", "sgd", "tree_map"]

Schedule = Union[float, Callable[[Any], Any]]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and tuples) of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _lr_at(lr: Schedule, step) -> torch.Tensor:
    """The learning rate at ``step`` as an fp32 scalar, like the reference's
    ``jnp.asarray(lr, float32)``."""
    return torch.as_tensor(lr(step) if callable(lr) else lr, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (params, state)


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
