"""Dense layers and MLP towers (port of the MLP part of ``repro.nn.layers``).

Parameters are nested dicts of tensors with the reference's names
(``{"l0": {"w": [d_in, d_out], "b": [d_out]}, ...}``), so converted JAX
parameters drop straight in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["Dtypes", "dense_init", "dense", "mlp_init", "mlp"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Dtypes:
    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, dt: Dtypes, device: torch.device, bias: bool = True
) -> Params:
    """Uniform(+-1/sqrt(d_in)) weights, zero bias."""
    bound = 1.0 / np.sqrt(max(d_in, 1))
    w = torch.rand((d_in, d_out), generator=gen, dtype=dt.param, device=device)
    p = {"w": w * (2 * bound) - bound}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dt.param, device=device)
    return p


def dense(p: Params, x: torch.Tensor, dt: Dtypes) -> torch.Tensor:
    y = x.to(dt.compute) @ p["w"].to(dt.compute)
    if "b" in p:
        y = y + p["b"].to(dt.compute)
    return y


def mlp_init(
    gen: torch.Generator, dims: Tuple[int, ...], dt: Dtypes, device: torch.device
) -> Dict[str, Params]:
    """Plain MLP tower: dims = (in, h1, ..., out)."""
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], dt, device) for i in range(len(dims) - 1)}


def mlp(p: Dict[str, Params], x: torch.Tensor, dt: Dtypes, final_act: bool = False) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x, dt)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x
