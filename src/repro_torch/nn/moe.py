"""FFN blocks (port of the dense part of ``repro.nn.moe``): the gated
SwiGLU FFN.  The top-k Mixture-of-Experts comes with the MoE slice (ROADMAP
item 15)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.layers import Dtypes

__all__ = ["ffn_init", "ffn_apply"]


def ffn_init(gen: torch.Generator, d: int, ff: int, dt: Dtypes,
             device: torch.device, lead=()) -> Dict[str, torch.Tensor]:
    """``gate`` / ``up`` [d, ff] and ``down`` [ff, d], normal / sqrt(fan-in);
    ``lead`` prepends stacking dims (the transformer's layer groups)."""
    s_in, s_ff = float(np.float32(1.0 / np.sqrt(d))), float(np.float32(1.0 / np.sqrt(ff)))

    def normal(shape, s):
        return torch.randn(tuple(lead) + shape, generator=gen, dtype=dt.param,
                           device=device).mul_(s)

    return {"gate": normal((d, ff), s_in), "up": normal((d, ff), s_in),
            "down": normal((ff, d), s_ff)}


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, dt: Dtypes) -> torch.Tensor:
    xc = x.to(dt.compute)
    h = F.silu(xc @ p["gate"].to(dt.compute)) * (xc @ p["up"].to(dt.compute))
    return h @ p["down"].to(dt.compute)
