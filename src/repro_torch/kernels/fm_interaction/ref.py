"""Plain-torch twins of ``repro.kernels.fm_interaction.ref``: the FM
pairwise interaction by the sum-square trick, and its O(F^2) definition."""
from __future__ import annotations

import torch

__all__ = ["fm_interaction_ref", "fm_interaction_naive"]


def fm_interaction_ref(v: torch.Tensor) -> torch.Tensor:
    """v [B, F, D] -> [B]: sum_{i<j} <v_i, v_j> via the sum-square trick."""
    s = v.sum(dim=-2)
    sq = (v * v).sum(dim=-2)
    return 0.5 * (s * s - sq).sum(dim=-1)


def fm_interaction_naive(v: torch.Tensor) -> torch.Tensor:
    """O(F^2) literal definition (cross-check for the trick itself)."""
    g = torch.einsum("bfd,bgd->bfg", v, v)
    f = v.shape[-2]
    iu, ju = torch.triu_indices(f, f, 1, device=v.device)
    return g[:, iu, ju].sum(-1)
