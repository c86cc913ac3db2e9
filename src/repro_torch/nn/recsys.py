"""Recsys interaction layers (port of the FM part of ``repro.nn.recsys``;
the DIN attention, the DIEN GRUs and the MIND capsules come with their
models in a later slice).  Layers take embedding rows that upstream code
fetched through the cache: the interaction math is cache-agnostic."""
from __future__ import annotations

import torch

from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

__all__ = ["fm_interaction"]


def fm_interaction(v: torch.Tensor, use_pallas: bool = False) -> torch.Tensor:
    """2-way FM pooling via the O(nk) sum-square trick (Rendle ICDM'10).

    v: [..., fields, dim] (embedding * feature value already folded in).
    Returns [...]: sum_{i<j} <v_i, v_j>.  ``use_pallas`` runs the FM kernel
    (serving only: it has no backward); otherwise torch ops in ``v``'s
    dtype, which autograd differentiates."""
    if use_pallas:
        from repro_torch.kernels.fm_interaction import ops as fm_ops

        return fm_ops.fm_interaction(v)
    return fm_interaction_ref(v)
