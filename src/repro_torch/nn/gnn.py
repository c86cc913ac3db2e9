"""GatedGCN message passing by segment sums (port of ``repro.nn.gnn``), and
the host-side neighbour sampler.

GatedGCN (arXiv:1711.07553, the benchmarking-gnns form of arXiv:2003.00982):

    e_ij' = e_ij + ReLU(LN(A h_i + B h_j + C e_ij))
    h_i'  = h_i + ReLU(LN(U h_i + sum_j eta_ij * (V h_j)))
    eta_ij = sigma(e_ij') / (sum_{j in N(i)} sigma(e_ij') + eps)

Graphs are edge lists (``src``, ``dst``) with -1 padding; a layer is
``gather -> edge MLP -> segment sum`` over destinations.  A segment sum
(``core.lanes.segment_sum``) is an ``index_add_`` into ``n + 1`` rows whose
last row takes the padding and is sliced off (the reference's
``segment_sum`` drops the bucket ``n``).  On the card ``index_add_`` sums a
row's edges with atomics in no fixed order, so two runs agree bitwise only
under ``torch.use_deterministic_algorithms``.
The reference's sharding hook (``constrain``) has no counterpart on one card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.lanes import segment_sum
from repro_torch.nn.indexing import take_rows
from repro_torch.nn.layers import Dtypes, Params, dense, dense_init, layernorm, layernorm_init

__all__ = ["gatedgcn_layer_init", "gatedgcn_layer", "neighbor_sample"]


def gatedgcn_layer_init(gen: torch.Generator, d: int, dt: Dtypes,
                        device: torch.device) -> dict:
    p = {k: dense_init(gen, d, d, dt, device) for k in ("A", "B", "C", "U", "V")}
    p["ln_h"] = layernorm_init(d, dt, device)
    p["ln_e"] = layernorm_init(d, dt, device)
    return p


def gatedgcn_layer(
    p: Params,
    h: torch.Tensor,  # [N, D] node features
    e: torch.Tensor,  # [E, D] edge features
    src: torch.Tensor,  # [E] int32 (-1 padding)
    dst: torch.Tensor,  # [E] int32 (-1 padding)
    dt: Dtypes,
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = h.shape[0]
    valid = (src >= 0) & (dst >= 0)
    h_src = take_rows(h, src)
    h_dst = take_rows(h, dst)

    e_new = dense(p["A"], h_dst, dt) + dense(p["B"], h_src, dt) + dense(p["C"], e, dt)
    e_out = e + torch.relu(layernorm(p["ln_e"], e_new, dt))

    gate = torch.sigmoid(e_new.float())
    gate = torch.where(valid[:, None], gate, 0.0)
    msg = gate * dense(p["V"], h_src, dt).float()

    seg = torch.where(valid, dst, n)  # padding -> the dropped bucket
    agg = segment_sum(msg, seg, n)
    den = segment_sum(gate, seg, n)
    agg = agg / (den + 1e-6)

    h_new = dense(p["U"], h, dt) + agg.to(dt.compute)
    h_out = h + torch.relu(layernorm(p["ln_h"], h_new, dt))
    return h_out, e_out


# ---------------------------------------------------------------------------
# Neighbour sampling (host-side numpy), for the minibatch_lg shape
# ---------------------------------------------------------------------------


def neighbor_sample(
    indptr: np.ndarray,  # CSR [N+1]
    indices: np.ndarray,  # CSR [nnz]
    seeds: np.ndarray,  # [B] seed node ids
    fanouts: Tuple[int, ...],  # e.g. (15, 10)
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Uniform k-hop neighbour sampling -> padded subgraph edge list.

    Returns (nodes [N_sub_max], src, dst, n_seed) where src / dst index into
    ``nodes`` (local ids), padded with -1 to the static worst-case size:
    N_sub_max = B * (1 + f1 + f1*f2 + ...), E_max = B*f1 + B*f1*f2 + ....
    Seeds occupy nodes[:B].  Duplicates are kept (GraphSAGE practice), so
    shapes stay static.  The same draws from the same generator as the
    reference, so the output is bitwise the reference's.
    """
    b = len(seeds)
    frontier = np.asarray(seeds, dtype=np.int64)
    nodes = [frontier]
    srcs, dsts = [], []
    base = 0  # local offset of the current frontier inside `nodes`
    for f in fanouts:
        deg = indptr[frontier + 1] - indptr[frontier]
        # f neighbours a frontier node, with replacement; deg == 0 -> -1
        u = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(frontier), f))
        pos = np.minimum(indptr[frontier][:, None] + u, len(indices) - 1)
        nbr = indices[pos]
        nbr = np.where(deg[:, None] > 0, nbr, -1)
        new_local = np.arange(nbr.size) + sum(len(x) for x in nodes)
        # edges: sampled neighbour (src) -> frontier node (dst)
        dst_local = np.repeat(np.arange(len(frontier)) + base, f)
        src_local = np.where(nbr.reshape(-1) >= 0, new_local, -1)
        srcs.append(src_local)
        dsts.append(np.where(src_local >= 0, dst_local, -1))
        base = sum(len(x) for x in nodes)
        frontier = np.maximum(nbr.reshape(-1), 0)
        nodes.append(frontier)
    all_nodes = np.concatenate(nodes)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    return all_nodes.astype(np.int64), src, dst, b
