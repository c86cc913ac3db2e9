"""Synthetic graphs (power-law degree), CSR utilities and sampled-block
batches (port of ``repro.data.graphs``): numpy on the host, every array
bitwise the reference's for the same arguments.  The sampler comes from
``repro_torch.nn.gnn``, which imports no JAX."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.nn.gnn import neighbor_sample

__all__ = ["random_graph_csr", "full_graph_batch", "sampled_batch", "molecule_batch"]


def random_graph_csr(n_nodes: int, n_edges: int, seed: int = 0):
    """Power-law-ish random graph as CSR (duplicates allowed, like real logs):
    (indptr [N+1], indices [E] int64, (src, dst) int32 sorted by dst)."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured endpoints
    dst = (rng.pareto(1.5, n_edges) * n_nodes / 20).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, n_edges)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, src.astype(np.int64), (src.astype(np.int32), dst.astype(np.int32))


def full_graph_batch(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """One whole graph for full-batch node classification."""
    rng = np.random.default_rng(seed)
    _, _, (src, dst) = random_graph_csr(n_nodes, n_edges, seed)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    # labels from the first feature's sign
    label = (feat[:, 0] > 0).astype(np.int32) % n_classes
    mask = (rng.random(n_nodes) < 0.5).astype(np.int32)
    return {"feat": feat, "src": src, "dst": dst, "label": label, "label_mask": mask}


def sampled_batch(
    indptr: np.ndarray,
    indices: np.ndarray,
    feats: np.ndarray,
    labels: np.ndarray,
    batch_nodes: int,
    fanouts: Tuple[int, ...],
    seed: int,
    step: int,
) -> Dict[str, np.ndarray]:
    """Neighbour-sampled block for minibatch training (static shapes): the
    seeds are labelled, every other node is context."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    n = len(indptr) - 1
    seeds = rng.integers(0, n, batch_nodes)
    nodes, src, dst, n_seed = neighbor_sample(indptr, indices, seeds, fanouts, rng)
    feat = feats[nodes]
    label = np.zeros(len(nodes), np.int32)
    label[:n_seed] = labels[seeds]
    mask = np.zeros(len(nodes), np.int32)
    mask[:n_seed] = 1
    return {"feat": feat.astype(np.float32), "src": src, "dst": dst, "label": label,
            "label_mask": mask}


def molecule_batch(
    n_graphs: int, max_nodes: int, max_edges: int, d_feat: int, seed: int, step: int
) -> Dict[str, np.ndarray]:
    """``n_graphs`` small graphs of ``max_nodes // 2`` to ``max_nodes`` nodes
    and ``max_edges // 2`` to ``max_edges`` edges, each padded to the
    maximum (padding nodes masked out, padding edges -1), with one
    regression label a graph."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tot_n, tot_e = n_graphs * max_nodes, n_graphs * max_edges
    feat = rng.normal(size=(tot_n, d_feat)).astype(np.float32)
    graph_id = np.repeat(np.arange(n_graphs, dtype=np.int32), max_nodes)
    node_mask = np.ones(tot_n, np.int32)
    src = np.zeros(tot_e, np.int32)
    dst = np.zeros(tot_e, np.int32)
    for g in range(n_graphs):
        nn = rng.integers(max_nodes // 2, max_nodes + 1)
        ne = rng.integers(max_edges // 2, max_edges + 1)
        s = rng.integers(0, nn, ne) + g * max_nodes
        d = rng.integers(0, nn, ne) + g * max_nodes
        src[g * max_edges: g * max_edges + ne] = s
        dst[g * max_edges: g * max_edges + ne] = d
        src[g * max_edges + ne: (g + 1) * max_edges] = -1
        dst[g * max_edges + ne: (g + 1) * max_edges] = -1
        node_mask[g * max_nodes + nn: (g + 1) * max_nodes] = 0
    label = rng.normal(size=n_graphs).astype(np.float32)
    return {
        "feat": feat,
        "src": src,
        "dst": dst,
        "graph_id": graph_id,
        "node_mask": node_mask,
        "label": label,
    }
