"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden 70, the gated
aggregator.  Feature widths by shape: cora (1433 / 7), reddit-sampled
(602 / 41), ogbn-products (100 / 47), molecules (16, graph regression).
``SHAPE_CFG`` is copied from ``repro.configs.gatedgcn``; ``SMOKE`` is the
config of the reference's ``smoke()``."""
from repro_torch.models.gatedgcn import GatedGCNConfig


def _pad512(n):
    # the reference pads nodes and edges to a multiple of 512 (divisible
    # shardings); padding edges are -1 and dropped by the layer
    return -(-n // 512) * 512


SHAPE_CFG = {
    # shape: (kind, n_nodes, n_edges, d_feat, n_classes, task, extras)
    "full_graph_sm": ("train", _pad512(2708), _pad512(10556), 1433, 7, "node", {}),
    "minibatch_lg": ("train", 1024 * (1 + 15 + 150), 1024 * (15 + 150), 602, 41, "node", {}),
    "ogb_products": ("train", _pad512(2_449_029), _pad512(61_859_140), 100, 47, "node", {}),
    "molecule": ("train", 128 * 30, 128 * 64, 16, 1, "graph", {"n_graphs": 128}),
}

SMOKE = GatedGCNConfig(d_feat=12, n_classes=5, n_layers=3, d_hidden=16)
