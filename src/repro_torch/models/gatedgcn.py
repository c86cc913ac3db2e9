"""GatedGCN (port of ``repro.models.gatedgcn``; arXiv:2003.00982's config:
16 layers, d_hidden 70, the gated aggregator).

The four graph regimes of ``configs.gatedgcn.SHAPE_CFG``:
  full_graph_sm  — Cora-scale full-batch node classification
  minibatch_lg   — Reddit-scale sampled training (the neighbour sampler in
                   ``repro_torch.data.graphs``; the model takes padded blocks)
  ogb_products   — full-batch large (2.4 M nodes / 62 M edges)
  molecule       — batched small graphs, graph-level regression

The layers' parameters are the reference's stacked ``[L, ...]`` leaves, so
a converted state maps leaf for leaf; ``fwd`` loops over them in Python
where the reference scans.  ``train_step`` is autograd, then Adam; it is
functional and leaves the state it was given intact.  ``init(seed,
device)`` builds the state on ``device`` (the CUDA card unless told
otherwise).  The reference's sharding hooks (``constrain``,
``split_params``) have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.core.lanes import segment_sum
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import gnn as G
from repro_torch.nn.layers import Dtypes, dense, dense_init
from repro_torch.optim import optimizers as opt_lib

__all__ = ["GatedGCNConfig", "GatedGCNModel"]


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    d_feat: int
    n_classes: int
    n_layers: int = 16
    d_hidden: int = 70
    task: str = "node"  # node | graph
    lr: float = 1e-3
    dtypes: Dtypes = Dtypes(param=torch.float32, compute=torch.float32)


class GatedGCNModel:
    def __init__(self, cfg: GatedGCNConfig):
        self.cfg = cfg
        self.optimizer = opt_lib.adam(cfg.lr)

    def init(self, seed_or_gen: Union[int, torch.Generator],
             device: DeviceLike = None) -> Dict[str, Any]:
        """``{"params", "opt", "step"}`` from a seed, or from a generator on
        ``device``: the input and edge embeddings, the layers stacked
        ``[L, ...]``, the readout; Adam's fp32 zero moments; step 0."""
        cfg, dev = self.cfg, resolve_device(device)
        gen = seed_or_gen
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed_or_gen))
        embed_h = dense_init(gen, cfg.d_feat, cfg.d_hidden, cfg.dtypes, dev)
        embed_e = dense_init(gen, 1, cfg.d_hidden, cfg.dtypes, dev)
        layers = [G.gatedgcn_layer_init(gen, cfg.d_hidden, cfg.dtypes, dev)
                  for _ in range(cfg.n_layers)]
        params = {
            "embed_h": embed_h,
            "embed_e": embed_e,
            "layers": opt_lib.tree_map(lambda *xs: torch.stack(xs), *layers),
            "readout": dense_init(gen, cfg.d_hidden, cfg.n_classes, cfg.dtypes, dev),
        }
        return {"params": params, "opt": self.optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def fwd(self, params, batch) -> torch.Tensor:
        """Logits: ``[N, n_classes]`` for the node task, ``[G, n_classes]``
        (masked mean of each graph's nodes) for the graph task."""
        cfg, dt = self.cfg, self.cfg.dtypes
        src, dst = batch["src"], batch["dst"]
        h = dense(params["embed_h"], batch["feat"].to(dt.compute), dt)
        e = dense(params["embed_e"],
                  torch.ones((src.shape[0], 1), dtype=dt.compute, device=h.device), dt)
        for i in range(cfg.n_layers):
            lp = opt_lib.tree_map(lambda x, i=i: x[i], params["layers"])
            h, e = G.gatedgcn_layer(lp, h, e, src, dst, dt)
        if cfg.task == "graph":
            gid, n_graphs = batch["graph_id"], batch["label"].shape[0]
            valid = (batch["node_mask"] > 0).to(h.dtype)[:, None]
            pooled = segment_sum(h * valid, gid, n_graphs)
            cnt = segment_sum(valid, gid, n_graphs)
            h = pooled / torch.clamp_min(cnt, 1.0)
        return dense(params["readout"], h, dt)

    def loss_fn(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, logits): the masked node cross-entropy, or for the graph
        task the mean squared error of ``logits[:, 0]`` against the label."""
        logits = self.fwd(params, batch)
        if self.cfg.task == "graph":
            pred = logits[:, 0]
            return torch.mean((pred - batch["label"].float()) ** 2), logits
        mask = batch["label_mask"].float()
        ll = torch.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(ll, 1, batch["label"][:, None].to(torch.int64))[:, 0]
        return -torch.sum(picked * mask) / torch.clamp_min(mask.sum(), 1.0), logits

    def train_step(self, state, batch):
        """One step: the loss and its gradients by autograd, then Adam.
        Returns (new state, {"loss"})."""
        params = opt_lib.tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
        loss, _ = self.loss_fn(params, batch)
        loss.backward()
        # a leaf the loss does not reach (one layer's ln_e: its edge output
        # is dropped) has a zero gradient, as under jax.grad
        grads = opt_lib.tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                                 params)
        with torch.no_grad():
            new_params, opt_state = self.optimizer.update(grads, state["opt"], state["params"],
                                                          state["step"])
        new_state = dict(state, params=new_params, opt=opt_state, step=state["step"] + 1)
        return new_state, {"loss": loss.detach()}

    @torch.no_grad()
    def serve_step(self, state, batch):
        return self.fwd(state["params"], batch), None

    def input_specs(self, n_nodes: int, n_edges: int, n_targets: int = 0,
                    n_graphs: int = 0) -> Dict[str, torch.Tensor]:
        """Shapes and dtypes of a batch, as ``meta`` tensors."""
        cfg = self.cfg

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        specs = {"feat": spec((n_nodes, cfg.d_feat), torch.float32),
                 "src": spec((n_edges,), torch.int32),
                 "dst": spec((n_edges,), torch.int32)}
        if cfg.task == "graph":
            specs.update(graph_id=spec((n_nodes,), torch.int32),
                         node_mask=spec((n_nodes,), torch.int32),
                         label=spec((n_graphs,), torch.float32))
        else:
            specs.update(label=spec((n_nodes,), torch.int32),
                         label_mask=spec((n_nodes,), torch.int32))
        return specs
