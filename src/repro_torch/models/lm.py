"""LM-family model wrapper (port of ``repro.models.lm``): train / prefill /
decode steps over ``repro_torch.nn.transformer`` with AdamW, global-norm
gradient clipping and optional gradient compression.

Two inits keep two sets of dtypes:

* :meth:`LMModel.init` builds the training state ``{"params", "opt",
  "step"}`` (plus ``"comp"``, the error feedback of the int8
  ``Compressor``) in the reference's dtypes: the reference's init promotes
  every matrix of a bf16 config to fp32 (``T.init_lm(promote=True)``), so
  only the embedding table and the norm scales stay in ``dtypes.param``;
  the AdamW moments are fp32.  An AdamW step on bf16 matrices would round
  every update to bf16, where the reference's does not.
* serving may call ``T.init_lm`` directly, which keeps every leaf in
  ``dtypes.param`` (a bf16 config's weights at half the bytes); the
  forward casts every matrix to ``dtypes.compute`` either way, so the two
  serve the same numbers from the same values.

``train_step`` is functional: it returns a new state and leaves the one it
was given intact.  On the card its embedding gradient and the MoE combine
sum duplicate lanes with ``index_add`` in no fixed order, so two runs agree
bitwise only under ``torch.use_deterministic_algorithms``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import softmax_xent
from repro_torch.nn import transformer as T
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.compression import Compressor

__all__ = ["LMModel"]


class LMModel:
    def __init__(self, cfg: T.TransformerConfig, lr: float = 3e-4, clip_norm: float = 1.0,
                 aux_weight: float = 0.01, compressor: str = "none"):
        self.cfg = cfg
        self.clip_norm = clip_norm
        self.aux_weight = aux_weight
        self.optimizer = opt_lib.adamw(lr)
        self.compressor = Compressor(compressor)

    def init(self, seed_or_gen: Union[int, torch.Generator],
             device: DeviceLike = None) -> Dict[str, Any]:
        """The training state from a seed, or from a generator on ``device``."""
        dev = resolve_device(device)
        gen = seed_or_gen
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed_or_gen))
        params = T.init_lm(gen, self.cfg, dev, promote=True)
        state = {"params": params, "opt": self.optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.compressor.codec == "int8":
            state["comp"] = self.compressor.init(params)
        return state

    def loss_fn(self, params, batch) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(xent + aux_weight * aux, (xent, aux)) of ``batch`` (``tokens`` and
        ``labels`` [B, S])."""
        logits, aux = T.forward(params, self.cfg, batch["tokens"])
        xent = softmax_xent(logits, batch["labels"])
        return xent + self.aux_weight * aux, (xent, aux)

    def train_step(self, state, batch):
        """One step: the loss and its gradients, clipping by the global norm,
        the compressor's encode and decode, then AdamW.  Returns (new state,
        {"loss", "xent", "aux", "grad_norm"})."""
        params = opt_lib.tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
        loss, (xent, aux) = self.loss_fn(params, batch)
        loss.backward()
        grads = opt_lib.tree_map(lambda p: p.grad, params)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, self.clip_norm)
        new_state = dict(state)
        if self.compressor.codec != "none":
            payload, sideband, comp_state = self.compressor.encode(grads, state.get("comp", ()))
            grads = self.compressor.decode(payload, sideband, grads)
            if self.compressor.codec == "int8":
                new_state["comp"] = comp_state
        with torch.no_grad():
            new_params, opt_state = self.optimizer.update(grads, state["opt"], state["params"],
                                                          state["step"])
        new_state.update(params=new_params, opt=opt_state, step=state["step"] + 1)
        return new_state, {"loss": loss.detach(), "xent": xent.detach(), "aux": aux.detach(),
                           "grad_norm": gnorm}

    @torch.no_grad()
    def prefill_step(self, params, batch) -> torch.Tensor:
        """Last-position logits [B, V] of ``batch["tokens"]`` [B, S] (a
        tensor, or a numpy array that is moved to the parameters' device)."""
        tokens = batch["tokens"]
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens).to(params["head"]["w"].device)
        return T.prefill(params, self.cfg, tokens)

    @torch.no_grad()
    def decode_fn(self, params, caches, token, pos):
        return T.decode_step(params, self.cfg, caches, token, pos)

    # ----- specs ------------------------------------------------------------
    def prefill_specs(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.empty((batch, seq), dtype=torch.int32, device="meta")}

    def decode_specs(self, batch: int, kv_len: int) -> Dict[str, Any]:
        """Shapes and dtypes of a decode step's inputs, as ``meta`` tensors."""
        caches = T._cache_tree(self.cfg, batch, kv_len,
                               lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"),
                               self.cfg.dtypes.compute)
        return {
            "caches": caches,
            "token": torch.empty((batch, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta"),
        }
