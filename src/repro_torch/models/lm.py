"""LM-family model wrapper (port of the serving part of
``repro.models.lm``): prefill and KV-cache decode over
``repro_torch.nn.transformer``.

Training (AdamW, global-norm clipping, the gradient ``Compressor``) comes
with the LM training slice (ROADMAP item 15): ``loss_fn`` and
``train_step`` raise until then, and ``init`` returns no optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import transformer as T

__all__ = ["LMModel"]

_TRAINING = "LM training is not ported yet (ROADMAP item 15: AdamW, clipping, the Compressor)"


class LMModel:
    def __init__(self, cfg: T.TransformerConfig):
        self.cfg = cfg

    def init(self, seed_or_gen: Union[int, torch.Generator],
             device: DeviceLike = None) -> Dict[str, Any]:
        """Random parameters from a seed, or from a generator on ``device``."""
        dev = resolve_device(device)
        gen = seed_or_gen
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed_or_gen))
        return {"params": T.init_lm(gen, self.cfg, dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def loss_fn(self, params, batch):
        raise NotImplementedError(_TRAINING)

    def train_step(self, state, batch):
        raise NotImplementedError(_TRAINING)

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
        dtype = self.cfg.dtypes.compute
        caches = T._cache_tree(self.cfg, batch, kv_len,
                               lambda shape: torch.empty(shape, dtype=dtype, device="meta"))
        return {
            "caches": caches,
            "token": torch.empty((batch, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta"),
        }
