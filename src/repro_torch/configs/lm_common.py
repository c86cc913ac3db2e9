"""Shapes and dtypes shared by the LM configs (port of the
``LM_SHAPES`` / ``SHAPE_DEFS`` / ``BF16`` part of ``repro.configs.lm_common``;
its ``lm_rules``, ``make_lm_arch`` and ``Arch`` / ``Cell`` are dry-run and
mesh machinery, and stay in the reference).

Shapes:
  train_4k     seq 4096,  global batch 256   -> train_step (fwd+bwd+adamw)
  prefill_32k  seq 32768, global batch 32    -> prefill forward
  decode_32k   kv 32768,  global batch 128   -> one-token decode vs KV cache
  long_500k    kv 524288, global batch 1     -> sub-quadratic archs only
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import Dtypes

__all__ = ["BF16", "LM_SHAPES", "SHAPE_DEFS"]

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SHAPE_DEFS = {
    "train_4k": ("train", 256, 4096),
    "prefill_32k": ("prefill", 32, 32768),
    "decode_32k": ("decode", 128, 32768),
    "long_500k": ("decode", 1, 524288),
}

BF16 = Dtypes(param=torch.bfloat16, compute=torch.bfloat16)
