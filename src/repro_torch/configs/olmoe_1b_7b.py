"""olmoe-1b-7b [arXiv:2409.02060]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8.  ``CONFIG`` and ``SMOKE`` copied field
for field from ``repro.configs.olmoe_1b_7b``."""
import torch

from repro_torch.configs.lm_common import BF16
from repro_torch.nn.layers import Dtypes
from repro_torch.nn.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, ffn="moe", n_experts=64, top_k=8, dtypes=BF16, remat=True,
    moe_impl="shard_map",
)

SMOKE = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=256,
    ffn="moe", n_experts=8, top_k=4,
    dtypes=Dtypes(param=torch.float32, compute=torch.float32), block_q=16, block_k=16,
)
