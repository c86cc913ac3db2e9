"""grok-1-314b [hf:xai-org/grok-1]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2, KV heads replicated 2x.  ``CONFIG`` and
``SMOKE`` copied field for field from ``repro.configs.grok_1_314b``."""
import torch

from repro_torch.configs.lm_common import BF16
from repro_torch.nn.layers import Dtypes
from repro_torch.nn.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, ffn="moe", n_experts=8, top_k=2, kv_repeat=2,
    dtypes=BF16, remat=True, moe_impl="shard_map",
)

SMOKE = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    ffn="moe", n_experts=8, top_k=2, kv_repeat=2,
    dtypes=Dtypes(param=torch.float32, compute=torch.float32), block_q=16, block_k=16,
)
