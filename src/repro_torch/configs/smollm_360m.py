"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M]: 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152 (llama arch).  ``CONFIG`` and ``SMOKE`` copied field
for field from ``repro.configs.smollm_360m``."""
import torch

from repro_torch.configs.lm_common import BF16
from repro_torch.nn.layers import Dtypes
from repro_torch.nn.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49152, dtypes=BF16, remat=True,
)

SMOKE = TransformerConfig(
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_head=20, d_ff=160,
    vocab=256, dtypes=Dtypes(param=torch.float32, compute=torch.float32),
    block_q=16, block_k=16,
)
