"""gemma3-27b [hf:google/gemma-3]: 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144, 5:1 local:global sliding-window (window 1024),
head_dim 128 (decoupled from d_model/n_heads).  ``CONFIG`` and ``SMOKE``
copied field for field from ``repro.configs.gemma3_27b``."""
import torch

from repro_torch.configs.lm_common import BF16
from repro_torch.nn.layers import Dtypes
from repro_torch.nn.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab=262144, pattern=("local",) * 5 + ("global",),
    window=1024, dtypes=BF16, remat=True,
)

SMOKE = TransformerConfig(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=256, pattern=("local",) * 5 + ("global",), window=8, kv_repeat=2,
    dtypes=Dtypes(param=torch.float32, compute=torch.float32), block_q=16, block_k=16,
)
