"""internlm2-20b [arXiv:2403.17297]: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92544, kv_repeat=2.  ``CONFIG`` and ``SMOKE`` copied field
for field from ``repro.configs.internlm2_20b``."""
import torch

from repro_torch.configs.lm_common import BF16
from repro_torch.nn.layers import Dtypes
from repro_torch.nn.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, kv_repeat=2, dtypes=BF16, remat=True,
)

SMOKE = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    kv_repeat=2, dtypes=Dtypes(param=torch.float32, compute=torch.float32),
    block_q=16, block_k=16,
)
