"""DLRM on Criteo Kaggle, the paper's own evaluation config (§5.1): 26
sparse fields, embed dim 128, bottom MLP 512-256-128, top MLP
1024-1024-512-256-1, batch 16384, cache ratio 1.5 %, SGD lr 1.0, an fp32
arena (set ``arena_precision`` fp16 / int8 to tier it)."""
from repro_torch.configs import shapes as S
from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig(
    vocab_sizes=S.CRITEO_VOCABS, n_dense=13, embed_dim=128,
    batch_size=16384, cache_ratio=0.015, lr=1.0, max_unique_per_step=1 << 19,
    arena_precision="fp32",
)
