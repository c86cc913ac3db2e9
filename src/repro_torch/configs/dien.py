"""DIEN (arXiv:1809.03672): DIN's tables and cache layout (items 10 000 000,
categories 1 000 000, users 1 000 256, embed dim 18, histories of 100,
batch 65 536, 4 194 304 arena slots), a GRU and an AUGRU of 108 units, MLP
200-80, SGD lr 0.05, an fp32 arena.  ``SMOKE`` is the reference's smoke
shape (12 GRU units)."""
from repro_torch.models.recsys_models import DIENConfig

CONFIG = DIENConfig(
    n_items=10_000_000, n_cates=1_000_000, n_users=1_000_256,
    embed_dim=18, seq_len=100, gru_dim=108, mlp=(200, 80),
    batch_size=65536, cache_ratio=0.015, max_unique_per_step=1 << 22, lr=0.05,
    arena_precision="fp32",
)

SMOKE = DIENConfig(n_items=512, n_cates=64, n_users=32, seq_len=8, batch_size=8,
                   cache_ratio=0.3, gru_dim=12)
