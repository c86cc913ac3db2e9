"""DIN (arXiv:1706.06978) at the Amazon scale: items 10 000 000, categories
1 000 000 and users 1 000 256 (the total divisible by 512), embed dim 18,
histories of 100, attention MLP 80-40, MLP 200-80, batch 65 536, cache
ratio 1.5 % with a unique bound of 2^22 lanes (so the shared arena holds
4 194 304 slots), SGD lr 0.05, an fp32 arena (set ``arena_precision`` fp16
/ int8 to tier it).  ``SMOKE`` is the reference's smoke shape."""
from repro_torch.models.recsys_models import DINConfig

CONFIG = DINConfig(
    n_items=10_000_000, n_cates=1_000_000, n_users=1_000_256,
    embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
    batch_size=65536, cache_ratio=0.015, max_unique_per_step=1 << 22, lr=0.05,
    arena_precision="fp32",
)

SMOKE = DINConfig(n_items=512, n_cates=64, n_users=32, seq_len=8, batch_size=8,
                  cache_ratio=0.3)
