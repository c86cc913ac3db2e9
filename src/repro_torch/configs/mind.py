"""MIND (arXiv:1904.08030) at the Taobao scale: items 4 000 000 and users
1 000 000, embed dim 64, histories of 100, 4 interests from 3 routing
iterations, batch 65 536, cache ratio 1.5 % with a unique bound of 2^22
lanes (4 194 304 arena slots), SGD lr 0.05, an fp32 arena.  ``SMOKE`` is
the reference's smoke shape."""
from repro_torch.models.recsys_models import MINDConfig

CONFIG = MINDConfig(
    n_items=4_000_000, n_users=1_000_000, embed_dim=64, seq_len=100,
    n_interests=4, capsule_iters=3, batch_size=65536,
    cache_ratio=0.015, max_unique_per_step=1 << 22, lr=0.05,
    arena_precision="fp32",
)

SMOKE = MINDConfig(n_items=512, n_users=32, embed_dim=16, seq_len=8, batch_size=8,
                   cache_ratio=0.3)
