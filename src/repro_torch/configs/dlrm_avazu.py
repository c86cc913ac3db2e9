"""DLRM on Avazu, the paper's second dataset (Table 1: 9 445 823 rows in
13 fields, batch 65 536, SGD lr 5e-2): 8 dense features, embed dim 128,
cache ratio 1.5 %, an fp32 arena (set ``arena_precision`` fp16 / int8 to
tier it).  ``SMOKE`` is the reference's smoke shape."""
from repro_torch.configs import shapes as S
from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig(
    vocab_sizes=S.AVAZU_VOCABS, n_dense=8, embed_dim=128,
    batch_size=65536, cache_ratio=0.015, lr=5e-2, max_unique_per_step=1 << 20,
    arena_precision="fp32",
)

SMOKE = DLRMConfig(vocab_sizes=(64, 32), n_dense=8, embed_dim=8, batch_size=8,
                   cache_ratio=0.5, lr=0.05, bottom_mlp=(16, 8), top_mlp=(16,))
