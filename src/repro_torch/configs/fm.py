"""FM (Rendle ICDM'10) at the Criteo scale: 40 fields (``shapes.FM_VOCABS``,
33 764 352 rows), embed dim 10 (rows of 11: the factors plus the linear
weight), batch 65536, cache ratio 1.5 % with a unique bound of 2^21 lanes
(so the arena holds 2 097 152 slots), SGD lr 0.05, an fp32 arena."""
from repro_torch.configs import shapes as S
from repro_torch.models.recsys_models import FMConfig

CONFIG = FMConfig(
    vocab_sizes=S.FM_VOCABS, embed_dim=10, batch_size=65536,
    cache_ratio=0.015, max_unique_per_step=1 << 21, lr=0.05,
    arena_precision="fp32",
)
