"""Model input shapes (the recsys and graph parts of
``repro.configs.shapes``, copied: the port imports nothing of the JAX
package)."""

RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_DEFS = {
    "train_batch": ("train", 65536),
    "serve_p99": ("serve", 512),
    "serve_bulk": ("serve", 262144),
    "retrieval_cand": ("retrieval", 1),  # + n_candidates=1_000_000
}
N_CANDIDATES = 1_000_000

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

# Criteo Kaggle per-field cardinalities (public; sum = 33,762,577)
CRITEO_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

# Avazu-like 13-field split; last field adjusted so the total matches the
# paper's Table 1 (9,445,823 rows)
_AVAZU_BASE = (241, 8, 8, 3697, 4614, 25, 6_500_000, 2_500_000, 26, 8, 10, 432, 0)
AVAZU_VOCABS = _AVAZU_BASE[:-1] + (9_445_823 - sum(_AVAZU_BASE[:-1]),)
assert sum(AVAZU_VOCABS) == 9_445_823

# FM (criteo-full featurization): 26 categorical + 13 bucketized-dense fields
# of 100 rows, plus a padding field that rounds the total up to a multiple of
# 512 (33,764,352 rows in 40 fields)
_FM_RAW = CRITEO_VOCABS + (100,) * 13
FM_VOCABS = _FM_RAW + (-(-sum(_FM_RAW) // 512) * 512 - sum(_FM_RAW),)
assert sum(FM_VOCABS) % 512 == 0
