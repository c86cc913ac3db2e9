"""Analytic model FLOPs per (arch x shape) (port of
``repro.launch.model_flops``): the *useful* flops a perfect implementation
would execute, the numerator of a cell's MFU.

Conventions: train = 3x forward (bwd = 2x fwd; remat recompute is not
counted, so a measured step that recomputes shows it as lost MFU);
prefill / serve = 1x forward; decode = one-token forward including the
attention reads over the KV cache.  Causal attention scores count the
triangle (x0.5).  All values are GLOBAL flops; divide by the cards for a
per-card figure.

The reference walks its ``configs.REGISTRY`` of ``Arch`` objects, which
the port leaves out (they are dry-run machinery); :data:`ARCHS` is the
same table of ``(arch, family, shapes)`` in the registry's order, and the
arithmetic reads only the port's configs: each config module's
``CONFIG``, ``lm_common.SHAPE_DEFS``, ``shapes.RECSYS_DEFS`` /
``N_CANDIDATES`` and ``gatedgcn.SHAPE_CFG``.  Plain Python, no device.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.configs.lm_common import SHAPE_DEFS as LM_SHAPE_DEFS
from repro_torch.configs.shapes import GNN_SHAPES, RECSYS_SHAPES

__all__ = ["ARCHS", "model_flops", "all_model_flops"]

# (arch, family, shapes), in the reference registry's order; the DLRMs'
# shapes are the reference's PAPER_SHAPES
ARCHS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("grok-1-314b", "lm", LM_SHAPES),
    ("olmoe-1b-7b", "lm", LM_SHAPES),
    ("gemma3-27b", "lm", LM_SHAPES),
    ("smollm-360m", "lm", LM_SHAPES),
    ("internlm2-20b", "lm", LM_SHAPES),
    ("gatedgcn", "gnn", GNN_SHAPES),
    ("din", "recsys", RECSYS_SHAPES),
    ("dien", "recsys", RECSYS_SHAPES),
    ("fm", "recsys", RECSYS_SHAPES),
    ("mind", "recsys", RECSYS_SHAPES),
    ("dlrm-criteo", "recsys", ("paper_16k",)),
    ("dlrm-avazu", "recsys", ("paper_64k",)),
)
_FAMILY = {name: family for name, family, _ in ARCHS}


def _config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}").CONFIG


def _lm_fwd_flops(cfg, tokens: int, seq: int, decode: bool = False) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    L = cfg.n_layers
    proj = 2 * d * (hq * hd + 2 * hkv * hd) + 2 * hq * hd * d  # qkv + o
    if cfg.ffn == "moe":
        ffn = 2 * 3 * d * cfg.d_ff * cfg.top_k + 2 * d * cfg.n_experts
    else:
        ffn = 2 * 3 * d * cfg.d_ff
    # attention context per token
    n_local = sum(1 for k in (cfg.pattern * L)[:L] if k == "local")
    n_global = L - n_local
    if decode:
        attn_per_layer_g = 4 * seq * hq * hd
        attn_per_layer_l = 4 * min(cfg.window, seq) * hq * hd
    else:
        attn_per_layer_g = 4 * seq * hq * hd * 0.5
        attn_per_layer_l = 4 * min(cfg.window, seq) * hq * hd * 0.75
    attn = n_global * attn_per_layer_g + n_local * attn_per_layer_l
    vocab = 2 * d * cfg.vocab
    return tokens * (L * (proj + ffn) + attn + vocab)


def _gnn_fwd_flops(n_nodes: int, n_edges: int, d: int, layers: int, d_feat: int) -> float:
    dense = 5 * 2 * n_nodes * d * d  # A, B, C, U, V
    edges = 12 * n_edges * d  # gate, messages, normalization
    return layers * (dense + edges) + 2 * n_nodes * d_feat * d


def _gru_flops(tokens: int, seq: int, d_in: int, d_h: int) -> float:
    return tokens * seq * 2 * 3 * (d_in * d_h + d_h * d_h)


def model_flops(arch: str, shape: str) -> float:
    """GLOBAL useful flops of the cell (0.0: not modelled)."""
    if _FAMILY[arch] == "lm":
        cfg = _config(arch)
        kind, batch, seq = LM_SHAPE_DEFS[shape]
        if kind == "train":
            return 3 * _lm_fwd_flops(cfg, batch * seq, seq)
        if kind == "prefill":
            return _lm_fwd_flops(cfg, batch * seq, seq)
        return _lm_fwd_flops(cfg, batch, seq, decode=True)

    if arch == "gatedgcn":
        from repro_torch.configs.gatedgcn import SHAPE_CFG

        kind, n, e, d_feat, n_cls, task, _ = SHAPE_CFG[shape]
        return 3 * _gnn_fwd_flops(n, e, 70, 16, d_feat)

    if arch.startswith("dlrm"):
        c = _config(arch)
        f1 = len(c.vocab_sizes) + 1
        bot = 2 * sum(a * b for a, b in zip((c.n_dense,) + c.bottom_mlp[:-1], c.bottom_mlp))
        inter = 2 * f1 * f1 * c.embed_dim
        top_in = c.embed_dim + f1 * (f1 - 1) // 2
        top = 2 * sum(a * b for a, b in zip((top_in,) + c.top_mlp, c.top_mlp + (1,)))
        return 3 * c.batch_size * (bot + inter + top)

    # recsys
    from repro_torch.configs.shapes import N_CANDIDATES, RECSYS_DEFS

    kind, batch = RECSYS_DEFS[shape]
    n = N_CANDIDATES if kind == "retrieval" else batch
    mult = 3 if kind == "train" else 1

    if arch == "fm":
        c = _config("fm")
        f, d = len(c.vocab_sizes), c.embed_dim
        return mult * n * (4 * f * d)
    if arch in ("din", "dien"):
        c = _config("din") if arch == "din" else _config("dien")
        d, t = c.embed_dim, c.seq_len
        attn_in = 8 * d
        attn = t * 2 * (attn_in * 80 + 80 * 40 + 40)
        mlp = 2 * (5 * d * 200 + 200 * 80 + 80)
        if arch == "dien":
            gru = _gru_flops(1, t, 2 * d, c.gru_dim) + _gru_flops(1, t, c.gru_dim, c.gru_dim)
            per = gru + attn + mlp
            if kind == "retrieval":
                per = _gru_flops(1, t, 2 * d, c.gru_dim) / n + t * 2 * c.gru_dim * 2  # shared GRU
        else:
            per = attn + mlp
        return mult * n * per
    if arch == "mind":
        c = _config("mind")
        d, t, k = c.embed_dim, c.seq_len, c.n_interests
        caps = 2 * t * d * d + c.capsule_iters * (2 * k * t * d * 2)
        if kind == "retrieval":
            return caps + n * 2 * k * d
        return mult * n * (caps + 2 * k * d)
    return 0.0


def all_model_flops() -> Dict[str, float]:
    """``"arch/shape"`` -> :func:`model_flops` for every shape of every arch
    (the reference maps a cell its arithmetic cannot run on to 0.0; every
    cell of the table runs)."""
    return {f"{name}/{shape}": model_flops(name, shape)
            for name, _, shapes in ARCHS for shape in shapes}
