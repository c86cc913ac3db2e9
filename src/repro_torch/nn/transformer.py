"""Config-driven decoder-only transformer (port of ``repro.nn.transformer``):
GQA with optional KV-head replication, RoPE, RMSNorm, the dense SwiGLU FFN,
local (sliding-window) / global attention layer patterns, prefill through
the chunked attention or the flash-attention kernel, and KV-cache decode
with ring buffers for windowed layers.

The parameter tree is the reference's: layers stacked per pattern position
as ``[G, ...]`` leaves under ``params["groups"]["p{i}"]``, the remainder
layers under ``params["rem"]``, so a converted JAX tree is a plain copy.
Where the reference scans over the groups, the port loops over them and
indexes the stacked leaves.  ``constrain``, ``Param``, ``split_params`` and
``remat`` are mesh and autodiff plumbing with no counterpart on this path;
``init_lm`` returns the values tree only.

Decode updates its caches in place (the reference's
``dynamic_update_slice`` returns new arrays): the returned caches are the
same tensors, and a full-length cache is never copied per token.

Not ported yet, and raising ``NotImplementedError``: ``ffn="moe"`` and
``kv_cache_int8=True`` (ROADMAP item 15: the MoE slice, and int8 KV-cache
decode).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M

__all__ = ["TransformerConfig", "init_lm", "forward", "prefill", "decode_step",
           "init_decode_caches"]

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    ffn: str = "dense"  # "dense" | "moe"
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    pattern: Tuple[str, ...] = ("global",)  # attention kinds, cycled over layers
    window: int = 1024
    kv_repeat: int = 1  # replicate kv heads (sharding over model axis > kv heads)
    rope_theta: float = 10000.0
    dtypes: L.Dtypes = L.Dtypes()
    remat: bool = True
    block_q: int = 512
    block_k: int = 512
    use_pallas: bool = False
    moe_dp_groups: int = 1
    moe_impl: str = "global"
    kv_cache_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def eff_kv_heads(self) -> int:
        return self.n_kv_heads * self.kv_repeat

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.pattern)

    def layer_kind(self, pos_in_pattern: int) -> str:
        return self.pattern[pos_in_pattern]


def _check_ported(cfg: TransformerConfig) -> None:
    if cfg.ffn == "moe":
        raise NotImplementedError("ffn='moe' is not ported yet (ROADMAP item 15: the MoE slice)")
    if cfg.kv_cache_int8:
        raise NotImplementedError(
            "kv_cache_int8 is not ported yet (ROADMAP item 15: int8 KV-cache decode)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: TransformerConfig, device: torch.device,
                lead=()) -> Tree:
    dt = cfg.dtypes
    hd, hq, hkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    lead = tuple(lead)

    def normal(shape, s):
        return torch.randn(lead + shape, generator=gen, dtype=dt.param, device=device).mul_(s)

    def norm():
        return {"scale": torch.ones(lead + (d,), dtype=dt.param, device=device)}

    s = 1.0 / np.sqrt(d)
    return {
        "ln_attn": norm(),
        "wq": normal((d, hq, hd), s),
        "wk": normal((d, hkv, hd), s),
        "wv": normal((d, hkv, hd), s),
        "wo": normal((hq, hd, d), 1.0 / np.sqrt(hq * hd)),
        "ln_ffn": norm(),
        "ffn": M.ffn_init(gen, d, cfg.d_ff, dt, device, lead),
    }


def init_lm(gen: torch.Generator, cfg: TransformerConfig, device: DeviceLike = None) -> Tree:
    """Random parameters drawn from ``gen`` (a generator on ``device``);
    group parameters are stacked ``[G, ...]``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = cfg.dtypes
    params = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, dev)}
    if cfg.n_groups > 0:
        params["groups"] = {f"p{i}": _layer_init(gen, cfg, dev, (cfg.n_groups,))
                            for i in range(len(cfg.pattern))}
    if cfg.n_rem:
        params["rem"] = {f"p{i}": _layer_init(gen, cfg, dev) for i in range(cfg.n_rem)}
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
    head = torch.randn((cfg.d_model, cfg.vocab), generator=gen, dtype=dt.param, device=dev)
    params["head"] = {"w": head.mul_(1.0 / np.sqrt(cfg.d_model))}
    return params


def _index(tree: Any, g: int) -> Any:
    """The ``g``-th slice of every stacked leaf (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, g) for v in tree)
    return tree[g]


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _qkv(p: Tree, x: torch.Tensor, cfg: TransformerConfig, positions: torch.Tensor):
    dt = cfg.dtypes
    h = L.rmsnorm(p["ln_attn"], x, dt)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(dt.compute))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(dt.compute))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(dt.compute))
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cfg.kv_repeat > 1:
        k = k.repeat_interleave(cfg.kv_repeat, dim=2)
        v = v.repeat_interleave(cfg.kv_repeat, dim=2)
    return q, k, v


def _attn_block(p: Tree, x: torch.Tensor, cfg: TransformerConfig, kind: str,
                positions: torch.Tensor):
    q, k, v = _qkv(p, x, cfg, positions)
    window = cfg.window if kind == "local" else None
    o = L.gqa_attention(
        q, k, v, causal=True, window=window,
        block_q=cfg.block_q, block_k=cfg.block_k, use_pallas=cfg.use_pallas,
    )
    o = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.dtypes.compute))
    return x + o, (k, v)


def _ffn_block(p: Tree, x: torch.Tensor, cfg: TransformerConfig):
    h = L.rmsnorm(p["ln_ffn"], x, cfg.dtypes)
    return x + M.ffn_apply(p["ffn"], h, cfg.dtypes), torch.zeros((), device=x.device)


def _layer_fwd(p: Tree, x: torch.Tensor, cfg: TransformerConfig, kind: str,
               positions: torch.Tensor):
    x, _ = _attn_block(p, x, cfg, kind, positions)
    return _ffn_block(p, x, cfg)


def _group_fwd(gp: Tree, x: torch.Tensor, cfg: TransformerConfig, positions: torch.Tensor):
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(cfg.pattern):
        x, a = _layer_fwd(gp[f"p{i}"], x, cfg, kind, positions)
        aux = aux + a
    return x, aux


def forward(params: Tree, cfg: TransformerConfig, tokens: torch.Tensor):
    """tokens [B, S] -> (logits [B, S, V], aux loss)."""
    _check_ported(cfg)
    dt = cfg.dtypes
    b, s = tokens.shape
    x = params["embed"]["table"][tokens].to(dt.compute)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), device=x.device)
    for g in range(cfg.n_groups):
        x, a = _group_fwd(_index(params["groups"], g), x, cfg, positions)
        aux = aux + a
    for i in range(cfg.n_rem):
        x, a = _layer_fwd(params["rem"][f"p{i}"], x, cfg, cfg.layer_kind(i), positions)
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, dt)
    logits = torch.einsum("bsd,dv->bsv", x, params["head"]["w"].to(dt.compute))
    return logits, aux


def prefill(params: Tree, cfg: TransformerConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill forward: last-position logits [B, V].  As in the reference,
    no caches: decode fills its own from position 0."""
    logits, _ = forward(params, cfg, tokens)
    return logits[:, -1]


# ---------------------------------------------------------------------------
# decode with KV caches
# ---------------------------------------------------------------------------


def _cache_len(cfg: TransformerConfig, kind: str, max_len: int) -> int:
    return min(cfg.window, max_len) if kind == "local" else max_len


def _cache_tree(cfg: TransformerConfig, batch: int, max_len: int, make) -> Tree:
    """The caches' structure: ``make(shape)`` for every k and v leaf."""
    _check_ported(cfg)
    hd, hkv = cfg.head_dim, cfg.eff_kv_heads

    def kv(s, lead=()):
        shape = tuple(lead) + (batch, s, hkv, hd)
        return (make(shape), make(shape))

    caches = {}
    if cfg.n_groups > 0:
        caches["groups"] = {
            f"p{i}": kv(_cache_len(cfg, kind, max_len), (cfg.n_groups,))
            for i, kind in enumerate(cfg.pattern)
        }
    if cfg.n_rem:
        caches["rem"] = {
            f"p{i}": kv(_cache_len(cfg, cfg.layer_kind(i), max_len))
            for i in range(cfg.n_rem)
        }
    return caches


def init_decode_caches(cfg: TransformerConfig, batch: int, max_len: int,
                       dtype: Optional[torch.dtype] = None, device: DeviceLike = None) -> Tree:
    """Zeroed KV caches: {"groups": {f"p{i}": (k, v)}, "rem": ...}.

    Group caches are stacked [G, B, S_kind, Hkv_eff, hd]; local layers get
    ring buffers of size ``window``.
    """
    dev = resolve_device(device)
    dtype = dtype or cfg.dtypes.compute
    return _cache_tree(cfg, batch, max_len,
                       lambda shape: torch.zeros(shape, dtype=dtype, device=dev))


def _decode_layer(p: Tree, x: torch.Tensor, cache, cfg: TransformerConfig, kind: str,
                  pos: torch.Tensor) -> torch.Tensor:
    """x [B,1,D]; cache (k,v) [B,S_k,H,hd], updated in place; pos 0-dim."""
    q, k, v = _qkv(p, x, cfg, pos.reshape(1, 1).expand(x.shape[0], 1))
    kc, vc = cache
    s_cache = kc.shape[1]
    # the reference's dynamic_update_slice clamps an index past the end
    idx = pos % s_cache if kind == "local" else torch.clamp(pos, 0, s_cache - 1)
    idx = idx.reshape(1).long()
    kc.index_copy_(1, idx, k.to(kc.dtype))
    vc.index_copy_(1, idx, v.to(vc.dtype))
    valid = torch.clamp_max(pos + 1, s_cache) if kind == "local" else pos + 1
    o = L.decode_attention(q, kc, vc, valid, window=None)
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.dtypes.compute))
    return _ffn_block(p, x, cfg)[0]


def decode_step(params: Tree, cfg: TransformerConfig, caches: Tree, token: torch.Tensor,
                pos: Union[int, torch.Tensor]):
    """One decode step.  token [B,1] int; pos [] int (same for all rows).

    Returns (logits [B, V], caches): the caches are updated in place and
    returned as they were passed.
    """
    _check_ported(cfg)
    dt = cfg.dtypes
    x = params["embed"]["table"][token].to(dt.compute)
    pos = torch.as_tensor(pos, device=x.device)
    for g in range(cfg.n_groups):
        gp, gc = _index(params["groups"], g), _index(caches["groups"], g)
        for i, kind in enumerate(cfg.pattern):
            x = _decode_layer(gp[f"p{i}"], x, gc[f"p{i}"], cfg, kind, pos)
    for i in range(cfg.n_rem):
        x = _decode_layer(params["rem"][f"p{i}"], x, caches["rem"][f"p{i}"], cfg,
                          cfg.layer_kind(i), pos)
    x = L.rmsnorm(params["final_norm"], x, dt)
    logits = torch.einsum("bsd,dv->bsv", x, params["head"]["w"].to(dt.compute))[:, 0]
    return logits, caches
