"""Config-driven decoder-only transformer (port of ``repro.nn.transformer``):
GQA with optional KV-head replication, RoPE, RMSNorm, the dense SwiGLU FFN
or the top-k MoE (``moe_impl`` "global" or "shard_map"), local
(sliding-window) / global attention layer patterns, prefill through the
chunked attention or the flash-attention kernel, remat of each layer group
in training, and KV-cache decode with ring buffers for windowed layers and
an optional int8 cache.

The parameter tree is the reference's: layers stacked per pattern position
as ``[G, ...]`` leaves under ``params["groups"]["p{i}"]``, the remainder
layers under ``params["rem"]``, so a converted JAX tree is a plain copy.
Where the reference scans over the groups, the port loops over them and
indexes the stacked leaves; where it wraps a group's body in
``jax.checkpoint``, the port wraps it in ``torch.utils.checkpoint`` (when
autograd records: the group's activations are recomputed in the backward,
so a flash layer launches its kernel twice a training step).
``constrain``, ``Param`` and ``split_params`` are mesh plumbing with no
counterpart on this path; ``init_lm`` returns the values tree only.

Decode updates its caches in place (the reference's
``dynamic_update_slice`` returns new arrays): the returned caches are the
same tensors, and a full-length cache is never copied per token.  The int8
cache holds per-(position, head) fp32 scales, and its attention takes the
reference's s8 x s8 -> s32 dots exactly (:func:`_int_dot`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: TransformerConfig, device: torch.device,
                lead=(), promote: bool = False) -> Tree:
    dt = cfg.dtypes
    hd, hq, hkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    lead = tuple(lead)

    def normal(shape, s):
        return M.normal_init(gen, lead + shape, s, dt, device, promote)

    def norm():
        return {"scale": torch.ones(lead + (d,), dtype=dt.param, device=device)}

    s = 1.0 / np.sqrt(d)
    p = {
        "ln_attn": norm(),
        "wq": normal((d, hq, hd), s),
        "wk": normal((d, hkv, hd), s),
        "wv": normal((d, hkv, hd), s),
        "wo": normal((hq, hd, d), 1.0 / np.sqrt(hq * hd)),
        "ln_ffn": norm(),
    }
    if cfg.ffn == "moe":
        p["moe"] = M.moe_init(gen, d, cfg.d_ff, cfg.n_experts, dt, device, lead, promote)
    else:
        p["ffn"] = M.ffn_init(gen, d, cfg.d_ff, dt, device, lead, promote)
    return p


def init_lm(gen: torch.Generator, cfg: TransformerConfig, device: DeviceLike = None,
            promote: bool = False) -> Tree:
    """Random parameters drawn from ``gen`` (a generator on ``device``);
    group parameters are stacked ``[G, ...]``.

    Every leaf is in ``dtypes.param`` (serving: a bf16 config's weights at
    half the bytes).  ``promote`` gives the reference's dtypes instead: its
    init multiplies each matrix's draw by a NumPy or fp32 scale, which
    promotes a bf16 draw to fp32, so the attention, FFN / MoE and head
    matrices are fp32 and only the embedding table and the norm scales
    stay in ``dtypes.param`` (the training state's dtypes)."""
    dev = resolve_device(device)
    dt = cfg.dtypes
    params = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, dev)}
    if cfg.n_groups > 0:
        params["groups"] = {f"p{i}": _layer_init(gen, cfg, dev, (cfg.n_groups,), promote)
                            for i in range(len(cfg.pattern))}
    if cfg.n_rem:
        params["rem"] = {f"p{i}": _layer_init(gen, cfg, dev, (), promote)
                         for i in range(cfg.n_rem)}
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
    params["head"] = {"w": M.normal_init(gen, (cfg.d_model, cfg.vocab),
                                         1.0 / np.sqrt(cfg.d_model), dt, dev, promote)}
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
    dt = cfg.dtypes
    h = L.rmsnorm(p["ln_ffn"], x, dt)
    if cfg.ffn == "moe":
        if cfg.moe_impl == "shard_map":
            out, aux = M.moe_apply_shard_map(p["moe"], h, dt, top_k=cfg.top_k,
                                             capacity_factor=cfg.capacity_factor)
        else:
            out, aux = M.moe_apply(p["moe"], h, dt, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   dp_groups=cfg.moe_dp_groups)
    else:
        out, aux = M.ffn_apply(p["ffn"], h, dt), torch.zeros((), device=x.device)
    return x + out, aux


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
    dt = cfg.dtypes
    b, s = tokens.shape
    x = params["embed"]["table"][tokens].to(dt.compute)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        gp = _index(params["groups"], g)
        if remat:  # the reference's jax.checkpoint: keep the group's input only
            x, a = checkpoint(_group_fwd, gp, x, cfg, positions, use_reentrant=False)
        else:
            x, a = _group_fwd(gp, x, cfg, positions)
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


def _cache_tree(cfg: TransformerConfig, batch: int, max_len: int, make,
                dtype: torch.dtype) -> Tree:
    """The caches' structure: ``make(shape, dtype)`` for every leaf: (k, v)
    in ``dtype``, or with ``kv_cache_int8`` (k, v) int8 codes and their
    fp32 scales ``[..., B, S, H]``."""
    hd, hkv = cfg.head_dim, cfg.eff_kv_heads

    def kv(s, lead=()):
        shape = tuple(lead) + (batch, s, hkv, hd)
        if cfg.kv_cache_int8:
            sshape = shape[:-1]
            return (make(shape, torch.int8), make(shape, torch.int8),
                    make(sshape, torch.float32), make(sshape, torch.float32))
        return (make(shape, dtype), make(shape, dtype))

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
    """Zeroed KV caches: {"groups": {f"p{i}": (k, v)}, "rem": ...}, or
    (k, v, k scales, v scales) a layer with ``kv_cache_int8``.

    Group caches are stacked [G, B, S_kind, Hkv_eff, hd]; local layers get
    ring buffers of size ``window``.
    """
    dev = resolve_device(device)
    return _cache_tree(cfg, batch, max_len,
                       lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev),
                       dtype or cfg.dtypes.compute)


def _decode_layer(p: Tree, x: torch.Tensor, cache, cfg: TransformerConfig, kind: str,
                  pos: torch.Tensor) -> torch.Tensor:
    """x [B,1,D]; cache (k,v) [B,S_k,H,hd] (or int8 codes and scales),
    updated in place; pos 0-dim."""
    q, k, v = _qkv(p, x, cfg, pos.reshape(1, 1).expand(x.shape[0], 1))
    s_cache = cache[0].shape[1]
    # the reference's dynamic_update_slice clamps an index past the end
    idx = pos % s_cache if kind == "local" else torch.clamp(pos, 0, s_cache - 1)
    idx = idx.reshape(1).long()
    valid = torch.clamp_max(pos + 1, s_cache) if kind == "local" else pos + 1
    if cfg.kv_cache_int8:
        kc, vc, ks, vs = cache
        # quantise the new token's K/V per (batch, head)
        for c, sc, t in ((kc, ks, k), (vc, vs, v)):
            codes, scale = _quant_i8(t)
            c.index_copy_(1, idx, codes)
            sc.index_copy_(1, idx, scale)
        o = _decode_attention_i8(q, kc, vc, ks, vs, valid)
    else:
        kc, vc = cache
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
        o = L.decode_attention(q, kc, vc, valid, window=None)
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.dtypes.compute))
    return _ffn_block(p, x, cfg)[0]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``like``'s device: the card divides by a host
    scalar as a multiply by its reciprocal, the reference divides."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _quant_i8(x: torch.Tensor):
    """[..., hd] -> (int8 codes, fp32 scale [...]): symmetric over the last
    dim, ``round`` half to even."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1), 1e-6) / _f32(127.0, x)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


_I8_TERMS = (1 << 24) // (127 * 127)  # 1040: int8 products an exact fp32 sum holds


def _i8_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq)`` of int8 codes as int32, for a contraction of at most
    ``_I8_TERMS`` terms: the card has no int8 einsum, and fp32 products of
    int8 codes summed in any order (TF32 too: the codes are exact there)
    stay integers below 2^24, so exact."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32)).to(torch.int32)


def _value_dot(w8: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """acc [B, H, G, D] = sum over the S cache positions of w8 [B, H, G, S]
    times vc [B, S, H, D], int32 and exact: the positions in chunks of 1024
    (each chunk sum exact in fp32, :func:`_i8_dot`), the chunk sums added
    in int32 (127^2 * 32768 < 2^31)."""
    s = w8.shape[-1]
    c = min(s, 1024)
    pad = -s % c
    wc = F.pad(w8, (0, pad)).unflatten(-1, (-1, c))  # [B, H, G, n, c]
    vcc = F.pad(vc, (0, 0, 0, 0, 0, pad)).unflatten(1, (-1, c))
    return _i8_dot("bhgnc,bnchd->bhgnd", wc, vcc).sum(3, dtype=torch.int32)


def _attention_i8_parts(q, kc, vc, ks, vs, cache_len) -> Dict[str, torch.Tensor]:
    """The int8-KV decode attention with its intermediates: ``q8`` / ``qs``
    (the query's codes and scales), ``raw`` (q8 . k8, int32), ``w8`` /
    ``wmax`` (the row-quantised ``softmax * v scale``), ``acc`` (w8 . v8,
    int32) and ``out``."""
    b, s, hkv, hd = kc.shape
    if hd > _I8_TERMS:
        raise ValueError(f"int8 decode attention: head dim {hd} > {_I8_TERMS}, the widest "
                         f"exact fp32 sum of int8 products")
    hq = q.shape[2]
    g = hq // hkv
    inv_sqrt = float(1.0 / np.sqrt(hd))
    q8, qs = _quant_i8(q.reshape(b, hkv, g, hd))  # scale over hd -> [b, hkv, g]
    raw = _i8_dot("bhgd,bshd->bhgs", q8, kc)
    scores = (raw.to(torch.float32) * qs[..., None] * ks.transpose(1, 2)[:, :, None, :]
              * inv_sqrt)
    validm = torch.arange(s, device=q.device)[None, :] < torch.as_tensor(
        cache_len, device=q.device).expand(b)[:, None]
    scores = torch.where(validm[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    w = p * vs.transpose(1, 2)[:, :, None, :]  # fold the per-position V scales
    wmax = torch.clamp_min(torch.abs(w).amax(-1, keepdim=True), 1e-9)
    w8 = torch.clamp(torch.round(w / wmax * 127.0), -127, 127).to(torch.int8)
    acc = _value_dot(w8, vc)
    out = acc.to(torch.float32) * (wmax / _f32(127.0, wmax))
    return {"q8": q8, "qs": qs, "raw": raw, "w8": w8, "wmax": wmax, "acc": acc,
            "out": out.reshape(b, 1, hq, hd).to(q.dtype)}


def _decode_attention_i8(q, kc, vc, ks, vs, cache_len) -> torch.Tensor:
    """int8-KV decode attention with the scales factored out of the int8
    dots (the reference's ``_decode_attention_i8``)::

        scores_j = (q8 . k8_j) * qs * ks_j / sqrt(hd)
        out_d    = (sum_j w8_j * v8_j[d]) * wmax / 127

    where ``w_j = softmax_j * vs_j`` is row-quantised to ``w8``.  q [B, 1,
    Hq, hd]; kc / vc int8 [B, S, H, hd]; ks / vs [B, S, H]."""
    return _attention_i8_parts(q, kc, vc, ks, vs, cache_len)["out"]


def decode_step(params: Tree, cfg: TransformerConfig, caches: Tree, token: torch.Tensor,
                pos: Union[int, torch.Tensor]):
    """One decode step.  token [B,1] int; pos [] int (same for all rows).

    Returns (logits [B, V], caches): the caches are updated in place and
    returned as they were passed.
    """
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
