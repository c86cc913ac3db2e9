"""Substrate layers (port of ``repro.nn.layers``): dense layers and MLP
towers, RMSNorm, LayerNorm, the embedding table, RoPE and grouped-query attention
(chunked online softmax for prefill, or the flash-attention kernel; one-token
decode against a KV cache).

Parameters are nested dicts of tensors with the reference's names
(``{"l0": {"w": [d_in, d_out], "b": [d_out]}, ...}``), so converted JAX
parameters drop straight in.  The compute dtype is separate from the
parameter dtype; softmax and norms accumulate in fp32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["Dtypes", "dense_init", "dense", "mlp_init", "mlp", "rmsnorm_init", "rmsnorm",
           "layernorm_init", "layernorm", "embed_init", "rope", "gqa_attention", "decode_attention"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Dtypes:
    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, dt: Dtypes, device: torch.device, bias: bool = True
) -> Params:
    """Uniform(+-1/sqrt(d_in)) weights, zero bias."""
    bound = 1.0 / np.sqrt(max(d_in, 1))
    w = torch.rand((d_in, d_out), generator=gen, dtype=dt.param, device=device)
    p = {"w": w * (2 * bound) - bound}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dt.param, device=device)
    return p


def dense(p: Params, x: torch.Tensor, dt: Dtypes) -> torch.Tensor:
    y = x.to(dt.compute) @ p["w"].to(dt.compute)
    if "b" in p:
        y = y + p["b"].to(dt.compute)
    return y


def mlp_init(
    gen: torch.Generator, dims: Tuple[int, ...], dt: Dtypes, device: torch.device
) -> Dict[str, Params]:
    """Plain MLP tower: dims = (in, h1, ..., out)."""
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], dt, device) for i in range(len(dims) - 1)}


def mlp(p: Dict[str, Params], x: torch.Tensor, dt: Dtypes,
        act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        final_act: bool = False) -> torch.Tensor:
    """``act`` between the layers (and after the last with ``final_act``)."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x, dt)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def rmsnorm_init(d: int, dt: Dtypes, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dt.param, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, dt: Dtypes, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast to the compute dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(dt.compute)


def layernorm_init(d: int, dt: Dtypes, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dt.param, device=device),
            "bias": torch.zeros((d,), dtype=dt.param, device=device)}


def layernorm(p: Params, x: torch.Tensor, dt: Dtypes, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in fp32 (mean and biased variance over the last axis),
    cast to the compute dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt.compute)


def embed_init(gen: torch.Generator, vocab: int, d: int, dt: Dtypes,
               device: torch.device) -> Params:
    table = torch.randn((vocab, d), generator=gen, dtype=dt.param, device=device)
    return {"table": table.mul_(0.02)}


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, hd]; positions: [..., S].  The
    angles are fp32; a bf16 ``x`` times them is fp32 (as JAX promotes it)
    and the result is cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]  # over heads
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Grouped-query attention (prefill) and decode against a KV cache
# --------------------------------------------------------------------------


def _block_mask(q_idx: torch.Tensor, k_idx: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """[bq, bk] boolean mask for absolute positions q_idx x k_idx."""
    m = torch.ones((q_idx.shape[0], k_idx.shape[0]), dtype=torch.bool, device=q_idx.device)
    if causal:
        m &= q_idx[:, None] >= k_idx[None, :]
    if window is not None:
        m &= (q_idx[:, None] - k_idx[None, :]) < window
    return m


def gqa_attention(
    q: torch.Tensor,  # [B, S, Hq, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd]
    v: torch.Tensor,  # [B, S, Hkv, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 512,
    block_k: int = 512,
    use_pallas: bool = False,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v with kv heads shared by their query
    groups; ``window`` adds the sliding-window constraint.

    ``use_pallas`` takes the flash-attention kernel
    (``kernels.flash_attention.ops``).  Otherwise the reference's chunked
    route runs as torch ops: every (q block, k block) pair with an online
    softmax in fp32 (no ``[S, S]`` buffer), the scores from the fp32 upcast
    of q and k, and ``p`` cast to v's dtype before the PV product, as the
    reference does (so the two routes round differently in bf16)."""
    if use_pallas:
        from repro_torch.kernels.flash_attention import ops as fa_ops

        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)

    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    scale = 1.0 / np.sqrt(hd)
    block_q, block_k = min(block_q, s), min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"gqa_attention: seq {s} must divide blocks ({block_q}, {block_k})")

    qg = q.reshape(b, s, hkv, groups, hd).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, S, hd]
    kk, vv = k.transpose(1, 2), v.transpose(1, 2)  # [B, Hkv, S, hd]
    outs = []
    for q0 in range(0, s, block_q):
        qb = qg[:, :, :, q0:q0 + block_q].float()
        q_pos = torch.arange(q0, q0 + block_q, device=q.device)
        m = torch.full((b, hkv, groups, block_q), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, groups, block_q, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, s, block_k):
            kb, vb = kk[:, :, k0:k0 + block_k], vv[:, :, k0:k0 + block_k]
            k_pos = torch.arange(k0, k0 + block_k, device=q.device)
            s_blk = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb.float()) * scale
            mask = _block_mask(q_pos, k_pos, causal=causal, window=window)
            s_blk = s_blk.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, s_blk.amax(-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        outs.append((acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=3)  # [B, Hkv, G, S, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, hd]
    k_cache: torch.Tensor,  # [B, S, Hkv, hd]
    v_cache: torch.Tensor,  # [B, S, Hkv, hd]
    cache_len: Union[int, torch.Tensor],  # [] or [B] valid prefix length
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention against a KV cache, in fp32 (the
    reference computes it outside any Pallas kernel).  Windowed layers pass
    a ring-buffer cache of size ``window``; masking is by validity only."""
    b, s, hkv, hd = k_cache.shape
    hq = q.shape[2]
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, hkv, hq // hkv, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float() * scale, k_cache.float())
    pos = torch.arange(s, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device).expand(b)[:, None]
    valid = pos[None, :] < cl
    if window is not None:
        valid &= pos[None, :] >= cl - window
    p = torch.softmax(scores.masked_fill(~valid[:, None, None, :], -1e30), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)
