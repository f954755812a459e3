"""Attention: GQA with RoPE and qk-norm; chunked (flash-style) softmax for
prefill and a single-token read for decode (torch port of the full-attention
parts of ``repro.models.attention``, dense or ket projections; local
windows and MLA are not ported yet).

Plain PyTorch, as in the JAX package (where neither is a Pallas kernel).
Scores and the probability-weighted sums accumulate in fp32; the
probabilities are rounded to the value dtype first, as in the JAX code.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import (apply_rope, dense_init, linear_init, linear_opts,
                                      out_proj, qkv_proj, rmsnorm)

NEG = -1e30


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, KVH, Dh)
    v: torch.Tensor,  # (B, Skv, KVH, Dh)
    *,
    causal: bool = True,
    chunk: int = 1024,
    q_offset: torch.Tensor | None = None,  # (B,) absolute position of query 0
) -> torch.Tensor:
    """Chunked-softmax attention over KV chunks; never builds the
    (Sq, Skv) score matrix beyond one chunk. ``q_offset`` shifts each
    sequence's query positions (chunked prefill continues a cache at
    per-slot offsets); keys sit at positions 0..Skv-1."""
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KVH
    qf = (q.float() * (Dh ** -0.5)).to(q.dtype).reshape(B, Sq, KVH, G, Dh).float()
    C = min(chunk, Skv)
    dev = q.device
    if q_offset is None:
        qpos = torch.arange(Sq, device=dev)[None]  # (1, Sq)
    else:
        qpos = q_offset[:, None] + torch.arange(Sq, device=dev)[None]  # (B, Sq)

    m = torch.full((B, KVH, G, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, Sq, Dv), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, C):
        kc = k[:, c0:c0 + C]
        vc = v[:, c0:c0 + C]
        kpos = torch.arange(c0, c0 + kc.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kc.float())
        valid = torch.ones((qpos.shape[0], Sq, kpos.shape[0]), dtype=torch.bool, device=dev)
        if causal:
            valid = valid & (kpos[None, None, :] <= qpos[:, :, None])
        s = torch.where(valid[:, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vc.dtype).float(), vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)  # (B,KVH,G,Sq,Dv)->(B,Sq,H,Dv)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, H, Dh): one new token per sequence
    k_cache: torch.Tensor,  # (B, S, KVH, Dh)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) number of valid positions
) -> torch.Tensor:
    """Single-step attention over a dense per-slot KV cache."""
    B, S, KVH, Dh = k_cache.shape
    H = q.shape[1]
    G = H // KVH
    qf = (q.float() * (Dh ** -0.5)).to(q.dtype).reshape(B, KVH, G, Dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    out = (o / torch.clamp(l, min=1e-30)[..., None]).reshape(B, H, Dh)
    return out.to(q.dtype)


def init_attention(gen: torch.Generator, cfg, device="cuda") -> dict:
    dtype = cfg.param_dtype
    d, H, KVH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.linear_kind == "ket":
        kw = dict(kind="ket", order=cfg.linear_order, rank=cfg.linear_rank,
                  quant=cfg.quant)
        p = {
            "wq": linear_init(gen, d, H * Dh, dtype, device, **kw),
            "wk": linear_init(gen, d, KVH * Dh, dtype, device, **kw),
            "wv": linear_init(gen, d, KVH * Dh, dtype, device, **kw),
            "wo": linear_init(gen, H * Dh, d, dtype, device, **kw),
        }
    else:
        p = {
            "wq": dense_init(gen, (d, H, Dh), dtype, fan_in=d, device=device),
            "wk": dense_init(gen, (d, KVH, Dh), dtype, fan_in=d, device=device),
            "wv": dense_init(gen, (d, KVH, Dh), dtype, fan_in=d, device=device),
            "wo": dense_init(gen, (H, Dh, d), dtype, fan_in=H * Dh, device=device),
        }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((Dh,), dtype=dtype, device=device)}
        p["k_norm"] = {"scale": torch.ones((Dh,), dtype=dtype, device=device)}
    return p


def attention_qkv(params: dict, cfg, x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor):
    """x (B,S,d) -> q (B,S,H,Dh), k,v (B,S,KVH,Dh), qk-norm and rope applied."""
    dt = cfg.dtype
    opts = linear_opts(cfg)
    q = qkv_proj(params["wq"], x, dt, cfg.num_heads, cfg.head_dim, **opts)
    k = qkv_proj(params["wk"], x, dt, cfg.num_kv_heads, cfg.head_dim, **opts)
    v = qkv_proj(params["wv"], x, dt, cfg.num_kv_heads, cfg.head_dim, **opts)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_out(params: dict, cfg, o: torch.Tensor) -> torch.Tensor:
    """o (..., H, Dh) -> (..., d_model) through wo (dense or ket)."""
    return out_proj(params["wo"], o, cfg.dtype, cfg.d_model, **linear_opts(cfg))
