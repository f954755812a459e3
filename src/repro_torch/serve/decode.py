"""Decode + chunked prefill over the dense per-slot KV cache (torch port of
the dense, single-device path of ``repro.serve.decode``).

``serve_step`` decodes one token per slot at per-slot positions
``cache["step"]``; ``prefill_step`` consumes C prompt tokens per slot
through the full forward path (flash attention over the slot's cache with
per-slot query offsets), so a P-token prompt warms its cache in ⌈P/C⌉
calls. Both update the K/V tensors of ``cache`` in place (the JAX package
returns new arrays; in place saves a copy of the whole cache per call) and
return ``(logits, cache)`` with ``cache["step"]`` advanced.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, embedding_for
from repro_torch.core.embedding import embed_lookup
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import out_proj, qkv_proj, rmsnorm, rope_angles
from repro_torch.models.transformer import layer_kinds, lm_logits_last


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache (B,S,KVH,Dh)[b, slot[b]] <- new (B,KVH,Dh), in place."""
    B = cache.shape[0]
    cache[torch.arange(B, device=cache.device), slot.long()] = new.to(cache.dtype)


def kv_decode_attention(cfg, q, k_new, v_new, cache_k, cache_v, slot, valid_len):
    """Write (k_new, v_new) at per-slot ``slot`` (B,) and attend (the local
    path; meshes are not ported yet).

    q (B,H,Dh); k_new/v_new (B,KVH,Dh); cache (B,S,KVH,Dh); slot/valid_len
    (B,). Returns (out (B,H,Dh), cache_k, cache_v).
    """
    _scatter_kv(cache_k, k_new, slot)
    _scatter_kv(cache_v, v_new, slot)
    out = A.decode_attention(q, cache_k, cache_v, valid_len)
    return out, cache_k, cache_v


def decode_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cache: dict,
                 step: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, d) one token at per-slot positions step (B,); returns (x, cache)."""
    if kind != "attn":
        raise NotImplementedError(f"decode for layer kind {kind!r} is not ported yet")
    dt = cfg.dtype
    h = rmsnorm(p["ln1"], x)
    q = qkv_proj(p["attn"]["wq"], h, dt, cfg.num_heads, cfg.head_dim)
    k = qkv_proj(p["attn"]["wk"], h, dt, cfg.num_kv_heads, cfg.head_dim)
    v = qkv_proj(p["attn"]["wv"], h, dt, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["attn"]["q_norm"], q)
        k = rmsnorm(p["attn"]["k_norm"], k)
    q = A.apply_rope(q[:, None], cos, sin)[:, 0]
    k = A.apply_rope(k[:, None], cos, sin)[:, 0]
    o, ck, cv = kv_decode_attention(cfg, q, k, v, cache["k"], cache["v"],
                                    step, step + 1)
    x = x + out_proj(p["attn"]["wo"], o, dt, cfg.d_model)
    x = x + F.ffn(p["ffn"], rmsnorm(p["ln2"], x), cfg.mlp_type, dt)
    return x, {"k": ck, "v": cv}


def serve_step(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor):
    """tokens (B,) -> (logits (B, vocab) fp32, cache). One decode step at
    per-slot positions cache["step"] (B,)."""
    step = cache["step"]
    x = embed_lookup(embedding_for(cfg), params["embed"], tokens).to(cfg.dtype)
    cos, sin = rope_angles(step[:, None], cfg.head_dim, cfg.rope_theta)  # (B,1,half)
    for i, kind in enumerate(layer_kinds(cfg)):
        x, cache["layers"][i] = decode_block(params["layers"][i], cfg, kind, x,
                                             cache["layers"][i], step, cos, sin)
    x = rmsnorm(params["final_norm"], x)
    logits = lm_logits_last(params, cfg, x)
    cache["step"] = step + 1
    return logits, cache


def _scatter_chunk(leaf: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
                   new: torch.Tensor) -> None:
    """leaf (B, S, ...)[b, positions[b, c]] <- new (B, C, ...)[b, c] for the
    valid lanes only, in place (the JAX code drops invalid lanes with an
    out-of-range index; here they are never selected)."""
    b_idx, c_idx = valid.nonzero(as_tuple=True)
    leaf[b_idx, positions[b_idx, c_idx].long()] = new[b_idx, c_idx].to(leaf.dtype)


def _chunk_attention(cfg, kind, p_attn, h, cache, step, lens, cos, sin):
    """Attention for a prompt chunk h (B, C, d) continuing per-slot caches
    (the dense full-attention branch): scatter the chunk's K/V into the
    cache (fresh positions, so writing before reading is safe), then
    flash-attend over the slot's whole cache with per-slot query offsets.
    Returns (o (B, C, H, Dh), layer cache)."""
    if kind != "attn":
        raise NotImplementedError(f"prefill for layer kind {kind!r} is not ported yet")
    C = h.shape[1]
    q, k, v = A.attention_qkv(p_attn, cfg, h, cos, sin)
    ar = torch.arange(C, device=h.device)
    pos = step[:, None] + ar  # (B, C) absolute positions
    valid = ar[None] < lens[:, None]
    _scatter_chunk(cache["k"], pos, valid, k)
    _scatter_chunk(cache["v"], pos, valid, v)
    o = A.flash_attention(q, cache["k"], cache["v"], causal=True,
                          chunk=cfg.attn_chunk, q_offset=step)
    return o, cache


def prefill_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cache: dict,
                  step: torch.Tensor, lens: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor):
    """x (B, C, d) chunk continuing per-slot caches at offsets step (B,);
    rows past lens_b are garbage (ignored downstream). Returns (x, cache)."""
    dt = cfg.dtype
    h = rmsnorm(p["ln1"], x)
    o, new_cache = _chunk_attention(cfg, kind, p["attn"], h, cache, step, lens,
                                    cos, sin)
    x = x + out_proj(p["attn"]["wo"], o, dt, cfg.d_model)
    x = x + F.ffn(p["ffn"], rmsnorm(p["ln2"], x), cfg.mlp_type, dt)
    return x, new_cache


def prefill_step(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                 lens: torch.Tensor):
    """Chunked batched prefill: tokens (B, C) prompt chunks at per-slot
    offsets cache["step"], per-slot valid lengths lens (B,) (0 = idle slot).

    Returns (logits (B, vocab) at each slot's last valid chunk position —
    meaningful only for slots whose prompt ends in this chunk — and the
    cache with step advanced by lens).
    """
    step = cache["step"]
    B, C = tokens.shape
    lens = lens.to(step.dtype)
    x = embed_lookup(embedding_for(cfg), params["embed"], tokens).to(cfg.dtype)
    pos = step[:, None] + torch.arange(C, device=tokens.device)  # (B, C)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)  # (B, C, half)
    for i, kind in enumerate(layer_kinds(cfg)):
        x, cache["layers"][i] = prefill_block(params["layers"][i], cfg, kind, x,
                                              cache["layers"][i], step, lens, cos, sin)
    x = rmsnorm(params["final_norm"], x)
    last = torch.clamp(lens - 1, 0, C - 1).long()
    x_last = x[torch.arange(B, device=x.device), last]  # (B, d)
    logits = lm_logits_last(params, cfg, x_last)
    cache["step"] = step + lens
    return logits, cache
