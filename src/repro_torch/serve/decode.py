"""Decode + chunked prefill over dense or paged KV caches (torch port of the
single-device path of ``repro.serve.decode``).

``serve_step`` decodes one token per slot at per-slot positions
``cache["step"]``; ``prefill_step`` consumes C prompt tokens per slot
through the full forward path (flash attention over the slot's cache with
per-slot query offsets), so a P-token prompt warms its cache in ⌈P/C⌉
calls. The layout of each layer is read from its cache: ``"k"``/``"v"``
(dense slots) or ``"k_pages"``/``"v_pages"`` (paged pools, with the shared
page table ``cache["ptab"]``). The paged decode read is the split-KV
kernel pair of ``kernels/flash_attn``.

Both steps update the K/V tensors of ``cache`` in place (the JAX package
returns new arrays; in place saves a copy of the whole cache per call) and
return ``(logits, cache)`` with ``cache["step"]`` advanced.

A continuous-batching engine advances the step of idle slots too, so a
position can pass the end of the cache. The JAX package drops such a write
(``.at[].set`` drops out-of-range updates) and clamps such a read (gathers
clamp their indices); every write and page lookup here does the same
explicitly, without a host sync.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, embedding_for
from repro_torch.core.embedding import embed_lookup
from repro_torch.kernels.flash_attn import ops as FOPS
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import out_proj, qkv_proj, rmsnorm, rope_angles
from repro_torch.models.transformer import layer_kinds, lm_logits_last
from repro_torch.serve.cache import TRASH_PAGE, gather_pages


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache (B,S,KVH,Dh)[b, slot[b]] <- new (B,KVH,Dh), in place; a slot at
    or past S is dropped (its position is rewritten with what it holds)."""
    B, S = cache.shape[:2]
    ar = torch.arange(B, device=cache.device)
    idx = torch.clamp(slot.long(), 0, S - 1)
    keep = ((slot >= 0) & (slot < S))[:, None, None]
    cache[ar, idx] = torch.where(keep, new.to(cache.dtype), cache[ar, idx])


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


def _page_write(pool: torch.Tensor, ptab: torch.Tensor, pos: torch.Tensor,
                new: torch.Tensor) -> None:
    """pool (P, ps, ...) <- new (B, ...) at logical positions pos (B,), in
    place. A position past the table reads its last entry, as the JAX
    gather clamps; idle slots carry all-trash table rows, so their writes
    land in the trash page, which is never read as valid data."""
    ps = pool.shape[1]
    B = pos.shape[0]
    pos = pos.long()
    col = torch.clamp(pos // ps, max=ptab.shape[1] - 1)
    pid = ptab[torch.arange(B, device=pool.device), col].long()
    pool[pid, pos % ps] = new.to(pool.dtype)


def _page_write_chunk(pool: torch.Tensor, ptab: torch.Tensor, step: torch.Tensor,
                      lens: torch.Tensor, new: torch.Tensor) -> None:
    """pool <- new (B, C, ...) at logical positions step+i for i < lens, in
    place; the ragged tail goes to the trash page."""
    ps = pool.shape[1]
    B, C = new.shape[0], new.shape[1]
    ar = torch.arange(C, device=pool.device)
    pos = step.long()[:, None] + ar  # (B, C)
    valid = ar[None] < lens[:, None]
    col = torch.clamp(pos // ps, max=ptab.shape[1] - 1)
    pid = ptab[torch.arange(B, device=pool.device)[:, None], col].long()
    pid = torch.where(valid, pid, TRASH_PAGE)
    pool[pid, pos % ps] = new.to(pool.dtype)


def paged_kv_decode_attention(cfg, q, k_new, v_new, pool_k, pool_v, ptab, step):
    """Paged decode read: write the new token into its slot's current page,
    then attend over the slot's logical view with the split-KV kernels;
    ``cfg.decode_kv_splits`` (pinned by the engine) fixes the split count.

    The read is position-blind — several slots may map one physical page
    (the prefix cache) — while the single write targets the slot's current
    page only, which the engine keeps private (copy-on-write in
    ``engine._grow``). Returns (out (B,H,Dh), pool_k, pool_v).
    """
    _page_write(pool_k, ptab, step, k_new)
    _page_write(pool_v, ptab, step, v_new)
    out = FOPS.paged_attention(q, pool_k, pool_v, ptab, step + 1,
                               use_kernel=cfg.use_kernels,
                               kv_splits=cfg.decode_kv_splits)
    return out.to(q.dtype), pool_k, pool_v


def decode_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cache: dict,
                 step: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 ptab: torch.Tensor | None = None):
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
    if "k_pages" in cache:
        o, pk, pv = paged_kv_decode_attention(cfg, q, k, v, cache["k_pages"],
                                              cache["v_pages"], ptab, step)
        new_cache = {"k_pages": pk, "v_pages": pv}
    else:
        o, ck, cv = kv_decode_attention(cfg, q, k, v, cache["k"], cache["v"],
                                        step, step + 1)
        new_cache = {"k": ck, "v": cv}
    x = x + out_proj(p["attn"]["wo"], o, dt, cfg.d_model)
    x = x + F.ffn(p["ffn"], rmsnorm(p["ln2"], x), cfg.mlp_type, dt)
    return x, new_cache


def serve_step(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor):
    """tokens (B,) -> (logits (B, vocab) fp32, cache). One decode step at
    per-slot positions cache["step"] (B,)."""
    step = cache["step"]
    ptab = cache.get("ptab")
    x = embed_lookup(embedding_for(cfg), params["embed"], tokens).to(cfg.dtype)
    cos, sin = rope_angles(step[:, None], cfg.head_dim, cfg.rope_theta)  # (B,1,half)
    for i, kind in enumerate(layer_kinds(cfg)):
        x, cache["layers"][i] = decode_block(params["layers"][i], cfg, kind, x,
                                             cache["layers"][i], step, cos, sin, ptab)
    x = rmsnorm(params["final_norm"], x)
    logits = lm_logits_last(params, cfg, x)
    cache["step"] = step + 1
    return logits, cache


def _scatter_chunk(leaf: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
                   new: torch.Tensor) -> None:
    """leaf (B, S, ...)[b, positions[b, c]] <- new (B, C, ...)[b, c] for the
    valid lanes inside the cache only, in place (the JAX code drops the
    others with an out-of-range index; here they are never selected)."""
    b_idx, c_idx = (valid & (positions < leaf.shape[1])).nonzero(as_tuple=True)
    leaf[b_idx, positions[b_idx, c_idx].long()] = new[b_idx, c_idx].to(leaf.dtype)


def _chunk_attention(cfg, kind, p_attn, h, cache, ptab, step, lens, cos, sin):
    """Attention for a prompt chunk h (B, C, d) continuing per-slot caches:
    scatter the chunk's K/V into the cache (fresh positions, so writing
    before reading is safe), then flash-attend over the slot's whole logical
    view with per-slot query offsets (for pools, the gathered view).
    Returns (o (B, C, H, Dh), layer cache)."""
    if kind != "attn":
        raise NotImplementedError(f"prefill for layer kind {kind!r} is not ported yet")
    C = h.shape[1]
    q, k, v = A.attention_qkv(p_attn, cfg, h, cos, sin)
    if "k_pages" in cache:
        _page_write_chunk(cache["k_pages"], ptab, step, lens, k)
        _page_write_chunk(cache["v_pages"], ptab, step, lens, v)
        ck, cv = gather_pages(cache["k_pages"], ptab), gather_pages(cache["v_pages"], ptab)
    else:
        ar = torch.arange(C, device=h.device)
        pos = step[:, None] + ar  # (B, C) absolute positions
        valid = ar[None] < lens[:, None]
        _scatter_chunk(cache["k"], pos, valid, k)
        _scatter_chunk(cache["v"], pos, valid, v)
        ck, cv = cache["k"], cache["v"]
    o = A.flash_attention(q, ck, cv, causal=True, chunk=cfg.attn_chunk, q_offset=step)
    return o, cache


def prefill_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cache: dict,
                  ptab: torch.Tensor | None, step: torch.Tensor, lens: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor):
    """x (B, C, d) chunk continuing per-slot caches at offsets step (B,);
    rows past lens_b are garbage (ignored downstream). Returns (x, cache)."""
    dt = cfg.dtype
    h = rmsnorm(p["ln1"], x)
    o, new_cache = _chunk_attention(cfg, kind, p["attn"], h, cache, ptab, step, lens,
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
    ptab = cache.get("ptab")
    B, C = tokens.shape
    lens = lens.to(step.dtype)
    x = embed_lookup(embedding_for(cfg), params["embed"], tokens).to(cfg.dtype)
    pos = step[:, None] + torch.arange(C, device=tokens.device)  # (B, C)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)  # (B, C, half)
    for i, kind in enumerate(layer_kinds(cfg)):
        x, cache["layers"][i] = prefill_block(params["layers"][i], cfg, kind, x,
                                              cache["layers"][i], ptab, step, lens,
                                              cos, sin)
    x = rmsnorm(params["final_norm"], x)
    last = torch.clamp(lens - 1, 0, C - 1).long()
    x_last = x[torch.arange(B, device=x.device), last]  # (B, d)
    logits = lm_logits_last(params, cfg, x_last)
    cache["step"] = step + lens
    return logits, cache
