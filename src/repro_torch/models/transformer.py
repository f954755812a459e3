"""Decoder-only LM assembly for the ``("attn",)`` pattern (torch port of the
parts of ``repro.models.transformer`` the serving and training paths use).

The JAX package stacks layers into groups and scans over them; here the
parameters hold a plain list of layers (``params["layers"]``) and every
step loops over it. ``repro_torch.convert`` maps one layout onto the other.

Training runs :func:`forward` over the full sequence and :func:`lm_loss`
streams the cross-entropy over vocabulary tiles (logits never built);
``forward(..., want_cache=True)`` also returns each layer's K and V, the
caches of the full-prompt ``models/model.prefill_fn``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, embedding_for, head_for
from repro_torch.core.embedding import embed_lookup, init_embedding
from repro_torch.core.logits import head_ce_loss, head_logits, init_head
from repro_torch.kernels import kernel_route
from repro_torch.kernels.flash_attn import ops as FA
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import init_rmsnorm, linear_opts, rmsnorm, rope_angles


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, device) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    lin = dict(kind=cfg.linear_kind, order=cfg.linear_order, rank=cfg.linear_rank,
               quant=cfg.quant)
    return {
        "ln1": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "attn": A.init_attention(gen, cfg, device),
        "ln2": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "ffn": F.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                          cfg.param_dtype, device, **lin),
    }


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Kind of every layer in order (the pattern repeated over the depth)."""
    pattern = cfg.layer_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {
        "embed": init_embedding(gen, embedding_for(cfg), device),
        "layers": [init_layer(gen, cfg, kind, device) for kind in layer_kinds(cfg)],
        "final_norm": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "head": init_head(gen, head_for(cfg), device),
    }


def head_params(params: dict, cfg: ModelConfig) -> dict:
    """Head parameter subtree (untied: the ported configs have no tying)."""
    return params["head"]


def lm_logits_last(params: dict, cfg: ModelConfig, x_last: torch.Tensor) -> torch.Tensor:
    """x_last (B, d) -> (B, vocab) fp32 logits (decode path)."""
    return head_logits(head_for(cfg), head_params(params, cfg), x_last)


def apply_block(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, want_cache: bool = False):
    """One pre-norm block over the full sequence, x (B, S, d) -> (B, S, d):
    causal GQA attention, then the SwiGLU FFN, each with a residual. The
    attention is the flash kernel's op (``kernels/flash_attn``) when
    ``kernel_route(cfg.use_kernels, q)`` holds, else the plain chunked
    attention. With ``want_cache`` it returns ``(x, {"k", "v"})``, the
    layer's K and V after qk-norm and rope in ``cfg.dtype``."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    h = rmsnorm(p["ln1"], x)
    q, k, v = A.attention_qkv(p["attn"], cfg, h, cos, sin)
    if kernel_route(cfg.use_kernels, q):
        o = FA.flash_attention(q, k, v, causal=True)
    else:
        o = A.flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = x + A.attention_out(p["attn"], cfg, o)
    x = x + F.ffn(p["ffn"], rmsnorm(p["ln2"], x), cfg.mlp_type, cfg.dtype,
                  dims=(cfg.d_model, cfg.d_ff), **linear_opts(cfg))
    return (x, {"k": k, "v": v}) if want_cache else x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            want_cache: bool = False):
    """tokens (B, S) -> final-normed hidden states (B, S, d) in ``cfg.dtype``;
    with ``want_cache``, ``(hidden, caches)``: a list with one ``{"k", "v"}``
    (B, S, KVH, Dh) per layer, after qk-norm and rope, in ``cfg.dtype``.

    ``cfg.remat`` sets the activation checkpointing: ``"none"`` keeps every
    activation for the backward; ``"full"`` and ``"dots"`` wrap each layer
    in ``torch.utils.checkpoint(use_reentrant=False)``, so the backward
    keeps only the layer inputs and recomputes the rest. ``"dots"`` saves
    less selectively than JAX's ``checkpoint_dots`` (which keeps the matmul
    outputs too): the numbers are the same, the backward recomputes more.
    """
    x = embed_lookup(embedding_for(cfg), params["embed"], tokens).to(cfg.dtype)
    cos, sin = rope_angles(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                           cfg.rope_theta)
    caches = []
    for p_layer, kind in zip(params["layers"], layer_kinds(cfg)):
        if cfg.remat == "none":
            out = apply_block(p_layer, cfg, kind, x, cos, sin, want_cache)
        else:
            out = checkpoint(apply_block, p_layer, cfg, kind, x, cos, sin, want_cache,
                             use_reentrant=False)
        if want_cache:
            x, cache = out
            caches.append(cache)
        else:
            x = out
    x = rmsnorm(params["final_norm"], x)
    return (x, caches) if want_cache else x


def lm_loss(params: dict, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B, S), labels (B, S) [, label_mask (B, S)] ->
    (mean token CE, metrics). The dense family has no auxiliary loss, so
    the loss is the CE (JAX adds ``0.01 · aux`` with ``aux = 0``)."""
    x = forward(params, cfg, batch["tokens"])
    ce = head_ce_loss(head_for(cfg), head_params(params, cfg), x, batch["labels"],
                      batch.get("label_mask"))
    return ce, {"loss": ce, "ce": ce}
