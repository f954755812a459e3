"""Decoder-only LM assembly for the ``("attn",)`` pattern (torch port of the
parts of ``repro.models.transformer`` the serving path uses).

The JAX package stacks layers into groups and scans over them; here the
parameters hold a plain list of layers (``params["layers"]``) and every
step loops over it. ``repro_torch.convert`` maps one layout onto the other.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, embedding_for, head_for
from repro_torch.core.embedding import init_embedding
from repro_torch.core.logits import head_logits, init_head
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import init_rmsnorm


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, device) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    return {
        "ln1": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "attn": A.init_attention(gen, cfg, device),
        "ln2": init_rmsnorm(cfg.d_model, cfg.param_dtype, device),
        "ffn": F.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                          cfg.param_dtype, device),
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
