"""Vocabulary head: the Kronecker (word2ketXS) head, forward only (torch
port of ``repro.core.logits``; the dense head and the streamed CE loss come
with their slices).

With LayerNorm off the embedding operator is exactly F = Σ_k ⊗_j F_jk, so
``logits = h · F`` factorizes into the chain of small matmuls that the
``kron_matmul`` kernel runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import ketops

__all__ = ["HeadConfig", "init_head", "head_logits", "head_num_params",
           "kron_head_logits"]


@dataclasses.dataclass(frozen=True, init=False)
class HeadConfig(ketops.SpecProps):
    """Vocab-head configuration (kind "kron"); a pure (LN-free) KronSpec."""

    vocab_size: int
    embed_dim: int
    kind: str
    spec: ketops.KronSpec

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int,
        kind: str = "kron",
        order: int = 2,
        rank: int = 32,
        q_dims: Optional[tuple[int, ...]] = None,
        t_dims: Optional[tuple[int, ...]] = None,
        dtype: Any = torch.float32,
        use_kernel: Optional[bool] = None,
    ):
        if kind != "kron":
            raise NotImplementedError(f"head kind {kind!r} is not ported yet")
        spec = ketops.KronSpec(
            in_dim=embed_dim, out_dim=vocab_size, order=order, rank=rank,
            q_dims=q_dims, t_dims=t_dims, use_layernorm=False, dtype=dtype,
            use_kernel=use_kernel).validate()
        object.__setattr__(self, "vocab_size", vocab_size)
        object.__setattr__(self, "embed_dim", embed_dim)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "spec", spec)


def init_head(gen: torch.Generator, cfg: HeadConfig, device) -> dict:
    return ketops.init(gen, cfg.spec, device)


def head_num_params(cfg: HeadConfig) -> int:
    return ketops.num_params(cfg.spec)


def kron_head_logits(cfg: HeadConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """h (..., p) -> fp32 logits (..., vocab) via the factor chain."""
    return ketops.apply_matrix(cfg.spec, params, h.float())


def head_logits(cfg: HeadConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    return kron_head_logits(cfg, params, h)
