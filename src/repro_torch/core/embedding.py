"""Embedding config and functional init/lookup (torch port of
``repro.core.embedding``; the word2ketXS kind only — "regular" and
"word2ket" are not ported yet).

``EmbeddingConfig`` holds a :class:`repro_torch.core.ketops.KronSpec` and
keeps the JAX package's scalar keyword constructor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import ketops, word2ketxs

__all__ = ["EmbeddingConfig", "init_embedding", "embed_lookup",
           "embedding_num_params", "embedding_num_bytes"]


@dataclasses.dataclass(frozen=True, init=False)
class EmbeddingConfig(ketops.SpecProps):
    """Configuration of a token-embedding representation (kind
    "word2ketxs"); the ketops knobs fold into ``spec``."""

    vocab_size: int
    embed_dim: int
    kind: str
    spec: ketops.KronSpec

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int,
        kind: str = "word2ketxs",
        order: int = 2,
        rank: int = 1,
        q_dims: Optional[tuple[int, ...]] = None,
        t_dims: Optional[tuple[int, ...]] = None,
        use_layernorm: bool = True,
        dtype: Any = torch.float32,
        quant: str = "none",
        use_kernel: Optional[bool] = None,
    ):
        if kind != "word2ketxs":
            raise NotImplementedError(f"embedding kind {kind!r} is not ported yet")
        spec = ketops.KronSpec(
            in_dim=embed_dim, out_dim=vocab_size, order=order, rank=rank,
            q_dims=q_dims, t_dims=t_dims, use_layernorm=use_layernorm,
            dtype=dtype, quant=quant, use_kernel=use_kernel).validate()
        object.__setattr__(self, "vocab_size", vocab_size)
        object.__setattr__(self, "embed_dim", embed_dim)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "spec", spec)


def init_embedding(gen: torch.Generator, cfg: EmbeddingConfig, device) -> dict:
    return word2ketxs.init(gen, cfg, device)


def embed_lookup(cfg: EmbeddingConfig, params: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> embeddings (..., embed_dim)."""
    return word2ketxs.lookup(cfg, params, ids)


def embedding_num_params(cfg: EmbeddingConfig) -> int:
    return ketops.num_params(cfg.spec)


def embedding_num_bytes(cfg: EmbeddingConfig) -> int:
    """Stored bytes, quant-aware (payloads at the quant width + scales)."""
    return ketops.num_bytes(cfg.spec)
