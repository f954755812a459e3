"""Vocabulary head: the Kronecker (word2ketXS) head (torch port of the kron
branch of ``repro.core.logits``; the dense head comes with its slice).

With LayerNorm off the embedding operator is exactly F = Σ_k ⊗_j F_jk, so
``logits = h · F`` factorizes into the chain of small matmuls that the
``kron_matmul`` kernel runs (decode), and the mean token cross-entropy
:func:`head_ce_loss` streams over vocabulary tiles without building the
``(tokens × vocab)`` logits, forward or backward (training).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import ketops
from repro_torch.kernels import kernel_route
from repro_torch.kernels.kron_logits.ops import fused_kron_ce, kron_ce_tiled

__all__ = ["HeadConfig", "init_head", "head_logits", "head_ce_loss", "head_num_params",
           "kron_head_logits"]


@dataclasses.dataclass(frozen=True, init=False)
class HeadConfig(ketops.SpecProps):
    """Vocab-head configuration (kind "kron"); a pure (LN-free) KronSpec.
    ``vocab_tile`` is the CE's streaming tile in t1 digits (lowered to a
    divisor of t1) on the plain route; the CUDA kernels pick their own."""

    vocab_size: int
    embed_dim: int
    kind: str
    spec: ketops.KronSpec
    vocab_tile: int

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int,
        kind: str = "kron",
        order: int = 2,
        rank: int = 32,
        q_dims: Optional[tuple[int, ...]] = None,
        t_dims: Optional[tuple[int, ...]] = None,
        vocab_tile: int = 4,
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
        object.__setattr__(self, "vocab_tile", vocab_tile)


def init_head(gen: torch.Generator, cfg: HeadConfig, device) -> dict:
    return ketops.init(gen, cfg.spec, device)


def head_num_params(cfg: HeadConfig) -> int:
    return ketops.num_params(cfg.spec)


def kron_head_logits(cfg: HeadConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """h (..., p) -> fp32 logits (..., vocab) via the factor chain."""
    return ketops.apply_matrix(cfg.spec, params, h.float())


def head_logits(cfg: HeadConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    return kron_head_logits(cfg, params, h)


def head_ce_loss(cfg: HeadConfig, params: dict, h: torch.Tensor, labels: torch.Tensor,
                 label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy of ``h (..., p)`` at ``labels (...)``, over
    the tokens where ``label_mask`` is nonzero (all without a mask).

    ``h`` is taken in fp32 and zero-padded to ``prod q``; vocabulary columns
    at or past ``vocab_size`` are masked. On the kernel route (CUDA tensors,
    ``use_kernel`` not False) the fused CE kernels run forward and backward;
    otherwise the vocab-tiled scan with a checkpointed body, which autograd
    differentiates by recomputing each tile's logits.
    """
    x = h.reshape(-1, h.shape[-1]).float()
    y = labels.reshape(-1)
    if kernel_route(cfg.use_kernel, x):
        per_tok = fused_kron_ce(params["factors"], x, y, cfg.vocab_size, cfg.vocab_tile)
    else:
        per_tok = kron_ce_tiled(params["factors"], x, y, cfg.vocab_size, cfg.vocab_tile)
    return _masked_mean(per_tok, label_mask)


def _masked_mean(per_tok: torch.Tensor, label_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if label_mask is not None:
        w = label_mask.reshape(-1).float()
        return (per_tok * w).sum() / torch.clamp(w.sum(), min=1.0)
    return per_tok.mean()
