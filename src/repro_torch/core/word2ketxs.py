"""word2ketXS (paper §3.2): whole-matrix Kronecker-factorized embeddings
(torch port of ``repro.core.word2ketxs``).

The p×d embedding operator is F = Σ_{k=1..r} ⊗_{j=1..n} F_jk, stored as
``order`` factor stacks (rank, q_j, t_j); a lookup extracts columns lazily
through the mixed-radix digits of the id. Thin adapter over
:mod:`repro_torch.core.ketops`; ``cfg`` is an ``EmbeddingConfig``.
"""

from __future__ import annotations

import torch

from repro_torch.core import ketops

__all__ = ["init", "lookup"]


def init(gen: torch.Generator, cfg, device) -> dict:
    return ketops.init(gen, cfg.spec, device)


def lookup(cfg, params: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> (..., embed_dim)."""
    return ketops.apply_vector(cfg.spec, params, ids)
