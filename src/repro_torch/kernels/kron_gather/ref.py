"""Plain PyTorch version of the fused word2ketXS lookup (port of
``repro.kernels.kron_gather.ref``).

The CPU route and the CPU tests run it; on the card ``chip_smoke.py`` holds
the CUDA kernel against it. It runs elementwise products and means only (no
matmul), so TF32 settings do not touch it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import kron as K


def kron_gather_ref(
    factors: Sequence[torch.Tensor],  # [(rank, q_j, t_j)] * order
    ids: torch.Tensor,  # (N,) int
    *,
    embed_dim: int,
    use_layernorm: bool = True,
) -> torch.Tensor:
    """ids -> (N, embed_dim); lazy column extraction + balanced LN tree +
    rank sum, in the factors' dtype."""
    t = [f.shape[2] for f in factors]
    digits = K.mixed_radix_digits(ids.long(), t)
    vs = [f[:, :, d].permute(2, 0, 1) for f, d in zip(factors, digits)]  # (N, r, q_j)
    v = K.kron_vectors_tree(vs, use_layernorm=use_layernorm)  # (N, r, prod q)
    return v.sum(dim=-2)[..., :embed_dim]
