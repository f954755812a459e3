"""Kronecker / tensor-product algebra underlying word2ketXS (torch port of
``repro.core.kron``).

  - mixed-radix index decomposition (lazy column indexing of a Kronecker
    product: ``col_i(⊗_j F_j) = ⊗_j col_{i_j}(F_j)``),
  - batched Kronecker products of vectors over a balanced binary tree with
    non-affine LayerNorm at each internal node (paper §2.3),
  - the factorization helpers choosing ``q_j`` / ``t_j``; these must agree
    with the JAX package exactly, or converted factor shapes disagree.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = [
    "mixed_radix_digits",
    "mixed_radix_recompose",
    "layernorm",
    "kron_vectors_tree",
    "factorize_dim",
    "choose_factorization",
]


def mixed_radix_digits(ids: torch.Tensor, radices: Sequence[int]) -> list[torch.Tensor]:
    """Decompose integer ids into mixed-radix digits, most-significant first:
    ``ids = sum_j digit_j * prod(radices[j+1:])``."""
    digits = []
    rem = ids
    for j in range(len(radices)):
        base = int(math.prod(radices[j + 1:]))
        digits.append(torch.div(rem, base, rounding_mode="floor"))
        rem = torch.remainder(rem, base)
    return digits


def mixed_radix_recompose(digits: Sequence[torch.Tensor], radices: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`mixed_radix_digits`."""
    out = torch.zeros_like(digits[0])
    for j, d in enumerate(digits):
        out = out + d * int(math.prod(radices[j + 1:]))
    return out


def layernorm(x: torch.Tensor, dim: int = -1, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine LayerNorm used at the balanced-tree nodes (paper §2.3)."""
    mu = x.mean(dim=dim, keepdim=True)
    var = (x - mu).square().mean(dim=dim, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def kron_vectors_tree(
    vs: Sequence[torch.Tensor],
    *,
    use_layernorm: bool = True,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Balanced-binary-tree Kronecker product of ``(..., q_j)`` vectors with
    non-affine LayerNorm at each internal node; an odd leaf at any level
    carries up unchanged. The tree has one home, the plain kernel math
    ``kernels.common.tree_forward``."""
    from repro_torch.kernels.common import tree_forward
    return tree_forward(vs, use_layernorm, eps)


def factorize_dim(dim: int, order: int) -> tuple[int, ...]:
    """Balanced exact factorization of ``dim`` into ``order`` integer factors
    (largest first). Raises if no exact factorization exists near the
    balanced root."""
    factors: list[int] = []
    rem = dim
    for j in range(order, 0, -1):
        f = round(rem ** (1.0 / j))
        best = None
        for cand in range(max(2, f - 64), f + 65):
            if rem % cand == 0:
                if best is None or abs(cand - f) < abs(best - f):
                    best = cand
        if best is None:
            raise ValueError(f"no exact order-{order} factorization of {dim}")
        factors.append(best)
        rem //= best
    if math.prod(factors) != dim:
        raise ValueError(f"no exact order-{order} factorization of {dim}")
    return tuple(sorted(factors, reverse=True))


def choose_factorization(dim: int, order: int) -> tuple[int, ...]:
    """Exact balanced factors when they exist, else the smallest balanced
    factors with ``prod >= dim`` (e.g. 151936, n=2 -> (390, 390))."""
    try:
        return factorize_dim(dim, order)
    except ValueError:
        pass
    base = int(math.ceil(dim ** (1.0 / order)))
    factors = [base] * order
    for j in range(order - 1, -1, -1):
        while factors[j] > 2:
            factors[j] -= 1
            if math.prod(factors) < dim:
                factors[j] += 1
                break
    return tuple(factors)
