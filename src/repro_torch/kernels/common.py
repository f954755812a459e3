"""Shared forward math of the kron kernels as plain torch (port of the
forward half of ``repro.kernels.common``).

These are the plain versions the CUDA kernels are held against: the
balanced tensor-product tree with per-node non-affine LayerNorm (the
``kron_gather`` inner math) and the rank-folded Kronecker factor chain (the
``kron_matmul`` inner math). The TPU's one-hot gather has no counterpart
here: on the card a gather is an indexed load.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.kron import layernorm

LN_EPS = 1e-5


def largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``k`` (``1 ≤ k``; ``k ≥ n`` -> n)."""
    if k <= 0:
        raise ValueError(f"tile clamp needs k >= 1, got {k}")
    if k >= n:
        return n
    best = 1
    i = 1
    while i * i <= n:
        if n % i == 0:
            if best < i <= k:
                best = i
            j = n // i
            if best < j <= k:
                best = j
        i += 1
    return best


def tree_plan(n_leaves: int) -> tuple[list, tuple]:
    """Pairing structure of the balanced kron tree: ``(plan, root)`` with
    ``plan`` a list of ``(node, left, right)`` tokens in creation order;
    tokens are ``("leaf", j)`` / ``("node", k)``. An odd leftover at any
    level carries up unchanged."""
    level: list = [("leaf", j) for j in range(n_leaves)]
    plan = []
    k = 0
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            tok = ("node", k)
            plan.append((tok, level[i], level[i + 1]))
            nxt.append(tok)
            k += 1
        if len(level) % 2 == 1:
            nxt.append(level[-1])
        level = nxt
    return plan, level[0]


def _pair_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(*a.shape[:-1], a.shape[-1] * b.shape[-1])


def tree_forward(leaves: Sequence[torch.Tensor], use_layernorm: bool,
                 eps: float = LN_EPS) -> torch.Tensor:
    """Balanced kron tree over ``(..., q_j)`` leaves with optional per-node
    non-affine LN; returns the root ``(..., prod q)`` (no saved stats — the
    forward-only leg)."""
    plan, root = tree_plan(len(leaves))
    vals: dict = {("leaf", j): v for j, v in enumerate(leaves)}
    for tok, lt, rt in plan:
        z = _pair_kron(vals[lt], vals[rt])
        vals[tok] = layernorm(z, eps=eps) if use_layernorm else z
    return vals[root]


def chain_fused_forward(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x (B, prod q) @ (Σ_k ⊗_j F_jk)`` -> ``(B, prod t)`` fp32, with the
    rank sum folded into the last contraction.

    Factors are ``(rank, q_j, t_j)``. Column order is ``(t_1, …, t_n)``
    row-major, matching mixed-radix ids. Every contraction runs in fp32.
    """
    q_dims = tuple(f.shape[1] for f in factors)
    n = len(factors)
    b = x.shape[0]
    z = x.float().reshape((b,) + q_dims)
    f32 = [f.float() for f in factors]
    if n == 1:
        return torch.einsum("bq,rqt->bt", z, f32[0])
    for i, f in enumerate(f32[:-1]):
        # z: (B, q_i, ..., q_n) then (B, r, q_{i+1}, ..., q_n, t_1, ..., t_i)
        if i == 0:
            z = torch.einsum("bq...,rqt->brt...", z, f)
        else:
            z = torch.einsum("brq...,rqt->brt...", z, f)
        z = torch.movedim(z, 2, 2 + (n - 1))
    # layout (B, r, q_n, t_1..t_{n-1}); contract q_n AND the rank axis
    z = torch.einsum("brq...,rqt->b...t", z, f32[-1])
    return z.reshape(b, -1)
