"""Shared math of the kron kernels as plain torch (port of
``repro.kernels.common``).

These are the plain versions the CUDA kernels are held against:

  * the balanced tensor-product tree with per-node non-affine LayerNorm
    (the ``kron_gather`` inner math) as a forward-with-residuals /
    backward-sweep pair, so the backward re-walks the forward's pairing
    with its saved LN statistics;
  * the Kronecker factor chain ``x · (Σ_k ⊗_j F_jk)``: the rank-folded
    forward of ``kron_matmul`` with its analytic VJP (the ket linears'
    backward), and the plain chain with its analytic VJP (the
    ``kron_logits`` CE forward and backward).

The TPU's one-hot gather has no counterpart here: on the card a gather is
an indexed load.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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


def num_tree_nodes(n_leaves: int) -> int:
    return n_leaves - 1


def _pair_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(*a.shape[:-1], a.shape[-1] * b.shape[-1])


def tree_forward(leaves: Sequence[torch.Tensor], use_layernorm: bool,
                 eps: float = LN_EPS,
                 stats: Optional[tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]] = None,
                 skip_root: bool = False):
    """Balanced kron tree over ``(..., q_j)`` leaves with optional per-node
    non-affine LN. Returns ``(root, (vals, means, rstds))``: the residuals
    hold every node value and the LN moments, what :func:`tree_backward`
    needs.

    ``stats`` (``(means, rstds)`` lists indexed by node id, each
    ``(..., 1)``) replaces the moments by saved ones, so a backward replay
    agrees with the forward that saved them. ``skip_root=True`` leaves the
    root node unbuilt (``root`` is None): the backward's separable root
    split never reads it, and it is the full ``(..., prod q)`` tensor. With
    LN it needs ``stats``, since the root moments need the root.
    """
    plan, root = tree_plan(len(leaves))
    vals: dict = {("leaf", j): v for j, v in enumerate(leaves)}
    means: list = []
    rstds: list = []
    for idx, (tok, lt, rt) in enumerate(plan):
        if skip_root and idx == len(plan) - 1:
            if use_layernorm:
                if stats is None:
                    raise ValueError("skip_root with LayerNorm needs the saved stats")
                means.append(stats[0][tok[1]])
                rstds.append(stats[1][tok[1]])
            vals[tok] = None
            break
        z = _pair_kron(vals[lt], vals[rt])
        if use_layernorm:
            if stats is not None:
                mu, rstd = stats[0][tok[1]], stats[1][tok[1]]
            else:
                mu = z.mean(dim=-1, keepdim=True)
                rstd = torch.rsqrt((z - mu).square().mean(dim=-1, keepdim=True) + eps)
            z = (z - mu) * rstd
            means.append(mu)
            rstds.append(rstd)
        vals[tok] = z
    return vals[root], (vals, means, rstds)


def tree_backward(n_leaves: int, d_root2d: torch.Tensor, use_layernorm: bool,
                  residuals) -> list[torch.Tensor]:
    """Cotangents of the tree leaves ``(B, r, q_j)`` given the rank-summed
    root cotangent ``d_root2d (B, prod q)`` (the same for every rank: the
    forward ends in a rank sum) and the residuals of :func:`tree_forward`.

    The root split uses the Kronecker structure: with ``z = u ⊗ v``,
    ``Σ(u⊗v) = Σu·Σv``, ``Σ(u⊗v)² = Σu²·Σv²``, and the cotangent
    contraction is one batched product against the ``(B, M, N)`` view of
    the cotangent, so no ``(B, r, prod q)`` tensor is built. Lower nodes
    take the non-affine LN VJP ``dz = rstd·(dy − mean(dy) − y·mean(dy·y))``.
    """
    vals, means, rstds = residuals
    plan, _ = tree_plan(n_leaves)
    if not plan:  # single leaf: the cotangent broadcasts over the rank
        leaf = vals[("leaf", 0)]
        return [d_root2d[:, None, :].expand(leaf.shape)]

    tok, lt, rt = plan[-1]
    u, v = vals[lt], vals[rt]  # (B, r, M), (B, r, N)
    bsz, M, N = d_root2d.shape[0], u.shape[-1], v.shape[-1]
    pn = M * N
    D = d_root2d.reshape(bsz, M, N)
    Dv = torch.einsum("bmn,brn->brm", D, v)
    Du = torch.einsum("bmn,brm->brn", D, u)
    if use_layernorm:
        mu, rstd = means[tok[1]], rstds[tok[1]]  # (B, r, 1)
        su1 = u.sum(-1, keepdim=True)
        su2 = (u * u).sum(-1, keepdim=True)
        sv1 = v.sum(-1, keepdim=True)
        sv2 = (v * v).sum(-1, keepdim=True)
        mbar = d_root2d.mean(-1)[:, None, None]  # (B, 1, 1)
        # c = mean(dy·y) with y = rstd·(u⊗v − μ): Σ dy·y = rstd·(uᵀDv − μ·P·m̄)
        udv = (u * Dv).sum(-1, keepdim=True)
        c = rstd * (udv - mu * pn * mbar) / pn
        du = rstd * ((Dv - mbar * sv1) - c * rstd * (u * sv2 - mu * sv1))
        dv = rstd * ((Du - mbar * su1) - c * rstd * (v * su2 - mu * su1))
    else:
        du, dv = Dv, Du
    cot = {lt: du, rt: dv}

    for tok, lt, rt in reversed(plan[:-1]):
        dy = cot.pop(tok)
        a, b = vals[lt], vals[rt]
        if use_layernorm:
            y = vals[tok]
            dz = rstds[tok[1]] * (dy - dy.mean(-1, keepdim=True)
                                  - y * (dy * y).mean(-1, keepdim=True))
        else:
            dz = dy
        dzr = dz.reshape(*a.shape, b.shape[-1])
        cot[lt] = (dzr * b[..., None, :]).sum(-1)
        cot[rt] = (dzr * a[..., :, None]).sum(-2)
    return [cot[("leaf", j)] for j in range(n_leaves)]


def chain_fused_forward(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x (B, prod q) @ (Σ_k ⊗_j F_jk)`` -> ``(B, prod t)``, with the rank
    sum folded into the last contraction.

    Factors are ``(rank, q_j, t_j)``. Column order is ``(t_1, …, t_n)``
    row-major, matching mixed-radix ids. Every contraction runs in fp32
    (fp64 for fp64 ``x``, for gradient checks).
    """
    q_dims = tuple(f.shape[1] for f in factors)
    n = len(factors)
    b = x.shape[0]
    dt = acc_dtype(x)
    z = x.to(dt).reshape((b,) + q_dims)
    fs = [f.to(dt) for f in factors]
    if n == 1:
        return torch.einsum("bq,rqt->bt", z, fs[0])
    for i, f in enumerate(fs[:-1]):
        # z: (B, q_i, ..., q_n) then (B, r, q_{i+1}, ..., q_n, t_1, ..., t_i)
        if i == 0:
            z = torch.einsum("bq...,rqt->brt...", z, f)
        else:
            z = torch.einsum("brq...,rqt->brt...", z, f)
        z = torch.movedim(z, 2, 2 + (n - 1))
    # layout (B, r, q_n, t_1..t_{n-1}); contract q_n AND the rank axis
    z = torch.einsum("brq...,rqt->b...t", z, fs[-1])
    return z.reshape(b, -1)


def chain_fused_vjp(x: torch.Tensor, factors: Sequence[torch.Tensor],
                    d_out: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Analytic VJP of :func:`chain_fused_forward`: ``(dx (B, prod q),
    [dF_j])`` from the output cotangent ``d_out (B, prod t)``.

    The cotangent is never broadcast over the rank: the last factor's
    contractions are the transposed folded GEMMs of the forward
    (``dz = g·F_nᵀ``, ``dF_n = z_{n-1}ᵀ·g``), and the other factors take the
    plain reverse sweep. The chain intermediates are recomputed, not saved.
    Contractions run in ``x``'s dtype promoted to at least fp32.
    """
    q_dims = tuple(f.shape[1] for f in factors)
    t_dims = tuple(f.shape[2] for f in factors)
    n = len(factors)
    b = x.shape[0]
    dt = acc_dtype(x)
    fs = [f.to(dt) for f in factors]
    d_out = d_out.to(dt)
    if n == 1:
        # y = Σ_r x·F_r: every rank slice sees the same cotangent
        df = torch.einsum("bq,bt->qt", x.to(dt).reshape(b, -1), d_out)
        dx = torch.einsum("bt,qt->bq", d_out, fs[0].sum(dim=0))
        return dx, [df[None].expand(fs[0].shape).contiguous()]

    zs = []
    z = x.to(dt).reshape((b,) + q_dims)
    for i, f in enumerate(fs[:-1]):
        zs.append(z)
        spec = "bq...,rqt->brt..." if i == 0 else "brq...,rqt->brt..."
        z = torch.movedim(torch.einsum(spec, z, f), 2, 2 + (n - 1))
    # z layout: (B, r, q_n, t_1..t_{n-1}), the folded last step's input
    dfactors: list = [None] * n
    d = d_out.reshape((b,) + t_dims)  # (B, t_1..t_n), no rank broadcast
    dfactors[n - 1] = torch.einsum("brq...,b...t->rqt", z, d)
    d = torch.einsum("b...t,rqt->brq...", d, fs[-1])
    for i in range(n - 2, -1, -1):
        d_moved = torch.movedim(d, 2 + (n - 1), 2)  # t_i back to axis 2
        if i == 0:
            dfactors[0] = torch.einsum("bq...,brt...->rqt", zs[0], d_moved)
            d = torch.einsum("brt...,rqt->bq...", d_moved, fs[0])
        else:
            dfactors[i] = torch.einsum("brq...,brt...->rqt", zs[i], d_moved)
            d = torch.einsum("brt...,rqt->brq...", d_moved, fs[i])
    return d.reshape(b, -1), dfactors


def chain_forward(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``x (B, P)`` -> ``(B, prod t)`` via the plain factor chain (the rank
    axis carried to the end, then summed). Factors may be tiles (F_1 sliced
    along t_1): only their own shapes matter. Contractions run in ``x``'s
    dtype promoted to at least fp32."""
    q_dims = tuple(f.shape[1] for f in factors)
    n = len(factors)
    b = x.shape[0]
    dt = acc_dtype(x)
    z = x.to(dt).reshape((b,) + q_dims)
    for i, f in enumerate(factors):
        spec = "bq...,rqt->brt..." if i == 0 else "brq...,rqt->brt..."
        z = torch.einsum(spec, z, f.to(dt))
        z = torch.movedim(z, 2, 2 + (n - 1))
    return z.sum(dim=1).reshape(b, -1)


def chain_vjp(x: torch.Tensor, factors: Sequence[torch.Tensor],
              d_logits: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Analytic VJP of :func:`chain_forward`: ``(dx, [dF_j])``. Recomputes
    the chain intermediates (none are saved) and sweeps back with one
    ``(z_i, d)`` and one ``(d, F_i)`` contraction per factor."""
    q_dims = tuple(f.shape[1] for f in factors)
    t_dims = tuple(f.shape[2] for f in factors)
    n = len(factors)
    b = x.shape[0]
    dt = acc_dtype(x)
    fs = [f.to(dt) for f in factors]
    zs = []
    z = x.to(dt).reshape((b,) + q_dims)
    for i, f in enumerate(fs):
        zs.append(z)
        spec = "bq...,rqt->brt..." if i == 0 else "brq...,rqt->brt..."
        z = torch.movedim(torch.einsum(spec, z, f), 2, 2 + (n - 1))

    rank = fs[0].shape[0]
    d = d_logits.to(dt).reshape((b,) + t_dims)
    d = d[:, None].expand((b, rank) + t_dims)  # undo the rank sum
    dfactors: list = [None] * n
    for i in range(n - 1, -1, -1):
        d_moved = torch.movedim(d, 2 + (n - 1), 2)  # t_i back to axis 2
        if i == 0:
            dfactors[0] = torch.einsum("bq...,brt...->rqt", zs[0], d_moved)
            d = torch.einsum("brt...,rqt->bq...", d_moved, fs[0])
        else:
            dfactors[i] = torch.einsum("brq...,brt...->rqt", zs[i], d_moved)
            d = torch.einsum("brt...,rqt->brq...", d_moved, fs[i])
    return d.reshape(b, -1), dfactors


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp64 stays fp64 (gradient checks); everything else accumulates in fp32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32
