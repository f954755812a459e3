"""Plain PyTorch versions of the fused word2ketXS lookup (port of
``repro.kernels.kron_gather.ref`` and of the host executor
``kron_gather_bwd_host``).

The CPU route and the CPU tests run them; on the card ``chip_smoke.py``
holds the CUDA kernels against them:

  * :func:`kron_gather_ref` — the lookup, in the factors' dtype;
  * :func:`kron_gather_fwd_ref` — the lookup that also returns the per-node
    LN statistics the backward needs (the ``with_stats`` leg);
  * :func:`kron_gather_bwd_ref` — the dedicated backward: re-gathered
    leaves, the tree replayed with the saved statistics, the separable root
    split, and ``index_add_`` in place of the TPU's one-hot scatter;
  * :func:`kron_gather_quant_ref` — the lookup over int8 / fp8 payloads
    with per-rank scales: dequantized, then :func:`kron_gather_ref`.

They run elementwise products, small einsums and means, so TF32 settings do
not touch them in fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core import kron as K
from repro_torch.kernels import common as C


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


def kron_gather_quant_ref(
    factors_q: Sequence[torch.Tensor],  # [(rank, q_j, t_j)] int8 / fp8 payloads
    scales: Sequence[torch.Tensor],  # [(rank, 1, 1)] fp32
    ids: torch.Tensor,  # (N,) int
    *,
    embed_dim: int,
    use_layernorm: bool = True,
) -> torch.Tensor:
    """ids -> (N, embed_dim) fp32 over quantized factor stacks: each stack
    dequantized as ``q.float() * scale``, then :func:`kron_gather_ref`."""
    factors = [q.float() * s for q, s in zip(factors_q, scales)]
    return kron_gather_ref(factors, ids, embed_dim=embed_dim, use_layernorm=use_layernorm)


def _leaves(factors: Sequence[torch.Tensor], ids: torch.Tensor):
    """Mixed-radix digits and the gathered leaves ``(N, r, q_j)`` in at
    least fp32."""
    digits = K.mixed_radix_digits(ids.long(), [f.shape[2] for f in factors])
    dt = C.acc_dtype(factors[0])
    return digits, [f[:, :, d].permute(2, 0, 1).to(dt) for f, d in zip(factors, digits)]


def kron_gather_fwd_ref(
    factors: Sequence[torch.Tensor],
    ids: torch.Tensor,
    *,
    embed_dim: int,
    use_layernorm: bool = True,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The lookup ``(N, embed_dim)`` plus the LN statistics ``(N, 2·nodes,
    rank)`` (``stats[:, 2k]`` the mean, ``stats[:, 2k+1]`` the rstd of node
    k, as the Pallas kernel writes them), or None without LN."""
    _, leaves = _leaves(factors, ids)
    root, (_, means, rstds) = C.tree_forward(leaves, use_layernorm)
    out = root.sum(dim=-2)[..., :embed_dim]
    if not use_layernorm:
        return out, None
    cols = []
    for mu, rstd in zip(means, rstds):
        cols += [mu[..., 0], rstd[..., 0]]  # (N, rank) each
    return out, torch.stack(cols, dim=1)


def kron_gather_bwd_ref(
    factors: Sequence[torch.Tensor],
    ids: torch.Tensor,
    g: torch.Tensor,  # (N, embed_dim) output cotangent
    stats: Optional[torch.Tensor],  # (N, 2·nodes, rank), or None without LN
    *,
    use_layernorm: bool = True,
) -> list[torch.Tensor]:
    """``dL/dF_j`` ``(rank, q_j, t_j)`` of the lookup, in at least fp32."""
    rank = factors[0].shape[0]
    q_dims = [f.shape[1] for f in factors]
    t_dims = [f.shape[2] for f in factors]
    P = math.prod(q_dims)
    n_ids = ids.shape[0]
    digits, leaves = _leaves(factors, ids)
    dt = leaves[0].dtype
    sts = None
    if use_layernorm:
        if stats is None:
            raise ValueError("the LayerNorm backward needs the saved stats")
        raw = stats.to(dt)
        nodes = C.num_tree_nodes(len(factors))
        sts = ([raw[:, 2 * k, :, None] for k in range(nodes)],
               [raw[:, 2 * k + 1, :, None] for k in range(nodes)])
    _, res = C.tree_forward(leaves, use_layernorm, stats=sts, skip_root=True)
    g32 = torch.nn.functional.pad(g.to(dt), (0, P - g.shape[1]))
    dleaves = C.tree_backward(len(factors), g32, use_layernorm, res)
    dfactors = []
    for d, dleaf, qj, tj in zip(digits, dleaves, q_dims, t_dims):
        seg = torch.zeros((tj, rank * qj), dtype=dt, device=g.device)
        seg.index_add_(0, d, dleaf.reshape(n_ids, rank * qj))
        dfactors.append(seg.reshape(tj, rank, qj).permute(1, 2, 0).contiguous())
    return dfactors
