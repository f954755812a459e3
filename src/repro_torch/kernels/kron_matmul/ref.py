"""Plain PyTorch version of the rank-folded Kronecker chain and its backward
(port of ``repro.kernels.kron_matmul``: the forward, and
``kron_matmul_bwd_host`` over the whole ``t1`` range).

The CPU route and the CPU tests run it; on the card ``chip_smoke.py`` holds
the CUDA kernels against it. Its contractions are fp32 matmuls, so on the
card it needs ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's
default, which ``chip_smoke.py`` sets explicitly).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import common as C


def kron_matmul_ref(
    factors: Sequence[torch.Tensor],  # [(rank, q_j, t_j)] * order
    x: torch.Tensor,  # (B, d_in)
    out_dim: int,
) -> torch.Tensor:
    """``x @ (Σ_k ⊗_j F_jk)`` -> ``(B, out_dim)`` fp32 (fp64 for fp64 ``x``):
    ``x`` zero-padded up to ``prod q``, columns sliced to ``out_dim``."""
    P = math.prod(f.shape[1] for f in factors)
    x2 = x.to(C.acc_dtype(x))
    if P > x2.shape[-1]:
        x2 = F.pad(x2, (0, P - x2.shape[-1]))
    return C.chain_fused_forward(x2, factors)[:, :out_dim]


def kron_matmul_bwd_ref(
    factors: Sequence[torch.Tensor],  # [(rank, q_j, t_j)] * order
    x: torch.Tensor,  # (B, d_in)
    g: torch.Tensor,  # (B, out_dim) cotangent of kron_matmul_ref's output
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The dedicated backward: ``(dx (B, prod q), [dF_j])`` in fp32 (fp64
    for fp64 ``x``). ``x`` is zero-padded up to ``prod q`` and ``g`` past
    ``out_dim`` up to ``prod t`` (those columns were sliced away, so their
    cotangent is zero); the caller slices ``dx`` back to ``d_in``."""
    P = math.prod(f.shape[1] for f in factors)
    T = math.prod(f.shape[2] for f in factors)
    dt = C.acc_dtype(x)
    x2, g2 = x.to(dt), g.to(dt)
    if P > x2.shape[-1]:
        x2 = F.pad(x2, (0, P - x2.shape[-1]))
    if T > g2.shape[-1]:
        g2 = F.pad(g2, (0, T - g2.shape[-1]))
    return C.chain_fused_vjp(x2, factors, g2)
