"""Plain PyTorch version of the rank-folded Kronecker chain (port of the
forward of ``repro.kernels.kron_matmul``).

The CPU route and the CPU tests run it; on the card ``chip_smoke.py`` holds
the CUDA kernel against it. Its contractions are fp32 matmuls, so on the
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
    """``x @ (Σ_k ⊗_j F_jk)`` -> ``(B, out_dim)`` fp32: ``x`` zero-padded up
    to ``prod q``, columns sliced to ``out_dim``."""
    P = math.prod(f.shape[1] for f in factors)
    x2 = x.float()
    if P > x2.shape[-1]:
        x2 = F.pad(x2, (0, P - x2.shape[-1]))
    return C.chain_fused_forward(x2, factors)[:, :out_dim]
