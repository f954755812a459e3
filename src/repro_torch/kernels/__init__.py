"""Hand-written Hopper kernels of the port, and their route.

kron_gather  — fused word2ketXS lookup (digits, column gather, LN kron
               tree, rank sum), with a stats leg and a dedicated backward,
               CUDA C++ in ``csrc/kron_gather.cu``
kron_matmul  — rank-folded Kronecker chain ``x·(Σ_k ⊗_j F_jk)`` (the kron
               head), CUDA C++ in ``csrc/kron_matmul.cu``
kron_logits  — fused Kronecker-head cross-entropy, forward and backward,
               CUDA C++ in ``csrc/kron_logits.cu``
flash_attn   — split-KV paged decode read and its combine, CUDA C++ in
               ``csrc/paged_attention.cu``
common       — the plain torch math the kernels are held against
build        — nvcc build of ``csrc/*.cu`` into ``build/`` and ctypes load

Each kernel package holds ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the wrapper: checks, allocation, launch, launch count).

The route is decided by the tensor, never by a fallback: a CUDA tensor
launches the kernel (a build or launch failure raises), a CPU tensor runs
the plain version. ``use_kernel=False`` selects the plain version on any
device because the caller asked for it.
"""

from __future__ import annotations

from typing import Optional

import torch


def kernel_route(flag: Optional[bool], t: torch.Tensor) -> bool:
    """True when the call on ``t`` goes to the hand-written kernel."""
    if flag is False:
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")
