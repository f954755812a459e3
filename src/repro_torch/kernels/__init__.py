"""Hand-written Hopper kernels of the port, and their route.

kron_gather  — fused word2ketXS lookup (digits, column gather, LN kron
               tree, rank sum), with a stats leg, a dedicated backward and
               a dequant-fused leg for int8 / fp8 factors, CUDA C++ in
               ``csrc/kron_gather.cu``
kron_matmul  — rank-folded Kronecker chain ``x·(Σ_k ⊗_j F_jk)`` (the kron
               head and the ket linears), with its backward and a
               dequant-fused forward for int8 / fp8 factors, CUDA C++ in
               ``csrc/kron_matmul.cu``
kron_logits  — fused Kronecker-head cross-entropy, forward and backward,
               CUDA C++ in ``csrc/kron_logits.cu``
flash_attn   — full-sequence flash attention (forward; the backward is the
               oracle's VJP, as in the JAX package), CUDA C++ in
               ``csrc/flash_attn.cu``; the split-KV paged decode read and
               its combine, CUDA C++ in ``csrc/paged_attention.cu``
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

from typing import Optional, Sequence

import torch

# payload dtypes of the dequant-fused kernel legs, and their codes in the C
# entry points
PAYLOAD_KINDS = {torch.int8: 0, torch.float8_e4m3fn: 1}


def kernel_route(flag: Optional[bool], t: torch.Tensor) -> bool:
    """True when the call on ``t`` goes to the hand-written kernel."""
    if flag is False:
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def quant_scales(factors_q: Sequence[torch.Tensor],
                 scales: Sequence[torch.Tensor]) -> tuple[int, list[torch.Tensor]]:
    """What the dequant-fused legs take besides their geometry: payloads all
    int8 or all fp8 e4m3, each with fp32 scales on its device shaped
    ``(rank, 1, 1)`` (one per rank slice, core/quant's wire format) or
    ``(1, 1, 1)`` (one for the whole stack). Returns the payload's code and
    each stack's scales as a contiguous ``(rank,)`` tensor; raises
    otherwise."""
    if len(scales) != len(factors_q):
        raise ValueError(f"{len(factors_q)} payloads but {len(scales)} scales")
    dtypes = {f.dtype for f in factors_q}
    if len(dtypes) != 1 or next(iter(dtypes)) not in PAYLOAD_KINDS:
        raise ValueError(f"payloads must be all int8 or all float8_e4m3fn, got {dtypes}")
    flat = []
    for f, s in zip(factors_q, scales):
        rank = f.shape[0]
        if s.dtype != torch.float32 or tuple(s.shape) not in ((rank, 1, 1), (1, 1, 1)):
            raise ValueError(f"scales must be fp32 ({rank}, 1, 1) or (1, 1, 1), got "
                             f"{s.dtype} {tuple(s.shape)}")
        if s.device != f.device:
            raise ValueError(f"scale on {s.device}, payload on {f.device}")
        flat.append(s.reshape(-1).expand(rank).contiguous())
    return PAYLOAD_KINDS[next(iter(dtypes))], flat


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """The dequant-fused legs are forward-only: quantized payloads are a
    serving format, not trainable parameters. Raise when autograd would
    need a gradient through one of ``tensors``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is forward-only: quantized factors are not "
                           "differentiable (train with quant='none')")
