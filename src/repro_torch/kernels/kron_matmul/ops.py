"""Wrapper of the rank-folded Kronecker chain kernel (``csrc/kron_matmul.cu``).

:func:`kron_matmul` routes by the tensor (``kernels.kernel_route``): a CUDA
tensor launches the CUDA kernel, a CPU tensor runs :func:`kron_matmul_ref`,
the plain version. ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, kernel_route
from repro_torch.kernels.kron_matmul.ref import kron_matmul_ref

__all__ = ["kron_matmul", "kron_matmul_cuda", "kron_matmul_ref", "check_inputs",
           "launches"]

launches = 0
_SMEM_LIMIT = 227 * 1024
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("kron_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w2k_kron_matmul2.argtypes = [p, i, p, p, i, i, i, i, i, p, p, i, p]
        lib.w2k_kron_matmul2.restype = i
        lib.w2k_kron_matmul2_smem_bytes.argtypes = [i, i, i]
        lib.w2k_kron_matmul2_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_kron_matmul2_scratch_floats.argtypes = [i, i, i, i]
        lib.w2k_kron_matmul2_scratch_floats.restype = ctypes.c_longlong
        lib.w2k_error_string.argtypes = [i]
        lib.w2k_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(factors: Sequence[torch.Tensor], x: torch.Tensor,
                 out_dim: int) -> None:
    """What the CUDA kernel takes: order-2 fp32 contiguous ``(rank, q_j,
    t_j)`` stacks of one rank, a 2-D fp32 ``x`` with ``d_in <= prod q``,
    everything on one device, ``out_dim <= prod t``; raises otherwise."""
    if len(factors) != 2:
        raise NotImplementedError(
            f"the kron_matmul CUDA kernel takes order-2 operators, got order "
            f"{len(factors)}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be a 2-D fp32 tensor, got {x.dtype} {tuple(x.shape)}")
    for f in factors:
        if f.dtype != torch.float32 or f.dim() != 3 or not f.is_contiguous():
            raise ValueError(f"factors must be contiguous 3-D fp32 tensors, got "
                             f"{f.dtype} {tuple(f.shape)}")
        if f.device != x.device:
            raise ValueError(f"factor on {f.device}, x on {x.device}")
    if factors[0].shape[0] != factors[1].shape[0]:
        raise ValueError("factors disagree on the rank")
    P = math.prod(f.shape[1] for f in factors)
    T = math.prod(f.shape[2] for f in factors)
    if x.shape[1] > P:
        raise ValueError(f"x has {x.shape[1]} features > prod q = {P}")
    if not 0 < out_dim <= T:
        raise ValueError(f"out_dim {out_dim} outside (0, prod t = {T}]")


def kron_matmul_cuda(factors: Sequence[torch.Tensor], x: torch.Tensor,
                     out_dim: int) -> torch.Tensor:
    """Launch the CUDA kernel: x (B, d_in) fp32 -> (B, out_dim) fp32. One
    launch runs its two stages back to back on the current stream, through
    a (B·t1, r·q2) fp32 scratch allocated here."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"kron_matmul_cuda needs CUDA tensors, got {x.device}")
    check_inputs(factors, x, out_dim)
    f1, f2 = factors
    rank, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    smem = lib.w2k_kron_matmul2_smem_bytes(rank, q1, q2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kron_matmul needs {smem} B of shared memory per block "
                         f"(> {_SMEM_LIMIT}) at rank {rank}, q ({q1}, {q2})")
    if x.shape[1] < q1 * q2:  # zero rows of the operator's padding
        x = F.pad(x, (0, q1 * q2 - x.shape[1]))
    x = x.contiguous()
    B = x.shape[0]
    out = torch.empty((B, out_dim), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    scratch = torch.empty(lib.w2k_kron_matmul2_scratch_floats(B, rank, t1, q2),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_kron_matmul2(x.data_ptr(), B, f1.data_ptr(), f2.data_ptr(),
                                  rank, q1, t1, q2, t2, scratch.data_ptr(),
                                  out.data_ptr(), out_dim, stream)
    if rc != 0:
        raise RuntimeError(f"kron_matmul launch failed: "
                           f"{lib.w2k_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return out


def kron_matmul(factors: Sequence[torch.Tensor], x: torch.Tensor, out_dim: int,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (B, d_in) -> (B, out_dim) fp32: the CUDA kernel for CUDA x, the
    plain version for CPU x or ``use_kernel=False``."""
    if kernel_route(use_kernel, x):
        return kron_matmul_cuda(factors, x, out_dim)
    return kron_matmul_ref(factors, x, out_dim)
