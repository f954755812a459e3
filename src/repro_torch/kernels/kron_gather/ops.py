"""Wrapper of the fused word2ketXS lookup kernel (``csrc/kron_gather.cu``).

:func:`kron_gather` routes by the tensor (``kernels.kernel_route``): a CUDA
tensor launches the CUDA kernel, a CPU tensor runs :func:`kron_gather_ref`,
the plain version. ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build, kernel_route
from repro_torch.kernels.common import LN_EPS
from repro_torch.kernels.kron_gather.ref import kron_gather_ref

__all__ = ["kron_gather", "kron_gather_cuda", "kron_gather_ref", "check_inputs",
           "launches"]

launches = 0
_SMEM_LIMIT = 227 * 1024
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("kron_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w2k_kron_gather2.argtypes = [p, i, p, p, i, i, i, i, i, i,
                                         ctypes.c_float, p, i, p]
        lib.w2k_kron_gather2.restype = i
        lib.w2k_kron_gather2_smem_bytes.argtypes = [i, i, i]
        lib.w2k_kron_gather2_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_error_string.argtypes = [i]
        lib.w2k_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(factors: Sequence[torch.Tensor], ids: torch.Tensor,
                 embed_dim: int) -> None:
    """What the CUDA kernel takes: order-2 fp32 contiguous ``(rank, q_j,
    t_j)`` stacks of one rank, 1-D contiguous int32 ids, everything on the
    ids' device, ``embed_dim <= prod q``; raises otherwise."""
    if len(factors) != 2:
        raise NotImplementedError(
            f"the kron_gather CUDA kernel takes order-2 operators, got order "
            f"{len(factors)}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    for f in factors:
        if f.dtype != torch.float32 or f.dim() != 3 or not f.is_contiguous():
            raise ValueError(f"factors must be contiguous 3-D fp32 tensors, got "
                             f"{f.dtype} {tuple(f.shape)}")
        if f.device != ids.device:
            raise ValueError(f"factor on {f.device}, ids on {ids.device}")
    if factors[0].shape[0] != factors[1].shape[0]:
        raise ValueError("factors disagree on the rank")
    P = math.prod(f.shape[1] for f in factors)
    if not 0 < embed_dim <= P:
        raise ValueError(f"embed_dim {embed_dim} outside (0, prod q = {P}]")
    if math.prod(f.shape[2] for f in factors) >= 2 ** 31:
        raise ValueError("prod t must fit in int32 ids")


def kron_gather_cuda(factors: Sequence[torch.Tensor], ids: torch.Tensor,
                     embed_dim: int, use_layernorm: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: ids (N,) int32 -> (N, embed_dim) fp32. Ids
    outside ``[0, prod t)`` give rows of NaN."""
    global launches
    if ids.device.type != "cuda":
        raise ValueError(f"kron_gather_cuda needs CUDA tensors, got {ids.device}")
    check_inputs(factors, ids, embed_dim)
    f1, f2 = factors
    rank, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    smem = lib.w2k_kron_gather2_smem_bytes(rank, q1, q2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kron_gather needs {smem} B of shared memory per block "
                         f"(> {_SMEM_LIMIT}) at rank {rank}, q ({q1}, {q2})")
    n = ids.shape[0]
    out = torch.empty((n, embed_dim), dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_kron_gather2(ids.data_ptr(), n, f1.data_ptr(), f2.data_ptr(),
                                  rank, q1, t1, q2, t2, int(use_layernorm), LN_EPS,
                                  out.data_ptr(), embed_dim, stream)
    if rc != 0:
        raise RuntimeError(f"kron_gather launch failed: "
                           f"{lib.w2k_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return out


def kron_gather(factors: Sequence[torch.Tensor], ids: torch.Tensor, embed_dim: int,
                use_layernorm: bool = True,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """ids (N,) -> (N, embed_dim) fp32: the CUDA kernel for CUDA ids, the
    plain version for CPU ids or ``use_kernel=False``."""
    if kernel_route(use_kernel, ids):
        return kron_gather_cuda(factors, ids, embed_dim, use_layernorm)
    return kron_gather_ref(factors, ids, embed_dim=embed_dim,
                           use_layernorm=use_layernorm).float()
