"""Wrappers of the rank-folded Kronecker chain kernels (``csrc/kron_matmul.cu``).

:func:`kron_matmul` goes through :class:`KronMatmul`, a
``torch.autograd.Function`` that saves only ``(x, factors)``. It routes by
the tensor (``kernels.kernel_route``): on a CUDA tensor its forward and
backward launch the CUDA kernels, on a CPU tensor they run the plain
versions :func:`kron_matmul_ref` and :func:`kron_matmul_bwd_ref`.
``launches`` counts kernel launches per leg and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, kernel_route
from repro_torch.kernels.kron_matmul.ref import kron_matmul_bwd_ref, kron_matmul_ref

__all__ = ["kron_matmul", "kron_matmul_cuda", "kron_matmul_bwd_cuda", "KronMatmul",
           "kron_matmul_ref", "kron_matmul_bwd_ref", "check_inputs", "launches"]

launches = {"kron_matmul_fwd": 0, "kron_matmul_bwd": 0}
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
        lib.w2k_kron_matmul2_bwd.argtypes = [p, i, p, p, p, i, i, i, i, i, p, p, p, p, p]
        lib.w2k_kron_matmul2_bwd.restype = i
        lib.w2k_kron_matmul2_bwd_scratch_floats.argtypes = [i, i, i, i, i, i]
        lib.w2k_kron_matmul2_bwd_scratch_floats.restype = ctypes.c_longlong
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


def _stage1_smem_check(lib, rank: int, q1: int, q2: int) -> None:
    smem = lib.w2k_kron_matmul2_smem_bytes(rank, q1, q2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kron_matmul needs {smem} B of shared memory per block "
                         f"(> {_SMEM_LIMIT}) at rank {rank}, q ({q1}, {q2})")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.w2k_error_string(rc).decode()} (cudaError {rc})")


def _pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` zero-padded on the right to ``cols`` columns, contiguous."""
    if t.shape[1] < cols:
        t = F.pad(t, (0, cols - t.shape[1]))
    return t.contiguous()


def kron_matmul_cuda(factors: Sequence[torch.Tensor], x: torch.Tensor,
                     out_dim: int) -> torch.Tensor:
    """Launch the CUDA forward: x (B, d_in) fp32 -> (B, out_dim) fp32. One
    launch runs its two stages back to back on the current stream, through
    a (B·t1, r·q2) fp32 scratch allocated here."""
    if x.device.type != "cuda":
        raise ValueError(f"kron_matmul_cuda needs CUDA tensors, got {x.device}")
    check_inputs(factors, x, out_dim)
    f1, f2 = factors
    rank, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    _stage1_smem_check(lib, rank, q1, q2)
    x = _pad_cols(x, q1 * q2)  # zero rows of the operator's padding
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
    _raise_on(lib, rc, "kron_matmul")
    launches["kron_matmul_fwd"] += 1
    return out


def kron_matmul_bwd_cuda(factors: Sequence[torch.Tensor], x: torch.Tensor,
                         g: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Launch the CUDA backward: ``(dx (B, prod q), [dF1, dF2])`` fp32 from
    x (B, d_in) fp32 and the output cotangent g (B, out_dim) fp32, zero-padded
    here as :func:`kron_matmul_bwd_ref` pads them. One launch recomputes
    stage 1 and runs the backward's contractions on the current stream; the
    dF sums over tokens go through per-block partials and a fixed-order
    reduce, so two calls give the same bits."""
    if x.device.type != "cuda":
        raise ValueError(f"kron_matmul_bwd_cuda needs CUDA tensors, got {x.device}")
    check_inputs(factors, x, g.shape[-1])
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"g must be ({x.shape[0]}, out_dim) fp32, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if g.device != x.device:
        raise ValueError(f"g on {g.device}, x on {x.device}")
    f1, f2 = factors
    rank, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    _stage1_smem_check(lib, rank, q1, q2)
    x = _pad_cols(x, q1 * q2)
    g = _pad_cols(g, t1 * t2)
    B = x.shape[0]
    dx = torch.empty_like(x)
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    if B == 0:
        return dx, [df1.zero_(), df2.zero_()]
    scratch = torch.empty(lib.w2k_kron_matmul2_bwd_scratch_floats(B, rank, q1, t1, q2, t2),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_kron_matmul2_bwd(x.data_ptr(), B, g.data_ptr(), f1.data_ptr(),
                                      f2.data_ptr(), rank, q1, t1, q2, t2,
                                      scratch.data_ptr(), dx.data_ptr(), df1.data_ptr(),
                                      df2.data_ptr(), stream)
    _raise_on(lib, rc, "kron_matmul backward")
    launches["kron_matmul_bwd"] += 1
    return dx, [df1, df2]


class KronMatmul(torch.autograd.Function):
    """``x (B, d_in) -> (B, out_dim)`` in ``x``'s dtype (every sum in fp32),
    differentiable in ``x`` and the factors. The forward saves only
    ``(x, factors)``; the backward recomputes what it needs. On the kernel
    route both directions launch the CUDA kernels (``x`` and the cotangent
    cast to fp32 for them); otherwise they run the plain versions. ``dx``
    comes back in ``x``'s dtype, each ``dF_j`` in its factor's."""

    @staticmethod
    def forward(ctx, x, out_dim, on_kernel, *factors):
        if on_kernel:
            out = kron_matmul_cuda(factors, x.float(), out_dim)
        else:
            out = kron_matmul_ref(factors, x, out_dim)
        ctx.on_kernel = on_kernel
        ctx.save_for_backward(x, *factors)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, *factors = ctx.saved_tensors
        if ctx.on_kernel:
            dx, dfs = kron_matmul_bwd_cuda(factors, x.float(), g.float())
        else:
            dx, dfs = kron_matmul_bwd_ref(factors, x, g)
        return (dx[:, :x.shape[1]].to(x.dtype), None, None,
                *[df.to(f.dtype) for df, f in zip(dfs, factors)])


def kron_matmul(factors: Sequence[torch.Tensor], x: torch.Tensor, out_dim: int,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (B, d_in) -> (B, out_dim) in x's dtype through :class:`KronMatmul`:
    the CUDA kernels for CUDA x, the plain versions for CPU x or
    ``use_kernel=False``."""
    return KronMatmul.apply(x, out_dim, kernel_route(use_kernel, x), *factors)
