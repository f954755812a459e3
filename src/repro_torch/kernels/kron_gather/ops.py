"""Wrappers of the fused word2ketXS lookup kernels (``csrc/kron_gather.cu``).

:func:`kron_gather` routes by the tensor (``kernels.kernel_route``): a CUDA
tensor launches the CUDA kernels, a CPU tensor runs the plain versions in
``ref.py``. When a gradient is needed it goes through :class:`KronGather`,
a ``torch.autograd.Function`` whose forward takes the stats leg (the lookup
that also writes the per-node LN statistics, reading its factor columns from
a column-contiguous copy that the call makes first) and whose backward is
the dedicated backward kernel; otherwise the forward-only leg runs.
:func:`kron_gather_quant` is the forward-only lookup over int8 / fp8
payloads with per-rank scales (core/quant), routed the same way: the
dequant-fused CUDA leg, or :func:`kron_gather_quant_ref`.

``launches`` counts kernel launches per leg and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import PAYLOAD_KINDS, build, kernel_route, quant_scales, refuse_grad
from repro_torch.kernels.common import LN_EPS
from repro_torch.kernels.kron_gather.ref import (kron_gather_bwd_ref, kron_gather_fwd_ref,
                                                 kron_gather_quant_ref, kron_gather_ref)

__all__ = ["kron_gather", "kron_gather_cuda", "kron_gather_bwd_cuda", "KronGather",
           "kron_gather_quant", "kron_gather_quant_cuda", "kron_gather_ref",
           "kron_gather_fwd_ref", "kron_gather_bwd_ref", "kron_gather_quant_ref",
           "check_inputs", "check_quant_inputs", "launches"]

launches = {"kron_gather_fwd": 0, "kron_gather_fwd_stats": 0, "kron_gather_bwd": 0,
            "kron_gather_fwd_quant": 0}
_SMEM_LIMIT = 227 * 1024
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("kron_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w2k_kron_gather2.argtypes = [p, i, p, p, i, i, i, i, i, i,
                                         ctypes.c_float, p, i, p, p]
        lib.w2k_kron_gather2.restype = i
        lib.w2k_kron_gather2_stats.argtypes = [p, i, p, p, i, i, i, i, i, ctypes.c_float,
                                               p, p, p, i, p, p]
        lib.w2k_kron_gather2_stats.restype = i
        lib.w2k_kron_gather2_quant.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i,
                                               ctypes.c_float, p, i, p]
        lib.w2k_kron_gather2_quant.restype = i
        lib.w2k_kron_gather2_smem_bytes.argtypes = [i, i, i]
        lib.w2k_kron_gather2_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_kron_gather2_bwd.argtypes = [p, i, p, i, p, p, p, i, i, i, i, i, i,
                                             p, p, p, p, p]
        lib.w2k_kron_gather2_bwd.restype = i
        lib.w2k_kron_gather2_bwd_smem_bytes.argtypes = [i, i, i]
        lib.w2k_kron_gather2_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_error_string.argtypes = [i]
        lib.w2k_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(factors: Sequence[torch.Tensor], ids: torch.Tensor,
                 embed_dim: int, dtypes=(torch.float32,)) -> None:
    """What the CUDA kernels take: order-2 contiguous ``(rank, q_j, t_j)``
    stacks of one rank in one of ``dtypes`` (fp32 for every leg but the
    quantized one), 1-D contiguous int32 ids, everything on the ids'
    device, ``embed_dim <= prod q``; raises otherwise."""
    if len(factors) != 2:
        raise NotImplementedError(
            f"the kron_gather CUDA kernel takes order-2 operators, got order "
            f"{len(factors)}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    for f in factors:
        if f.dtype not in dtypes or f.dim() != 3 or not f.is_contiguous():
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise ValueError(f"factors must be contiguous 3-D {names} tensors, got "
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


def check_quant_inputs(factors_q: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                       ids: torch.Tensor, embed_dim: int) -> tuple[int, list[torch.Tensor]]:
    """What the quantized leg takes: :func:`check_inputs` with int8 or fp8
    e4m3 payloads (one kind), and fp32 ``(rank, 1, 1)`` (or ``(1, 1, 1)``)
    scales on the same device. Returns the payload code and the scales as
    contiguous ``(rank,)`` tensors."""
    check_inputs(factors_q, ids, embed_dim, dtypes=tuple(PAYLOAD_KINDS))
    return quant_scales(factors_q, scales)


def _fwd_smem_check(lib, rank: int, q1: int, q2: int) -> None:
    smem = lib.w2k_kron_gather2_smem_bytes(rank, q1, q2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kron_gather needs {smem} B of shared memory per block "
                         f"(> {_SMEM_LIMIT}) at rank {rank}, q ({q1}, {q2})")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.w2k_error_string(rc).decode()} (cudaError {rc})")


def kron_gather_cuda(factors: Sequence[torch.Tensor], ids: torch.Tensor,
                     embed_dim: int, use_layernorm: bool = True,
                     with_stats: bool = False):
    """Launch the CUDA lookup: ids (N,) int32 -> (N, embed_dim) fp32. Ids
    outside ``[0, prod t)`` give rows of NaN. With ``with_stats`` (LN on)
    also returns the root node's LN statistics ``(N, 2, rank)`` fp32
    (``[:, 0]`` mean, ``[:, 1]`` rstd) as ``(out, stats)``; that leg first
    copies both stacks to ``(t_j, rank, q_j)`` scratch allocated here, and
    the copy with its lookup counts as one launch."""
    if ids.device.type != "cuda":
        raise ValueError(f"kron_gather_cuda needs CUDA tensors, got {ids.device}")
    check_inputs(factors, ids, embed_dim)
    if with_stats and not use_layernorm:
        raise ValueError("the stats leg needs LayerNorm on: without it there are "
                         "no statistics to save")
    f1, f2 = factors
    rank, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    _fwd_smem_check(lib, rank, q1, q2)
    n = ids.shape[0]
    out = torch.empty((n, embed_dim), dtype=torch.float32, device=ids.device)
    stats = (torch.empty((n, 2, rank), dtype=torch.float32, device=ids.device)
             if with_stats else None)
    if n > 0:
        with torch.cuda.device(ids.device):
            stream = torch.cuda.current_stream().cuda_stream
            if with_stats:
                ft1 = torch.empty((t1, rank, q1), dtype=torch.float32, device=ids.device)
                ft2 = torch.empty((t2, rank, q2), dtype=torch.float32, device=ids.device)
                rc = lib.w2k_kron_gather2_stats(ids.data_ptr(), n, f1.data_ptr(),
                                                f2.data_ptr(), rank, q1, t1, q2, t2, LN_EPS,
                                                ft1.data_ptr(), ft2.data_ptr(),
                                                out.data_ptr(), embed_dim, stats.data_ptr(),
                                                stream)
            else:
                rc = lib.w2k_kron_gather2(ids.data_ptr(), n, f1.data_ptr(), f2.data_ptr(),
                                          rank, q1, t1, q2, t2, int(use_layernorm), LN_EPS,
                                          out.data_ptr(), embed_dim, None, stream)
        _raise_on(lib, rc, "kron_gather")
        launches["kron_gather_fwd_stats" if with_stats else "kron_gather_fwd"] += 1
    return (out, stats) if with_stats else out


def kron_gather_quant_cuda(factors_q: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                           ids: torch.Tensor, embed_dim: int,
                           use_layernorm: bool = True) -> torch.Tensor:
    """Launch the dequant-fused CUDA lookup over int8 / fp8 payloads:
    ids (N,) int32 -> (N, embed_dim) fp32; ids outside ``[0, prod t)``
    give rows of NaN."""
    if ids.device.type != "cuda":
        raise ValueError(f"kron_gather_quant_cuda needs CUDA tensors, got {ids.device}")
    kind, (s1, s2) = check_quant_inputs(factors_q, scales, ids, embed_dim)
    f1, f2 = factors_q
    rank, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    _fwd_smem_check(lib, rank, q1, q2)
    n = ids.shape[0]
    out = torch.empty((n, embed_dim), dtype=torch.float32, device=ids.device)
    if n > 0:
        with torch.cuda.device(ids.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.w2k_kron_gather2_quant(
                ids.data_ptr(), n, f1.data_ptr(), f2.data_ptr(), s1.data_ptr(),
                s2.data_ptr(), kind, rank, q1, t1, q2, t2, int(use_layernorm), LN_EPS,
                out.data_ptr(), embed_dim, stream)
        _raise_on(lib, rc, "kron_gather_quant")
        launches["kron_gather_fwd_quant"] += 1
    return out


def kron_gather_bwd_cuda(factors: Sequence[torch.Tensor], ids: torch.Tensor,
                         g: torch.Tensor, stats: Optional[torch.Tensor],
                         use_layernorm: bool = True) -> list[torch.Tensor]:
    """Launch the CUDA backward: ``dL/dF_j`` fp32 from the output cotangent
    ``g (N, embed_dim)`` and, with LN, the stats of the forward. Each id's
    factor-column cotangents go to ``(N, rank·q_j)`` scratch allocated here,
    and a second kernel sums them per factor column in token order, so two
    calls give the same bits; the call with its sum counts as one launch."""
    if ids.device.type != "cuda":
        raise ValueError(f"kron_gather_bwd_cuda needs CUDA tensors, got {ids.device}")
    check_inputs(factors, ids, g.shape[-1])
    n = ids.shape[0]
    rank = factors[0].shape[0]
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != n:
        raise ValueError(f"g must be ({n}, embed_dim) fp32, got {g.dtype} {tuple(g.shape)}")
    if use_layernorm and (stats is None or stats.shape != (n, 2, rank)
                          or stats.dtype != torch.float32):
        raise ValueError(f"the LayerNorm backward needs fp32 stats ({n}, 2, {rank})")
    f1, f2 = factors
    _, q1, t1 = f1.shape
    _, q2, t2 = f2.shape
    lib = _load()
    smem = lib.w2k_kron_gather2_bwd_smem_bytes(rank, q1, q2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kron_gather backward needs {smem} B of shared memory per "
                         f"block (> {_SMEM_LIMIT}) at rank {rank}, q ({q1}, {q2})")
    g = g.contiguous()
    stats = stats.contiguous() if use_layernorm else None
    if n == 0:
        return [torch.zeros_like(f1), torch.zeros_like(f2)]
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    du_rows = torch.empty((n, rank * q1), dtype=torch.float32, device=ids.device)
    dv_rows = torch.empty((n, rank * q2), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_kron_gather2_bwd(
            ids.data_ptr(), n, g.data_ptr(), g.shape[1],
            stats.data_ptr() if use_layernorm else None, f1.data_ptr(), f2.data_ptr(),
            rank, q1, t1, q2, t2, int(use_layernorm), du_rows.data_ptr(),
            dv_rows.data_ptr(), df1.data_ptr(), df2.data_ptr(), stream)
    _raise_on(lib, rc, "kron_gather backward")
    launches["kron_gather_bwd"] += 1
    return [df1, df2]


class KronGather(torch.autograd.Function):
    """The lookup differentiable in the factors: forward through the stats
    leg, backward through the dedicated backward (the CUDA kernels on the
    kernel route, ``kron_gather_fwd_ref`` / ``kron_gather_bwd_ref``
    otherwise). Ids get no gradient."""

    @staticmethod
    def forward(ctx, ids, embed_dim, use_layernorm, on_kernel, *factors):
        if on_kernel:
            res = kron_gather_cuda(factors, ids, embed_dim, use_layernorm,
                                   with_stats=use_layernorm)
            out, stats = res if use_layernorm else (res, None)
        else:
            out, stats = kron_gather_fwd_ref(factors, ids, embed_dim=embed_dim,
                                             use_layernorm=use_layernorm)
        ctx.meta = (use_layernorm, on_kernel)
        ctx.save_for_backward(ids, stats, *factors)
        return out

    @staticmethod
    def backward(ctx, g):
        use_layernorm, on_kernel = ctx.meta
        ids, stats, *factors = ctx.saved_tensors
        if on_kernel:
            dfs = kron_gather_bwd_cuda(factors, ids, g.float(), stats, use_layernorm)
        else:
            dfs = kron_gather_bwd_ref(factors, ids, g, stats, use_layernorm=use_layernorm)
        return (None, None, None, None, *[df.to(f.dtype) for df, f in zip(dfs, factors)])


def kron_gather(factors: Sequence[torch.Tensor], ids: torch.Tensor, embed_dim: int,
                use_layernorm: bool = True,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """ids (N,) -> (N, embed_dim), at least fp32: the CUDA kernels for CUDA
    ids, the plain versions for CPU ids or ``use_kernel=False``;
    differentiable in the factors."""
    on_kernel = kernel_route(use_kernel, ids)
    if torch.is_grad_enabled() and any(f.requires_grad for f in factors):
        return KronGather.apply(ids, embed_dim, use_layernorm, on_kernel, *factors)
    if on_kernel:
        return kron_gather_cuda(factors, ids, embed_dim, use_layernorm)
    return kron_gather_ref(factors, ids, embed_dim=embed_dim,
                           use_layernorm=use_layernorm).float()


def kron_gather_quant(factors_q: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                      ids: torch.Tensor, embed_dim: int, use_layernorm: bool = True,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """ids (N,) -> (N, embed_dim) fp32 over int8 / fp8 payloads ``(rank,
    q_j, t_j)`` with per-rank fp32 scales ``(rank, 1, 1)``: the
    dequant-fused CUDA leg for CUDA ids, :func:`kron_gather_quant_ref` for
    CPU ids or ``use_kernel=False``. Forward-only."""
    refuse_grad("kron_gather_quant", *factors_q, *scales)
    if kernel_route(use_kernel, ids):
        return kron_gather_quant_cuda(factors_q, scales, ids, embed_dim, use_layernorm)
    return kron_gather_quant_ref(factors_q, scales, ids, embed_dim=embed_dim,
                                 use_layernorm=use_layernorm)
