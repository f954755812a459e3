"""Wrappers of the fused Kronecker-head cross-entropy kernels
(``csrc/kron_logits.cu``).

:func:`fused_kron_ce` is a ``torch.autograd.Function``: per-token CE losses
of ``h`` against the Kronecker vocab head without building the
``(tokens × vocab)`` logits in either direction. The forward keeps three
fp32 values per token (``m``, ``l``, the label logit) and saves ``(m, l)``;
the backward recomputes the logits tile by tile and forms
``g·(softmax − onehot)`` from them. A CUDA tensor launches the CUDA kernels
(a build or launch failure raises); a CPU tensor, or ``use_kernel=False``,
runs ``kron_ce_fwd_ref`` / ``kron_ce_bwd_ref``.

``launches`` counts one per wrapper call that launches (each call runs its
kernel and the merge of the per-block partials from the same source).

The backward has two kernels, picked by :func:`bwd_route` from the head's
shape alone: ``ce_bwd_tc_kernel`` (64-token blocks, its three large
products on the tensor cores in 3xTF32) for every head whose buffers fit
its shared memory, and ``ce_bwd_kernel`` (32-token blocks, fp32 on the CUDA
cores) for the rest. Both count under ``launches["kron_ce_bwd"]``;
``routes`` counts the calls of each. The forward has two kernels the same
way, picked by :func:`fwd_route`: ``ce_fwd_tc_kernel`` (the backward's
pass 1 in the same device code, so the backward recomputes the very logits
whose ``(m, l)`` the forward kept) wherever the backward takes the tensor
cores, and ``ce_fwd_kernel`` (fp32, CUDA cores) for the rest; both count
under ``launches["kron_ce_fwd"]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, kernel_route
from repro_torch.kernels.kron_logits.ref import (kron_ce_bwd_ref, kron_ce_fwd_ref,
                                                 kron_ce_naive, kron_ce_tiled)

__all__ = ["fused_kron_ce", "FusedKronCE", "kron_ce_fwd_cuda", "kron_ce_bwd_cuda",
           "kron_ce_fwd_ref", "kron_ce_bwd_ref", "kron_ce_naive", "kron_ce_tiled",
           "check_inputs", "vocab_splits", "bwd_vocab_splits", "bwd_route", "fwd_route",
           "tc_chunks", "launches", "routes"]

launches = {"kron_ce_fwd": 0, "kron_ce_bwd": 0}
# calls of each kernel (each also counts as launches["kron_ce_bwd"] or
# launches["kron_ce_fwd"])
routes = {"kron_ce_bwd_tc": 0, "kron_ce_bwd_simt": 0, "kron_ce_fwd_tc": 0,
          "kron_ce_fwd_simt": 0}
ROWS_PER_BLOCK = 32  # tokens per block (BT in the source)
TC_ROWS_PER_BLOCK = 64  # tokens per block of the tensor-core backward (kT)
_SMEM_LIMIT = 227 * 1024
# the tensor-core backward's shared memory (x_offset and smem_bytes in the
# source): the logits, then pass 1's ring and z chunk (to 178,176 bytes) or
# pass 2's ring and z tiles (to 173,056) and dF1 sums; the x chunk; the F1
# column twice; 18 barriers (the rings' full and empty, 2 x 4 each, and two
# hand-offs) and 1,024 bytes of alignment
_TC_PASS1_END, _TC_DF1_AT, _TC_SMEM_TAIL = 178_176, 173_056, 18 * 8 + 1024
# the tensor-core forward's (fwd_smem_bytes in the source): pass 1's region,
# the x chunk, the F1 column [q1][rp], the per-token statistics and labels
# (16 bytes a token of 64), 8 barriers and 1,024 bytes of alignment
_TC_FWD_STATS, _TC_FWD_TAIL = 16 * 64, 8 * 8 + 1024
_TC_CHUNK_ROWS, _TC_X_FLOATS = 64, 8192
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("kron_logits")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w2k_kron_ce_fwd.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i,
                                        p, p, p, p, p, p, p]
        lib.w2k_kron_ce_fwd.restype = i
        lib.w2k_kron_ce_bwd.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                        p, p, p, p, p, p, p]
        lib.w2k_kron_ce_bwd.restype = i
        lib.w2k_kron_ce_smem_bytes.argtypes = [i, i, i, i, i]
        lib.w2k_kron_ce_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_kron_ce_bwd_tc.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                           p, p, p, p, p, p, p, p, p, p]
        lib.w2k_kron_ce_bwd_tc.restype = i
        lib.w2k_kron_ce_bwd_tc_smem_bytes.argtypes = [i, i, i, i, i, i]
        lib.w2k_kron_ce_bwd_tc_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_kron_ce_fwd_tc.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, i, i,
                                           p, p, p, p, p, p, p, p, p]
        lib.w2k_kron_ce_fwd_tc.restype = i
        lib.w2k_kron_ce_fwd_tc_smem_bytes.argtypes = [i, i, i, i, i, i]
        lib.w2k_kron_ce_fwd_tc_smem_bytes.restype = ctypes.c_longlong
        lib.w2k_error_string.argtypes = [i]
        lib.w2k_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(factors: Sequence[torch.Tensor], x: torch.Tensor,
                 labels: torch.Tensor) -> None:
    """What the CUDA kernels take: order-2 fp32 contiguous ``(rank, q_j,
    t_j)`` stacks with ``q_2`` dividing 32, ``rank·q_2 <= 1024`` and
    ``t_2 <= 416``; ``x (N, q_1·q_2)`` fp32 contiguous; int32 labels
    ``(N,)``; all on one device. Raises otherwise."""
    if len(factors) != 2:
        raise NotImplementedError(
            f"the kron_logits CUDA kernels take order-2 heads, got order {len(factors)}")
    for f in factors:
        if f.dtype != torch.float32 or f.dim() != 3 or not f.is_contiguous():
            raise ValueError(f"factors must be contiguous 3-D fp32 tensors, got "
                             f"{f.dtype} {tuple(f.shape)}")
        if f.device != x.device:
            raise ValueError(f"factor on {f.device}, x on {x.device}")
    (r, q1, _), (r2, q2, t2) = (f.shape for f in factors)
    if r != r2:
        raise ValueError("factors disagree on the rank")
    if 32 % q2 or r * q2 > 1024 or t2 > 416:
        raise NotImplementedError(
            f"the kron_logits CUDA kernels need q_2 | 32, rank·q_2 <= 1024 and "
            f"t_2 <= 416; got rank {r}, q_2 {q2}, t_2 {t2}")
    n = x.shape[0]
    if x.dtype != torch.float32 or x.shape != (n, q1 * q2) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous ({n}, {q1 * q2}) fp32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if labels.dtype != torch.int32 or labels.shape != (n,) or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous ({n},) int32, got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if labels.device != x.device:
        raise ValueError(f"labels on {labels.device}, x on {x.device}")


def vocab_splits(n_rows: int, t1: int, sms: int) -> int:
    """Blocks along the t1 axis. One block fits per SM (its shared memory
    allows no second), so the token blocks times the splits fill at most
    one wave: more splits would shorten each block's column loop but add a
    1.6 MB dF2 partial per block to the backward."""
    n_tb = -(-n_rows // ROWS_PER_BLOCK)
    return max(1, min(t1, sms // n_tb))


def bwd_vocab_splits(n_rows: int, t1: int, sms: int) -> int:
    """Blocks along the t1 axis of the tensor-core backward: as
    :func:`vocab_splits`, over its 64-token blocks."""
    n_tb = -(-n_rows // TC_ROWS_PER_BLOCK)
    return max(1, min(t1, sms // n_tb))


def tc_chunks(rank: int, q1: int, q2: int) -> Optional[tuple[int, int]]:
    """The tensor-core backward's kz chunks: ``(j per chunk, k per chunk)``,
    each chunk at most 64 rows of (j, k) pairs (k rounded up to 4) and its x
    slice (64 tokens x j x q1, q1 rounded up to 4) at most 8,192 floats; None
    when q1 is too wide for one j."""
    qp = -(-q1 // 4) * 4
    if qp * TC_ROWS_PER_BLOCK > _TC_X_FLOATS:
        return None
    kcm = min(rank, _TC_CHUNK_ROWS)
    kcp = -(-kcm // 4) * 4
    return max(1, min(_TC_CHUNK_ROWS // kcp, q2, _TC_X_FLOATS // (TC_ROWS_PER_BLOCK * qp))), kcm


def _tc_smem_bytes(rank: int, q1: int) -> int:
    qp, rp = -(-q1 // 4) * 4, -(-rank // 4) * 4
    x_at = -(-max(_TC_PASS1_END, _TC_DF1_AT + 4 * rank * qp) // 16) * 16
    f1_end = x_at + 4 * _TC_X_FLOATS + 4 * (q1 * rp + rank * qp)
    return -(-f1_end // 8) * 8 + _TC_SMEM_TAIL


def _tc_fwd_smem_bytes(rank: int, q1: int) -> int:
    rp = -(-rank // 4) * 4
    stats_at = _TC_PASS1_END + 4 * _TC_X_FLOATS + 4 * q1 * rp
    return -(-(stats_at + _TC_FWD_STATS) // 8) * 8 + _TC_FWD_TAIL


def bwd_route(rank: int, q1: int, q2: int, t2: int) -> str:
    """The backward kernel of a head that :func:`check_inputs` takes, from
    its shape alone: ``"kron_ce_bwd_tc"`` when its F1 column and x slice fit
    the tensor-core kernel's shared memory, else ``"kron_ce_bwd_simt"``."""
    if tc_chunks(rank, q1, q2) is None or _tc_smem_bytes(rank, q1) > _SMEM_LIMIT:
        return "kron_ce_bwd_simt"
    return "kron_ce_bwd_tc"


def fwd_route(rank: int, q1: int, q2: int, t2: int) -> str:
    """The forward kernel of a head that :func:`check_inputs` takes, from its
    shape alone: ``"kron_ce_fwd_tc"`` wherever :func:`bwd_route` gives the
    tensor-core backward and the forward's buffers (pass 1's region of the
    backward, the x chunk and one F1 layout) fit too, else
    ``"kron_ce_fwd_simt"``."""
    if (bwd_route(rank, q1, q2, t2) == "kron_ce_bwd_tc"
            and _tc_fwd_smem_bytes(rank, q1) <= _SMEM_LIMIT):
        return "kron_ce_fwd_tc"
    return "kron_ce_fwd_simt"


def _prep(factors, h, labels):
    P = math.prod(f.shape[1] for f in factors)
    x = h.float()
    if P > x.shape[-1]:
        x = F.pad(x, (0, P - x.shape[-1]))
    x = x.contiguous()
    labels = labels.to(torch.int32).contiguous()
    check_inputs(factors, x, labels)
    lib = _load()
    (r, q1, t1), (_, q2, t2) = (f.shape for f in factors)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = vocab_splits(x.shape[0], t1, sms)
    return lib, x, labels, (r, q1, t1, q2, t2), splits


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.w2k_error_string(rc).decode()} (cudaError {rc})")


def _check_smem(lib, dims, backward: bool) -> None:
    r, q1, _, q2, t2 = dims
    smem = lib.w2k_kron_ce_smem_bytes(r, q1, q2, t2, int(backward))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kron_logits needs {smem} B of shared memory per block "
                         f"(> {_SMEM_LIMIT}) at rank {r}, q ({q1}, {q2}), t_2 {t2}")


def _fwd_tc(lib, x, y, factors, dims, vocab_size, loss, m, l) -> None:
    """The tensor-core forward's launch into ``loss, m, l``."""
    r, q1, t1, q2, t2 = dims
    n = x.shape[0]
    jcm, kcm = tc_chunks(r, q1, q2)
    smem = lib.w2k_kron_ce_fwd_tc_smem_bytes(r, q1, q2, t2, jcm, kcm)
    if smem != _tc_fwd_smem_bytes(r, q1):
        raise RuntimeError(f"the tensor-core forward needs {smem} B of shared memory, its "
                           f"route assumed {_tc_fwd_smem_bytes(r, q1)} B")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = bwd_vocab_splits(n, t1, sms)
    npad = -(-n // TC_ROWS_PER_BLOCK) * TC_ROWS_PER_BLOCK
    nch = -(-q2 // jcm) * -(-r // kcm)
    dev, f32 = x.device, torch.float32
    xt = torch.empty((npad, q2, q1), dtype=f32, device=dev)
    img1 = torch.empty(nch * 8 * 26_624, dtype=torch.uint8, device=dev)  # the F2^T image
    part = torch.empty((3, splits, npad), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_kron_ce_fwd_tc(
            x.data_ptr(), n, y.data_ptr(), factors[0].data_ptr(), factors[1].data_ptr(),
            r, q1, t1, q2, t2, vocab_size, splits, jcm, kcm, xt.data_ptr(), img1.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
            loss.data_ptr(), m.data_ptr(), l.data_ptr(), stream)
    _raise_on(lib, rc, "kron_logits forward (tensor cores)")


def kron_ce_fwd_cuda(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                     vocab_size: int, route: Optional[str] = None):
    """Launch the fused CE forward: ``(loss, m, l)``, each (N,) fp32, on the
    kernel :func:`fwd_route` picks for the head, or on ``route``
    (``"kron_ce_fwd_simt"`` takes every head; ``"kron_ce_fwd_tc"`` only
    those that :func:`fwd_route` gives it)."""
    if h.device.type != "cuda":
        raise ValueError(f"kron_ce_fwd_cuda needs CUDA tensors, got {h.device}")
    lib, x, y, dims, splits = _prep(factors, h, labels)
    r, q1, t1, q2, t2 = dims
    fits = fwd_route(r, q1, q2, t2)
    route = route or fits
    if route not in ("kron_ce_fwd_simt", fits):
        raise ValueError(f"route {route!r} does not take this head (its route: {fits!r})")
    n = x.shape[0]
    loss, m, l = (torch.empty(n, dtype=torch.float32, device=x.device) for _ in range(3))
    if n == 0:
        return loss, m, l
    if route == "kron_ce_fwd_tc":
        _fwd_tc(lib, x, y, factors, dims, vocab_size, loss, m, l)
    else:
        _check_smem(lib, dims, backward=False)
        npad = -(-n // ROWS_PER_BLOCK) * ROWS_PER_BLOCK
        part = torch.empty((3, splits, npad), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.w2k_kron_ce_fwd(
                x.data_ptr(), n, y.data_ptr(), factors[0].data_ptr(), factors[1].data_ptr(),
                r, q1, t1, q2, t2, vocab_size, splits,
                part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
                loss.data_ptr(), m.data_ptr(), l.data_ptr(), stream)
        _raise_on(lib, rc, "kron_logits forward")
    launches["kron_ce_fwd"] += 1
    routes[route] += 1
    return loss, m, l


def _bwd_tc(lib, x, y, g, m, l, factors, dims, vocab_size):
    """The tensor-core backward's launch: ``([dF_1, dF_2], dx)``, dx
    (npad, q1·q2) with npad a multiple of 64."""
    r, q1, t1, q2, t2 = dims
    n, P = x.shape
    jcm, kcm = tc_chunks(r, q1, q2)
    smem = lib.w2k_kron_ce_bwd_tc_smem_bytes(r, q1, q2, t2, jcm, kcm)
    if smem != _tc_smem_bytes(r, q1):
        raise RuntimeError(f"the tensor-core backward needs {smem} B of shared memory, its "
                           f"route assumed {_tc_smem_bytes(r, q1)} B")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = bwd_vocab_splits(n, t1, sms)
    n_tb = -(-n // TC_ROWS_PER_BLOCK)
    npad = n_tb * TC_ROWS_PER_BLOCK
    qp = -(-q1 // 4) * 4
    nch = -(-q2 // jcm) * -(-r // kcm)
    kzp = nch * _TC_CHUNK_ROWS
    dev, f32 = x.device, torch.float32
    df1, df2 = torch.empty_like(factors[0]), torch.empty_like(factors[1])
    dx = torch.empty((npad, P), dtype=f32, device=dev)
    xt = torch.empty((npad, q2, q1), dtype=f32, device=dev)
    # the F2 images: per chunk 8 stages of (416 x 8) hi and lo tiles, each
    img1, img2 = (torch.empty(nch * 8 * 26_624, dtype=torch.uint8, device=dev)
                  for _ in range(2))
    df2_part = torch.empty((n_tb * splits, t2, kzp), dtype=f32, device=dev)
    df1_part = torch.empty((n_tb, r * q1 * t1), dtype=f32, device=dev)
    dx_part = torch.empty((splits, npad, q2, qp), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_kron_ce_bwd_tc(
            x.data_ptr(), n, y.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
            factors[0].data_ptr(), factors[1].data_ptr(), r, q1, t1, q2, t2, vocab_size,
            splits, jcm, kcm, xt.data_ptr(), img1.data_ptr(), img2.data_ptr(),
            df2_part.data_ptr(), df1_part.data_ptr(), dx_part.data_ptr(), df1.data_ptr(),
            df2.data_ptr(), dx.data_ptr(), stream)
    _raise_on(lib, rc, "kron_logits backward (tensor cores)")
    return [df1, df2], dx


def kron_ce_bwd_cuda(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                     m: torch.Tensor, l: torch.Tensor, g: torch.Tensor, vocab_size: int):
    """Launch the fused CE backward: ``([dF_1, dF_2], dh)`` fp32, on the
    kernel :func:`bwd_route` picks for the head. Every cross-block sum goes
    through per-block partials and a fixed-order reduce, so the result is
    the same from run to run."""
    if h.device.type != "cuda":
        raise ValueError(f"kron_ce_bwd_cuda needs CUDA tensors, got {h.device}")
    lib, x, y, dims, splits = _prep(factors, h, labels)
    r, q1, t1, q2, t2 = dims
    n, P = x.shape
    for name, v in (("m", m), ("l", l), ("g", g)):
        if v.shape != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be ({n},) fp32, got {v.dtype} {tuple(v.shape)}")
    m, l, g = m.contiguous(), l.contiguous(), g.contiguous()
    route = bwd_route(r, q1, q2, t2)
    if route == "kron_ce_bwd_tc":
        if n == 0:
            return [torch.zeros_like(factors[0]), torch.zeros_like(factors[1])], \
                torch.zeros_like(h, dtype=torch.float32)
        dfs, dx = _bwd_tc(lib, x, y, g, m, l, factors, dims, vocab_size)
        launches["kron_ce_bwd"] += 1
        routes[route] += 1
        return dfs, dx[:n, :h.shape[-1]]
    _check_smem(lib, dims, backward=True)
    n_tb = -(-n // ROWS_PER_BLOCK)
    npad = n_tb * ROWS_PER_BLOCK
    df1 = torch.empty_like(factors[0])
    df2 = torch.empty_like(factors[1])
    dx = torch.empty((npad, P), dtype=torch.float32, device=x.device)
    # per-block partials, summed in a fixed order by the reduce launches
    df2_part = torch.empty((n_tb * splits, r * q2 * t2), dtype=torch.float32, device=x.device)
    df1_part = torch.empty((n_tb, r * q1 * t1), dtype=torch.float32, device=x.device)
    dx_part = torch.empty((splits, npad * P), dtype=torch.float32, device=x.device)
    if n > 0:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.w2k_kron_ce_bwd(
                x.data_ptr(), n, y.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
                factors[0].data_ptr(), factors[1].data_ptr(), r, q1, t1, q2, t2,
                vocab_size, splits, df2_part.data_ptr(), df1_part.data_ptr(),
                dx_part.data_ptr(), df1.data_ptr(), df2.data_ptr(), dx.data_ptr(), stream)
        _raise_on(lib, rc, "kron_logits backward")
        launches["kron_ce_bwd"] += 1
        routes[route] += 1
    else:
        df1.zero_()
        df2.zero_()
    return [df1, df2], dx[:n, :h.shape[-1]]


class FusedKronCE(torch.autograd.Function):
    """Per-token CE losses, differentiable in the factors and ``h``."""

    @staticmethod
    def forward(ctx, h, labels, vocab_size, t1_block, on_kernel, *factors):
        if on_kernel:
            loss, m, l = kron_ce_fwd_cuda(factors, h, labels, vocab_size)
        else:
            loss, m, l = kron_ce_fwd_ref(factors, h, labels, vocab_size, t1_block)
        ctx.meta = (vocab_size, t1_block, on_kernel)
        ctx.save_for_backward(h, labels, m, l, *factors)
        return loss

    @staticmethod
    def backward(ctx, g):
        vocab_size, t1_block, on_kernel = ctx.meta
        h, labels, m, l, *factors = ctx.saved_tensors
        if on_kernel:
            dfs, dh = kron_ce_bwd_cuda(factors, h, labels, m, l, g.float().contiguous(),
                                       vocab_size)
        else:
            dfs, dh = kron_ce_bwd_ref(factors, h, labels, m, l, g, vocab_size, t1_block)
        return (dh.to(h.dtype), None, None, None, None,
                *[df.to(f.dtype) for df, f in zip(dfs, factors)])


def fused_kron_ce(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, t1_block: int = 16,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(N,) CE losses of ``h (N, p)`` against the Kronecker head ``factors``
    at ``labels (N,)``: the CUDA kernels for CUDA tensors, the plain versions
    (vocab tiles of ``t1_block`` t1 columns) for CPU tensors or
    ``use_kernel=False``."""
    return FusedKronCE.apply(h, labels, vocab_size, t1_block,
                             kernel_route(use_kernel, h), *factors)
