"""Wrappers of the flash-attention kernels: the full-sequence forward
(``csrc/flash_attn.cu``) and the split-KV paged decode read
(``csrc/paged_attention.cu``).

:func:`flash_attention` goes through :class:`FlashAttention`, a
``torch.autograd.Function`` routed by the tensor (``kernels.kernel_route``):
on a CUDA tensor its forward launches a flash kernel, on a CPU tensor it
runs :func:`~repro_torch.kernels.flash_attn.ref.attention_ref`. Its backward
recomputes through ``attention_ref`` and takes that oracle's VJP on either
route, as the JAX package's ``ops.flash_attention`` does.

The full-sequence forward has two kernels, chosen from (dtype, head_dim)
by one static table, :data:`FLASH_TC_ROUTES`, before the launch:
``flash_fwd_tc`` (bf16 and fp16 on the tensor cores, 128 query rows a
block) and ``flash_fwd`` (fp32 on the CUDA cores, 64 rows a block: tensor
cores would compute fp32 in TF32). Neither falls back on the other: a
failed build or launch raises.

:func:`paged_attention_split` and :func:`combine_splits` route the same
way: a CUDA tensor launches the CUDA kernel, a CPU tensor runs the plain
version in ``ref.py``. :func:`paged_attention` is the decode read of
``serve/decode.py``: split and combine, or the gather oracle when the
caller asks for ``use_kernel=False`` (as the JAX package's
``ops.paged_attention`` does). ``launches`` counts the launches of each
kernel and nothing else.

The paged wrappers never read ``lens`` on the host: the kernels stop at
each slot's last valid page themselves, so a decode step pays no sync per
layer.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import autotune, build, kernel_route
from repro_torch.kernels.flash_attn.ref import (attention_ref, combine_splits_ref,
                                                paged_attention_ref,
                                                paged_attention_split_ref,
                                                split_layout)

__all__ = ["flash_attention", "FlashAttention", "flash_attention_cuda",
           "check_flash_inputs", "flash_route", "FLASH_TC_ROUTES", "paged_attention",
           "paged_attention_split", "combine_splits", "paged_attention_split_cuda",
           "combine_splits_cuda", "check_split_inputs", "launches"]

launches = {"paged_split": 0, "paged_combine": 0, "flash_fwd": 0, "flash_fwd_tc": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_GROUPS = (1, 2, 4, 8)
FLASH_HEAD_DIMS = (16, 32, 64, 96, 128)
# (dtype, head_dim) that the tensor-core kernel takes; every other
# combination the flash wrappers accept runs the CUDA-core kernel
FLASH_TC_ROUTES = frozenset((dt, d) for dt in (torch.bfloat16, torch.float16)
                            for d in FLASH_HEAD_DIMS)
FLASH_BLOCK_Q = {"flash_fwd": 64, "flash_fwd_tc": 128}  # query rows per block
_lib: Optional[ctypes.CDLL] = None
_flash_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w2k_paged_split.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p, p, p, p]
        lib.w2k_paged_split.restype = i
        lib.w2k_paged_combine.argtypes = [p, p, p, i, i, i, i, p, p]
        lib.w2k_paged_combine.restype = i
        lib.w2k_error_string.argtypes = [i]
        lib.w2k_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_flash() -> ctypes.CDLL:
    global _flash_lib
    if _flash_lib is None:
        lib = build.load("flash_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.w2k_flash_fwd, lib.w2k_flash_fwd_tc):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.w2k_error_string.argtypes = [i]
        lib.w2k_error_string.restype = ctypes.c_char_p
        _flash_lib = lib
    return _flash_lib


def _raise_on(rc: int, what: str, lib: Optional[ctypes.CDLL] = None) -> None:
    if rc < 0:
        raise ValueError(f"{what}: the kernel does not take these shapes (code {rc})")
    if rc != 0:
        lib = lib or _load()
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.w2k_error_string(rc).decode()} (cudaError {rc})")


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The flash kernel that takes (dtype, head_dim): ``"flash_fwd_tc"`` for
    the pairs in :data:`FLASH_TC_ROUTES`, ``"flash_fwd"`` otherwise."""
    return "flash_fwd_tc" if (dtype, head_dim) in FLASH_TC_ROUTES else "flash_fwd"


def check_flash_inputs(q, k, v, *, window: int = 0) -> None:
    """What the flash kernels take: contiguous, 16-byte aligned q (B, Sq, H,
    D), k and v (B, Skv, KVH, D) of one dtype (fp32, bf16 or fp16) on one
    device, D in ``FLASH_HEAD_DIMS`` for both keys and values, H a multiple
    of KVH (any group size), Skv >= 1, at most 65,535 query tiles of the
    route's block height, ``window >= 0``; raises ``ValueError``
    otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B, Sq, H, D), k and v (B, Skv, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, KVH, Dk = k.shape
    if Bk != B or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"batch and kv shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Dk != D or v.shape[3] != D or D not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dims q {D}, k {Dk}, v {v.shape[3]}: the kernel takes one "
                         f"of {FLASH_HEAD_DIMS} for all three")
    if KVH < 1 or H % KVH:
        raise ValueError(f"{H} query heads over {KVH} kv heads: need a whole group size")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if Skv < 1:
        raise ValueError("need at least one key")
    block_q = FLASH_BLOCK_Q[flash_route(q.dtype, D)]
    if -(-Sq // block_q) > 65535:
        raise ValueError(f"Sq {Sq} gives more than 65,535 query tiles of {block_q} rows")
    if int(window) != window or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the flash kernel of :func:`flash_route`: q (B, Sq, H, D), k and
    v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's dtype, the function of
    :func:`~repro_torch.kernels.flash_attn.ref.attention_ref`."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    check_flash_inputs(q, k, v, window=window)
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = flash_route(q.dtype, D)
    lib = _load_flash()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"w2k_{route}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B,
            Sq, Skv, H, KVH, D, int(causal), int(window), D ** -0.5, stream)
    _raise_on(rc, route, lib)
    launches[route] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Full-sequence GQA attention ``(q, k, v) -> out`` in q's dtype,
    differentiable in q, k and v. The forward launches the flash kernel on
    the kernel route and runs ``attention_ref`` otherwise; it saves q, k
    and v. The backward is the VJP of ``attention_ref`` recomputed from
    them on either route, which builds the (Sq, Skv) scores: that is the
    reference's own design (JAX ``ops.flash_attention`` is a
    ``custom_vjp`` whose backward is the oracle's VJP, and the JAX package
    has no backward kernel for flash attention), not a fallback."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, on_kernel):
        if on_kernel:
            out = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                       causal=causal, window=window)
        else:
            out = attention_ref(q, k, v, causal=causal, window=window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_ref(*qkv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    use_kernel: Optional[bool] = None):
    """Full-sequence attention q (B, Sq, H, Dh), k and v (B, Skv, KVH, Dh)
    -> (B, Sq, H, Dh) in q's dtype through :class:`FlashAttention`: the
    flash kernel for CUDA q, ``attention_ref`` for CPU q or
    ``use_kernel=False``."""
    return FlashAttention.apply(q, k, v, causal, window, kernel_route(use_kernel, q))


def check_split_inputs(q, k_pages, v_pages, ptab, lens) -> None:
    """What the split kernel takes: contiguous, 16-byte aligned q (B, H, Dh)
    and pools (P, ps, KVH, Dh) of one dtype (fp32, bf16 or fp16), H/KVH in
    {1, 2, 4, 8}, a row of Dh split into a power of two (at most 32) of
    16-byte loads, at most four such rows per thread per page, contiguous
    int32 ptab (B, NP) and lens (B,), everything on q's device; raises
    otherwise."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"need q (B, H, Dh) and equal pools (P, ps, KVH, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, Dh = q.shape
    _, ps, KVH, Dk = k_pages.shape
    if Dk != Dh or H % KVH or H // KVH not in _GROUPS:
        raise ValueError(f"heads {H} over kv heads {KVH} (group in {_GROUPS}) and "
                         f"head dims {Dh}/{Dk} must agree")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"q and pools must share one of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    vec = 16 // q.element_size()  # elements per 16-byte load
    lanes = Dh // vec
    if Dh % vec or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"head_dim {Dh} must be {vec} times a power of two up to 32 "
                         f"for {q.dtype}")
    if ps * lanes > 4 * 128:
        raise ValueError(f"page_size {ps} too large for head_dim {Dh} in {q.dtype}")
    if ptab.dtype != torch.int32 or ptab.dim() != 2 or ptab.shape[0] != B:
        raise ValueError(f"ptab must be int32 (B, NP), got {ptab.dtype} "
                         f"{tuple(ptab.shape)}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise ValueError(f"lens must be int32 (B,), got {lens.dtype} {tuple(lens.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("ptab", ptab), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def paged_attention_split_cuda(q, k_pages, v_pages, ptab, lens, *, kv_splits: int):
    """Launch the split kernel: the partials ``(mid_o, m, l)`` of
    :func:`~repro_torch.kernels.flash_attn.ref.paged_attention_split_ref`."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_split_cuda needs CUDA tensors, got {q.device}")
    check_split_inputs(q, k_pages, v_pages, ptab, lens)
    B, H, Dh = q.shape
    P, ps, KVH, _ = k_pages.shape
    NP = ptab.shape[1]
    G = H // KVH
    S, pps = split_layout(NP, kv_splits)
    mid_o = torch.empty((B, KVH, S, G, Dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, KVH, S, G, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if B == 0 or NP == 0:
        return mid_o, m, l
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_paged_split(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                                 ptab.data_ptr(), lens.data_ptr(), _DTYPES[q.dtype],
                                 B, P, KVH, G, Dh, ps, NP, S, Dh ** -0.5, mid_o.data_ptr(),
                                 m.data_ptr(), l.data_ptr(), stream)
    _raise_on(rc, "paged_split")
    launches["paged_split"] += 1
    return mid_o, m, l


def combine_splits_cuda(mid_o, m, l):
    """Launch the combine kernel: (B, KVH, S, G, Dv) partials -> (B, KVH, G,
    Dv) fp32."""
    if mid_o.device.type != "cuda":
        raise ValueError(f"combine_splits_cuda needs CUDA tensors, got {mid_o.device}")
    B, KVH, S, G, Dv = mid_o.shape
    for name, t, shape in (("mid_o", mid_o, (B, KVH, S, G, Dv)),
                           ("m", m, (B, KVH, S, G, 1)), ("l", l, (B, KVH, S, G, 1))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != mid_o.device):
            raise ValueError(f"{name} must be a contiguous fp32 {shape} on "
                             f"{mid_o.device}, got {t.dtype} {tuple(t.shape)}")
    out = torch.empty((B, KVH, G, Dv), dtype=torch.float32, device=mid_o.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(mid_o.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.w2k_paged_combine(mid_o.data_ptr(), m.data_ptr(), l.data_ptr(),
                                   B * KVH, S, G, Dv, out.data_ptr(), stream)
    _raise_on(rc, "paged_combine")
    launches["paged_combine"] += 1
    return out


def paged_attention_split(q, k_pages, v_pages, ptab, lens, *, kv_splits: int,
                          use_kernel: Optional[bool] = None):
    """Split partials: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors or ``use_kernel=False``."""
    if kernel_route(use_kernel, q):
        return paged_attention_split_cuda(q, k_pages, v_pages, ptab, lens,
                                          kv_splits=kv_splits)
    return paged_attention_split_ref(q, k_pages, v_pages, ptab, lens,
                                     kv_splits=kv_splits)


def combine_splits(mid_o, m, l, use_kernel: Optional[bool] = None):
    """LSE merge of the partials, routed like :func:`paged_attention_split`."""
    if kernel_route(use_kernel, mid_o):
        return combine_splits_cuda(mid_o, m, l)
    return combine_splits_ref(mid_o, m, l)


def paged_attention(q, k_pages, v_pages, ptab, lens, *, use_kernel: Optional[bool] = None,
                    kv_splits: Optional[int] = None):
    """Decode-step attention over paged pools: q (B, H, Dh) -> (B, H, Dv) in
    q's dtype. ``use_kernel=False`` takes the gather oracle; otherwise the
    split-KV algorithm runs (kernels on the card, their plain versions on
    the CPU). ``kv_splits=None`` resolves from the heuristic on the read
    shape."""
    if use_kernel is False:
        return paged_attention_ref(q, k_pages, v_pages, ptab, lens)
    B, H, Dh = q.shape
    _, ps, KVH, Dv = v_pages.shape
    if kv_splits is None:
        kv_splits = autotune.heuristic_kv_splits(
            ps, H // KVH, Dh, ptab.shape[1], batch=B,
            backend=autotune.backend_of(q.device))
    mid_o, m, l = paged_attention_split(q, k_pages, v_pages, ptab, lens,
                                        kv_splits=kv_splits, use_kernel=use_kernel)
    out = combine_splits(mid_o, m, l, use_kernel=use_kernel)
    return out.reshape(B, H, Dv).to(q.dtype)

