"""Low-bit storage for Kronecker factors: int8 / fp8 quantization for
serving (torch port of ``repro.core.quant``).

The wire format, one rule for every ket tensor, is per-slice symmetric
max-abs scaling along axis 0:

  * a quantized tensor is ``{"q": payload, "scale": fp32}`` where
    ``payload`` keeps the source's shape and ``scale`` is ``(lead, 1, ...,
    1)``: one scale per rank slice of a ``(rank, q_j, t_j)`` factor stack;
  * ``int8``: ``q = round(x / s)`` clipped to ±127, ``s = maxabs / 127``
    (``torch.round`` rounds half to even, as ``jnp.round`` does);
  * ``fp8``: ``q = float8_e4m3fn(x / s)``, ``s = maxabs / 448`` (the
    e4m3fn maximum).

The payloads and scales equal the JAX package's bit for bit. Dequantizing
is ``q.float() * scale``; the ``kron_gather`` and ``kron_matmul`` kernels
do it as they load a factor element. :func:`quantize_params` /
:func:`dequantize_params` walk a parameter tree and convert every ket
factor stack (the word2ketXS embedding, the kron head, ket linears),
leaving dense tensors alone: the post-training calibration of
``serve/engine.ServingEngine(quant=...)`` and ``launch/serve.py --quant``.
Quantized payloads are not differentiable: train with ``quant="none"``,
quantize afterwards.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "MODES",
    "is_quantized",
    "payload_dtype",
    "itemsize",
    "quantize",
    "dequantize",
    "as_f32",
    "quantize_params",
    "dequantize_params",
    "materialize_error_bound",
    "num_scales",
    "storage_bytes",
]

MODES = ("none", "int8", "fp8")

_INT8_MAX = 127.0
_FP8_MAX = 448.0  # float8_e4m3fn finite max
_TINY = 1e-12

# keys marking a ket parameter's list of factor tensors in a parameter tree
_KET_KEYS = ("factors", "leaves")


def is_quantized(x) -> bool:
    """True when ``x`` is a quantized-tensor dict (payload + scales)."""
    return isinstance(x, dict) and "q" in x and "scale" in x


def payload_dtype(mode: str) -> torch.dtype:
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"no payload dtype for quant mode {mode!r}")


def itemsize(mode: str, dtype: torch.dtype = torch.float32) -> int:
    """Bytes per stored payload element for a quant mode ("none" -> dtype)."""
    if mode == "none":
        return dtype.itemsize
    return payload_dtype(mode).itemsize


def _slice_scale(x: torch.Tensor, mode: str) -> torch.Tensor:
    m = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True).float()
    qmax = _INT8_MAX if mode == "int8" else _FP8_MAX
    return torch.clamp(m, min=_TINY) / qmax


def quantize(x, mode: str):
    """Symmetric per-axis-0-slice quantization -> ``{"q", "scale"}``.
    Already-quantized inputs pass through unchanged (idempotent)."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (expected one of {MODES})")
    if mode == "none" or is_quantized(x):
        return x
    scale = _slice_scale(x, mode)
    y = x.float() / scale
    if mode == "int8":
        q = torch.clamp(torch.round(y), -_INT8_MAX, _INT8_MAX).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return {"q": q, "scale": scale}


def dequantize(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if not is_quantized(x):
        return x.to(dtype)
    return (x["q"].float() * x["scale"]).to(dtype)


def as_f32(x) -> torch.Tensor:
    """Dequant-on-read helper: quantized dict -> fp32, tensor -> fp32."""
    return dequantize(x, torch.float32)


def _map_ket_tensors(tree, fn):
    # list stays list and tuple stays tuple: a quantize / dequantize round
    # trip leaves the tree's structure as it was
    if isinstance(tree, dict):
        if is_quantized(tree):
            return fn(tree)

        def _map_val(k, v):
            if k in _KET_KEYS and isinstance(v, (list, tuple)):
                mapped = [fn(t) for t in v]
                return tuple(mapped) if isinstance(v, tuple) else mapped
            return _map_ket_tensors(v, fn)
        return {k: _map_val(k, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [_map_ket_tensors(v, fn) for v in tree]
        return tuple(mapped) if isinstance(tree, tuple) else mapped
    return tree


def quantize_params(params, mode: str):
    """Post-training calibration: every ket factor stack (a ``"factors"``
    list, wherever it sits) becomes its ``{"q", "scale"}`` wire form; dense
    tensors are untouched. ``mode="none"`` returns the tree unchanged."""
    if mode == "none":
        return params
    return _map_ket_tensors(params, lambda t: quantize(t, mode))


def dequantize_params(params, dtype: torch.dtype = torch.float32):
    """Inverse of :func:`quantize_params`: payloads expanded back to floats."""
    return _map_ket_tensors(params, lambda t: dequantize(t, dtype))


def _slice_maxabs(f: torch.Tensor) -> torch.Tensor:
    return f.float().abs().amax(dim=tuple(range(1, f.dim())))


def _slice_delta(m: torch.Tensor, mode: str) -> torch.Tensor:
    """Per-slice worst-case elementwise quantization error given maxabs m."""
    if mode == "int8":  # round to nearest on the int grid: half a step
        return 0.5 * torch.clamp(m, min=_TINY) / _INT8_MAX
    if mode == "fp8":
        # e4m3: 3 mantissa bits -> rel err <= 2^-4 for normals, plus the
        # subnormal absolute step 2^-9 of the scaled grid
        return (2.0 ** -4) * m + (2.0 ** -9) * torch.clamp(m, min=_TINY) / _FP8_MAX
    raise ValueError(f"no error bound for quant mode {mode!r}")


def materialize_error_bound(params: dict, mode: str) -> float:
    """Max-abs bound on ``materialize(quantized) − materialize(fp32)`` for a
    LayerNorm-free operator: with ``|f_jk| <= M_jk`` and per-entry error
    ``|e_jk| <= Δ_jk``, every entry's error is at most
    ``Σ_k [Π_j (M_jk + Δ_jk) − Π_j M_jk]``. ``params`` holds the fp32
    factors."""
    factors = params["factors"]
    rank = factors[0].shape[0]
    hi = torch.ones((rank,), dtype=torch.float32, device=factors[0].device)
    lo = torch.ones_like(hi)
    for f in factors:
        m = _slice_maxabs(f)
        hi = hi * (m + _slice_delta(m, mode))
        lo = lo * m
    return float((hi - lo).sum())


def num_scales(shapes) -> int:
    """Scale count for a list of tensor shapes (one per axis-0 slice)."""
    return sum(int(s[0]) for s in shapes)


def storage_bytes(shapes, mode: str, dtype: torch.dtype = torch.float32) -> int:
    """Stored bytes of tensors of ``shapes`` under a quant mode: payloads at
    the mode's width plus fp32 scales (none => no scales)."""
    n = sum(int(math.prod(s)) for s in shapes)
    if mode == "none":
        return n * itemsize(mode, dtype)
    return n * itemsize(mode) + 4 * num_scales(shapes)
