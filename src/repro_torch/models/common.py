"""Shared building blocks: norms, rotary embeddings, initializers and the
ket-aware projection helpers (torch port of ``repro.models.common``).

A *ket linear* stores a (d_in, d_out) weight as Kronecker factor stacks
(``{"factors": [(rank, q_j, t_j), ...]}``, core/ketops) instead of a dense
tensor, and applies it with the factor chain (``kron_matmul``). The
projection helpers take either form, so ``linear_kind="ket"`` swaps the
storage model-wide.

Dense parameters keep the JAX package's layouts: a linear is
``(d_in, d_out)``, q/k/v projections ``(d, H, Dh)``, the output
projection ``(H, Dh, d)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["rmsnorm", "init_rmsnorm", "dense_init", "apply_rope", "rope_angles",
           "linear_init", "linear_apply", "qkv_proj", "out_proj", "is_ket_param",
           "linear_opts"]


def init_rmsnorm(dim: int, dtype=torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(dt)


def dense_init(gen: torch.Generator, shape, dtype=torch.float32, fan_in=None,
               device="cuda") -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in)."""
    fi = fan_in if fan_in is not None else shape[0]
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * (1.0 / math.sqrt(fi))


def is_ket_param(p) -> bool:
    """True when a projection parameter is a ket factor dict, not a tensor."""
    return isinstance(p, dict)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
                device="cuda", *, kind: str = "dense", order: int = 2, rank: int = 8,
                quant: str = "none"):
    """A (d_in, d_out) projection: a dense tensor, or ket factor stacks with
    the JAX package's shapes and scale (``ketops.init`` of a LayerNorm-free
    spec). ``quant`` stores the ket factors in the int8 / fp8 wire format
    (serving only; a dense projection ignores it)."""
    if kind == "dense":
        return dense_init(gen, (d_in, d_out), dtype, fan_in=d_in, device=device)
    if kind != "ket":
        raise ValueError(f"unknown linear kind {kind!r}")
    from repro_torch.core import ketops
    spec = ketops.KronSpec(in_dim=d_in, out_dim=d_out, order=order, rank=rank,
                           use_layernorm=False, dtype=dtype, quant=quant)
    return ketops.init(gen, spec, device)


def linear_opts(cfg) -> dict:
    """The ket-linear apply options of a ModelConfig, as ``linear_apply`` /
    ``qkv_proj`` / ``out_proj`` / ``ffn`` kwargs: the kron_matmul route."""
    return {"use_kernel": cfg.linear_use_kernel}


def linear_apply(p, x: torch.Tensor, dtype, d_out: int, *,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (..., d_in) @ p -> (..., d_out) in ``dtype``; p is a dense
    (d_in, d_out) tensor or a ket dict (``use_kernel`` routes the latter)."""
    if is_ket_param(p):
        from repro_torch.core import ketops
        return ketops.apply_matrix_factors(p["factors"], x.to(dtype), d_out,
                                           use_kernel=use_kernel)
    return x.to(dtype) @ p.to(dtype)


def qkv_proj(p, x: torch.Tensor, dtype, n_heads: int, head_dim: int, *,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (..., d) -> (..., n_heads, head_dim). Dense p: (d, n_heads, head_dim);
    ket p: factors covering d -> n_heads·head_dim."""
    if is_ket_param(p):
        y = linear_apply(p, x, dtype, n_heads * head_dim, use_kernel=use_kernel)
    else:
        y = x.to(dtype) @ p.to(dtype).reshape(p.shape[0], n_heads * head_dim)
    return y.reshape(*x.shape[:-1], n_heads, head_dim)


def out_proj(p, o: torch.Tensor, dtype, d_model: int, *,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """o (..., H, Dh) -> (..., d_model). Dense p: (H, Dh, d); ket p: factors
    covering H·Dh -> d."""
    o2 = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])
    if is_ket_param(p):
        return linear_apply(p, o2, dtype, d_model, use_kernel=use_kernel)
    return o2.to(dtype) @ p.to(dtype).reshape(-1, d_model)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin of shape (..., S, head_dim//2), fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, Dh); cos/sin (..., S, Dh//2). Rotate-half convention."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)
