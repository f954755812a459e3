"""Shared building blocks: norms, rotary embeddings, initializers and the
dense projection helpers (torch port of ``repro.models.common``; the ket
branch of the projections is not ported yet).

Parameters keep the JAX package's layouts: a linear is ``(d_in, d_out)``,
q/k/v projections ``(d, H, Dh)``, the output projection ``(H, Dh, d)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rmsnorm", "init_rmsnorm", "dense_init", "apply_rope", "rope_angles",
           "linear_init", "linear_apply", "qkv_proj", "out_proj"]


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


def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """A dense (d_in, d_out) projection."""
    return dense_init(gen, (d_in, d_out), dtype, fan_in=d_in, device=device)


def linear_apply(p: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """x (..., d_in) @ p (d_in, d_out) in ``dtype``."""
    return x.to(dtype) @ p.to(dtype)


def qkv_proj(p: torch.Tensor, x: torch.Tensor, dtype, n_heads: int,
             head_dim: int) -> torch.Tensor:
    """x (..., d) -> (..., n_heads, head_dim); p (d, n_heads, head_dim)."""
    y = x.to(dtype) @ p.to(dtype).reshape(p.shape[0], n_heads * head_dim)
    return y.reshape(*x.shape[:-1], n_heads, head_dim)


def out_proj(p: torch.Tensor, o: torch.Tensor, dtype, d_model: int) -> torch.Tensor:
    """o (..., H, Dh) -> (..., d_model); p (H, Dh, d)."""
    o2 = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1]).to(dtype)
    return o2 @ p.to(dtype).reshape(-1, d_model)


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
