"""Feed-forward block: the gated SwiGLU MLP (torch port of the swiglu
branch of ``repro.models.ffn``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import linear_apply, linear_init


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype=torch.float32, device="cuda") -> dict:
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet")
    wi = linear_init(gen, d_model, d_ff, dtype, device)
    wg = linear_init(gen, d_model, d_ff, dtype, device)
    wo = linear_init(gen, d_ff, d_model, dtype, device)
    return {"wi": wi, "wo": wo, "wg": wg}


def ffn(params: dict, x: torch.Tensor, mlp_type: str, dtype) -> torch.Tensor:
    """x (..., d_model) -> (..., d_model): wo · (silu(wg·x) * (wi·x))."""
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet")
    h = linear_apply(params["wi"], x, dtype)
    g = linear_apply(params["wg"], x, dtype)
    return linear_apply(params["wo"], F.silu(g) * h, dtype)
