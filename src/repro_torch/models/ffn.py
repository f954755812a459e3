"""Feed-forward block: the gated SwiGLU MLP (torch port of the swiglu
branch of ``repro.models.ffn``).

Projections go through the ket-aware ``linear_apply``, so
``linear_kind="ket"`` stores wi/wg/wo as Kronecker factor stacks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import linear_apply, linear_init


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype=torch.float32, device="cuda", *, kind: str = "dense",
             order: int = 2, rank: int = 8, quant: str = "none") -> dict:
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet")
    kw = dict(kind=kind, order=order, rank=rank, quant=quant)
    wi = linear_init(gen, d_model, d_ff, dtype, device, **kw)
    wg = linear_init(gen, d_model, d_ff, dtype, device, **kw)
    wo = linear_init(gen, d_ff, d_model, dtype, device, **kw)
    return {"wi": wi, "wo": wo, "wg": wg}


def ffn(params: dict, x: torch.Tensor, mlp_type: str, dtype, dims: tuple[int, int],
        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (..., d_model) -> (..., d_model): wo · (silu(wg·x) * (wi·x)).
    ``dims=(d_model, d_ff)``: ket factor products may overcover the logical
    dims; ``use_kernel`` is the ket-linear route (``models.common.linear_opts``)."""
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet")
    d_model, d_ff = dims
    h = linear_apply(params["wi"], x, dtype, d_ff, use_kernel=use_kernel)
    g = linear_apply(params["wg"], x, dtype, d_ff, use_kernel=use_kernel)
    return linear_apply(params["wo"], F.silu(g) * h, dtype, d_model, use_kernel=use_kernel)
