"""ketops: the Kronecker-operator subsystem (torch port of
``repro.core.ketops``, the parts the serving and training paths use).

The operator is ``F = Σ_{k=1..r} ⊗_{j=1..n} F_jk`` with ``F_jk ∈ R^{q_j × t_j}``,
stored as ``order`` factor stacks of shape ``(rank, q_j, t_j)``
(``storage="factors"``, word2ketXS, paper §3.2):

  * :func:`init`          — factor stacks from a ``torch.Generator``, in the
                            int8 / fp8 wire format (core/quant) when the
                            spec has a ``quant`` mode;
  * :func:`apply_vector`  — lazy column extraction ``ids -> F[:, ids]`` (an
                            embedding lookup) through ``kron_gather``,
                            differentiable in fp32 factors; quantized factors
                            go to its dequant-fused forward leg;
  * :func:`apply_matrix`  — ``x @ F`` through ``kron_matmul`` (the kron head
                            and, via :func:`apply_matrix_factors`, the ket
                            linears), differentiable in ``x`` and fp32
                            factors; quantized factors go to its
                            dequant-fused forward leg;
  * :func:`materialize`   — the dense table, for tests only.

Factors are all fp32 or all quantized on the kernel route. A stack that
mixes the two (a partially calibrated checkpoint) runs the plain versions
on dequantized factors on the CPU, as the JAX package's chain does, and
raises on a CUDA tensor. The per-column ``"leaves"`` storage (word2ket) is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import kron as K
from repro_torch.core import quant as Q
from repro_torch.kernels import kernel_route

__all__ = [
    "KronSpec",
    "SpecProps",
    "init",
    "apply_vector",
    "apply_matrix",
    "apply_matrix_factors",
    "materialize",
    "num_params",
    "num_bytes",
    "factor_shapes",
]


@dataclasses.dataclass(frozen=True)
class KronSpec:
    """Shape + policy of one Kronecker-factorized operator F (in_dim × out_dim).

    in_dim:  the q-axis logical dimension (embedding width / fan-in);
             ``prod(resolved_q()) >= in_dim``, excess rows are sliced away.
    out_dim: the t-axis logical dimension (vocab size / fan-out);
             ``prod(resolved_t()) >= out_dim``, excess columns are sliced.
    order/rank: tensor order n and rank r.
    q_dims/t_dims: explicit factorizations; derived when None.
    use_layernorm: non-affine LayerNorm at the balanced-tree nodes. Must be
             False for ``apply_matrix``.
    quant:   "none" | "int8" | "fp8": the storage :func:`init` emits (the
             apply functions read the format from the parameters).
    use_kernel: None = the CUDA kernel for CUDA tensors, the plain version
             for CPU tensors; False = the plain version everywhere.
    """

    in_dim: int
    out_dim: int
    order: int = 2
    rank: int = 1
    q_dims: Optional[tuple[int, ...]] = None
    t_dims: Optional[tuple[int, ...]] = None
    use_layernorm: bool = True
    dtype: Any = torch.float32
    quant: str = "none"
    use_kernel: Optional[bool] = None

    def __post_init__(self):
        if self.quant not in Q.MODES:
            raise ValueError(f"unknown quant {self.quant!r} (expected {Q.MODES})")

    def resolved_q(self) -> tuple[int, ...]:
        if self.q_dims is not None:
            return self.q_dims
        return K.choose_factorization(self.in_dim, self.order)

    def resolved_t(self) -> tuple[int, ...]:
        if self.t_dims is not None:
            return self.t_dims
        return K.choose_factorization(self.out_dim, self.order)

    def validate(self) -> "KronSpec":
        q, t = self.resolved_q(), self.resolved_t()
        if len(q) != self.order or math.prod(q) < self.in_dim:
            raise ValueError(f"bad q_dims {q} for in_dim={self.in_dim}")
        if len(t) != self.order or math.prod(t) < self.out_dim:
            raise ValueError(f"bad t_dims {t} for out_dim={self.out_dim}")
        return self


class SpecProps:
    """Read-only pass-through of KronSpec knobs for configs holding a
    ``spec`` field (EmbeddingConfig / HeadConfig)."""

    spec: KronSpec

    @property
    def order(self) -> int:
        return self.spec.order

    @property
    def rank(self) -> int:
        return self.spec.rank

    @property
    def q_dims(self) -> Optional[tuple[int, ...]]:
        return self.spec.q_dims

    @property
    def t_dims(self) -> Optional[tuple[int, ...]]:
        return self.spec.t_dims

    @property
    def use_layernorm(self) -> bool:
        return self.spec.use_layernorm

    @property
    def dtype(self) -> Any:
        return self.spec.dtype

    @property
    def quant(self) -> str:
        return self.spec.quant

    @property
    def use_kernel(self) -> Optional[bool]:
        return self.spec.use_kernel

    def resolved_q(self) -> tuple[int, ...]:
        return self.spec.resolved_q()

    def resolved_t(self) -> tuple[int, ...]:
        return self.spec.resolved_t()


def factor_shapes(spec: KronSpec) -> list[tuple[int, int, int]]:
    q, t = spec.resolved_q(), spec.resolved_t()
    return [(spec.rank, qj, tj) for qj, tj in zip(q, t)]


def _leaf_scale(spec: KronSpec) -> float:
    # a reconstructed entry sums r products of n factor entries; with factor
    # std s its std is sqrt(r)·s^n — aim at 1/sqrt(prod q)
    p = math.prod(spec.resolved_q())
    return (1.0 / (math.sqrt(spec.rank) * math.sqrt(p))) ** (1.0 / spec.order)


def init(gen: torch.Generator, spec: KronSpec, device) -> dict:
    """Factor stacks with the JAX package's shapes and scale (not its values:
    ``torch.Generator`` and ``jax.random`` differ). With ``spec.quant`` the
    same draw is quantized, so quantizing an fp32 init from the same
    generator state gives the same payloads."""
    spec.validate()
    s = _leaf_scale(spec)
    params = {"factors": [
        torch.randn(shape, generator=gen, dtype=spec.dtype, device=device) * s
        for shape in factor_shapes(spec)
    ]}
    return Q.quantize_params(params, spec.quant)


def num_params(spec: KronSpec) -> int:
    """r · Σ_j q_j·t_j (paper §3.2)."""
    q, t = spec.resolved_q(), spec.resolved_t()
    return spec.rank * sum(qj * tj for qj, tj in zip(q, t))


def num_bytes(spec: KronSpec) -> int:
    """Stored bytes of the operator: payloads at the quant width plus the
    fp32 per-slice scales."""
    return Q.storage_bytes(factor_shapes(spec), spec.quant, spec.dtype)


def _n_quantized(factors) -> int:
    """How many of ``factors`` are in the quantized wire format."""
    return sum(Q.is_quantized(f) for f in factors)


def _mixed(on_kernel: bool) -> None:
    """A mix of quantized and fp32 stacks has no kernel leg: raise on the
    kernel route."""
    if on_kernel:
        raise NotImplementedError(
            "a mix of quantized and fp32 factor stacks has no kernel leg; "
            "quantize every stack (core/quant.quantize_params) or pass "
            "use_kernel=False")


def apply_vector(spec: KronSpec, params: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> columns of F as vectors (..., in_dim) in
    ``spec.dtype``: lazy mixed-radix column extraction, the balanced LN tree
    and the rank sum, through ``kron_gather`` (kernel or plain version), or
    its dequant-fused leg ``kron_gather_quant`` for quantized factors."""
    from repro_torch.kernels.kron_gather.ops import (kron_gather, kron_gather_quant,
                                                     kron_gather_ref)
    factors = params["factors"]
    flat_ids = ids.reshape(-1).to(torch.int32).contiguous()
    n_quant = _n_quantized(factors)
    if n_quant == 0:
        flat = kron_gather(factors, flat_ids, spec.in_dim, spec.use_layernorm,
                           spec.use_kernel)
    elif n_quant == len(factors):
        flat = kron_gather_quant([f["q"] for f in factors], [f["scale"] for f in factors],
                                 flat_ids, spec.in_dim, spec.use_layernorm,
                                 spec.use_kernel)
    else:
        _mixed(kernel_route(spec.use_kernel, flat_ids))
        flat = kron_gather_ref([Q.as_f32(f) for f in factors], flat_ids,
                               embed_dim=spec.in_dim, use_layernorm=spec.use_layernorm)
    return flat.reshape(*ids.shape, spec.in_dim).to(spec.dtype)


def apply_matrix_factors(factors: list, x: torch.Tensor, out_dim: int, *,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``x (..., d_in) @ (Σ_k ⊗_j F_jk)`` -> ``(..., out_dim)``, spec-free:
    ``x`` zero-padded up to ``prod q``, output sliced to ``out_dim``, every
    contraction in fp32, result in ``x``'s dtype. fp32 factors go through
    the ``KronMatmul`` autograd Function: the CUDA kernels forward and
    backward for CUDA ``x``, the plain versions for CPU ``x`` or
    ``use_kernel=False``. Quantized factors go through the forward-only
    dequant-fused leg ``kron_matmul_quant``, routed the same way."""
    from repro_torch.kernels.kron_matmul.ops import (kron_matmul, kron_matmul_quant,
                                                     kron_matmul_ref)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n_quant = _n_quantized(factors)
    if n_quant == 0:
        z = kron_matmul(factors, x2, out_dim, use_kernel)
    elif n_quant == len(factors):
        z = kron_matmul_quant([f["q"] for f in factors], [f["scale"] for f in factors],
                              x2, out_dim, use_kernel)
    else:
        _mixed(kernel_route(use_kernel, x2))
        z = kron_matmul_ref([Q.as_f32(f) for f in factors], x2, out_dim).to(x.dtype)
    return z.reshape(*lead, out_dim)


def apply_matrix(spec: KronSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x (..., in_dim) -> (..., out_dim)`` through the factorized operator;
    requires ``use_layernorm=False`` (then F is exactly Σ_k ⊗_j F_jk)."""
    if spec.use_layernorm:
        raise ValueError("apply_matrix requires a pure (LayerNorm-free) operator")
    return apply_matrix_factors(params["factors"], x, spec.out_dim,
                                use_kernel=spec.use_kernel)


def materialize(spec: KronSpec, params: dict, *, chunk: int = 4096) -> torch.Tensor:
    """Full (out_dim, in_dim) table by lazy lookup of every column, through
    the plain version (an oracle independent of the kernel), ``chunk`` ids at
    a time so the (chunk, rank, prod q) tree stays small."""
    plain = dataclasses.replace(spec, use_kernel=False)
    f0 = params["factors"][0]
    device = (f0["q"] if Q.is_quantized(f0) else f0).device
    ids = torch.arange(spec.out_dim, device=device)
    return torch.cat([apply_vector(plain, params, part)
                      for part in torch.split(ids, chunk)])
