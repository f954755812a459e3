"""ketops: the Kronecker-operator subsystem (torch port of
``repro.core.ketops``, the parts the serving path uses).

The operator is ``F = Σ_{k=1..r} ⊗_{j=1..n} F_jk`` with ``F_jk ∈ R^{q_j × t_j}``,
stored as ``order`` factor stacks of shape ``(rank, q_j, t_j)``
(``storage="factors"``, word2ketXS, paper §3.2):

  * :func:`init`          — factor stacks from a ``torch.Generator``;
  * :func:`apply_vector`  — lazy column extraction ``ids -> F[:, ids]`` (an
                            embedding lookup) through ``kron_gather``;
  * :func:`apply_matrix`  — ``x @ F`` through ``kron_matmul`` (the kron head);
  * :func:`materialize`   — the dense table, for tests only.

The per-column ``"leaves"`` storage (word2ket) and the quantized wire format
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import kron as K

__all__ = [
    "KronSpec",
    "SpecProps",
    "init",
    "apply_vector",
    "apply_matrix",
    "apply_matrix_factors",
    "materialize",
    "num_params",
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
    use_kernel: Optional[bool] = None

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
    ``torch.Generator`` and ``jax.random`` differ)."""
    spec.validate()
    s = _leaf_scale(spec)
    return {"factors": [
        torch.randn(shape, generator=gen, dtype=spec.dtype, device=device) * s
        for shape in factor_shapes(spec)
    ]}


def num_params(spec: KronSpec) -> int:
    """r · Σ_j q_j·t_j (paper §3.2)."""
    q, t = spec.resolved_q(), spec.resolved_t()
    return spec.rank * sum(qj * tj for qj, tj in zip(q, t))


def apply_vector(spec: KronSpec, params: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> columns of F as vectors (..., in_dim) in
    ``spec.dtype``: lazy mixed-radix column extraction, the balanced LN tree
    and the rank sum, through ``kron_gather`` (kernel or plain version)."""
    from repro_torch.kernels.kron_gather.ops import kron_gather
    flat = kron_gather(params["factors"], ids.reshape(-1).to(torch.int32).contiguous(),
                       spec.in_dim, spec.use_layernorm, spec.use_kernel)
    return flat.reshape(*ids.shape, spec.in_dim).to(spec.dtype)


def apply_matrix_factors(factors: list, x: torch.Tensor, out_dim: int, *,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``x (..., d_in) @ (Σ_k ⊗_j F_jk)`` -> ``(..., out_dim)``, spec-free:
    ``x`` zero-padded up to ``prod q``, output sliced to ``out_dim``, every
    contraction in fp32, result in ``x``'s dtype."""
    from repro_torch.kernels.kron_matmul.ops import kron_matmul
    lead = x.shape[:-1]
    z = kron_matmul(factors, x.reshape(-1, x.shape[-1]), out_dim, use_kernel)
    return z.reshape(*lead, out_dim).to(x.dtype)


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
    device = params["factors"][0].device
    ids = torch.arange(spec.out_dim, device=device)
    return torch.cat([apply_vector(plain, params, part)
                      for part in torch.split(ids, chunk)])
