"""Model config dataclass (the fields the ported serving and training paths
read).

Field names and defaults are those of ``repro.configs.base.ModelConfig``;
``dtype`` and ``param_dtype`` are torch dtypes. Fields of slices not yet
ported (MoE, MLA, SSM, quantization, meshes) are left out until their
slice lands, and so are the TPU tile sizes of the ket linears
(``linear_tile``, ``linear_block_b``) and their mesh knob
(``ket_shard_rank``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.embedding import EmbeddingConfig
from repro_torch.core.logits import HeadConfig

__all__ = ["ModelConfig", "embedding_for", "head_for"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config per architecture (exact published dims)."""

    name: str
    family: str  # only "dense" is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    qk_norm: bool = False
    rope_theta: float = 10000.0
    mlp_type: str = "swiglu"  # only swiglu is ported

    # empty => uniform pattern derived from family
    layer_pattern: tuple[str, ...] = ()

    # embedding & head representation (the paper's technique)
    embedding_kind: str = "word2ketxs"
    embedding_order: int = 2
    embedding_rank: int = 32
    embedding_layernorm: bool = True
    head_kind: str = "kron"
    head_order: int = 2
    head_rank: int = 32
    # t1 digits per vocab tile of the CE's plain route (core/logits.py)
    head_vocab_tile: int = 4
    # hand-written kernels for lookup / head: None = auto (the kernel for
    # CUDA tensors, the plain version for CPU tensors); False = the plain
    # version everywhere, because the caller asked for it
    use_kernels: Optional[bool] = None

    # ket linear layers: "ket" stores the FFN wi/wg/wo and the attention
    # q/k/v/o projections as rank-r Kronecker factor stacks (core/ketops)
    # applied by the factor chain, forward and backward
    linear_kind: str = "dense"  # dense | ket
    linear_order: int = 2
    linear_rank: int = 8
    # the kron_matmul kernels for the ket linears, independent of
    # ``use_kernels``: None = the kernels for CUDA tensors, the plain
    # versions for CPU tensors; False = the plain versions everywhere
    linear_use_kernel: Optional[bool] = None

    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    attn_chunk: int = 1024  # flash-attention KV-chunk size
    # activation checkpointing of the training forward, per layer: "none",
    # or "full" / "dots" (both a per-layer torch.utils.checkpoint; see
    # models/transformer.forward)
    remat: str = "dots"

    # serving substrate (serve/engine.py + serve/cache.py): ``page_size`` is
    # the token granularity of the paged KV pools; ``prefill_chunk`` is how
    # many prompt tokens one engine tick ingests through chunked prefill
    page_size: int = 16
    prefill_chunk: int = 16
    # parallel KV splits of the split-KV paged decode read. None = resolved
    # from kernels.autotune.heuristic_kv_splits on the read shape; the
    # engine pins it at build time so every decode step uses one value
    decode_kv_splits: Optional[int] = None

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet (only 'dense')")
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", ("attn",))
        if set(self.layer_pattern) != {"attn"}:
            raise NotImplementedError(
                f"layer kinds {self.layer_pattern} are not ported yet (only 'attn')")
        if self.mlp_type != "swiglu":
            raise NotImplementedError(f"mlp_type {self.mlp_type!r} is not ported yet")
        if self.linear_kind not in ("dense", "ket"):
            raise ValueError(f"unknown linear kind {self.linear_kind!r}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat policy {self.remat!r}")

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def embedding_for(cfg: ModelConfig) -> EmbeddingConfig:
    return EmbeddingConfig(
        vocab_size=cfg.vocab_size,
        embed_dim=cfg.d_model,
        kind=cfg.embedding_kind,
        order=cfg.embedding_order,
        rank=cfg.embedding_rank,
        use_layernorm=cfg.embedding_layernorm,
        dtype=cfg.param_dtype,
        use_kernel=cfg.use_kernels,
    )


def head_for(cfg: ModelConfig) -> HeadConfig:
    return HeadConfig(
        vocab_size=cfg.vocab_size,
        embed_dim=cfg.d_model,
        kind=cfg.head_kind,
        order=cfg.head_order,
        rank=cfg.head_rank,
        vocab_tile=cfg.head_vocab_tile,
        dtype=cfg.param_dtype,
        use_kernel=cfg.use_kernels,
    )
