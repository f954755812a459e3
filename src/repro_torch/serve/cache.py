"""Dense per-slot KV cache (torch port of the dense layout of
``repro.serve.cache``; paged pools come with their slice).

Every attention layer holds ``(batch_slots, max_len, kv_heads, head_dim)``
K/V tensors in ``cfg.dtype``; ``step`` (B,) is each slot's own position, so
slots advance independently. The JAX cache stacks layers into groups; here
``cache["layers"]`` is a list with one entry per layer.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = ["init_cache", "init_layer_cache"]


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"cache for layer kind {kind!r} is not ported yet")
    shp = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    from repro_torch.models.transformer import layer_kinds
    dev = resolve_device(device)
    return {
        "layers": [init_layer_cache(cfg, kind, batch, max_len, dev)
                   for kind in layer_kinds(cfg)],
        "step": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
