"""Unified model API of the port: init / loss / cache / serve / chunked
prefill (torch port of the LM branch of ``repro.models.model``).

Every entry point that creates tensors takes an explicit ``device``
(default ``"cuda"``) and raises when the card is missing.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve import cache as SC
from repro_torch.serve import decode as D

__all__ = ["init_params", "loss_fn", "init_cache", "serve_step_fn", "prefill_chunk_fn",
           "param_count"]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Seeded init of the LM's parameters on ``device`` (a ``torch.Generator``
    on that device; ``"meta"`` gives shapes without memory)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return T.init_lm(gen, cfg, dev)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """Training loss of the LM: (loss, metrics) of :func:`transformer.lm_loss`."""
    return T.lm_loss(params, cfg, batch)


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return sum(param_count(v) for v in params)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, paged: bool = False,
               num_pages: int | None = None, page_size: int | None = None,
               device="cuda") -> dict:
    """Decode cache (serve/cache.py): dense slots by default, paged KV pools
    with ``paged=True`` (``num_pages`` counts the trash page; None gives
    full capacity, every slot able to reach max_len)."""
    if not paged:
        return SC.init_cache(cfg, batch, max_len, device=device)
    ps = page_size or cfg.page_size
    if num_pages is None:
        num_pages = batch * SC.logical_pages(max_len, ps) + 1
    return SC.init_paged_cache(cfg, batch, max_len, num_pages=num_pages, page_size=ps,
                               device=device)


def serve_step_fn(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor):
    """One greedy-decodable step: tokens (B,) -> (logits (B, vocab), cache)."""
    return D.serve_step(params, cfg, cache, tokens)


def prefill_chunk_fn(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                     lens: torch.Tensor):
    """Chunked batched prefill: tokens (B, C) at per-slot offsets, lens (B,)
    valid counts -> (last-position logits, cache)."""
    return D.prefill_step(params, cfg, cache, tokens, lens)
