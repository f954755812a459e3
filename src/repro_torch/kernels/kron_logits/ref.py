"""Plain PyTorch versions of the fused Kronecker-head cross-entropy (port of
``repro.kernels.kron_logits.ref``, plus the plain versions of the two
kernels the CUDA code is held against).

  * :func:`kron_chain_logits` — full logits through the factor chain;
  * :func:`kron_ce_naive` — CE on the materialized logits (small-shape oracle);
  * :func:`kron_ce_tiled` — vocab-tiled online-logsumexp CE, each tile under
    ``torch.utils.checkpoint`` so autograd recomputes tile logits instead of
    saving them (the plain route of ``core.logits.head_ce_loss``);
  * :func:`kron_ce_fwd_ref` — the fused forward: ``(loss, m, l)`` per token;
  * :func:`kron_ce_bwd_ref` — the dedicated backward: each tile recomputed,
    ``g·(softmax − onehot)`` formed from the saved ``(m, l)`` and pushed
    through ``common.chain_vjp`` into ``dh`` and ``dF_j``.

``h`` is zero-padded to ``P = prod q``; vocabulary columns at or past
``vocab_size`` are masked. Every contraction runs in at least fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import common as C

NEG = -1e30


def kron_chain_logits(factors: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (B, P) (P = prod q) -> logits (B, prod t) via the factor chain."""
    return C.chain_forward(x, factors)


def _pad_x(factors, h: torch.Tensor) -> torch.Tensor:
    P = math.prod(f.shape[1] for f in factors)
    x = h.to(C.acc_dtype(h))
    if P > x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, P - x.shape[-1]))
    return x


def kron_ce_naive(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Materializes the full logits: small-shape oracle. (B,) losses."""
    logits = kron_chain_logits(factors, _pad_x(factors, h))[:, :vocab_size]
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(1, labels.long()[:, None])[:, 0]


def _tile_update(x, f0_tile, rest, y, col0, vocab_size, carry):
    m, l, ylogit = carry
    logits = C.chain_forward(x, [f0_tile, *rest])  # (B, tile_cols)
    tile_cols = logits.shape[1]
    cols = col0 + torch.arange(tile_cols, device=x.device)
    logits = torch.where(cols[None] < vocab_size, logits, NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    in_tile = (y >= col0) & (y < col0 + tile_cols)
    local = torch.clamp(y - col0, 0, tile_cols - 1)
    picked = logits.gather(1, local[:, None])[:, 0]
    return m_new, l, torch.where(in_tile, picked, ylogit)


def _tiles(factors, t1_block: int):
    """(t1 columns per vocab tile, vocab columns per tile): ``t1_block``
    lowered to a divisor of t1, the JAX kernels' rule."""
    t1 = factors[0].shape[2]
    blk = min(t1_block, t1)
    while t1 % blk:
        blk -= 1
    t_rest = math.prod(f.shape[2] for f in factors[1:])
    return blk, blk * t_rest


def _online_stats(factors, x, y, vocab_size, t1_block, tile_fn):
    """(m, l, label logit) per token over the vocab tiles."""
    blk, tile_cols = _tiles(factors, t1_block)
    B = x.shape[0]
    carry = (torch.full((B,), NEG, dtype=x.dtype, device=x.device),
             torch.zeros((B,), dtype=x.dtype, device=x.device),
             torch.zeros((B,), dtype=x.dtype, device=x.device))
    for i in range(factors[0].shape[2] // blk):
        carry = tile_fn(x, factors[0][:, :, i * blk:(i + 1) * blk], factors[1:], y,
                        i * tile_cols, vocab_size, carry)
    return carry


def kron_ce_tiled(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, t1_block: int = 16) -> torch.Tensor:
    """Vocab-tiled online-logsumexp CE, O(B·tile) memory, differentiable by
    autograd with every tile checkpointed. (B,) losses."""
    x = _pad_x(factors, h)

    def tile_fn(x, f0_tile, rest, y, col0, vocab_size, carry):
        return checkpoint(_tile_update, x, f0_tile, rest, y, col0, vocab_size, carry,
                          use_reentrant=False)

    m, l, ylogit = _online_stats(factors, x, labels.long(), vocab_size, t1_block, tile_fn)
    return m + torch.log(l) - ylogit


@torch.no_grad()
def kron_ce_fwd_ref(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                    vocab_size: int, t1_block: int = 16):
    """The fused forward's plain version: ``(loss, m, l)``, each (B,), with
    ``loss = m + log l − label logit``."""
    x = _pad_x(factors, h)
    m, l, ylogit = _online_stats(factors, x, labels.long(), vocab_size, t1_block,
                                 _tile_update)
    return m + torch.log(l) - ylogit, m, l


@torch.no_grad()
def kron_ce_bwd_ref(factors: Sequence[torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                    m: torch.Tensor, l: torch.Tensor, g: torch.Tensor, vocab_size: int,
                    t1_block: int = 16) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The dedicated backward's plain version: ``([dL/dF_j], dL/dh)`` from
    the forward's ``(m, l)`` and the per-token loss cotangent ``g``."""
    x = _pad_x(factors, h)
    dt = x.dtype
    y = labels.long()
    blk, tile_cols = _tiles(factors, t1_block)
    m, l, g = m.to(dt)[:, None], l.to(dt)[:, None], g.to(dt)[:, None]
    dx = torch.zeros_like(x)
    dfs = [torch.zeros(f.shape, dtype=dt, device=x.device) for f in factors]
    for i in range(factors[0].shape[2] // blk):
        tile = [factors[0][:, :, i * blk:(i + 1) * blk], *factors[1:]]
        logits = C.chain_forward(x, tile)
        col0 = i * tile_cols
        cols = col0 + torch.arange(tile_cols, device=x.device)
        p = torch.where(cols[None] < vocab_size, torch.exp(logits - m) / l, 0.0)
        onehot = (cols[None] == y[:, None]).to(dt)
        dtx, dtf = C.chain_vjp(x, tile, g * (p - onehot))
        dx += dtx
        dfs[0][:, :, i * blk:(i + 1) * blk] = dtf[0]
        for acc, d in zip(dfs[1:], dtf[1:]):
            acc += d
    return dfs, dx[:, :h.shape[-1]]
