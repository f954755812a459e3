"""AdamW with global-norm clipping and the cosine LR schedule (torch port of
``repro.optim.adamw``).

The same math as the JAX package, not ``torch.optim.AdamW`` (which applies
the weight decay to the parameter before the Adam step): clip by the global
norm, bias-corrected moments, the decoupled decay added to the normalized
update, and an fp32 master copy that the parameters are copied from.

The state mirrors the parameters (``master``, ``m``, ``v``) plus ``step``,
a Python int. :func:`adamw_update` updates the state and the parameters in
place, where JAX returns new pytrees: it saves a second copy of 17 GB of
state at the full qwen3-1.7b width.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm",
           "learning_rate", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[int], float]] = None


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac · peak`` at ``total``."""
    def f(step: int) -> float:
        if step < warmup:
            return peak * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + math.cos(math.pi * prog)))
    return f


def learning_rate(cfg: AdamWConfig, step: int) -> float:
    """The LR of optimizer step ``step`` (counted from 1)."""
    return cfg.schedule(step) if cfg.schedule is not None else cfg.lr


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / list in a fixed order (dict insertion
    order, then list order)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        for v in tree:
            yield from tree_leaves(v)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def adamw_init(params) -> dict:
    with torch.no_grad():
        leaves = list(tree_leaves(params))
        return {
            "master": [p.detach().float().clone() for p in leaves],
            "m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves],
            "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves],
            "step": 0,
        }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: list, opt_state: dict, params,
                 gnorm: Optional[torch.Tensor] = None) -> dict:
    """One AdamW step, in place on ``opt_state`` and the parameters (their
    dtype kept); ``grads`` are in ``tree_leaves(params)`` order, and
    ``gnorm`` their global norm when the caller has it. Returns the metrics
    ``{"grad_norm", "lr"}``."""
    step = opt_state["step"] + 1
    lr = learning_rate(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p, g, m, v, master in zip(tree_leaves(params), grads, opt_state["m"],
                                  opt_state["v"], opt_state["master"]):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * master
        master.sub_(lr * update)
        p.copy_(master)
    opt_state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
