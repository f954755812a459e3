"""Train-step factory: loss -> grads -> AdamW (torch port of
``repro.train.step``).

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch,
guard=None)``. Microbatch accumulation runs the microbatches one after the
other and averages their gradients, as the JAX step's scan does.

What differs from the JAX step:

* The state holds no ``rng``: JAX carries a per-step key for stochastic
  regularizers; nothing on the ported path draws random numbers in a step,
  and a ``torch.Generator`` could not reproduce JAX's stream anyway.
* The update is in place (``optim.adamw``), and ``train_step`` returns the
  same state dict it was given.
* The guard decides before the update: a non-finite or over-threshold
  loss/grad-norm leaves every tensor of the state as it was, which is what
  JAX's select of the old values gives, without a second copy of the
  state; it costs one host read of the two scalars per guarded step.
* Gradient compression is not ported (``compress_grads`` raises).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                                     learning_rate, tree_leaves)

__all__ = ["TrainConfig", "init_state", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # gradient-accumulation depth
    compress_grads: bool = False  # error-feedback int8 gradients: not ported


def _check(tcfg: TrainConfig) -> None:
    if tcfg.compress_grads:
        raise NotImplementedError("gradient compression is not ported yet")


def init_state(cfg: ModelConfig, tcfg: TrainConfig, *, seed: int = 0,
               device="cuda") -> dict:
    """Seeded parameters (requiring grad) and their AdamW state."""
    _check(tcfg)
    params = MD.init_params(cfg, seed=seed, device=device)
    return with_params(params)


def with_params(params: dict) -> dict:
    """A fresh training state around existing parameters (converted ones,
    in the tests): they are made to require grad, the optimizer state starts
    at step 0."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw_init(params)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    _check(tcfg)

    def compute_grads(params: dict, batch: dict):
        leaves = list(tree_leaves(params))
        n = tcfg.microbatches
        if n <= 1:
            loss, metrics = MD.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)
        size = batch["tokens"].shape[0] // n
        gsum, loss_sum = None, 0.0
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, _ = MD.loss_fn(params, cfg, mb)
            grads = torch.autograd.grad(loss, leaves)
            if gsum is None:
                gsum = list(grads)
            else:
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        loss = loss_sum / n
        return loss, {"loss": loss}, [g / n for g in gsum]

    def train_step(state: dict, batch: dict,
                   guard: Optional[tuple[float, float]] = None):
        """One optimizer step on ``state`` (in place); ``guard=(max_loss,
        max_grad_norm)`` rejects a non-finite or over-threshold step, leaving
        the state untouched (``metrics["applied"]`` False)."""
        if batch["tokens"].shape[0] % tcfg.microbatches:
            raise ValueError(f"batch {batch['tokens'].shape[0]} does not split into "
                             f"{tcfg.microbatches} microbatches")
        loss, metrics, grads = compute_grads(state["params"], batch)
        gnorm = global_norm(grads)
        metrics = dict(metrics)
        if guard is not None:
            max_loss, max_gnorm = guard
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm)
                      & (loss <= max_loss) & (gnorm <= max_gnorm))
            metrics["applied"] = ok
            if not ok:
                metrics.update(grad_norm=gnorm, lr=learning_rate(
                    tcfg.optimizer, state["opt"]["step"] + 1))
                return state, metrics
        metrics.update(adamw_update(tcfg.optimizer, grads, state["opt"], state["params"],
                                    gnorm=gnorm))
        return state, metrics

    return train_step
