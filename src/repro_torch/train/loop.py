"""Training loop with the loss-anomaly ladder (torch port of
``repro.train.loop``, without checkpoints).

Each step draws its batch from the counter-based synthetic pipeline
(``data.synthetic.batch_at``), so a step is replayable from the seed. The
train step's guard rejects an update whose loss or grad norm is non-finite
or spikes past ``spike_factor`` × the rolling median of applied steps
(``fault.LossAnomalyDetector``); a rejected step is retried at the same
index, and after ``skip_strikes`` consecutive rejections the loop asks for
a rollback. The port has no checkpoint manager yet, so ``ckpt_dir`` must be
None and a rollback fails the run with a recorded reason, as the JAX loop
does when it has no checkpoint directory.

A step that raises propagates: the JAX loop's retry of step exceptions is
for injected faults, which the port does not have yet, and retrying on the
card would hide a kernel failure.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.fault import LossAnomalyDetector, PreemptionHandler, StragglerWatchdog
from repro_torch.train.step import TrainConfig, init_state, make_train_step

__all__ = ["LoopConfig", "train_loop"]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None  # checkpoints are not ported: must be None
    log_every: int = 10
    seed: int = 0
    # anomaly ladder knobs
    spike_factor: float = 10.0   # reject loss/gnorm > factor x rolling median
    spike_window: int = 64
    spike_warmup: int = 8        # applied steps before spike gating arms
    skip_strikes: int = 2        # consecutive rejections at one step -> rollback


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig, lcfg: LoopConfig,
               *, device="cuda", log_fn: Callable[[str], None] = print) -> dict:
    """Runs training; returns the summary (``state`` included). Anomalies
    never raise: they resolve through the ladder or end the run with
    ``summary["failed"]`` and ``summary["fail_reason"]``."""
    if lcfg.ckpt_dir is not None:
        raise NotImplementedError("checkpoints are not ported yet: ckpt_dir must be None")
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, tcfg)
    state = init_state(cfg, tcfg, seed=lcfg.seed, device=dev)

    det = LossAnomalyDetector(factor=lcfg.spike_factor, window=lcfg.spike_window,
                              warmup=lcfg.spike_warmup)
    dog = StragglerWatchdog()
    losses: list[float] = []
    step = 0
    fail_reason: Optional[str] = None
    skipped = rollbacks = strikes = 0
    anomalies: list[tuple[int, str]] = []

    def rollback(reason: str) -> None:
        nonlocal rollbacks, fail_reason
        anomalies.append((step, reason))
        rollbacks += 1
        fail_reason = f"{reason} (no checkpoint dir; rollback unavailable)"

    pre = PreemptionHandler()
    try:
        while step < lcfg.total_steps and fail_reason is None:
            t0 = time.monotonic()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dcfg, step).items()}
            thresholds = det.thresholds()
            state, metrics = step_fn(state, batch, thresholds)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.monotonic() - t0
            if not metrics["applied"]:
                skipped += 1
                strikes += 1
                reason = det.classify(loss, gnorm, thresholds)
                anomalies.append((step, reason))
                log_fn(f"[loop] step {step} REJECTED ({reason}) "
                       f"strike {strikes}/{lcfg.skip_strikes}")
                if strikes > lcfg.skip_strikes:
                    strikes = 0
                    rollback(f"anomaly persisted {lcfg.skip_strikes + 1} attempts "
                             f"at step {step}: {reason}")
                continue
            strikes = 0
            det.observe(loss, gnorm)
            losses.append(loss)
            slow = dog.observe(step, dt)
            if step % lcfg.log_every == 0 or slow:
                tag = " [STRAGGLER]" if slow else ""
                log_fn(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms){tag}")
            step += 1
            if pre.preempted:
                log_fn(f"[loop] preemption requested; stopped at step {step}")
                break
    finally:
        pre.restore()

    if fail_reason is not None:
        log_fn(f"[loop] FAILED at step {step}: {fail_reason}")
    return {
        "final_step": step,
        "first_loss": losses[0] if losses else float("nan"),
        "final_loss": float(np.mean(losses[-5:])) if losses else float("nan"),
        "preempted": bool(pre.preempted),
        "failed": fail_reason is not None,
        "fail_reason": fail_reason,
        "skipped_steps": skipped,
        "rollbacks": rollbacks,
        "anomalies": anomalies,
        "losses": list(losses),
        **dog.stats(),
        "state": state,
    }
