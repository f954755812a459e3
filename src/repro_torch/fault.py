"""Fault-tolerance hooks of the serving engine and the training loop (torch
port of ``repro.fault``).

* Preemption: SIGTERM/SIGINT sets a flag; the engine reacts at its next
  tick (it stops admitting and drains in-flight requests), the training
  loop at its next step (it stops).
* Stragglers: a per-step wall-clock watchdog that flags steps slower than
  ``factor`` × the rolling median and records step-time p50/p95.
* Loss anomalies: :class:`LossAnomalyDetector` turns the applied-step
  loss/grad-norm history into the guard thresholds of the training loop's
  skip-step -> rollback -> fail ladder (``train/loop.py``).
"""

from __future__ import annotations

import math
import signal

__all__ = ["PreemptionHandler", "StragglerWatchdog", "LossAnomalyDetector"]


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except (ValueError, OSError):  # non-main thread / restricted env
                pass

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def restore(self) -> None:
        """Put back the handlers this one replaced."""
        for s, h in self._prev.items():
            signal.signal(s, h)


class StragglerWatchdog:
    """Tracks step durations; flags steps slower than `factor` x rolling median."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.durations: list[float] = []
        self.straggler_steps: list[int] = []

    def observe(self, step: int, duration_s: float) -> bool:
        self.durations.append(duration_s)
        hist = self.durations[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        slow = len(hist) >= 5 and duration_s > self.factor * med
        if slow:
            self.straggler_steps.append(step)
        return slow

    def stats(self) -> dict:
        if not self.durations:
            return {}
        h = sorted(self.durations)
        return {
            "step_p50_s": h[len(h) // 2],
            "step_p95_s": h[int(len(h) * 0.95)],
            "stragglers": len(self.straggler_steps),
        }


class LossAnomalyDetector:
    """Guard thresholds for the training loop's anomaly ladder.

    Tracks the loss/grad-norm history of *applied* steps (rejected steps
    never enter the baseline) and gives ``thresholds()``: non-finite values
    are always anomalous; finite values are anomalous past ``factor`` × the
    rolling median over the last ``window`` applied steps. During warmup
    (fewer than ``warmup`` observations) the thresholds are +inf, since
    early-training loss swings are expected. The comparison itself is the
    train step's guard; this class derives the bounds and names the
    reason of a rejection.
    """

    def __init__(self, factor: float = 10.0, window: int = 64, warmup: int = 8):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.losses: list[float] = []
        self.gnorms: list[float] = []

    @staticmethod
    def _median(hist: list[float]) -> float:
        h = sorted(hist)
        return h[len(h) // 2]

    def thresholds(self) -> tuple[float, float]:
        """(max_loss, max_grad_norm) for the next step; +inf during warmup."""
        if len(self.losses) < self.warmup:
            return (math.inf, math.inf)
        return (self.factor * max(self._median(self.losses), 1e-8),
                self.factor * max(self._median(self.gnorms), 1e-8))

    def observe(self, loss: float, gnorm: float) -> None:
        """Record an APPLIED step's metrics."""
        self.losses.append(float(loss))
        self.gnorms.append(float(gnorm))
        if len(self.losses) > self.window:
            del self.losses[:-self.window]
            del self.gnorms[:-self.window]

    def classify(self, loss: float, gnorm: float,
                 thresholds: tuple[float, float]) -> str:
        """Reason string for a step the guard rejected."""
        max_loss, max_gnorm = thresholds
        if not math.isfinite(loss):
            return "nonfinite_loss"
        if not math.isfinite(gnorm):
            return "nonfinite_grad_norm"
        if loss > max_loss:
            return f"loss_spike: {loss:.4g} > {max_loss:.4g}"
        if gnorm > max_gnorm:
            return f"grad_norm_spike: {gnorm:.4g} > {max_gnorm:.4g}"
        return "rejected"
