"""Fault-tolerance hooks of the serving engine: preemption handling and the
straggler watchdog (torch port of the serving half of ``repro.fault``).

* Preemption: SIGTERM/SIGINT sets a flag; the engine reacts at its next
  tick (it stops admitting and drains in-flight requests).
* Stragglers: a per-tick wall-clock watchdog that flags ticks slower than
  ``factor`` × the rolling median and records tick-time p50/p95.

The training half (``LossAnomalyDetector``) comes with the training slice.
"""

from __future__ import annotations

import signal

__all__ = ["PreemptionHandler", "StragglerWatchdog"]


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        for s in signals:
            try:
                signal.signal(s, self._handle)
            except (ValueError, OSError):  # non-main thread / restricted env
                pass

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


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
