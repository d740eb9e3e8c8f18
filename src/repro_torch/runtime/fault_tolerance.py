"""Straggler detection for the supervised serve loop (counterpart of
``repro/runtime/fault_tolerance.py``'s ``StragglerMonitor``).

The monitor keeps an EWMA of healthy step times and flags a step slower
than ``threshold`` times it.  :class:`~repro_torch.runtime.serve_loop
.ServeSupervisor` feeds it the host time around each session step; on the
card that step ends in a copy of the greedy picks to the host, so the
time includes the device's work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["StragglerMonitor"]


@dataclass
class StragglerMonitor:
    alpha: float = 0.1
    threshold: float = 3.0  # flag steps slower than threshold * EWMA
    ewma: float | None = None
    events: list = field(default_factory=list)

    def observe(self, step: int, duration: float) -> bool:
        """Record one step's duration; True when it is flagged."""
        if self.ewma is None:
            self.ewma = duration
            return False
        if duration > self.threshold * self.ewma:
            self.events.append((step, duration, self.ewma))
            # A flagged duration stays out of the EWMA: the baseline models
            # healthy steps, so a sustained burst keeps being flagged.
            return True
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return False
