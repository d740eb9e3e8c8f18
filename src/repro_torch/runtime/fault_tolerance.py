"""Straggler detection and supervised training (counterpart of
``repro/runtime/fault_tolerance.py``: ``StragglerMonitor`` and
``TrainingSupervisor``).

The monitor keeps an EWMA of healthy step times and flags a step slower
than ``threshold`` times it.  :class:`~repro_torch.runtime.serve_loop
.ServeSupervisor` feeds it the host time around each session step; on the
card that step ends in a copy of the greedy picks to the host, so the
time includes the device's work.

:class:`TrainingSupervisor` runs training steps with checkpoint/restart:
it checkpoints every ``ckpt_every`` steps, and on a failed step restores
the newest committed checkpoint and reseeks the (deterministic) data
stream to the restored step, retrying with exponential backoff up to
``max_retries`` consecutive failures.

On a group of several ranks every rank runs its own supervisor with its
own manager over one directory: the manager saves and restores each
rank's shards (:mod:`repro_torch.checkpoint.checkpoint`), and its
``restore_latest`` waits for the save in flight, so every rank restores
the same committed step.  A failure is taken as job-wide: every rank
raises at the same step, before that step's collectives, as a preemption
does.  A failure on one rank alone would leave its peers waiting in a
collective it never reaches; recovering from that is not supported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["StragglerMonitor", "TrainingSupervisor"]


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


class TrainingSupervisor:
    def __init__(self, *, ckpt_manager, data, ckpt_every: int = 50, max_retries: int = 5,
                 backoff: float = 0.01, failure_hook=None):
        self.ckpt = ckpt_manager
        self.data = data
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.backoff = backoff
        self.failure_hook = failure_hook  # called with the step before it runs (tests)
        self.straggler = StragglerMonitor()
        self.restarts = 0

    def run(self, step_fn, state, *, start_step: int, num_steps: int):
        """Run ``num_steps`` steps with checkpoint/restart, resuming from
        the newest committed checkpoint when there is one.  ``state`` is
        the whole training state tree, ``step_fn(state, batch, step) ->
        (state, metrics)``.  Returns (state, last_step, history)."""
        restored_step, restored = self.ckpt.restore_latest(state)
        if restored_step is not None:
            state, start_step = restored, restored_step
        step = start_step
        history = []
        retries = 0
        while step < start_step + num_steps:
            batch = self.data.batch_at(step)  # deterministic reseek
            t0 = time.perf_counter()
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                state, metrics = step_fn(state, batch, step)
            except Exception:
                retries += 1
                self.restarts += 1
                if retries > self.max_retries:
                    raise
                time.sleep(self.backoff * (2 ** (retries - 1)))
                rs, restored = self.ckpt.restore_latest(state)
                if rs is not None:
                    state, step = restored, rs
                    # the rolled-back steps run again: drop their records
                    history = [h for h in history if h[0] < step]
                continue
            retries = 0
            self.straggler.observe(step, time.perf_counter() - t0)
            history.append((step, metrics))
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, step, history
