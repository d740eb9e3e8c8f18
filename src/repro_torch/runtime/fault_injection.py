"""Deterministic chaos injection for the serving stack (counterpart of
``repro/runtime/fault_injection.py``; pure data, the same plans from the
same seeds).

A :class:`FaultPlan` is a seeded, inspectable schedule of failures —
shard loss at step s, a slow (straggling) shard, a pool-pressure spike,
a client abandoning its request — that the supervised serve loop
(:class:`repro_torch.runtime.serve_loop.ServeSupervisor`) applies between
decode steps.  Determinism is the point: the same seed replays the same
failure scenario on every run, so the recovery invariants (greedy outputs
bit-identical after suspend/replay, zero leaked pool pages) gate every CI
build instead of only surfacing under real faults.

The plan never touches a session directly — it is pure data.  The
supervisor maps each event onto the session's fault-tolerance surface
(``fail_shard``, ``hold_pages``, the straggler monitor, abandon), which
keeps injected faults and real ones on exactly the same recovery path.
On a single session a ``shard_loss`` event is skipped and counted in the
supervisor's ``faults_skipped``, as the reference does; a sharded session
fails the shard and re-routes its requests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan"]

FAULT_KINDS = ("shard_loss", "slow_shard", "pool_pressure", "abandon")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault; fires at supervisor step ``step``.

    Fields beyond ``(step, kind)`` are kind-specific:

    * ``shard_loss``: data shard ``shard`` dies — every live request there
      is suspended and re-routed to survivors (the supervisor never kills
      the last healthy shard, so on a single session it is skipped).
    * ``slow_shard``: for ``duration`` steps the decode step time fed to
      the :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor` is
      inflated by ``factor`` × its EWMA baseline — one straggling shard
      gates the whole synchronous step, which is exactly what the monitor
      exists to flag.  Deterministic by construction (no real sleeps).
    * ``pool_pressure``: ``pages`` free pages of shard ``shard``'s pool are
      seized as ballast for ``duration`` steps, forcing admission backoff
      and recoverable eviction under memory pressure.
    * ``abandon``: the oldest live request is abandoned (client gone); its
      partial output is kept and counted as abandoned, not lost.
    """

    step: int
    kind: str
    shard: int = 0
    duration: int = 4
    pages: int = 0
    factor: float = 5.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick one of {FAULT_KINDS}"
            )
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.shard < 0:
            raise ValueError(f"fault shard must be >= 0, got {self.shard}")

    def describe(self) -> str:
        extra = {
            "shard_loss": f"shard={self.shard}",
            "slow_shard": (
                f"shard={self.shard} x{self.factor:g} for {self.duration}"
            ),
            "pool_pressure": (
                f"shard={self.shard} {self.pages} pages for {self.duration}"
            ),
            "abandon": "oldest live request",
        }[self.kind]
        return f"step {self.step}: {self.kind} ({extra})"


class FaultPlan:
    """An ordered, replayable schedule of :class:`FaultEvent`\\ s."""

    def __init__(self, events):
        events = list(events)
        for ev in events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"FaultPlan takes FaultEvents, got {ev!r}")
        self.events = sorted(
            events, key=lambda e: (e.step, FAULT_KINDS.index(e.kind))
        )

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def events_at(self, step: int) -> list[FaultEvent]:
        """Events that fire exactly at supervisor step ``step``."""
        return [e for e in self.events if e.step == step]

    def describe(self) -> str:
        if not self.events:
            return "no faults"
        return "; ".join(e.describe() for e in self.events)

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        num_shards: int = 1,
        horizon: int = 32,
        pool_pages: int | None = None,
        kinds=("shard_loss", "slow_shard", "pool_pressure"),
    ) -> "FaultPlan":
        """Seeded random plan: one event per requested kind, placed inside
        ``horizon`` supervisor steps.

        ``shard_loss`` needs ``num_shards >= 2`` (there must be survivors
        to re-route onto) and lands in the first half of the horizon so the
        recovery actually runs mid-stream.  ``pool_pressure`` needs
        ``pool_pages`` (it seizes about half a shard's pool).  ``abandon``
        is deliberately NOT in the default kinds: generated plans back the
        CI gate "every request completes with unchanged greedy output", and
        an abandon event truncates output by design — opt in explicitly for
        scenarios that test it.
        """
        if horizon < 2:
            raise ValueError(f"horizon must be >= 2 steps, got {horizon}")
        rng = np.random.default_rng(seed)
        events = []
        half = max(2, horizon // 2)
        if "shard_loss" in kinds and num_shards >= 2:
            events.append(
                FaultEvent(
                    step=int(rng.integers(1, half + 1)),
                    kind="shard_loss",
                    shard=int(rng.integers(num_shards)),
                )
            )
        if "slow_shard" in kinds:
            events.append(
                FaultEvent(
                    step=int(rng.integers(1, horizon)),
                    kind="slow_shard",
                    shard=int(rng.integers(num_shards)),
                    duration=int(rng.integers(2, 5)),
                    factor=float(5 + rng.integers(0, 3)),
                )
            )
        if "pool_pressure" in kinds and pool_pages:
            events.append(
                FaultEvent(
                    step=int(rng.integers(1, horizon)),
                    kind="pool_pressure",
                    shard=int(rng.integers(num_shards)),
                    pages=max(1, pool_pages // 2),
                    duration=int(rng.integers(2, 6)),
                )
            )
        if "abandon" in kinds:
            events.append(
                FaultEvent(
                    step=int(rng.integers(1, horizon)), kind="abandon"
                )
            )
        return cls(events)
