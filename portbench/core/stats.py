"""Statistics over all the requests and all the time of a window: a rate
over every token and every second, a percentile over every gap."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Record:
    """One request as the benchmark saw it (host clock, seconds)."""

    prompt: list[int]
    rid: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    times: list[float] = dataclasses.field(default_factory=list)  # host read each token


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` %
    of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    return vals[max(math.ceil(q / 100.0 * len(vals)) - 1, 0)]


def tokens_in(records, t0: float, t1: float) -> int:
    return sum(1 for r in records for t in r.times if t0 < t <= t1)


def gaps_in(records, t0: float, t1: float) -> list[float]:
    """Every gap between two consecutive tokens of one request, both read
    inside ``(t0, t1]``."""
    return [b - a for r in records for a, b in zip(r.times, r.times[1:]) if t0 < a and b <= t1]

