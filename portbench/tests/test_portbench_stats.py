"""Rates over every token and every second of the window, percentiles over
every gap: one stall in the window shows in both."""

import pytest

from portbench.core import stats
from portbench.metrics import out_tok_s, tpot_p95_ms


class Ctx:
    def __init__(self, records, t0, t1):
        self.records, self.t0, self.t1 = records, t0, t1

    @property
    def window_s(self):
        return self.t1 - self.t0


def closed_batch(step_s, stall_at=None, stall_s=0.0, steps=100, batch=4):
    recs, t = [], 0.0
    times = []
    for i in range(steps):
        t += step_s + (stall_s if i == stall_at else 0.0)
        times.append(t)
    for _ in range(batch):
        recs.append(stats.Record(prompt=[1], tokens=[0] * steps, times=list(times)))
    return Ctx(recs, 0.0, times[-1])


def test_rate_counts_every_token_and_the_stall():
    steady = closed_batch(0.02)
    stalled = closed_batch(0.02, stall_at=50, stall_s=1.0)
    assert out_tok_s.read(steady) == pytest.approx(400 / 2.0)
    # the stall's second is in the window: 400 tokens over 3 s, not a median of chunks
    assert out_tok_s.read(stalled) == pytest.approx(400 / 3.0)


def test_p95_is_over_every_gap():
    # 99 gaps a request, 6 of them stalls: more than 5 %, so the p95 is a stall
    c = closed_batch(0.02)
    for r in c.records:
        for k in (10, 20, 30, 40, 50, 60):
            r.times = [t + (0.5 if i >= k else 0.0) for i, t in enumerate(r.times)]
    c.t1 = c.records[0].times[-1]
    assert tpot_p95_ms.read(c) == pytest.approx(520.0)
    # one stall among 99 gaps is below the p95
    assert tpot_p95_ms.read(closed_batch(0.02, stall_at=50, stall_s=1.0)) == pytest.approx(20.0)


def test_gaps_inside_the_window_only():
    r = stats.Record(prompt=[1], tokens=[0] * 4, times=[0.5, 1.0, 2.0, 4.0])
    assert stats.gaps_in([r], 0.9, 3.0) == [1.0]
    assert stats.tokens_in([r], 0.9, 3.0) == 2


def test_percentile_nearest_rank():
    assert stats.percentile(range(1, 101), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)

