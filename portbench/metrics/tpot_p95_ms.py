"""95th percentile of every gap between two consecutive tokens of one
request, both read inside the window (ms)."""

from portbench.core import stats


def read(ctx):
    gaps = stats.gaps_in(ctx.records, ctx.t0, ctx.t1)
    return 1e3 * stats.percentile(gaps, 95) if gaps else None
