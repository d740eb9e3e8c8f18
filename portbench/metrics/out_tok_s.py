"""Output tokens per second: every token the host read inside the window,
over the window's length."""

from portbench.core import stats


def read(ctx):
    return stats.tokens_in(ctx.records, ctx.t0, ctx.t1) / ctx.window_s
