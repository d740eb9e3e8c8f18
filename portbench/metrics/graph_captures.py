"""CUDA graphs the session captured inside the window (its counter)."""


def read(ctx):
    before, after = ctx.counters
    return float(after["graph_captures"] - before["graph_captures"])
