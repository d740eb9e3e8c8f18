"""Share of the traced stretch in which no kernel, copy or set ran on the
device (%)."""


def read(ctx):
    if ctx.traced is None:
        return None
    return 100.0 * (1.0 - ctx.traced.busy_s / ctx.traced.window_s)
