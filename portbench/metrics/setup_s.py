"""Seconds from the process's start to the window: imports, weights,
kernel build, prefill and the warm-up steps (graph captures)."""


def read(ctx):
    return ctx.setup_s
