"""Device time of every kernel that is neither a matrix product nor one of
the port's attention kernels (norms, RoPE, casts, indexing, argmax) per
traced step (ms)."""

from portbench.core import trace


def read(ctx):
    if ctx.traced is None:
        return None
    return 1e3 * ctx.traced.kernel_s(lambda n: trace.kind_of(n) == "small_ops") / ctx.traced.steps
