"""Device time of the matrix products (cuBLAS / CUTLASS kernels) per
traced step (ms)."""

from portbench.core import trace


def read(ctx):
    if ctx.traced is None:
        return None
    return 1e3 * ctx.traced.kernel_s(lambda n: trace.kind_of(n) == "cublas") / ctx.traced.steps
