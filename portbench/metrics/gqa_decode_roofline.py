"""The GQA decode attention (``ops.gqa_attention`` at one row: K6 and the
K3 combine of its splits) against its roofline: the bound of every call
of the traced steps, counted from the shapes (``core.roofline``), over
the device time of those kernels (%)."""

from portbench.core import roofline

KERNELS = ("gqa_decode", "gqa_rows", "combine_kernel")


def read(ctx):
    if ctx.traced is None or ctx.model.get("mla"):
        return None
    device_s = ctx.traced.kernel_s(lambda n: any(k in n for k in KERNELS))
    if device_s <= 0:
        return None
    bound = sum(roofline.bound_s(*roofline.attention_call(kv, ctx.model)) for kv in ctx.traced_kv)
    return 100.0 * ctx.model["n_layers"] * bound / device_s
