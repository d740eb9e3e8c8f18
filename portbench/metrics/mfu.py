"""The whole step's share of the chip's peak over the window: model FLOPs
of every token prefilled or decoded in it (2 x the weights the token
multiplies by, plus its attention in every layer, ``core.roofline``) over
the window's length times 989 TFLOP/s (%).  A prompt is counted at its
first token: every position through the layers, the unembedding once."""

from portbench.core import roofline


def read(ctx):
    model, flops = ctx.model, 0.0
    for r in ctx.records:
        p = len(r.prompt)
        for j, t in enumerate(r.times):
            if not ctx.t0 < t <= ctx.t1:
                continue
            if j == 0:
                attn, _ = roofline.attention_call([p], model, q_rows=p)
                flops += 2.0 * (ctx.matmul_params - ctx.head_params) * p \
                    + 2.0 * ctx.head_params + model["n_layers"] * attn
            else:
                flops += roofline.step_flops([p + j], model, ctx.matmul_params)
    return 100.0 * flops / (ctx.window_s * roofline.PEAK_FLOPS)
