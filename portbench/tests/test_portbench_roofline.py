"""The attention roofline is counted from shapes, once per operation: a
call split into K2 partials and a K3 combine, or done by one kernel, reads
the same work and, at the same device time, the same share."""

import pytest

from portbench.core import roofline, trace
from portbench.metrics import gqa_decode_roofline, mfu, mla_decode_paged_roofline

MLA = dict(n_layers=60, n_heads=128, dtype="bfloat16",
           mla=dict(d_latent=512, d_rope=64, d_nope=128, d_vhead=128))
GQA = dict(n_layers=48, n_heads=48, n_kv_heads=8, head_dim=128, dtype="bfloat16")


class Ctx:
    def __init__(self, model, kernels, kv):
        self.model = model
        self.traced = trace.Traced(steps=len(kv), window_s=1.0, busy_s=1.0, kernels=kernels, idle=[])
        self.traced_kv = kv


def test_mla_call_by_hand():
    flops, nbytes = roofline.attention_call([4096, 5000], MLA)
    assert flops == 2 * (576 + 512) * 128 * (4096 + 5000)
    assert nbytes == 2 * 128 * (576 * 2 + 512 * 4) + (4096 + 5000) * 576 * 2
    assert roofline.bound_s(flops, nbytes) == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))


def test_gqa_call_by_hand():
    flops, nbytes = roofline.attention_call([3000], GQA)
    assert flops == 4 * 128 * 48 * 3000
    assert nbytes == 48 * 128 * (2 + 4) + 3000 * 2 * 8 * 128 * 2


@pytest.mark.parametrize("metric, model, names", [
    (mla_decode_paged_roofline, MLA, ("mla_decode_queue_mma_kernel", "combine_kernel")),
    (gqa_decode_roofline, GQA, ("gqa_decode_mma_kernel", "combine_kernel")),
])
def test_split_and_unsplit_read_the_same(metric, model, names):
    kv = [[4200, 4800] * 16] * 3
    layers = model["n_layers"]
    split = [(names[0], 1.6e-4), (names[1], 0.4e-4)] * (3 * layers)
    whole = [(names[0], 2.0e-4)] * (3 * layers)
    other = whole + [("ampere_bf16_gemm", 5e-3), ("elementwise_kernel", 1e-4)]
    a, b, c = (metric.read(Ctx(model, k, kv)) for k in (split, whole, other))
    assert a == pytest.approx(b) and b == pytest.approx(c)
    bound = roofline.bound_s(*roofline.attention_call(kv[0], model))
    assert a == pytest.approx(100.0 * bound / 2.0e-4)


def test_a_reader_with_nothing_to_read_returns_none():
    assert mla_decode_paged_roofline.read(Ctx(MLA, [("gemm", 1.0)], [[10]])) is None
    assert gqa_decode_roofline.read(Ctx(MLA, [("gqa_decode", 1.0)], [[10]])) is None
    c = Ctx(MLA, [], [])
    c.traced = None
    assert mla_decode_paged_roofline.read(c) is None


def test_mfu_counts_decode_and_prompt_tokens():
    from portbench.core import stats

    class W:
        model = MLA | dict(d_model=5120)
        matmul_params, head_params = 1000, 100
        t0, t1, window_s = 0.0, 1.0, 1.0

    decode = stats.Record(prompt=[1] * 10, tokens=[5, 6], times=[-0.5, 0.5])
    W.records = [decode]
    want = roofline.step_flops([11], MLA, 1000)
    assert mfu.read(W) == pytest.approx(100 * want / 989e12)
    prompt = stats.Record(prompt=[1] * 10, tokens=[5], times=[0.5])
    W.records = [prompt]
    attn, _ = roofline.attention_call([10], MLA, q_rows=10)
    want = 2 * 900 * 10 + 2 * 100 + 60 * attn
    assert mfu.read(W) == pytest.approx(100 * want / 989e12)
