"""The port's blockwise flash references (``repro_torch.core.flash`` /
``core.amla``) and the attention entry points' training gradient
(``core.attention``) against the JAX package, on the CPU.

The cases of ``test_amla_core.py`` (accuracy against an fp64 golden,
compensation, int add vs fp multiply, block size, ragged and masked keys,
softcap, extremes) run on the port, and each port output is held against
the reference's function on the same inputs.  Both run the same per-row
recurrence over the same blocks and differ in fp32 summation order only:
with fp32 products they agree within 1e-5 of the output's largest
magnitude; with the default bf16 products ``P`` is rounded to bf16 before
``P V``, and a last-place difference in a score moves a few of those
roundings by one bf16 step, so they agree within 2e-3 (measured at most
7e-4, MLA widths at sigma 1; most cases below 1e-5).  The cases of
``test_attention_api.py``'s ``impl="xla"`` path run through
``blockwise_attention``.

The gradient: ``multi_head_attention`` and ``mla_attention`` forward
through the kernels' plain versions here (equal to ``ops`` bit for bit)
and backward through autograd of the blockwise path, equal bit for bit to
autograd through ``blockwise_attention`` itself, and within one bf16 step
of JAX's gradient of ``impl="xla"`` (a step of an element x is at most
2^-7 |x|, so 2^-7 of the tensor's largest magnitude), with fewer than
1 % of the elements differing at all: the gradients of bf16-rounded
operands (q, k, v, P) are rounded to bf16 on both sides, and an fp32
difference in the last place upstream moves a few of those roundings by
one step (measured: 0.06 % of dq's elements, the worst one step of an
element at 0.36 of the tensor's largest, 2.4e-3 of it).

The AMLA caveat the port reproduces: the int32 add carries no derivative,
so under ``variant="amla"`` the value rows of every KV block but the last
get exactly zero gradient, in JAX and in the port alike; under ``base``
they do not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amla as ref_amla
from repro.core import attention as ref_attention
from repro.core import flash as ref_flash
from repro_torch.core import amla, attention, flash
from repro_torch.kernels import ops

TOL = 1e-5  # outputs, port vs reference, fp32 products (measured <= 2.3e-7)
TOL_BF16 = 2e-3  # outputs with bf16 products: a few P roundings apart (measured <= 7e-4)
GRAD_TOL = 2.0**-7  # gradients: at most one bf16 step of the tensor's largest magnitude


def golden_attention(q, k, v, scale, causal=False, window=None, softcap=None):
    q, k, v = [np.asarray(x, np.float64) for x in (q, k, v)]
    s = q @ k.T * scale
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    g, sk = s.shape
    if causal or window is not None:
        qp = np.arange(g)[:, None] + (sk - g)
        kp = np.arange(sk)[None, :]
        mask = np.ones_like(s, bool)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    denom = p.sum(-1, keepdims=True)
    denom[denom == 0] = 1.0
    return (p / denom) @ v


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-10)


def max_err(a, b):
    """max |a - b| over max(max |b|, tiny)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def make_inputs(g, s, dk, dv, sigma=1.0, seed=0, dist="normal"):
    """bf16-representable fp32 numpy inputs, as in the paper's experiments."""
    rng = np.random.default_rng(seed)
    draw = (lambda sh: rng.normal(0, sigma, sh)) if dist == "normal" else (
        lambda sh: rng.uniform(-sigma, sigma, sh))
    cast = lambda x: torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
    return cast(draw((g, dk))), cast(draw((s, dk))), cast(draw((s, dv)))


PORT = {"base": flash.flash_attention_base, "amla": amla.flash_attention_amla}
REF = {"base": ref_flash.flash_attention_base, "amla": ref_amla.flash_attention_amla}


def both(variant, q, k, v, **kw):
    """(port, reference) outputs as numpy; position/length arguments are
    numpy arrays, given to each side as its own tensor type."""
    t = {k_: (torch.from_numpy(np.asarray(v_)) if isinstance(v_, np.ndarray) else v_)
         for k_, v_ in kw.items()}
    j = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    if "matmul_dtype" in kw:
        t["matmul_dtype"], j["matmul_dtype"] = torch.float32, jnp.float32
    got = PORT[variant](*(torch.from_numpy(x) for x in (q, k, v)), **t)
    want = REF[variant](*(jnp.asarray(x) for x in (q, k, v)), **j)
    if isinstance(got, tuple):
        return [x.numpy() for x in got], [np.asarray(x) for x in want]
    return got.numpy(), np.asarray(want)


MLA_DIMS = dict(g=32, s=2048, dk=576, dv=512)


@pytest.mark.parametrize("sigma", [1.0, 4.0, 10.0])
@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_amla_matches_base_accuracy(sigma, dist):
    """Paper Tables 3-4 on the port: AMLA's error against the golden is
    Base's; each equals the reference's output within TOL."""
    q, k, v = make_inputs(**MLA_DIMS, sigma=sigma, dist=dist)
    scale = 1.0 / np.sqrt(MLA_DIMS["dk"])
    g = golden_attention(q, k, v, scale)
    base, base_ref = both("base", q, k, v, scale=scale)
    out, out_ref = both("amla", q, k, v, scale=scale)
    assert rel_err(out, g) < max(2.0 * rel_err(base, g), 2e-4)
    assert max_err(base, base_ref) < TOL_BF16 and max_err(out, out_ref) < TOL_BF16


def test_error_compensation_helps():
    q, k, v = make_inputs(**MLA_DIMS, sigma=1.0)
    scale = 1.0 / np.sqrt(MLA_DIMS["dk"])
    g = golden_attention(q, k, v, scale)
    comp, _ = both("amla", q, k, v, scale=scale)
    nc, nc_ref = both("amla", q, k, v, scale=scale, error_compensation=False)
    assert rel_err(comp, g) < rel_err(nc, g)
    assert max_err(nc, nc_ref) < TOL_BF16


def test_int_add_equals_fp_mul_path():
    """Lemma 3.1 at algorithm level: the int32-add path agrees with the
    exact-fp32-multiply ablation to bf16 level, as in the reference."""
    q, k, v = make_inputs(**MLA_DIMS, sigma=2.0, seed=3)
    scale = 1.0 / np.sqrt(MLA_DIMS["dk"])
    a, _ = both("amla", q, k, v, scale=scale, int_add=True)
    b, b_ref = both("amla", q, k, v, scale=scale, int_add=False)
    np.testing.assert_allclose(a, b, rtol=6e-3, atol=5e-3)
    assert rel_err(a, b) < 1e-3
    assert max_err(b, b_ref) < TOL_BF16


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("block", [64, 128, 512])
def test_block_size_invariance(variant, block):
    q, k, v = make_inputs(g=16, s=1024, dk=128, dv=128, sigma=1.0, seed=7)
    scale = 1.0 / np.sqrt(128)
    out, out_ref = both(variant, q, k, v, scale=scale, block_size=block)
    whole, _ = both(variant, q, k, v, scale=scale, block_size=1024)
    np.testing.assert_allclose(out, whole, rtol=2e-2, atol=2e-3)
    assert max_err(out, out_ref) < TOL_BF16


@pytest.mark.parametrize("variant", ["base", "amla"])
def test_ragged_kv_padding(variant):
    """A key count off the block size, and an explicit kv_len mask."""
    q, k, v = make_inputs(g=8, s=700, dk=64, dv=64, seed=11)
    out, out_ref = both(variant, q, k, v, scale=0.125, block_size=256,
                        kv_len=np.int32(600))
    assert rel_err(out, golden_attention(q, k[:600], v[:600], 0.125)) < 5e-3
    assert max_err(out, out_ref) < TOL_BF16


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("window", [None, 64])
def test_causal_and_window_masks(variant, window):
    g_rows, s = 128, 512
    q, k, v = make_inputs(g=g_rows, s=s, dk=64, dv=64, seed=5)
    q_pos = np.arange(g_rows, dtype=np.int32) + (s - g_rows)
    out, out_ref = both(variant, q, k, v, scale=0.125, block_size=128, q_pos=q_pos,
                        causal=True, window=window)
    assert rel_err(out, golden_attention(q, k, v, 0.125, causal=True, window=window)) < 5e-3
    assert max_err(out, out_ref) < TOL_BF16


@pytest.mark.parametrize("variant", ["base", "amla"])
def test_softcap(variant):
    q, k, v = make_inputs(g=16, s=512, dk=64, dv=64, sigma=4.0, seed=9)
    out, out_ref = both(variant, q, k, v, scale=0.125, softcap=50.0)
    assert rel_err(out, golden_attention(q, k, v, 0.125, softcap=50.0)) < 5e-3
    assert max_err(out, out_ref) < TOL_BF16


FP32_CASES = {
    "plain": dict(),
    "causal-window": dict(q_pos=np.arange(8, dtype=np.int32) + 400, causal=True, window=200),
    "ragged-softcap": dict(kv_len=np.int32(300), softcap=20.0),
}


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_fp32_products_and_residuals_match_reference(variant, case):
    """With fp32 products nothing is rounded to bf16: the port's output
    and its ``return_residuals`` (acc, m, l) equal the reference's within
    TOL."""
    q, k, v = make_inputs(g=8, s=512, dk=64, dv=64, seed=20)
    kw = dict(scale=0.125, block_size=128, matmul_dtype="fp32", **FP32_CASES[case])
    out, out_ref = both(variant, q, k, v, **kw)
    assert max_err(out, out_ref) < TOL
    got, want = both(variant, q, k, v, return_residuals=True, **kw)
    for a, b in zip(got, want):
        assert max_err(a, b) < TOL


def test_fully_masked_rows_are_zero():
    q, k, v = make_inputs(g=4, s=256, dk=32, dv=32, seed=13)
    out, _ = both("amla", q, k, v, scale=1.0, kv_len=np.int32(0))
    np.testing.assert_array_equal(out, 0.0)


def test_extreme_distributions_no_nan():
    for sigma in [0.01, 100.0]:
        q, k, v = make_inputs(g=8, s=512, dk=576, dv=512, sigma=sigma, seed=17)
        out, out_ref = both("amla", q, k, v, scale=1.0 / np.sqrt(576))
        assert np.isfinite(out).all()
        assert rel_err(out, golden_attention(q, k, v, 1.0 / np.sqrt(576))) < 5e-2
        assert max_err(out, out_ref) < TOL_BF16


@pytest.mark.parametrize("variant", ["base", "amla"])
def test_leading_batch_dims_equal_per_slice_calls(variant):
    """The port's leading dims take the place of the reference's vmap:
    each (b, h) slice, with its own positions and length, equals a call on
    that slice alone, bit for bit."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(2, 3, 24, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 3, 300, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 3, 300, 16)).astype(np.float32))
    q_pos = torch.from_numpy(rng.integers(0, 300, size=(2, 1, 24)).astype(np.int32))
    kv_len = torch.tensor([[300], [170]], dtype=torch.int32)
    kw = dict(scale=0.2, block_size=128, causal=True, window=100)
    out = PORT[variant](q, k, v, q_pos=q_pos, kv_len=kv_len, **kw)
    for b in range(2):
        for h in range(3):
            one = PORT[variant](q[b, h], k[b, h], v[b, h], q_pos=q_pos[b, 0],
                                kv_len=kv_len[b, 0], **kw)
            assert torch.equal(out[b, h], one)


def test_rescale_skip_rate_matches_reference():
    rng = np.random.default_rng(6)
    m = np.cumsum(np.abs(rng.normal(size=(12, 16))), axis=0).astype(np.float32)
    got = float(amla.rescale_skip_rate(torch.from_numpy(m)))
    assert got == pytest.approx(float(ref_amla.rescale_skip_rate(jnp.asarray(m))), abs=0)
    assert 0.0 <= got <= 1.0


# --------------------------------------------------------------------------- #
# blockwise_attention: the reference's impl="xla" path
# --------------------------------------------------------------------------- #
def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def xla_pair(q, k, v, **kw):
    """(port blockwise_attention, reference impl="xla") outputs."""
    t = {a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
    j = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
    got = attention.blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)), **t)
    want = ref_attention.multi_head_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                              impl="xla", **j)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (8, 1)])
def test_gqa_decode_vs_reference_xla(variant, hq, hkv):
    q, k, v = rand((2, 1, hq, 64), 1), rand((2, 384, hkv, 64), 2), rand((2, 384, hkv, 64), 3)
    got, want = xla_pair(q, k, v, variant=variant)
    assert max_err(got, want) < TOL_BF16
    naive = attention._naive_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), scale=1 / 8, causal=False, window=None,
        softcap=None, kv_len=None, q_offset=np.full((2,), 383))
    assert rel_err(got, naive.numpy()) < 5e-3


@pytest.mark.parametrize("variant", ["base", "amla"])
def test_prefill_causal_vs_reference_xla(variant):
    q, k, v = rand((2, 256, 4, 32), 4), rand((2, 256, 2, 32), 5), rand((2, 256, 2, 32), 6)
    got, want = xla_pair(q, k, v, variant=variant, causal=True, block_size=64)
    assert max_err(got, want) < TOL_BF16


def test_ragged_decode_and_mtp_vs_reference_xla():
    q, k, v = rand((3, 1, 4, 32), 7), rand((3, 256, 4, 32), 8), rand((3, 256, 4, 32), 9)
    got, want = xla_pair(q, k, v, kv_len=np.asarray([64, 256, 130], np.int32))
    assert max_err(got, want) < TOL_BF16
    q2 = rand((1, 2, 2, 32), 10)
    got, want = xla_pair(q2, k[:1, :128, :2], v[:1, :128, :2], causal=True,
                         kv_len=np.asarray([128], np.int32))
    assert max_err(got, want) < TOL_BF16


@pytest.mark.parametrize("variant", ["base", "amla"])
def test_window_softcap_offset_vs_reference_xla(variant):
    q, k, v = rand((2, 40, 4, 16), 11), rand((2, 300, 2, 16), 12), rand((2, 300, 2, 16), 13)
    got, want = xla_pair(q, k, v, variant=variant, causal=True, window=48, softcap=20.0,
                         kv_len=np.asarray([300, 211], np.int32),
                         q_offset=np.asarray([260, 100], np.int32), block_size=128)
    assert max_err(got, want) < TOL_BF16


# --------------------------------------------------------------------------- #
# the training gradient
# --------------------------------------------------------------------------- #
def assert_grad_close(g, want, frac=0.01):
    """Within GRAD_TOL of the largest magnitude, and fewer than ``frac``
    of the elements differing at all."""
    g, want = np.asarray(g), np.asarray(want)
    assert max_err(g, want) < GRAD_TOL
    assert np.mean(g != want) < frac


def grads_of(fn, tensors, ct):
    ts = [torch.from_numpy(x).requires_grad_() for x in tensors]
    out = fn(*ts)
    out.backward(torch.from_numpy(ct))
    return out.detach(), [t.grad.numpy() for t in ts]


CASES = {
    "prefill": dict(shape=(2, 96, 4, 2, 32, 96), kw=dict(causal=True)),
    "window-softcap": dict(shape=(2, 80, 4, 1, 16, 80), kw=dict(causal=True, window=24,
                                                               softcap=30.0)),
    "two-blocks": dict(shape=(1, 640, 2, 2, 32, 640), kw=dict(causal=True)),
    "non-causal": dict(shape=(2, 24, 4, 4, 16, 100), kw=dict(causal=False)),
}


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_gradient(variant, case):
    """Forward = the kernel's (bit for bit); backward = autograd through
    ``blockwise_attention`` (bit for bit) = JAX's gradient of impl="xla"
    within GRAD_TOL; forward within 2e-3 of the blockwise forward."""
    b, sq, hq, hkv, d, sk = CASES[case]["shape"]
    kw = dict(variant=variant, scale=0.3, **CASES[case]["kw"])
    if sq != sk:
        kw["kv_len"] = np.asarray([sk] * b, np.int32)
    tensors = [rand((b, sq, hq, d), 30), rand((b, sk, hkv, d), 31), rand((b, sk, hkv, d), 32)]
    ct = rand((b, sq, hq, d), 33)
    targs = {a: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for a, x in kw.items()}
    out, got = grads_of(lambda q, k, v: attention.multi_head_attention(q, k, v, **targs),
                        tensors, ct)
    block_out, block = grads_of(lambda q, k, v: attention.blockwise_attention(q, k, v, **targs),
                                tensors, ct)
    kernel = ops.gqa_attention(*(torch.from_numpy(x) for x in tensors),
                               q_offset=np.zeros(b, np.int32) if sq == sk else None,
                               **{a: x for a, x in targs.items() if a != "kv_len"},
                               kv_len=targs.get("kv_len"))
    assert torch.equal(out, kernel)
    assert max_err(out.numpy(), block_out.numpy()) < 2e-3
    for g, g_block in zip(got, block):
        np.testing.assert_array_equal(g, g_block)
    jkw = {a: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for a, x in kw.items()}
    f = lambda q, k, v: jnp.sum(ref_attention.multi_head_attention(q, k, v, impl="xla", **jkw)
                                * ct)
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in tensors))
    for g, w in zip(got, want):
        assert_grad_close(g, w)


def test_no_record_without_gradient():
    """No input needs a gradient: the kernel's output, nothing recorded;
    one does: the Function's node, and ``torch.no_grad`` records nothing."""
    q, k, v = (torch.from_numpy(rand(s, i)) for i, s in
               enumerate([(1, 16, 2, 16), (1, 16, 2, 16), (1, 16, 2, 16)]))
    out = attention.multi_head_attention(q, k, v, causal=True)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, ops.gqa_attention(q, k, v, causal=True, scale=0.25,
                                              q_offset=np.zeros(1, np.int32)))
    qg = q.clone().requires_grad_()
    assert type(attention.multi_head_attention(qg, k, v, causal=True).grad_fn).__name__ == (
        "_KernelForwardBackward")
    with torch.no_grad():
        assert attention.multi_head_attention(qg, k, v, causal=True).grad_fn is None


def test_amla_cuts_value_gradient_before_the_last_block():
    """Reference caveat, both packages: under ``amla`` the int32 exponent
    add carries no derivative, so the accumulator's path to every KV block
    but the last is cut — the value rows of those blocks get exactly zero
    gradient; under ``base`` they get their share.  G 8, S 1024, D 64,
    blocks of 256."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in [(8, 64), (1024, 64), (1024, 64)])
    ct = rng.normal(size=(8, 64)).astype(np.float32)
    for variant in ("base", "amla"):
        f = lambda q, k, v: jnp.sum(REF[variant](q, k, v, scale=0.125, block_size=256) * ct)
        ref_dv = np.asarray(jax.grad(f, argnums=2)(q, k, v))
        _, (_, _, dv) = grads_of(
            lambda q, k, v: PORT[variant](q, k, v, scale=0.125, block_size=256), [q, k, v], ct)
        for g in (ref_dv, dv):
            early, last = np.abs(g[:768]).sum(), np.abs(g[768:]).sum()
            assert last > 0
            assert (early == 0.0) if variant == "amla" else (early > 0.1 * last)
        assert_grad_close(dv, ref_dv)


def test_mla_attention_gradient():
    """The absorbed MLA form (``mla_absorbed_train``): forward the
    contiguous MLA kernel's (K4), backward autograd of the blockwise path
    over the latent rows as K and V, against JAX's impl="xla"."""
    b, s, h, dk, dv = 2, 40, 4, 48, 32
    q, c = rand((b, s, h, dk), 40) * 0.3, rand((b, s, dk), 41) * 0.3
    ct = rand((b, s, h, dv), 42)
    kw = dict(d_v=dv, causal=True, scale=0.2, kv_len=np.full((b,), s, np.int32),
              q_offset=np.zeros((b,), np.int32))
    targs = {a: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for a, x in kw.items()}
    out, got = grads_of(lambda q, c: attention.mla_attention(q, c, **targs), [q, c], ct)
    assert torch.equal(out, ops.mla_decode(torch.from_numpy(q), torch.from_numpy(c), **targs))
    jkw = {a: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for a, x in kw.items()}
    f = lambda q, c: jnp.sum(ref_attention.mla_attention(q, c, impl="xla", **jkw) * ct)
    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(c))
    for g, w in zip(got, want):
        assert max_err(g, w) < GRAD_TOL


def test_unequal_widths_pad_for_the_kernel():
    """MLA's expanded form attends with Dk = 48, Dv = 32: the kernel call
    takes zero columns up to 64 (exact: zero score terms, zero output
    columns sliced off), equal to the plain version at the true widths;
    the gradient has the true widths."""
    q, k, v = rand((2, 24, 4, 48), 50), rand((2, 24, 4, 48), 51), rand((2, 24, 4, 32), 52)
    assert attention._kernel_width(48, 32) == 64 and attention._kernel_width(16, 16) == 16
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.multi_head_attention(*ts, causal=True, scale=0.2)
    unpadded = ops.gqa_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                                 scale=0.2, q_offset=np.zeros(2, np.int32))
    np.testing.assert_allclose(out.detach().numpy(), unpadded.numpy(), rtol=0, atol=1e-6)
    out.sum().backward()
    assert [t.grad.shape for t in ts] == [t.shape for t in ts]
