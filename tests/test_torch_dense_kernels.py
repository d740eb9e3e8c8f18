"""The port's dense-path kernels (K4 contiguous MLA decode, K6 GQA decode,
K7 flash prefill) against the JAX reference, on the CPU.

On the CPU each kernel runs its plain PyTorch version.  Two levels:

* **Row kernels at fp32** (``gqa_decode_rows``, ``flash_prefill``,
  ``mla_decode_rows``) against the reference's same functions with its
  Pallas kernels in interpret mode, on the cases of
  ``tests/test_kernels.py`` (window, softcap, Sq = 2, ragged kv_len) plus
  kv_len 0: ``base`` to 1e-5 (only fp32 summation order and exp ulps
  differ), ``amla`` to 2e-3, the reference's own AMLA bound (its int32
  rescale approximates the multiply by 1 + eps, and an exp ulp can flip
  S16).
* **The public wrappers** ``ops.gqa_attention`` / ``ops.mla_decode``,
  which round q, k, v and p to bf16 as the reference's do, against the
  reference's wrappers at 2e-3 for both variants: there an fp32 ulp of a
  score (the two dot products sum in different orders) can flip the bf16
  rounding of one probability, which moves an output by up to ~2e-4
  (measured) in ``base`` too.

Everything is also held against the fp32 oracles ``kernels/ref.py`` and
the port's ``core.attention._naive_attention`` at rel_err < 8e-3, as the
reference's kernel tests are.  The CUDA kernels themselves are held
against these plain versions on a card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import flash_prefill as ref_prefill
from repro.kernels import gqa_decode as ref_gqa
from repro.kernels import mla_decode as ref_mla
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.core.attention import _naive_attention
from repro_torch.kernels import flash_prefill as port_prefill
from repro_torch.kernels import gqa_decode as port_gqa
from repro_torch.kernels import mla_decode as port_mla
from repro_torch.kernels import ops

TOL = {"base": 1e-5, "amla": 2e-3}  # row kernels, fp32
OPS_TOL = 2e-3  # public wrappers, bf16 rounding of q, k, v and p


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's contiguous MLA kernel run in interpret mode on
    this jax, which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.
    The alias is undone after each test, and so are the jit traces made
    under it (a cached trace would change a later reference test's
    outcome)."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-10)


def bf16ish(shape, seed, scale=1.0):
    """Seeded normal values that are exact in bf16, as fp32 numpy."""
    x = np.random.default_rng(seed).normal(0, scale, shape)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def t(x):
    return torch.from_numpy(np.array(x))


def jx(x):
    return jnp.asarray(x)


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# --------------------------------------------------------------------------- #
# K6: GQA decode rows
# --------------------------------------------------------------------------- #
GQA_DECODE = [
    # (hq, hkv, dh, sq, s, kv_len, window, softcap)
    pytest.param(8, 8, 64, 1, 768, [768, 300], None, None, id="mha-ragged"),
    pytest.param(8, 2, 128, 1, 768, [768, 300], None, None, id="gqa4-ragged"),
    pytest.param(4, 1, 256, 1, 768, [768, 0], None, None, id="mqa-dh256-kv0"),
    pytest.param(16, 8, 64, 1, 768, [5, 700], None, None, id="gqa2-short"),
    pytest.param(4, 2, 64, 1, 512, [512], 64, None, id="window64"),
    pytest.param(4, 2, 64, 1, 1200, [1200, 900], 256, 50.0, id="window256-softcap"),
    pytest.param(4, 4, 32, 2, 256, [256], None, None, id="mtp-sq2"),
    pytest.param(4, 4, 64, 1, 384, [384], None, 30.0, id="softcap30"),
]


def gqa_rows_inputs(hq, hkv, dh, sq, s, kv_len):
    """Seeded (B, Sq, Hq, Dh) q and (B, S, Hkv, Dh) k, v, the kernels' row
    layout of q (B, Hkv, Sq * group, Dh) and its positions."""
    b = len(kv_len)
    q = bf16ish((b, sq, hq, dh), 7)
    k = bf16ish((b, s, hkv, dh), 8)
    v = bf16ish((b, s, hkv, dh), 9)
    lens = np.asarray(kv_len, np.int32)
    group = hq // hkv
    q_pos = np.maximum(lens - sq, 0)[:, None] + np.arange(sq)[None, :]
    rows_pos = np.repeat(q_pos, group, axis=1).astype(np.int32)
    qr = q.reshape(b, sq, hkv, group, dh).transpose(0, 2, 1, 3, 4).reshape(b, hkv, sq * group, dh)
    return q, k, v, lens, qr, rows_pos


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("hq,hkv,dh,sq,s,kv_len,window,softcap", GQA_DECODE)
def test_gqa_decode_rows_match_reference(variant, hq, hkv, dh, sq, s, kv_len, window, softcap):
    q, k, v, lens, qr, rows_pos = gqa_rows_inputs(hq, hkv, dh, sq, s, kv_len)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    scale = 1.0 / dh**0.5
    kw = dict(variant=variant, scale=scale, softcap=softcap, window=window)
    # k and v as transposed views: the cache layout the kernels read in place
    got = port_gqa.gqa_decode_rows(
        t(qr), t(k).transpose(1, 2), t(v).transpose(1, 2), t(lens), t(rows_pos), **kw
    ).numpy()
    want = ref_gqa.gqa_decode_rows(jx(qr), jx(kt), jx(vt), jx(lens), jx(rows_pos),
                                   interpret=True, **kw)
    assert got.shape == want.shape
    assert max_err(got, want) <= TOL[variant]
    assert not got[lens == 0].any()  # rows with no visible key are exact zeros
    oracle = ref_oracle.gqa_decode_ref(jx(qr), jx(kt), jx(vt), jx(lens), jx(rows_pos),
                                       scale=scale, softcap=softcap, window=window)
    assert rel_err(got, oracle) < 8e-3
    naive = _naive_attention(
        t(q), t(k), t(v), scale=scale, causal=True, window=window, softcap=softcap,
        kv_len=t(lens), q_offset=t(np.maximum(lens - sq, 0)),
    ).numpy()
    b, group = len(kv_len), hq // hkv
    naive = naive.reshape(b, sq, hkv, group, dh).transpose(0, 2, 1, 3, 4).reshape(got.shape)
    assert rel_err(got, naive) < 8e-3


# --------------------------------------------------------------------------- #
# K7: flash prefill
# --------------------------------------------------------------------------- #
PREFILL = [
    # (sq, s, hq, hkv, dh, window, softcap, kv_len, causal)
    pytest.param(256, 256, 4, 2, 64, None, None, None, True, id="gqa2"),
    pytest.param(256, 256, 4, 4, 64, 128, None, None, True, id="window128"),
    pytest.param(192, 320, 2, 2, 64, None, None, None, True, id="ragged-q-ne-kv"),
    pytest.param(128, 128, 2, 2, 64, None, 20.0, [100], True, id="softcap-kvlen"),
    pytest.param(40, 600, 4, 2, 256, 16, 50.0, [40, 0], True, id="dh256-window-kv0"),
    pytest.param(16, 700, 4, 1, 128, None, None, [700, 513], False, id="two-blocks-noncausal"),
]


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("sq,s,hq,hkv,dh,window,softcap,kv_len,causal", PREFILL)
def test_flash_prefill_matches_reference(variant, sq, s, hq, hkv, dh, window, softcap,
                                         kv_len, causal):
    lens = np.asarray(kv_len if kv_len is not None else [s], np.int32)
    b = len(lens)
    q = bf16ish((b, hq, sq, dh), 19)
    k = bf16ish((b, hkv, s, dh), 20)
    v = bf16ish((b, hkv, s, dh), 21)
    scale = 1.0 / dh**0.5
    kw = dict(variant=variant, scale=scale, softcap=softcap, window=window, causal=causal)
    got = port_prefill.flash_prefill(t(q), t(k), t(v), t(lens), **kw).numpy()
    want = ref_prefill.flash_prefill(jx(q), jx(k), jx(v), jx(lens), interpret=True, **kw)
    assert got.shape == want.shape
    assert max_err(got, want) <= TOL[variant]
    assert not got[lens == 0].any()
    oracle = ref_oracle.prefill_ref(jx(q), jx(k), jx(v), jx(lens), scale=scale,
                                    causal=causal, window=window, softcap=softcap)
    assert rel_err(got, oracle) < 8e-3


# --------------------------------------------------------------------------- #
# K4: contiguous MLA decode rows
# --------------------------------------------------------------------------- #
MLA = [
    # (b, sq, hq, dk, dv, s, kv_len)
    pytest.param(2, 1, 16, 576, 512, 1024, [1024, 512], id="paper-geometry"),
    pytest.param(1, 2, 8, 576, 512, 640, [640], id="mtp-sq2-ragged-s"),
    pytest.param(3, 1, 4, 128, 128, 384, [384, 0, 130], id="small-latent-kv0"),
    pytest.param(1, 20, 4, 80, 64, 64, [40], id="prefill-rows"),
]


@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("b,sq,hq,dk,dv,s,kv_len", MLA)
def test_mla_decode_rows_match_reference(pallas_interpret, variant, b, sq, hq, dk, dv, s, kv_len):
    q = bf16ish((b, sq * hq, dk), 1, 0.3)
    c = bf16ish((b, s, dk), 2, 0.3)
    lens = np.asarray(kv_len, np.int32)
    q_pos = np.maximum(lens - sq, 0)[:, None] + np.arange(sq)[None, :]
    rows_pos = np.repeat(q_pos, hq, axis=1).astype(np.int32)
    kw = dict(d_v=dv, variant=variant, scale=1.0 / dk**0.5)
    got = port_mla.mla_decode_rows(t(q), t(c), t(lens), t(rows_pos), **kw).numpy()
    want = ref_mla.mla_decode_rows(jx(q), jx(c), jx(lens), jx(rows_pos), interpret=True, **kw)
    assert got.shape == want.shape
    assert max_err(got, want) <= TOL[variant]
    assert not got[lens == 0].any()
    oracle = np.asarray(ref_oracle.mla_decode_ref(jx(q), jx(c), jx(lens), jx(rows_pos),
                                                  d_v=dv, scale=kw["scale"]))
    live = lens > 0
    assert rel_err(got[live], oracle[live]) < 8e-3


# --------------------------------------------------------------------------- #
# The public wrappers (bf16 rounding, positions, dispatch)
# --------------------------------------------------------------------------- #
OPS_GQA = [
    # (hq, hkv, dh, sq, s, kv_len, window, softcap): Sq <= 8 is K6, else K7
    pytest.param(8, 2, 128, 1, 768, [768, 300], None, None, id="decode-gqa4"),
    pytest.param(4, 2, 64, 2, 1200, [1200, 0], 256, 50.0, id="decode-sq2-window-softcap"),
    pytest.param(4, 2, 64, 192, 320, [320], 128, None, id="prefill-window"),
]


@pytest.mark.parametrize("hq,hkv,dh,sq,s,kv_len,window,softcap", OPS_GQA)
def test_gqa_attention_matches_reference(hq, hkv, dh, sq, s, kv_len, window, softcap):
    q, k, v, lens, _, _ = gqa_rows_inputs(hq, hkv, dh, sq, s, kv_len)
    kw = dict(variant="amla", causal=True, window=window, softcap=softcap, scale=1.0 / dh**0.5)
    if sq > 8:
        lens = np.full_like(lens, s)  # the prefill's kv_len; queries start at 0
    got = ops.gqa_attention(t(q), t(k), t(v), kv_len=t(lens), **kw).numpy()
    want = ref_ops.gqa_attention(jx(q), jx(k), jx(v), kv_len=jx(lens), interpret=True, **kw)
    assert max_err(got, want) <= OPS_TOL
    assert not got[lens == 0].any()
    q_off = np.zeros_like(lens) if sq > 8 else np.maximum(lens - sq, 0)
    naive = _naive_attention(t(q), t(k), t(v), scale=kw["scale"], causal=True, window=window,
                             softcap=softcap, kv_len=t(lens), q_offset=t(q_off))
    assert rel_err(got, naive.numpy()) < 8e-3


def test_mla_decode_matches_reference(pallas_interpret):
    """Default, explicit-offset and non-causal row positions."""
    b, sq, hq, dk, dv, s = 2, 3, 4, 80, 64, 200
    q, c = bf16ish((b, sq, hq, dk), 3, 0.3), bf16ish((b, s, dk), 4, 0.3)
    lens = np.asarray([200, 90], np.int32)
    off = np.asarray([10, 50], np.int32)
    for extra in ({}, {"q_offset": off}, {"causal": False}):
        port_kw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()}
        ref_kw = {k: (jx(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()}
        got = ops.mla_decode(t(q), t(c), d_v=dv, scale=0.1, kv_len=t(lens), **port_kw)
        want = ref_ops.mla_decode(jx(q), jx(c), d_v=dv, scale=0.1, kv_len=jx(lens),
                                  interpret=True, **ref_kw)
        assert max_err(got.numpy(), want) <= OPS_TOL


def test_prefill_rejects_a_query_offset():
    """The flash prefill counts query positions from 0; a nonzero offset
    raises instead of returning the reference's misaligned answer."""
    q = torch.zeros((1, 16, 2, 64))
    k = torch.zeros((1, 32, 2, 64))
    with pytest.raises(ValueError, match="q_offset must be 0"):
        ops.gqa_attention(q, k, k, causal=True, scale=0.125, q_offset=torch.tensor([4]))
    out = ops.gqa_attention(q, k, k, causal=True, scale=0.125, q_offset=torch.tensor([0]))
    assert out.shape == (1, 16, 2, 64)


def test_fp32_cache_is_rounded_where_read():
    """An fp32 latent cache with bf16 queries computes what a bf16 copy of
    the cache computes (the kernels round each row as they read it)."""
    q = torch.from_numpy(bf16ish((1, 1, 4, 80), 5, 0.3))
    c = torch.from_numpy(np.random.default_rng(6).normal(0, 0.3, (1, 100, 80)).astype(np.float32))
    a = ops.mla_decode(q, c, d_v=64, scale=0.1)
    b = ops.mla_decode(q, c.to(torch.bfloat16), d_v=64, scale=0.1)
    assert torch.equal(a, b)
