"""Which row body the GQA decode (K6) and flash prefill (K7) kernels run,
what their tensor-core launches hand over, and K6's split walk, checked on
the CPU (no card, no nvcc).

The launch paths are driven with CPU tensors against a stand-in for the
kernel library that records each call (as in ``test_torch_mma_rows.py``):
bf16 q over bf16 K/V takes the tensor-core body, which reads K and V where
they lie through their strides, splits K6 over the KV blocks of each
``(b, kv head)`` and merges the partials with the combine (K3); fp32 keeps
the scalar body.  The split walk of the plain version is held against the
unsplit one and against the JAX reference's ``gqa_decode_rows`` (Pallas in
interpret mode): ``base`` to 1e-5 (the split only adds an fp32 LSE merge),
``amla`` to 2e-3 (the reference's own AMLA bound, as in
``test_torch_dense_kernels.py``).
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gqa_decode as ref_gqa
from repro_torch.kernels import _build
from repro_torch.kernels import flash_prefill as port_prefill
from repro_torch.kernels import gqa_decode as port_gqa
from repro_torch.kernels import mla_decode_combine as port_combine

BF, F32 = torch.bfloat16, torch.float32
TOL = {"base": 1e-5, "amla": 2e-3}
SMS = 132  # an H100's SM count, standing in for the card's


class _Lib:
    """Stands in for the kernel library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(port_gqa, "_sm_count", lambda device: SMS)
    return fake


@pytest.fixture
def combines(monkeypatch):
    """Records the combine calls K6 makes (its partials are the stand-in's
    uninitialized buffers, so nothing is merged)."""
    calls = []

    def combine(o_part, lse, dest_table, n_splits):
        calls.append((o_part, lse, dest_table, n_splits))
        return torch.zeros((dest_table.shape[0],) + tuple(o_part.shape[1:]))

    monkeypatch.setattr(port_combine, "combine_split_partials", combine)
    return calls


@pytest.fixture
def no_build(monkeypatch):
    def load():
        raise AssertionError("the kernels were built before the geometry check")

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(port_gqa, "_sm_count", lambda device: SMS)


def _rn(shape, seed, dtype=F32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)


def _k6(q, k, v, lens=None, **kw):
    b, _, g, dh = q.shape
    lens = torch.full((b,), k.shape[2], dtype=torch.int32, device=q.device) if lens is None else lens
    pos = torch.clamp_min(lens - 1, 0)[:, None].repeat(1, g).to(torch.int32)
    kw = dict(variant="amla", scale=1 / math.sqrt(dh), block_k=min(512, max(k.shape[2], 128)),
              softcap=None, window=None) | kw
    return port_gqa._decode_cuda(q, k, v, lens, pos, **kw)


def _k7(q, k, v, **kw):
    b, _, _, dh = q.shape
    lens = torch.full((b,), k.shape[2], dtype=torch.int32, device=q.device)
    kw = dict(variant="amla", scale=1 / math.sqrt(dh), block_k=min(512, max(k.shape[2], 128)),
              softcap=None, window=None, causal=True) | kw
    return port_prefill._prefill_cuda(q, k, v, lens, **kw)


# positions of the C entry points' arguments
K6_SPLITS, K6_STRIDES, K6_BF16 = 13, slice(14, 20), 24
K7_STRIDES, K7_BF16 = slice(12, 18), 23


@pytest.mark.parametrize("dtype", [BF, F32])
def test_decode_body_selection(lib, combines, dtype):
    """K6: bf16 runs (and counts) the tensor-core body, split over its KV
    blocks with one combine launch; fp32 keeps the scalar body, one split,
    no lse and no combine."""
    fn = port_gqa.gqa_decode_rows
    before = (fn.launches, fn.mma_launches)
    q, k, v = _rn((2, 2, 4, 64), 0, dtype), _rn((2, 2, 1300, 64), 1, dtype), _rn((2, 2, 1300, 64), 2, dtype)
    out = _k6(q, k, v)
    mma = dtype == BF
    assert (fn.launches, fn.mma_launches) == (before[0] + 1, before[1] + mma)
    (name, args), = lib.calls
    assert name == "amla_gqa_decode"
    assert args[K6_BF16] == int(mma)
    assert (args[K6_SPLITS] > 1, args[6] is not None, len(combines)) == (mma, mma, int(mma))
    assert out.shape == (2, 2, 4, 64)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_prefill_body_selection(lib, dtype):
    """K7: bf16 runs (and counts) the tensor-core body, fp32 the scalar."""
    fn = port_prefill.flash_prefill
    before = (fn.launches, fn.mma_launches)
    _k7(_rn((1, 4, 64, 128), 3, dtype), _rn((1, 2, 64, 128), 4, dtype), _rn((1, 2, 64, 128), 5, dtype))
    assert (fn.launches, fn.mma_launches) == (before[0] + 1, before[1] + (dtype == BF))
    (name, args), = lib.calls
    assert name == "amla_flash_prefill"
    assert args[K7_BF16] == int(dtype == BF)


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_strides_of_transposed_views_and_cache_slots(lib, combines, kernel):
    """K and V are handed over where they lie: k as a transposed view of a
    (B, S, Hkv, Dh) cache (sequence stride Hkv * Dh), v as a slot of a
    longer (B, Hkv, S', Dh) cache starting 3 rows in (its pointer moves by 3
    rows, its batch and head strides stay the cache's)."""
    b, hkv, s, dh = 2, 4, 300, 64
    cache = _rn((b, s, hkv, dh), 6, BF)
    longer = _rn((b, hkv, s + 8, dh), 7, BF)
    k, v = cache.transpose(1, 2), longer[:, :, 3:3 + s]
    if kernel == "K6":
        _k6(_rn((b, hkv, 2, dh), 8, BF), k, v)
        strides = K6_STRIDES
    else:
        _k7(_rn((b, 2 * hkv, 16, dh), 8, BF), k, v)
        strides = K7_STRIDES
    (_, args), = lib.calls
    assert args[1] == cache.data_ptr()
    assert args[2] == longer.data_ptr() + 3 * dh * 2
    assert args[strides] == (s * hkv * dh, dh, hkv * dh, hkv * (s + 8) * dh, (s + 8) * dh, dh)


@pytest.mark.parametrize("b,hkv,g,s,splits", [
    (4, 4, 2, 8192, 16),   # gemma2-2b decode: 16 CTAs, 16 blocks of 512
    (4, 2, 8, 2048, 4),    # qwen2.5-3b decode: 8 CTAs, 4 blocks
    (4, 16, 1, 2048, 4),   # qwen1.5-0.5b decode: 64 CTAs, 4 blocks
    (2, 2, 64, 2048, 4),   # an 8-token prefill at group 8: 4 tiles of 16 rows a head
    (1, 4, 16, 8, 1),      # gemma2-2b's 8-token bucket: a single 128-key block
    (33, 4, 2, 8192, 1),   # 132 CTAs fill the card: no split
])
def test_split_count_and_combine_arguments(lib, combines, b, hkv, g, s, splits):
    """The split count comes from host-known shapes (SM count, B x Hkv x
    16-row tiles, blocks of the cache); over more than one split, K6 writes
    partials in slot ``split * B * Hkv + b * Hkv + h`` and hands the combine
    a table that merges all splits of every (b, kv head)."""
    q = torch.zeros((b, hkv, g, 64), dtype=BF)
    kv = torch.zeros((b, hkv, s, 64), dtype=BF)
    out = _k6(q, kv, kv)
    (_, args), = lib.calls
    assert args[K6_SPLITS] == splits == port_gqa.split_count(q, kv, min(512, max(s, 128)))
    assert out.shape == (b, hkv, g, 64)
    if splits == 1:
        assert args[6] is None and not combines
        return
    (o_part, lse, dest, n_splits), = combines
    assert args[5] == o_part.data_ptr() and args[6] == lse.data_ptr()
    assert o_part.shape == (splits * b * hkv, g, 64) and lse.shape == (splits * b * hkv, g, 1)
    cols = b * hkv
    want = np.arange(splits)[None, :] * cols + np.arange(cols)[:, None]
    assert dest.dtype == torch.int32 and np.array_equal(dest.numpy(), want)
    assert n_splits.tolist() == [splits] * cols


def test_split_rule():
    """One split once the CTAs fill the SMs; else about two CTAs per SM,
    never more splits than blocks."""
    assert port_gqa.decode_splits(132, 132, 16) == 1
    assert port_gqa.decode_splits(132, 16, 16) == 16
    assert port_gqa.decode_splits(132, 16, 9) == 9
    assert port_gqa.decode_splits(132, 64, 100) == 5
    assert port_gqa.decode_splits(132, 1, 1) == 1


def _misaligned(shape, dtype=BF):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _faults():
    kv = _rn((1, 2, 128, 64), 10, BF)
    # a transposed view of a (1, 2**28, 2, 64) cache: rows 128 elements (16
    # pieces) apart, 2**32 pieces a head; meta tensors hold no memory
    meta = lambda shape: torch.empty(shape, dtype=BF, device="meta")
    huge = meta((1, 2**28, 2, 64)).transpose(1, 2)
    small = meta((1, 2, 128, 64))
    yield "K6 k past 2**31 pieces", lambda: _k6(meta((1, 2, 2, 64)), huge, small), "32-bit"
    yield "K6 q off a 16-byte boundary", lambda: _k6(_misaligned((1, 2, 2, 64)), kv, kv), \
        "q must start on a 16-byte boundary"
    yield "K7 v past 2**31 pieces", lambda: _k7(meta((1, 4, 16, 64)), small, huge), "32-bit"
    yield "K7 q off a 16-byte boundary", lambda: _k7(_misaligned((1, 4, 16, 64)), kv, kv), \
        "q must start on a 16-byte boundary"


FAULTS = ["K6 k past 2**31 pieces", "K6 q off a 16-byte boundary", "K7 v past 2**31 pieces",
          "K7 q off a 16-byte boundary"]


@pytest.mark.parametrize("what", FAULTS)
def test_geometry_the_body_cannot_address_raises_before_building(no_build, what):
    """Rows the tensor-core body cannot address raise ``ValueError`` before
    the kernels are built or loaded: no other body takes over."""
    faults = {w: (call, match) for w, call, match in _faults()}
    assert list(faults) == FAULTS
    call, match = faults[what]
    fn = port_gqa.gqa_decode_rows if what.startswith("K6") else port_prefill.flash_prefill
    before = (fn.launches, fn.mma_launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert (fn.launches, fn.mma_launches) == before


def _rows_case(seed, lens, *, hkv=2, group=4, sq=1, s=1200, dh=64):
    """fp32 values that are exact in bf16: q rows (B, Hkv, Sq * group, Dh)
    at the last Sq positions below kv_len, k and v (B, Hkv, S, Dh)."""
    b = len(lens)
    r = lambda shape, sd: _rn(shape, sd, BF).float()
    q, k, v = r((b, hkv, sq * group, dh), seed), r((b, hkv, s, dh), seed + 1), r((b, hkv, s, dh), seed + 2)
    lens = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.clamp_min(lens - sq, 0)[:, None] + torch.arange(sq)[None, :]
    return q, k, v, lens, q_pos.repeat_interleave(group, dim=1).to(torch.int32)


SPLIT_CASES = [
    # (lens, sq, window, softcap, block_k)
    pytest.param([0, 37, 1200], 1, None, None, 128, id="ragged-kv0"),
    pytest.param([1200, 700], 1, 300, 50.0, 128, id="window300-softcap"),
    pytest.param([9, 1100], 8, None, None, 256, id="8-token-prefill"),
]


@pytest.mark.parametrize("num_splits", [1, 2, 9])
@pytest.mark.parametrize("variant", ["base", "amla"])
@pytest.mark.parametrize("lens,sq,window,softcap,block_k", SPLIT_CASES)
def test_split_plain_version_matches_unsplit_and_reference(variant, num_splits, lens, sq,
                                                           window, softcap, block_k):
    """The plain version walked in 1, 2 or 9 splits (each a fresh state,
    merged by the combine's plain version) against the unsplit walk and the
    JAX reference's ``gqa_decode_rows`` (interpret mode); kv_len 0 rows are
    exact zeros in every split count."""
    q, k, v, kv, pos = _rows_case(12, lens, sq=sq)
    kw = dict(variant=variant, scale=1 / 8, block_k=block_k, softcap=softcap, window=window)
    got = port_gqa.attend_plain(q, k, v, kv, pos, num_splits=num_splits, **kw)
    unsplit = port_gqa.attend_plain(q, k, v, kv, pos, **kw)
    jx = lambda t: jnp.asarray(t.numpy())
    want = np.asarray(ref_gqa.gqa_decode_rows(jx(q), jx(k), jx(v), jx(kv), jx(pos),
                                              interpret=True, **kw))
    assert (got - unsplit).abs().max().item() <= TOL[variant]
    assert np.abs(got.numpy() - want).max() <= TOL[variant]
    assert not got[kv == 0].any()


def test_split_edges_cover_each_request_once():
    """Every live block of a request lies in exactly one split, from the
    block that holds the window start of its smallest position to the one
    that holds min(kv_len, largest position + 1); a request with kv_len 0
    has none."""
    kv = torch.tensor([0, 5, 1200, 1200])
    pos = torch.tensor([[0, 0], [4, 4], [1199, 1199], [600, 1199]])
    edges = port_gqa.split_edges(kv, pos, s=1200, block_k=128, window=300, causal=True,
                                 num_splits=4)
    first = [0, 0, (1199 - 299) // 128, (600 - 299) // 128]
    last = [0, 1, 10, 10]
    assert edges[:, 0].tolist() == first and edges[:, -1].tolist() == last
    assert (edges[:, 1:] >= edges[:, :-1]).all()
