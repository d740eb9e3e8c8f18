"""Which row body the contiguous (K4) and padded paged (K5) MLA kernels run,
and the geometry their tensor-core body takes, checked on the CPU (no card,
no nvcc).  The launch paths are driven with CPU tensors against a stand-in
for the kernel library that records each call: bf16 queries over bf16 rows
take the tensor-core body, whose 16-byte copies and 32-bit piece offsets
bound ``d_k``, ``d_v``, the rows one base pointer reaches and the alignment
of the rows; everything else keeps the scalar body.  K2 shares the same
selection and checks."""

import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as port_mla
from repro_torch.kernels import mla_decode_paged as port_paged

BF, F32 = torch.bfloat16, torch.float32
SCALE = 1 / math.sqrt(192)


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
    return fake


@pytest.fixture
def no_build(monkeypatch):
    def load():
        raise AssertionError("the kernels were built before the geometry check")

    monkeypatch.setattr(_build, "load", load)


def _rn(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)


def _k4(q, c, **kw):
    b, g, _ = q.shape
    kv = torch.full((b,), c.shape[1], dtype=torch.int32)
    pos = torch.full((b, g), c.shape[1] - 1, dtype=torch.int32)
    kw = dict(d_v=64, variant="amla", scale=SCALE, block_k=128, softcap=None) | kw
    return port_mla._rows_cuda(q, c, kv, pos, **kw)


def _k5(q, pool, **kw):
    b, g, _ = q.shape
    bt = torch.zeros((b, 3), dtype=torch.int32)
    kv = torch.full((b,), 20, dtype=torch.int32)
    pos = torch.full((b, g), 19, dtype=torch.int32)
    kw = dict(d_v=64, variant="amla", scale=SCALE, softcap=None) | kw
    return port_paged._padded_rows_cuda(q, pool, bt, kv, pos, **kw)


def test_every_mla_kernel_shares_one_selection_and_one_geometry_check():
    for name in ("_takes_mma_body", "_check_mma_geometry", "_check_mma_alignment"):
        assert getattr(port_paged, name) is getattr(port_mla, name)


@pytest.mark.parametrize("q_dtype,kv_dtype,mma", [
    (BF, BF, True), (BF, F32, False), (F32, BF, False), (F32, F32, False)])
def test_contiguous_kernel_body_selection(lib, q_dtype, kv_dtype, mma):
    """K4: bf16 q over a bf16 cache runs (and counts) the tensor-core body;
    the flags handed to the kernel name the dtypes as given."""
    fn = port_mla.mla_decode_rows
    before = (fn.launches, fn.mma_launches)
    _k4(_rn((2, 8, 80), 0, q_dtype), _rn((2, 40, 80), 1, kv_dtype))
    assert (fn.launches, fn.mma_launches) == (before[0] + 1, before[1] + mma)
    (name, args), = lib.calls
    assert name == "amla_mla_decode_rows"
    assert args[15:17] == (int(q_dtype == BF), int(kv_dtype == BF))


@pytest.mark.parametrize("q_dtype,kv_dtype,mma", [
    (BF, BF, True), (BF, F32, False), (F32, BF, False), (F32, F32, False)])
def test_padded_kernel_body_selection(lib, q_dtype, kv_dtype, mma):
    """K5: bf16 q over a bf16 pool runs (and counts) the tensor-core body."""
    fn = port_paged.mla_decode_paged_rows
    before = (fn.launches, fn.mma_launches)
    _k5(_rn((2, 8, 80), 2, q_dtype), _rn((4, 16, 80), 3, kv_dtype))
    assert (fn.launches, fn.mma_launches) == (before[0] + 1, before[1] + mma)
    (name, args), = lib.calls
    assert name == "amla_mla_decode_paged_padded"
    assert args[16:18] == (int(q_dtype == BF), int(kv_dtype == BF))


def _misaligned(shape, dtype, *, offset=1):
    """A contiguous tensor that starts ``offset`` elements past an aligned
    allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _k4_faults():
    q80, c80 = _rn((2, 8, 80), 4, BF), _rn((2, 40, 80), 5, BF)
    yield "width off a piece", lambda: _k4(_rn((2, 8, 84), 4, BF), _rn((2, 40, 84), 5, BF)), \
        "multiples of 8"
    yield "d_v off a piece", lambda: _k4(q80, c80, d_v=60), "multiples of 8"
    strided = torch.zeros(2 * (40 * 80 + 4), dtype=BF).as_strided(
        (2, 40, 80), (40 * 80 + 4, 80, 1))
    yield "batch stride off a piece", lambda: _k4(q80, strided), "batch stride"
    yield "cache off a 16-byte boundary", lambda: _k4(q80, _misaligned((2, 40, 80), BF)), \
        "c_kv must start on a 16-byte boundary"
    yield "q off a 16-byte boundary", lambda: _k4(_misaligned((2, 8, 80), BF), c80), \
        "q must start on a 16-byte boundary"
    # 2**28 rows of 64 bf16 = 2**31 pieces, as a broadcast view (no memory)
    huge = torch.zeros((1, 1, 64), dtype=BF).expand(1, 2**28, 64)
    yield "rows past 2**31 pieces", lambda: _k4(_rn((1, 8, 64), 6, BF), huge, d_v=64), "32-bit"


def _k5_faults():
    q80 = _rn((2, 8, 80), 7, BF)
    yield "width off a piece", lambda: _k5(_rn((2, 8, 84), 7, BF), _rn((4, 16, 84), 8, BF)), \
        "multiples of 8"
    yield "d_v off a piece", lambda: _k5(q80, _rn((4, 16, 80), 8, BF), d_v=60), "multiples of 8"
    yield "pool off a 16-byte boundary", lambda: _k5(q80, _misaligned((4, 16, 80), BF)), \
        "kv_pages must start on a 16-byte boundary"
    huge = torch.zeros((1, 1, 64), dtype=BF).expand(2**24, 16, 64)
    yield "pool past 2**31 pieces", lambda: _k5(_rn((2, 8, 64), 9, BF), huge), "32-bit"


FAULTS = {
    "K4": ["width off a piece", "d_v off a piece", "batch stride off a piece",
           "cache off a 16-byte boundary", "q off a 16-byte boundary", "rows past 2**31 pieces"],
    "K5": ["width off a piece", "d_v off a piece", "pool off a 16-byte boundary",
           "pool past 2**31 pieces"],
}


@pytest.mark.parametrize("kernel,what", [(k, w) for k, ws in FAULTS.items() for w in ws])
def test_launch_paths_check_the_geometry_before_building(no_build, kernel, what):
    """Geometry the tensor-core body cannot address raises ``ValueError``
    before the kernels are built or loaded: no other body takes over."""
    faults = {w: (call, match) for w, call, match in
              (_k4_faults() if kernel == "K4" else _k5_faults())}
    assert list(faults) == FAULTS[kernel]
    call, match = faults[what]
    fn = port_mla.mla_decode_rows if kernel == "K4" else port_paged.mla_decode_paged_rows
    before = (fn.launches, fn.mma_launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert (fn.launches, fn.mma_launches) == before


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_scalar_body_takes_what_the_tensor_core_body_refuses(lib, kernel):
    """An fp32 cache or pool keeps the scalar body, which takes rows off a
    16-byte piece, an odd batch stride and an unaligned start."""
    q = _rn((2, 8, 84), 10, BF)
    if kernel == "K4":
        c = torch.zeros(2 * (40 * 84 + 1) + 1, dtype=F32)[1:].as_strided(
            (2, 40, 84), (40 * 84 + 1, 84, 1))
        _k4(q, c, d_v=60)
    else:
        _k5(q, _misaligned((4, 16, 84), F32), d_v=60)
    assert len(lib.calls) == 1


def test_one_request_ignores_its_batch_stride(lib):
    """With B = 1 the batch stride is never used, so a single request's
    cache may carry any stride there (a slice of a larger cache)."""
    c = torch.zeros(40 * 80 + 8, dtype=BF).as_strided((1, 40, 80), (40 * 80 + 3, 80, 1))
    fn = port_mla.mla_decode_rows
    n = fn.mma_launches
    _k4(_rn((1, 8, 80), 11, BF), c)
    assert fn.mma_launches == n + 1


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_int8_rows_stay_on_the_paged_queue_kernel(kernel):
    """K4 and K5 take no int8 rows (the reference's padded grid and
    contiguous kernel have no dequant path)."""
    q, rows = _rn((1, 8, 64), 12, BF), torch.zeros((2, 16, 64), dtype=torch.int8)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        _k4(q, rows) if kernel == "K4" else _k5(q, rows)


def test_queue_kernel_checks_its_pool_through_the_shared_helper(no_build):
    """K2 over a bf16 pool past 2**31 pieces (a broadcast view) raises
    before it copies the pool or builds anything."""
    q = _rn((1, 8, 64), 13, BF)
    pool = torch.zeros((1, 1, 64), dtype=BF).expand(2**24, 16, 64)
    items = [torch.tensor(a, dtype=torch.int32) for a in ([0], [0], [0], [1], [1], [1])]
    with pytest.raises(ValueError, match="32-bit"):
        port_paged._queue_rows_cuda(
            q, pool, torch.zeros((1, 2), dtype=torch.int32), torch.tensor([20], dtype=torch.int32),
            torch.full((1, 8), 19, dtype=torch.int32), items, None, d_v=64, variant="amla",
            scale=SCALE, block_k=16, num_dest_slots=1, softcap=None)
