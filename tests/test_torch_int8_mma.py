"""Which row body the paged queue kernel runs, and the geometry its
tensor-core body takes, checked on the CPU (no card, no nvcc): bf16 queries
over a bf16 or an int8 pool take the tensor-core body, whose 16-byte copies
and 32-bit row indices bound ``d_k``, ``d_v`` and the pool's rows."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode_paged as port_paged


@pytest.mark.parametrize("q_dtype,pool_dtype,mma", [
    (torch.bfloat16, torch.int8, True),
    (torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.int8, False),
    (torch.float32, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, False),
    (torch.float32, torch.float32, False),
])
def test_body_selection(q_dtype, pool_dtype, mma):
    q = torch.zeros((1, 2, 16), dtype=q_dtype)
    pool = torch.zeros((2, 4, 16), dtype=pool_dtype)
    assert port_paged._takes_mma_body(q, pool) is mma


@pytest.mark.parametrize("pool_dtype,d_k,d_v", [
    (torch.int8, 584, 512),  # d_k a whole 8 but not 16 elements
    (torch.int8, 576, 504),  # d_v likewise
    (torch.int8, 88, 64),
    (torch.bfloat16, 84, 64),  # d_k off an 8-element bf16 piece
    (torch.bfloat16, 576, 508),
])
def test_geometry_rejects_widths_off_a_16_byte_row(pool_dtype, d_k, d_v):
    unit = 16 // torch.empty((), dtype=pool_dtype).element_size()
    with pytest.raises(ValueError, match=f"multiples of {unit}"):
        port_paged._check_mma_geometry(pool_dtype, 32, 128, d_k, d_v)


@pytest.mark.parametrize("pool_dtype,d_k,d_v", [
    (torch.int8, 576, 512),
    (torch.int8, 80, 64),
    (torch.bfloat16, 584, 504),
    (torch.bfloat16, 576, 512),
])
def test_geometry_takes_whole_16_byte_rows(pool_dtype, d_k, d_v):
    port_paged._check_mma_geometry(pool_dtype, 32, 128, d_k, d_v)


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("page_size", [1, 128])
def test_geometry_bounds_the_pool_in_its_own_16_byte_units(pool_dtype, page_size):
    """Rows are addressed by 32-bit offsets in 16-byte pieces: a 576-wide
    row is 36 pieces in int8 and 72 in bf16, so the int8 pool's last page
    count that fits is past the bf16 pool's."""
    pieces = 576 * pool_dtype.itemsize // 16
    last = (2**31 - 1) // (pieces * page_size)  # pages that still fit
    port_paged._check_mma_geometry(pool_dtype, last, page_size, 576, 512)
    with pytest.raises(ValueError, match="32-bit"):
        port_paged._check_mma_geometry(pool_dtype, last + 1, page_size, 576, 512)
    if pool_dtype == torch.int8:
        with pytest.raises(ValueError, match="32-bit"):
            port_paged._check_mma_geometry(torch.bfloat16, last, page_size, 576, 512)


def test_int8_launch_path_checks_the_geometry_before_building(monkeypatch):
    """The launch path (driven here with CPU tensors) rejects an int8 row
    off a 16-byte piece before it builds or loads the kernels."""
    def no_build():
        raise AssertionError("the kernels were built before the geometry check")

    monkeypatch.setattr(_build, "load", no_build)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(0, 1, (1, 8, 88)).astype(np.float32)).to(torch.bfloat16)
    pool = torch.ones((4, 16, 88), dtype=torch.int8)
    items = [torch.tensor(a, dtype=torch.int32) for a in ([0], [0], [0], [1], [1], [1])]
    with pytest.raises(ValueError, match="multiples of 16"):
        port_paged._queue_rows_cuda(
            q, pool, torch.zeros((1, 2), dtype=torch.int32), torch.tensor([20], dtype=torch.int32),
            torch.full((1, 8), 19, dtype=torch.int32), items, torch.ones((4, 16)),
            d_v=64, variant="amla", scale=1 / math.sqrt(192), block_k=32, num_dest_slots=1,
            softcap=None)
