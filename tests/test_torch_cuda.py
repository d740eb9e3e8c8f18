"""The port's CUDA kernels on a card, against their plain PyTorch versions
on the same inputs.  Every test is marked ``cuda`` and skips without a
card (a CUDA kernel has no CPU mode); this file imports nothing of JAX, so
it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are chip_smoke.py's: fp32 ``base`` 1e-4 (summation order and
exp ulps), fp32 ``amla`` 2e-3 (the int32 rescale's 1.5*eps compensation is
approximate, and an exp ulp can flip S16), bf16 1e-2 (p*S16 is rounded to
bf16 before P.V).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import mla_decode_combine as port_combine
from repro_torch.kernels import mla_decode_paged as port_paged
from repro_torch.kernels import ops

TOL = {(torch.float32, "base"): 1e-4, (torch.float32, "amla"): 2e-3,
       (torch.bfloat16, "base"): 1e-2, (torch.bfloat16, "amla"): 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _paged_inputs(seed, kv_lens, *, b_rows, dk=576, page=128):
    """Random pool + shuffled block tables + queries, on the CPU."""
    rng = np.random.default_rng(seed)
    w = max(max(-(-l // page) for l in kv_lens), 1)
    num_pages = len(kv_lens) * w + 3
    bt = rng.permutation(num_pages)[: len(kv_lens) * w].reshape(len(kv_lens), w)
    pool = torch.from_numpy(rng.normal(0, 1, (num_pages, page, dk)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (len(kv_lens), 1, b_rows, dk)).astype(np.float32))
    return q, pool, torch.from_numpy(bt.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_paged_decode_kernels_match_plain_versions(cuda_device, variant, dtype, num_splits):
    kv_lens = [0, 1, 700, 2100]
    q, pool, bt = _paged_inputs(0, kv_lens, b_rows=128)
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192), block_k=512,
              num_splits=num_splits, compute_dtype=dtype)
    dev = cuda_device
    k2, k3 = (port_paged.mla_decode_paged_queue_rows.launches,
              port_combine.combine_split_partials.launches)
    got = ops.mla_decode_paged(q.to(dev), pool.to(dev, dtype), bt.to(dev),
                               torch.tensor(kv_lens, device=dev), **kw)
    torch.cuda.synchronize()
    assert port_paged.mla_decode_paged_queue_rows.launches == k2 + 1
    assert port_combine.combine_split_partials.launches == k3 + 1
    want = ops.mla_decode_paged(q, pool.to(dtype), bt, np.asarray(kv_lens), **kw)
    assert (got.cpu() - want).abs().max().item() <= TOL[dtype, variant]
    assert got[0].abs().max().item() == 0.0  # kv_len 0: exact zeros
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_prefill_chunk_rows_match_plain_version(cuda_device):
    """G = 32 tokens x 128 heads with per-row causal positions."""
    q, pool, bt = _paged_inputs(1, [1100], b_rows=128)
    q = q.expand(1, 32, 128, 576).contiguous() + torch.linspace(0, 1, 32)[None, :, None, None]
    kw = dict(d_v=512, scale=1 / math.sqrt(192), q_offset=torch.tensor([1068]),
              compute_dtype=torch.bfloat16)
    dev = cuda_device
    got = ops.mla_decode_paged(q.to(dev), pool.to(dev, torch.bfloat16), bt.to(dev),
                               torch.tensor([1100], device=dev),
                               **{**kw, "q_offset": kw["q_offset"].to(dev)})
    want = ops.mla_decode_paged(q, pool.to(torch.bfloat16), bt, np.asarray([1100]), **kw)
    assert (got.cpu() - want).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda_device):
    dev = cuda_device
    q = torch.zeros((1, 8, 80), device=dev)
    pool = torch.zeros((4, 16, 80), device=dev, dtype=torch.float16)
    items = [torch.zeros(16, dtype=torch.int32, device=dev)] * 6
    with pytest.raises(TypeError, match="kv_pages dtype"):
        port_paged.mla_decode_paged_queue_rows(
            q, pool, torch.zeros((1, 2), dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev),
            torch.zeros((1, 8), dtype=torch.int32, device=dev), *items,
            d_v=64, scale=0.1, block_k=32, num_dest_slots=2)
    with pytest.raises(ValueError, match="on cpu"):
        port_combine.combine_split_partials(
            torch.zeros((2, 8, 64), device=dev), torch.zeros((2, 8, 1)),
            torch.zeros((1, 1), dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev))
