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

from repro_torch.kernels import flash_prefill as port_prefill
from repro_torch.kernels import gqa_decode as port_gqa
from repro_torch.kernels import mla_decode as port_mla
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


def _randn(shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_gqa_decode_kernel_matches_plain_version(cuda_device, variant, dtype):
    """K6 at gemma2-2b's geometry (Dh 256, group 2, window 4096, softcap
    50): kv_len 0, ragged, and a context longer than the window; k and v
    read as transposed views of (B, S, Hkv, Dh) tensors."""
    lens = [0, 700, 5000]
    q = _randn((3, 4, 2, 256), 0, dtype)
    k = _randn((3, 5000, 4, 256), 1, dtype)
    v = _randn((3, 5000, 4, 256), 2, dtype)
    kv = torch.tensor(lens, dtype=torch.int32)
    pos = torch.clamp_min(kv - 1, 0)[:, None].repeat(1, 2)
    kw = dict(variant=variant, scale=1 / 16, softcap=50.0, window=4096)
    dev = cuda_device
    n = port_gqa.gqa_decode_rows.launches
    got = port_gqa.gqa_decode_rows(q.to(dev), k.to(dev).transpose(1, 2), v.to(dev).transpose(1, 2),
                                   kv.to(dev), pos.to(dev), **kw)
    torch.cuda.synchronize()
    assert port_gqa.gqa_decode_rows.launches == n + 1
    want = port_gqa.gqa_decode_rows(q, k.transpose(1, 2), v.transpose(1, 2), kv, pos, **kw)
    assert (got.cpu() - want).abs().max().item() <= TOL[dtype, variant]
    assert got[0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_flash_prefill_kernel_matches_plain_version(cuda_device, variant, dtype):
    """K7 at qwen2.5-3b's geometry (16/2 heads, Dh 128), causal, two
    512-key blocks, kv_len below the query count in one row."""
    q = _randn((2, 16, 600, 128), 3, dtype)
    k = _randn((2, 2, 600, 128), 4, dtype)
    v = _randn((2, 2, 600, 128), 5, dtype)
    kv = torch.tensor([600, 300], dtype=torch.int32)
    kw = dict(variant=variant, scale=1 / math.sqrt(128), causal=True)
    dev = cuda_device
    n = port_prefill.flash_prefill.launches
    got = port_prefill.flash_prefill(q.to(dev), k.to(dev), v.to(dev), kv.to(dev), **kw)
    torch.cuda.synchronize()
    assert port_prefill.flash_prefill.launches == n + 1
    want = port_prefill.flash_prefill(q, k, v, kv, **kw)
    assert (got.cpu() - want).abs().max().item() <= TOL[dtype, variant]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mla_decode_rows_kernel_matches_plain_version(cuda_device, variant, dtype):
    """K4 at 128 heads, 576/512: a decode step (kv_len 0 and ragged) and a
    batch-1 view of a larger cache."""
    q = _randn((3, 128, 576), 6, dtype)
    c = _randn((4, 1200, 576), 7, dtype)
    kv = torch.tensor([0, 513, 1200], dtype=torch.int32)
    pos = torch.clamp_min(kv - 1, 0)[:, None].repeat(1, 128)
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192))
    dev = cuda_device
    n = port_mla.mla_decode_rows.launches
    got = port_mla.mla_decode_rows(q.to(dev), c.to(dev)[1:], kv.to(dev), pos.to(dev), **kw)
    torch.cuda.synchronize()
    assert port_mla.mla_decode_rows.launches == n + 1
    want = port_mla.mla_decode_rows(q, c[1:], kv, pos, **kw)
    assert (got.cpu() - want).abs().max().item() <= TOL[dtype, variant]
    assert got[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_dense_session_on_card_matches_cpu(cuda_device):
    """The smoke gemma2-2b (fp32) through ServingSession on the card and on
    the CPU: the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import ServingSession

    cfg = get_config("gemma2-2b", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    p_gpu = _to(p_cpu, cuda_device)
    outs = []
    for params in (p_cpu, p_gpu):
        sess = ServingSession(model, params, batch_size=2, max_len=64)
        sess.add_request(list(range(3, 8)))
        sess.add_request(list(range(3, 43)))
        for _ in range(6):
            sess.step()
        outs.append(sess.outputs)
    assert outs[0] == outs[1]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
