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


def _family_cache(dtype, *, seed=3, page=128, dk=576):
    """A CPU pool (bf16 or int8) holding a forked family over a 1100-row
    prefix (2 complete 512-row blocks shared) with suffixes of 7, 40 and
    300 rows, plus an unrelated 513-row request and an empty slot."""
    from repro_torch.runtime.kv_cache import PagedKVCache

    rng = np.random.default_rng(seed)
    kv = PagedKVCache(num_pages=40, page_size=page, width=dk, dtype=dtype, device="cpu")
    rows = lambda n: torch.from_numpy(rng.normal(0, 1, (n, dk)).astype(np.float32))
    kv.alloc(0)
    kv.append(0, rows(1100))
    for rid, n in ((1, 7), (2, 40), (3, 300)):
        kv.fork(0, rid)
        kv.append(rid, rows(n))
    kv.alloc(4)
    kv.append(4, rows(513))
    kv.alloc(5)
    return kv, [0, 1, 2, 3, 4, 5]


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_sharing", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_int8_and_group_prefix_kernels_match_plain_versions(cuda_device, variant, dtype,
                                                            prefix_sharing):
    """K2-int8 over an int8 pool, and with prefix sharing K2′ (one group
    of 4, G = 512 stacked rows) + the hetero combine, card vs CPU."""
    kv, rids = _family_cache(torch.int8)
    bt, kv_len = kv.block_table(rids, width=kv.num_pages)
    q = _randn((len(rids), 1, 128, 576), 4, torch.float32)
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192), num_splits=2,
              compute_dtype=dtype, prefix_sharing=prefix_sharing)
    dev = cuda_device
    n8, n_grp = (port_paged.mla_decode_paged_queue_rows.int8_launches,
                 port_paged.mla_decode_paged_group_prefix.launches)
    got = ops.mla_decode_paged(q.to(dev), kv.pages.to(dev), torch.from_numpy(bt).to(dev),
                               kv_len, kv_scales=kv.scales.to(dev), **kw)
    torch.cuda.synchronize()
    assert port_paged.mla_decode_paged_queue_rows.int8_launches == n8 + 1
    assert port_paged.mla_decode_paged_group_prefix.launches == n_grp + int(prefix_sharing)
    want = ops.mla_decode_paged(q, kv.pages, torch.from_numpy(bt), kv_len,
                                kv_scales=kv.scales, **kw)
    assert (got.cpu() - want).abs().max().item() <= TOL[dtype, variant]
    assert got[5].abs().max().item() == 0.0 and torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_sharing_on_card_matches_unshared(cuda_device, dtype):
    """On the card, the shared-prefix path (K2′ + K2 + hetero K3) against
    the unshared queue over the same bf16 pool."""
    kv, rids = _family_cache(torch.bfloat16)
    bt, kv_len = kv.block_table(rids, width=kv.num_pages)
    dev = cuda_device
    q = _randn((len(rids), 1, 128, 576), 5, torch.float32).to(dev)
    kw = dict(d_v=512, scale=1 / math.sqrt(192), compute_dtype=dtype, variant="base")
    args = (q, kv.pages.to(dev), torch.from_numpy(bt).to(dev), kv_len)
    shared = ops.mla_decode_paged(*args, prefix_sharing=True, **kw)
    unshared = ops.mla_decode_paged(*args, **kw)
    assert (shared - unshared).abs().max().item() <= (2e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_padded_kernel_matches_plain_version(cuda_device, variant, dtype):
    """K5: one AMLA update per page over a fragmented table of W = 12
    columns; kv_len 0 and ragged lengths."""
    kv_lens = [0, 37, 513, 1100]
    q, pool, bt = _paged_inputs(6, kv_lens, b_rows=128)
    bt = torch.nn.functional.pad(bt, (0, 12 - bt.shape[1]))
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192), compute_dtype=dtype,
              scheduler="padded")
    dev = cuda_device
    k5 = port_paged.mla_decode_paged_rows.launches
    got = ops.mla_decode_paged(q.to(dev), pool.to(dev, dtype), bt.to(dev),
                               torch.tensor(kv_lens, device=dev), **kw)
    torch.cuda.synchronize()
    assert port_paged.mla_decode_paged_rows.launches == k5 + 1
    want = ops.mla_decode_paged(q, pool.to(dtype), bt, np.asarray(kv_lens), **kw)
    assert (got.cpu() - want).abs().max().item() <= TOL[dtype, variant]
    assert got[0].abs().max().item() == 0.0 and torch.isfinite(got).all()
    with pytest.raises(ValueError, match="does not support int8"):
        ops.mla_decode_paged(q.to(dev), pool.to(dev, torch.int8), bt.to(dev), kv_lens,
                             kv_scales=torch.ones(pool.shape[:2], device=dev), **kw)


# ---- the tensor-core body of K2 / K2′ (bf16 q over a bf16 or int8 pool) --

RAGGED_KV = [0, 1, 15, 16, 127, 129, 511, 513, 1116]


def _queue_case(seed, kv_lens, g, num_splits, positions, *, dk=576, dv=512, page=128,
                block_k=512):
    """bf16 queries (B, G, dk) and a bf16 pool behind shuffled block
    tables, the work queue of ``num_splits`` and per-row positions, on the
    CPU."""
    from repro_torch.kernels import decode_schedule as sched

    q, pool, bt = _paged_inputs(seed, kv_lens, b_rows=g, dk=dk, page=page)
    kv = np.asarray(kv_lens, np.int32)
    s = sched.build_schedule(kv, block_k=block_k, num_splits=num_splits)
    items = [torch.from_numpy(np.asarray(a, np.int32)) for a in s.prefetch_arrays()]
    pos = torch.from_numpy(np.stack([positions(int(n), g) for n in kv]).astype(np.int32))
    return dict(q=q[:, 0].to(torch.bfloat16), pool=pool.to(torch.bfloat16), bt=bt,
                kv=torch.from_numpy(kv), pos=pos, items=items, sched=s, dv=dv, block_k=block_k)


def _decode_rows(kv_len, g):
    """One token at the end of the cache; every 5th row 300 earlier."""
    pos = np.full(g, max(kv_len - 1, 0))
    pos[::5] = np.maximum(pos[::5] - 300, 0)
    return pos


def _run_queue(c, dev, variant, softcap=None, pool=None):
    """K2 on ``dev`` (the kernel on a card, the plain version on the CPU);
    K2-int8 when the case has ``scales``."""
    pool = c["pool"] if pool is None else pool
    scales = c.get("scales")
    to = lambda t: t.to(dev)
    return port_paged.mla_decode_paged_queue_rows(
        to(c["q"]), to(pool), to(c["bt"]), to(c["kv"]), to(c["pos"]),
        *(to(t) for t in c["items"]), None if scales is None else to(scales), d_v=c["dv"],
        variant=variant, scale=1 / math.sqrt(192), block_k=c["block_k"],
        num_dest_slots=c["sched"].num_dest_slots, softcap=softcap)


def _assert_partials_match(c, got, want, tol):
    """o and lse of every slot the queue writes; rows without a visible key
    (lse -inf) in the same places, with o exactly 0."""
    s = c["sched"]
    live = sorted(set(s.item_dest[s.item_valid == 1].tolist()))
    o_k, lse_k = (t.cpu()[live] for t in got)
    o_p, lse_p = (t[live] for t in want)
    fin = torch.isfinite(lse_p)
    assert torch.equal(fin, torch.isfinite(lse_k))
    assert torch.isfinite(o_k).all()
    assert (o_k - o_p).abs().max().item() <= tol
    assert (lse_k[fin] - lse_p[fin]).abs().max().item() <= tol
    empty = ~fin[..., 0]
    if empty.any():
        assert o_k[empty].abs().max().item() == 0.0


def _on_pool(c, pool):
    """The case over its bf16 pool, or over that pool quantized by the
    cache's own write path (symmetric per-row int8 + fp32 scales)."""
    from repro_torch.runtime.kv_cache import _quantize_rows

    if pool == "int8":
        c["pool"], c["scales"] = _quantize_rows(c["pool"].float())
    return c


def _hold_mma_launch(cuda_device, c, variant, softcap=None):
    """One launch of the tensor-core body on the card against the plain
    version: counted in ``mma_launches`` and in ``launches`` (bf16 pool)
    or ``int8_launches`` (int8 pool)."""
    fn = port_paged.mla_decode_paged_queue_rows
    int8 = c.get("scales") is not None
    before = (fn.launches, fn.int8_launches, fn.mma_launches)
    got = _run_queue(c, cuda_device, variant, softcap=softcap)
    torch.cuda.synchronize()
    assert (fn.launches, fn.int8_launches, fn.mma_launches) == (
        before[0] + (not int8), before[1] + int8, before[2] + 1)
    _assert_partials_match(c, got, _run_queue(c, "cpu", variant, softcap=softcap),
                           TOL[torch.bfloat16, variant])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("g", [1, 17, 128, 512])
@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_body_matches_plain_version(cuda_device, variant, num_splits, g, pool):
    """Ragged kv_len (0, 1, either side of a 16-key chunk, a 128-key strip,
    a 512-row block, and 1116), G from one row to a ragged 17-row tile to
    512 rows (32-row tiles; rows with 1 or 15 visible keys), shuffled block
    tables, bf16 and int8 pages: every slot's partial within bf16
    tolerance, kv_len 0 exact zeros."""
    c = _on_pool(_queue_case(11, RAGGED_KV, g, num_splits, _decode_rows), pool)
    got = _hold_mma_launch(cuda_device, c, variant)
    out = port_combine.combine_split_partials(
        got[0], got[1], torch.from_numpy(c["sched"].dest_table).to(cuda_device),
        torch.from_numpy(c["sched"].n_splits).to(cuda_device))
    assert out[0].abs().max().item() == 0.0 and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_body_softcap_and_causal_prefill_rows(cuda_device, variant, pool):
    """A 4-token prefill chunk of 32 heads (G = 128, row r is token r // 32,
    each row its own causal limit) with softcap 30 and two splits."""
    chunk = lambda kv_len, g: np.maximum(kv_len - 4, 0) + np.arange(g) // 32
    c = _on_pool(_queue_case(12, [1116, 300, 3, 0], 128, 2, chunk), pool)
    _hold_mma_launch(cuda_device, c, variant, softcap=30.0)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_body_prefill_chunk_on_32_row_tiles(cuda_device, variant, pool):
    """A 32-token prefill chunk of 128 heads (G = 4096) for two requests:
    256 tiles of 32 rows fill the card, so the launcher takes 32-row
    tiles."""
    chunk = lambda kv_len, g: np.maximum(kv_len - 32, 0) + np.arange(g) // 128
    _hold_mma_launch(cuda_device, _on_pool(_queue_case(14, [1100, 4096], 4096, 1, chunk), pool),
                     variant)


def _two_families(seed=5, page=128, dk=576, dtype=torch.bfloat16):
    """A bf16 (or int8) CPU pool with two forked families: a 1100-row
    prefix with three members (children of 7 and 40 rows) and a 600-row
    prefix with two (a child of 300 rows), so the group of two is padded to
    gmax = 3."""
    from repro_torch.runtime.kv_cache import PagedKVCache

    rng = np.random.default_rng(seed)
    kv = PagedKVCache(num_pages=40, page_size=page, width=dk, dtype=dtype, device="cpu")
    rows = lambda n: torch.from_numpy(rng.normal(0, 1, (n, dk)).astype(np.float32))
    kv.alloc(0)
    kv.append(0, rows(1100))
    for rid, n in ((1, 7), (2, 40)):
        kv.fork(0, rid)
        kv.append(rid, rows(n))
    kv.alloc(3)
    kv.append(3, rows(600))
    kv.fork(3, 4)
    kv.append(4, rows(300))
    return kv, [0, 1, 2, 3, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_body_group_prefix_with_padded_members(cuda_device, variant, pool):
    """K2′ over a bf16 or an int8 pool: two groups (3 and 2 members, gmax
    3), so the smaller group's third member rows are padding: exact zeros
    with lse -inf.  One launch in K2′'s ``launches`` and ``mma_launches``,
    none in the queue kernel's counts."""
    from repro_torch.kernels import decode_schedule as sched

    kv, rids = _two_families(dtype=pool)
    bt, kv_len = kv.block_table(rids, width=kv.num_pages)
    ps = sched.build_prefix_schedule(kv_len, bt, page_size=128, block_k=512, num_splits=2)
    groups = ps.groups
    assert ps.num_groups == 2 and groups.gmax == 3
    q = _randn((len(rids), 128, 576), 9, torch.float32).to(torch.bfloat16)
    pos = torch.from_numpy(np.repeat((kv_len - 1)[:, None], 128, 1).astype(np.int32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    args = [q, kv.pages, i32(bt), pos, i32(groups.group_member), i32(groups.group_rep),
            i32(ps.prefix_lens)]
    items = [i32(a) for a in ps.prefix.prefetch_arrays()]
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192), block_k=512,
              num_dest_slots=ps.prefix.num_dest_slots, softcap=None)
    grp, rows = port_paged.mla_decode_paged_group_prefix, port_paged.mla_decode_paged_queue_rows
    counts = lambda: (grp.launches, grp.mma_launches, rows.launches, rows.int8_launches,
                      rows.mma_launches)
    before = counts()
    scales = kv.scales
    o_k, lse_k = grp(*(t.to(cuda_device) for t in args), *(t.to(cuda_device) for t in items),
                     None if scales is None else scales.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, *before[2:])
    o_p, lse_p = port_paged._group_prefix_plain(*args, items, scales, **kw)
    o_k, lse_k = o_k.cpu(), lse_k.cpu()
    s = ps.prefix
    padded = 0
    for t in np.flatnonzero(s.item_valid):
        j, d = int(s.item_req[t]), int(s.item_dest[t])
        for slot in range(groups.gmax):
            r = d * groups.gmax + slot
            if groups.group_member[j, slot] < 0:
                padded += 1
                assert o_k[r].abs().max().item() == 0.0
                assert torch.isneginf(lse_k[r]).all()
            else:
                assert (o_k[r] - o_p[r]).abs().max().item() <= TOL[torch.bfloat16, variant]
                assert (lse_k[r] - lse_p[r]).abs().max().item() <= TOL[torch.bfloat16, variant]
    assert padded > 0


@pytest.mark.cuda
def test_mma_body_rejects_widths_off_a_16_byte_row(cuda_device):
    """bf16 q over a bf16 pool needs d_k and d_v multiples of 8 and tensors
    on 16-byte boundaries (16-byte copies); the scalar body (fp32 pool)
    still takes d_k = 84."""
    dev = cuda_device
    items = [torch.tensor(a, dtype=torch.int32, device=dev) for a in ([0], [0], [0], [1], [1], [1])]
    common = (torch.zeros((1, 2), dtype=torch.int32, device=dev),
              torch.tensor([20], dtype=torch.int32, device=dev),
              torch.full((1, 8), 19, dtype=torch.int32, device=dev))
    kw = dict(scale=0.1, block_k=32, num_dest_slots=1)
    q = torch.randn((1, 8, 84), device=dev)
    pool = torch.randn((4, 16, 84), device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        port_paged.mla_decode_paged_queue_rows(
            q.to(torch.bfloat16), pool.to(torch.bfloat16), *common, *items, d_v=64, **kw)
    with pytest.raises(ValueError, match="multiples of 8"):
        port_paged.mla_decode_paged_queue_rows(
            q[..., :80].to(torch.bfloat16), pool[..., :80].to(torch.bfloat16), *common, *items,
            d_v=60, **kw)
    shifted = torch.zeros(8 * 80 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 8, 80)
    with pytest.raises(ValueError, match="16-byte boundary"):
        port_paged.mla_decode_paged_queue_rows(
            shifted, pool[..., :80].to(torch.bfloat16), *common, *items, d_v=64, **kw)
    o, _ = port_paged.mla_decode_paged_queue_rows(q, pool, *common, *items, d_v=64, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all()


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.int8)])
def test_scalar_body_launches_are_not_counted_as_mma(cuda_device, q_dtype, pool_dtype):
    """fp32 pools and fp32 queries keep the scalar body: one launch in
    ``launches``, none in ``mma_launches``.  bf16 queries over an int8 pool
    take the tensor-core body: one launch in ``int8_launches`` and one in
    ``mma_launches``."""
    from repro_torch.runtime.kv_cache import _quantize_rows

    c = _queue_case(13, [0, 129, 513], 17, 2, _decode_rows)
    pool, scales = c["pool"].float().to(pool_dtype), None
    if pool_dtype == torch.int8:
        pool, scales = _quantize_rows(c["pool"].float())
    c["q"] = c["q"].to(q_dtype)
    fn = port_paged.mla_decode_paged_queue_rows
    before = (fn.launches, fn.int8_launches, fn.mma_launches)
    to = lambda t: t.to(cuda_device)
    fn(to(c["q"]), to(pool), to(c["bt"]), to(c["kv"]), to(c["pos"]), *(to(t) for t in c["items"]),
       None if scales is None else to(scales), d_v=512, scale=1 / math.sqrt(192), block_k=512,
       num_dest_slots=c["sched"].num_dest_slots)
    torch.cuda.synchronize()
    int8 = pool_dtype == torch.int8
    mma = q_dtype == torch.bfloat16 and int8
    assert (fn.launches, fn.int8_launches, fn.mma_launches) == (
        before[0] + (not int8), before[1] + int8, before[2] + mma)


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(64, 48), (80, 64)])
@pytest.mark.parametrize("g", [17, 4096])
@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_int8_mma_body_at_narrow_rows_matches_plain_version(cuda_device, variant, num_splits, g,
                                                            dk, dv):
    """Narrow int8 rows (d_k 64 or 80) keep more than two per-block key/σ
    buffers in flight: 16-key blocks take the fewest chunks a block can, so
    the producer runs several blocks ahead of the softmax that reads their σ.
    Random rows with their own per-row scales, up to 21 blocks a request;
    G = 4096 over several slots takes the 32-row tiles."""
    chunk = lambda kv_len, g: np.maximum(kv_len - g // 128, 0) + np.arange(g) // 128
    c = _queue_case(15, [0, 1, 15, 16, 100, 333], g, num_splits,
                    _decode_rows if g == 17 else chunk, dk=dk, dv=dv, page=16, block_k=16)
    c = _on_pool(c, "int8")
    sigma = c["scales"].flatten()
    assert (sigma[1:] != sigma[:-1]).float().mean().item() > 0.9  # neighbours' σ differ
    _hold_mma_launch(cuda_device, c, variant)


# ---- K4 and K5 on the tensor-core body (bf16 q over bf16 rows) -----------


def _hold_mla_rows(cuda_device, fn, run, variant, *, mma=True, dtype=torch.bfloat16,
                   zero_rows=()):
    """One launch of K4 or K5 on the card against its plain version on the
    CPU: counted in ``launches``, and in ``mma_launches`` when ``mma``."""
    before = (fn.launches, fn.mma_launches)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mma_launches) == (before[0] + 1, before[1] + mma)
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert (got - run("cpu")).abs().max().item() <= TOL[dtype, variant]
    for r in zero_rows:
        assert got[r].abs().max().item() == 0.0


def _k4_run(q, c, kv, pos, variant, **kw):
    """K4 over ``c[1:]`` (a batch slice of a larger cache) on ``dev``."""
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192)) | kw
    return lambda dev: port_mla.mla_decode_rows(q.to(dev), c.to(dev)[1:], kv.to(dev),
                                                pos.to(dev), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", [128, 256, 512])
@pytest.mark.parametrize("g", [1, 17, 128])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_contiguous_body_matches_plain_version(cuda_device, variant, g, block_k):
    """K4 on the tensor-core body over a batch-sliced cache: ragged kv_len
    (0, either side of a 16-key chunk, a 128-key strip, a 512-row block),
    G from one row to 128, blocks of 128, 256 and 512 rows."""
    kv = torch.tensor(RAGGED_KV, dtype=torch.int32)
    q = _randn((len(RAGGED_KV), g, 576), 20, torch.float32).to(torch.bfloat16)
    c = _randn((len(RAGGED_KV) + 1, 1116, 576), 21, torch.float32).to(torch.bfloat16)
    pos = torch.from_numpy(np.stack([_decode_rows(int(n), g) for n in RAGGED_KV]).astype(np.int32))
    _hold_mla_rows(cuda_device, port_mla.mla_decode_rows,
                   _k4_run(q, c, kv, pos, variant, block_k=block_k), variant, zero_rows=[0])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_contiguous_body_causal_prefill_on_32_row_tiles(cuda_device, variant):
    """A causal prefill of 96 tokens x 128 heads after 200 cached rows, and
    one of 33 tokens from the start: 12288 rows a request, so 32-row
    tiles."""
    sq = 96
    kv = torch.tensor([200 + sq, 33], dtype=torch.int32)
    pos = torch.stack([200 + torch.arange(sq * 128) // 128,
                       torch.clamp(torch.arange(sq * 128) // 128, max=32)]).to(torch.int32)
    q = _randn((2, sq * 128, 576), 22, torch.float32).to(torch.bfloat16)
    c = _randn((3, 512, 576), 23, torch.float32).to(torch.bfloat16)
    _hold_mla_rows(cuda_device, port_mla.mla_decode_rows, _k4_run(q, c, kv, pos, variant), variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(64, 48), (80, 64)])
@pytest.mark.parametrize("g", [17, 4096])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_contiguous_body_at_narrow_rows(cuda_device, variant, g, dk, dv):
    """Narrow rows in 16-row blocks: a block takes the fewest chunks it can,
    so the producer runs several blocks ahead (the key buffer ring holds 3-5
    of them); G = 4096 over two requests takes the 32-row tiles."""
    kv = torch.tensor([0, 1, 15, 16, 100, 333], dtype=torch.int32)
    q = _randn((6, g, dk), 24, torch.float32).to(torch.bfloat16)
    c = _randn((7, 333, dk), 25, torch.float32).to(torch.bfloat16)
    chunk = lambda n, g: np.maximum(n - g // 128, 0) + np.arange(g) // 128
    rows = chunk if g > 17 else _decode_rows
    pos = torch.from_numpy(np.stack([rows(int(n), g) for n in kv]).astype(np.int32))
    _hold_mla_rows(cuda_device, port_mla.mla_decode_rows,
                   _k4_run(q, c, kv, pos, variant, d_v=dv, block_k=16), variant, zero_rows=[0])


def _padded_case(seed, kv_lens, g, page, extra=3):
    """bf16 queries and pool, and a fragmented (B, W) table whose entries
    past each request's last page point anywhere in the pool."""
    rng = np.random.default_rng(seed)
    w = max(max(-(-n // page) for n in kv_lens), 1) + extra
    num_pages = len(kv_lens) * w + 5
    bt = rng.permutation(num_pages)[: len(kv_lens) * w].reshape(len(kv_lens), w)
    for r, n in enumerate(kv_lens):
        used = -(-n // page)
        bt[r, used:] = rng.integers(0, num_pages, size=w - used)
    pool = torch.from_numpy(rng.normal(0, 1, (num_pages, page, 576)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (len(kv_lens), g, 576)).astype(np.float32))
    pos = np.stack([_decode_rows(n, g) for n in kv_lens]).astype(np.int32)
    return (q.to(torch.bfloat16), pool.to(torch.bfloat16), torch.from_numpy(bt.astype(np.int32)),
            torch.tensor(kv_lens, dtype=torch.int32), torch.from_numpy(pos))


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 64, 128, 512])
@pytest.mark.parametrize("g", [1, 17, 128])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_padded_body_matches_plain_version(cuda_device, variant, g, page):
    """K5 on the tensor-core body, one state update per page of 16 to 512
    rows, over ragged kv_len and a fragmented table with arbitrary tail
    entries; kv_len 0 gives exact zeros."""
    args = _padded_case(30, RAGGED_KV, g, page)
    kw = dict(d_v=512, variant=variant, scale=1 / math.sqrt(192))
    run = lambda dev: port_paged.mla_decode_paged_rows(*(t.to(dev) for t in args), **kw)
    _hold_mla_rows(cuda_device, port_paged.mla_decode_paged_rows, run, variant, zero_rows=[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_scalar_mla_bodies_are_not_counted_as_mma(cuda_device, kernel, q_dtype, kv_dtype):
    """K4 and K5 with an fp32 query or fp32 rows keep the scalar body: one
    launch in ``launches``, none in ``mma_launches``."""
    q, pool, bt, kv, pos = _padded_case(31, [0, 129, 513], 17, 128)
    q, pool = q.float().to(q_dtype), pool.float().to(kv_dtype)
    kw = dict(d_v=512, variant="amla", scale=1 / math.sqrt(192))
    if kernel == "K4":
        c = pool[: 3 * 5].reshape(3, 5 * 128, 576)
        fn = port_mla.mla_decode_rows
        run = lambda dev: fn(q.to(dev), c.to(dev), kv.to(dev), pos.to(dev), **kw)
    else:
        fn = port_paged.mla_decode_paged_rows
        run = lambda dev: fn(q.to(dev), pool.to(dev), bt.to(dev), kv.to(dev), pos.to(dev), **kw)
    # the rows are rounded to q's dtype where they are used
    _hold_mla_rows(cuda_device, fn, run, "amla", mma=False, dtype=q_dtype, zero_rows=[0])


# ---- K6 and K7 on the tensor-core body (bf16 q over bf16 K/V) -------------


def _hold_gqa(cuda_device, fn, run, plain, variant, *, zero_rows=(), combines=0):
    """One bf16 launch of K6 or K7 on the card against its plain version on
    the CPU: counted in ``launches`` and ``mma_launches``; ``combines``
    more launches of the combine (K6 over more than one split)."""
    k3 = port_combine.combine_split_partials
    before = (fn.launches, fn.mma_launches, k3.launches)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mma_launches, k3.launches) == (
        before[0] + 1, before[1] + 1, before[2] + combines)
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert (got - plain()).abs().max().item() <= TOL[torch.bfloat16, variant]
    for r in zero_rows:
        assert got[r].abs().max().item() == 0.0


def _k6_case(seed, *, b, hkv, group, sq, s, dh, lens, v_layout="transposed"):
    """bf16 q rows (B, Hkv, Sq * group, Dh) at the last Sq positions below
    kv_len, and k, v as transposed views of (B, S, Hkv, Dh) tensors (or v
    as a slot, rows 3.. of a (B, Hkv, S + 3, Dh) tensor: other strides than
    k's)."""
    bf = torch.bfloat16
    lens = torch.tensor(lens, dtype=torch.int32)
    q_pos = torch.clamp_min(lens - sq, 0)[:, None] + torch.arange(sq)[None, :]
    pos = q_pos.repeat_interleave(group, dim=1).to(torch.int32)
    q = _randn((b, hkv, sq * group, dh), seed, bf)
    k = _randn((b, s, hkv, dh), seed + 1, bf).transpose(1, 2)
    if v_layout == "transposed":
        v = _randn((b, s, hkv, dh), seed + 2, bf).transpose(1, 2)
    else:
        v = _randn((b, hkv, s + 3, dh), seed + 2, bf)[:, :, 3:]
    return q, k, v, lens, pos


def _hold_k6(cuda_device, case, variant, *, window=None, softcap=None):
    q, k, v, lens, pos = case
    kw = dict(variant=variant, scale=1 / math.sqrt(q.shape[-1]), softcap=softcap, window=window)
    block_k = min(512, max(k.shape[2], 128))
    splits = port_gqa.split_count(q.to(cuda_device), k.to(cuda_device), block_k)
    run = lambda dev: port_gqa.gqa_decode_rows(*(t.to(dev) for t in case), **kw)
    plain = lambda: port_gqa.attend_plain(q, k, v, lens, pos, block_k=block_k,
                                          num_splits=splits, **kw)
    _hold_gqa(cuda_device, port_gqa.gqa_decode_rows, run, plain, variant,
              zero_rows=[i for i, n in enumerate(lens.tolist()) if n == 0],
              combines=int(splits > 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_gqa_decode_matches_plain_version(cuda_device, variant, group, dh):
    """K6 on the tensor-core body, split over the KV blocks and merged by
    the combine: head dims 64/128/256, groups 1/2/8, kv_len 0 (exact zeros)
    and ragged lengths across 512-key blocks."""
    case = _k6_case(40, b=3, hkv=2, group=group, sq=1, s=1300, dh=dh, lens=[0, 513, 1300])
    _hold_k6(cuda_device, case, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_gqa_decode_window_softcap_past_the_window(cuda_device, variant):
    """gemma2-2b's heads (4 KV heads of 256, group 2) with its window 4096
    and softcap 50 over contexts of 0 to 5000 keys: the first blocks of the
    longest one lie outside the window and are skipped whole."""
    case = _k6_case(41, b=4, hkv=4, group=2, sq=1, s=5000, dh=256, lens=[0, 21, 4100, 5000])
    _hold_k6(cuda_device, case, variant, window=4096, softcap=50.0)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 8])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_gqa_decode_eight_token_prefill(cuda_device, variant, group):
    """An 8-token prefill through K6 (G = 16 and 64 rows per KV head), one
    prompt at the start of its cache and one after 1500 cached keys."""
    case = _k6_case(42, b=2, hkv=2, group=group, sq=8, s=2048, dh=128, lens=[8, 1508])
    _hold_k6(cuda_device, case, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_gqa_decode_reads_k_and_v_at_their_own_strides(cuda_device, variant):
    """k a transposed view of a (B, S, Hkv, Dh) cache and v a slot of a
    longer (B, Hkv, S + 3, Dh) one: value rows are read at their own
    offsets, not the keys'."""
    case = _k6_case(43, b=2, hkv=2, group=4, sq=1, s=900, dh=128, lens=[900, 333],
                    v_layout="slot")
    _hold_k6(cuda_device, case, variant)


def _hold_k7(cuda_device, variant, seed, *, b, hq, hkv, sq, s, dh, lens, window=None,
             softcap=None, causal=True, transposed=False):
    bf = torch.bfloat16
    q = _randn((b, hq, sq, dh), seed, bf)
    if transposed:  # views of (B, S, Hkv, Dh) caches, as the dense layer hands them over
        k = _randn((b, s, hkv, dh), seed + 1, bf).transpose(1, 2)
        v = _randn((b, s, hkv, dh), seed + 2, bf).transpose(1, 2)
    else:
        k = _randn((b, hkv, s, dh), seed + 1, bf)
        v = _randn((b, hkv, s, dh), seed + 2, bf)
    lens = torch.tensor(lens, dtype=torch.int32)
    kw = dict(variant=variant, scale=1 / math.sqrt(dh), softcap=softcap, window=window,
              causal=causal)
    run = lambda dev: port_prefill.flash_prefill(*(t.to(dev) for t in (q, k, v, lens)), **kw)
    _hold_gqa(cuda_device, port_prefill.flash_prefill, run, lambda: run("cpu"), variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_flash_prefill_matches_plain_version(cuda_device, variant, group, dh):
    """K7 on the tensor-core body: head dims 64/128/256, groups 1/2/8 (KV
    head h / group by index), a causal 600-token prompt over two 512-key
    blocks and one whose kv_len stops short of its rows."""
    _hold_k7(cuda_device, variant, 50, b=2, hq=2 * group, hkv=2, sq=600, s=600, dh=dh,
             lens=[600, 300])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_flash_prefill_window_softcap_and_transposed_views(cuda_device, variant):
    """gemma2's window and softcap (here a 256-key window) over a 1100-token
    prompt, with K and V transposed views of (B, S, Hkv, Dh) caches: rows
    past the window skip their first blocks."""
    _hold_k7(cuda_device, variant, 51, b=1, hq=8, hkv=4, sq=1100, s=1100, dh=256, lens=[1100],
             window=256, softcap=50.0, transposed=True)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_mma_flash_prefill_not_causal(cuda_device, variant, window):
    """K7 with ``causal=False``: every row sees every key below kv_len
    (within the window of its position when there is one)."""
    _hold_k7(cuda_device, variant, 52, b=2, hq=4, hkv=2, sq=200, s=700, dh=128, lens=[700, 90],
             window=window, causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_fp32_gqa_kernels_keep_the_scalar_body(cuda_device, kernel):
    """fp32 q, k and v keep the scalar body of gqa_rows.cuh: one launch in
    ``launches``, none in ``mma_launches``, no combine."""
    k3 = port_combine.combine_split_partials
    if kernel == "K6":
        fn = port_gqa.gqa_decode_rows
        case = [t.float() if t.is_floating_point() else t for t in
                _k6_case(44, b=2, hkv=2, group=2, sq=1, s=1300, dh=128, lens=[0, 1300])]
        run = lambda dev: fn(*(t.to(dev) for t in case), variant="amla", scale=0.1)
    else:
        fn = port_prefill.flash_prefill
        q = _randn((1, 4, 64, 64), 45, torch.float32)
        k = _randn((1, 2, 64, 64), 46, torch.float32)
        v = _randn((1, 2, 64, 64), 47, torch.float32)
        lens = torch.tensor([64], dtype=torch.int32)
        run = lambda dev: fn(q.to(dev), k.to(dev), v.to(dev), lens.to(dev), variant="amla",
                             scale=0.125)
    before = (fn.launches, fn.mma_launches, k3.launches)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mma_launches, k3.launches) == (before[0] + 1, before[1], before[2])
    assert (got.cpu() - run("cpu")).abs().max().item() <= TOL[torch.float32, "amla"]


# --------------------------------------------------------------------------- #
# K3, the split-KV combine: one group of lanes per piece of a row, the
# partial rows of several splits in flight, one or two sources
# --------------------------------------------------------------------------- #

K3_TOL = 1e-5  # fp32 on the same partials: only expf ulps and fused multiply-adds differ


def _combine_case(seed, b, g, d_v, s, *, second=0):
    """K3's inputs on the CPU: ragged ``n_splits`` (0 and ``s`` among them),
    a fifth of the lse ``-inf``, a request whose live splits are all empty,
    slot ids out of order (and repeated), padding columns that repeat a
    live slot or name one far out of range (never read); ``second`` > 0
    puts that many more slots in a second source of its own.  Returns the
    partials and lse of each source, the table for the kernel, the table
    clamped into range for the plain version, and ``n_splits``."""
    rng = np.random.default_rng(seed)
    d = b * s + 1
    o = rng.normal(0, 1, (d + second, g, d_v)).astype(np.float32)
    lse = rng.normal(0, 3, (d + second, g, 1)).astype(np.float32)
    lse[rng.random(lse.shape) < 0.2] = -np.inf
    n = rng.integers(0, s + 1, b)
    n[0], n[-1] = 0, s
    dest = rng.integers(0, d + second, (b, s)).astype(np.int32)
    pad = np.arange(s)[None, :] - n[:, None]  # >= 0 on padding columns
    repeat = (pad >= 0) & (pad % 2 == 0) & (n[:, None] > 0)
    dest = np.where(repeat, dest[:, :1], np.where(pad >= 0, 10**9, dest)).astype(np.int32)
    if b > 2:
        lse[dest[1, :n[1]]] = -np.inf
    o, lse = torch.from_numpy(o), torch.from_numpy(lse)
    parts = ([o[:d].clone(), o[d:].clone()], [lse[:d].clone(), lse[d:].clone()]) if second else ([o], [lse])
    dest = torch.from_numpy(dest)
    return (*parts, dest, dest.clamp(max=d + second - 1), torch.from_numpy(n.astype(np.int32)))


def _hold_combine(dev, what, o_parts, lse_parts, dest, dest_plain, n_splits):
    """One K3 launch (two sources: through ``combine_hetero_partials``) on
    the card against the plain version on the CPU."""
    k3 = port_combine.combine_split_partials
    before = k3.launches
    if len(o_parts) == 1:
        got = k3(o_parts[0].to(dev), lse_parts[0].to(dev), dest.to(dev), n_splits.to(dev))
    else:
        got = port_combine.combine_hetero_partials([o.to(dev) for o in o_parts],
                                                   [x.to(dev) for x in lse_parts],
                                                   dest.to(dev), n_splits.to(dev))
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = port_combine._combine_plain(torch.cat([o.cpu() for o in o_parts]),
                                       torch.cat(lse_parts), dest_plain, n_splits)
    got = got.cpu()
    err = (got - want).abs().max().item()
    zero = (want == 0).all(-1)
    print(f"K3 {what}: max |kernel - plain| {err:.3e} (tol {K3_TOL:g}), {int(zero.sum())} zero rows")
    assert zero.any() and (got[zero] == 0).all()  # no live split: exact zeros
    assert torch.isfinite(got).all() and err <= K3_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 16, 33])
@pytest.mark.parametrize("d_v", [64, 128, 256, 512])
def test_combine_kernel_matches_plain_version(cuda_device, d_v, splits):
    """Dv 64 to 512 (16 lanes a row to four 32-lane groups), 1 to 33 splits
    (past one warp of slot ids)."""
    _hold_combine(cuda_device, f"Dv {d_v}, {splits} splits",
                  *_combine_case(d_v + splits, 5, 3, d_v, splits))


@pytest.mark.cuda
@pytest.mark.parametrize("b,g", [(70000, 1), (3, 30000)])
def test_combine_kernel_past_65535_rows(cuda_device, b, g):
    """B x G above 65535 rows on the 1-D grid; B alone above the old grid's
    65535 cap."""
    _hold_combine(cuda_device, f"B {b} x G {g}", *_combine_case(7, b, g, 64, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("d_v", [128, 512])
def test_combine_hetero_reads_two_sources_in_place(cuda_device, monkeypatch, d_v):
    """The shared-prefix merge: a second source whose slots start at D0 > 0,
    each source its own allocation, one launch and no concatenated copy."""
    case = _combine_case(8, 4, 3, d_v, 3, second=6)
    real_cat = torch.cat

    def cat(tensors, *a, **k):
        assert not any(t.is_cuda for t in tensors), "the CUDA path concatenated its sources"
        return real_cat(tensors, *a, **k)

    monkeypatch.setattr(torch, "cat", cat)
    _hold_combine(cuda_device, f"two sources, D0 {case[0][0].shape[0]}, Dv {d_v}", *case)


@pytest.mark.cuda
def test_combine_kernel_on_rows_off_16_bytes(cuda_device):
    """Partials that do not start on a 16-byte boundary (and a Dv that is
    not a multiple of 4) take the kernel's scalar loads."""
    o_parts, lse_parts, dest, dest_plain, n = _combine_case(9, 4, 3, 64, 4)
    o = o_parts[0].to(cuda_device)
    shifted = torch.empty(o.numel() + 1, device=cuda_device)
    shifted[1:] = o.reshape(-1)
    _hold_combine(cuda_device, "partials 4 bytes off 16", [shifted[1:].view(o.shape)],
                  lse_parts, dest, dest_plain, n)
    _hold_combine(cuda_device, "Dv 50", *_combine_case(10, 4, 3, 50, 4))
