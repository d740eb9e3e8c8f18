"""The port's int8 latent pages (K2-int8) against the JAX reference.

* ``_quantize_rows`` is bit-equal to the reference's, as its cache writes
  run it (under ``jax.jit``, where XLA multiplies by the fp32 reciprocal of
  127 instead of dividing), on seeded sweeps of fp32 and bf16 rows,
  all-zero rows and rows that hit the +-127 edges.
* The same op sequence (alloc, multi-chunk writes, fork, a copy-on-write
  append) on both packages' caches gives identical block tables,
  refcounts, free lists, int8 bytes and scales, flat and layered.
* The queue kernel's plain version over an int8 pool is within 2e-3 of the
  reference's queue kernel (Pallas, interpret mode) on the same int8 bytes
  and scales at fp32 compute, and within 3e-2 of the bf16-pool result
  (the reference's int8 tolerance, ``tests/test_quantized_cache.py``).
* A zero-length slot gives exact zeros; the rejections match the
  reference's error classes.

The CUDA kernel is held against the plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import ops as ref_ops
from repro.kernels.decode_schedule import build_prefix_schedule as ref_build_prefix
from repro.runtime import kv_cache as ref
from repro.runtime.serve_loop import PagedDecodeSession as RefDecodeSession
from repro_torch.kernels import ops
from repro_torch.kernels.decode_schedule import build_prefix_schedule, build_schedule
from repro_torch.runtime import kv_cache as port
from repro_torch.runtime.serve_loop import PagedDecodeSession

ATOL = 2e-3  # AMLA's fp32 tolerance (the reference's)
INT8_PARITY_ATOL = 3e-2  # int8 vs bf16 pool (the reference's bound)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``; undone, with
    the traces made under it, after each test."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def to_torch(x) -> torch.Tensor:
    """A JAX array as a CPU tensor of the same dtype (bf16 via fp32)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.uint32)


# --------------------------------------------------------------------------- #
# quantize-on-write
# --------------------------------------------------------------------------- #


def _sweep_rows(seed, dtype):
    rng = np.random.default_rng(seed)
    mags = np.exp2(rng.uniform(-10, 6, (24, 1)))
    x = rng.normal(0, 1, (24, 96)) * mags
    x[3] = 0.0  # an all-zero row
    x[5, 7] = -np.abs(x[5]).max() * 1.5  # the row max is negative: q = -127
    x[6] = np.linspace(-1, 1, 96)  # +-127 at both ends, half steps between
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(5))
def test_quantize_rows_bit_equal_to_reference(seed, dtype):
    rows = _sweep_rows(seed, getattr(jnp, dtype))
    q_ref, s_ref = jax.jit(ref._quantize_rows)(rows)
    q, s = port._quantize_rows(to_torch(rows))
    np.testing.assert_array_equal(np.asarray(q_ref), q.numpy())
    np.testing.assert_array_equal(bits(s_ref), bits(s.numpy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_quantize_rows_edges():
    rows = np.zeros((4, 8), np.float32)
    rows[1] = [127.0, -127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5]  # ties go to even
    rows[2, 0] = -3.0
    rows[3] = 1e-30
    q_ref, s_ref = jax.jit(ref._quantize_rows)(jnp.asarray(rows))
    q, s = port._quantize_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(q_ref), q.numpy())
    np.testing.assert_array_equal(bits(s_ref), bits(s.numpy()))
    assert q[0].abs().max() == 0 and s[0].item() == np.float32(1.0) / np.float32(127.0)
    # outside jit the reference divides, and the two forms differ by an
    # ulp on some rows; the pool bytes follow the jitted form (above)
    assert q[1, :2].tolist() == [127, -127] and q[2, 0].item() == -127


# --------------------------------------------------------------------------- #
# the same op sequence on both caches
# --------------------------------------------------------------------------- #

PAGE, W, L = 8, 24, 3


def _make(layered, num_pages=16):
    if layered:
        r = ref.LayeredPagedKVCache(num_layers=L, num_pages=num_pages, page_size=PAGE,
                                    width=W, dtype=jnp.int8)
        p = port.LayeredPagedKVCache(num_layers=L, num_pages=num_pages, page_size=PAGE,
                                     width=W, dtype=torch.int8, device="cpu")
    else:
        r = ref.PagedKVCache(num_pages=num_pages, page_size=PAGE, width=W, dtype=jnp.int8)
        p = port.PagedKVCache(num_pages=num_pages, page_size=PAGE, width=W,
                              dtype=torch.int8, device="cpu")
    return r, p


def _assert_same(r, p, rids):
    assert list(r._free) == list(p._free)
    np.testing.assert_array_equal(r._ref, p._ref)
    live = [x for x in rids if x in r._seq_pages]
    assert live == [x for x in rids if x in p._seq_pages]
    for x, y in zip(r.block_table(live, width=r.num_pages), p.block_table(live, width=p.num_pages)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(r.pages), p.pages.numpy())
    np.testing.assert_array_equal(bits(r.scales), bits(p.scales.numpy()))
    assert r.num_aliased_pages() == p.num_aliased_pages()
    assert r.refcount_sweep() == {**p.refcount_sweep(), "retained_pages": 0}


def _write(c, rid, rows, layered, layer_by_layer=False):
    """Append ``rows`` ((n, W), or (L, n, W) layered) to ``rid``."""
    if isinstance(c, ref.PagedKVCache):
        if layer_by_layer:
            plan = c.reserve(rid, rows.shape[1])
            for layer in range(L):
                c.write_layer(layer, plan, jnp.asarray(rows[layer]))
        else:
            c.append(rid, jnp.asarray(rows))
        return
    if layer_by_layer:
        plan = c.reserve(rid, rows.shape[1])
        for layer in range(L):
            c.write_layer(layer, plan, torch.from_numpy(rows[layer]))
    else:
        c.append(rid, torch.from_numpy(rows))


@pytest.mark.parametrize("layered", [False, True], ids=["flat", "layered"])
def test_op_sequence_with_fork_and_cow_matches_reference(layered):
    rng = np.random.default_rng(11)
    shape = lambda n: (L, n, W) if layered else (n, W)
    r, p = _make(layered)
    for c in (r, p):
        c.alloc(0)
        c.alloc(1)
    # multi-chunk writes: 19 rows cross two page boundaries
    for rid, n in ((0, 19), (1, 5), (0, 6)):
        rows = rng.normal(0, 0.5, shape(n)).astype(np.float32)
        for c in (r, p):
            _write(c, rid, rows, layered, layer_by_layer=layered and rid == 0)
        _assert_same(r, p, [0, 1, 2, 3])
    for c in (r, p):
        c.fork(0, 2)  # whole history: 25 rows, the partial page 3 aliased
        c.fork(0, 3, 16)  # page-aligned prefix
    _assert_same(r, p, [0, 1, 2, 3])
    assert r.num_aliased_pages() == 4
    # copy-on-write: the child's append copies the shared boundary page
    # (data and scales), then the parent's append no longer needs to
    rows = rng.normal(0, 2.0, shape(4)).astype(np.float32)
    for c in (r, p):
        assert c.pages_needed_for_append(2, 4) == 1
        _write(c, 2, rows, layered)
        assert c.seq_pages(2)[-1] != c.seq_pages(0)[-1]
        assert c.page_refcount(c.seq_pages(0)[-1]) == 1
    _assert_same(r, p, [0, 1, 2, 3])
    rows = rng.normal(0, 1.0, shape(9)).astype(np.float32)
    for c in (r, p):
        _write(c, 0, rows, layered)
        _write(c, 3, rows[..., :3, :], layered)
    _assert_same(r, p, [0, 1, 2, 3])
    if layered:
        rows = rng.normal(0, 1, (3, W)).astype(np.float32)
        pids, offs = [], []
        for rid in (0, 1, 2):
            (pid, off, _), = p.reserve(rid, 1)
            (pid_r, off_r, _), = r.reserve(rid, 1)
            assert (pid, off) == (pid_r, off_r)
            pids.append(pid)
            offs.append(off)
        r.write_layer_tokens(1, np.asarray(pids), np.asarray(offs), jnp.asarray(rows))
        p.write_layer_tokens(1, pids, offs, torch.from_numpy(rows))
        np.testing.assert_array_equal(bits(r.layer_scales(1)), bits(p.layer_scales(1).numpy()))
        np.testing.assert_array_equal(
            np.asarray(r.gather_contiguous(2, layer=1)), p.gather_contiguous(2, layer=1).numpy())
    else:
        np.testing.assert_array_equal(np.asarray(r.gather_contiguous(2)),
                                      p.gather_contiguous(2).numpy())
    _assert_same(r, p, [0, 1, 2, 3])
    for rid in (0, 2, 1, 3):
        r.free(rid)
        p.free(rid)
        _assert_same(r, p, [0, 1, 2, 3])
    assert p.num_free_pages == p.num_pages


def test_fork_errors_match_reference():
    r, p = _make(False)
    for c in (r, p):
        c.alloc(0)
        c.append(0, np.zeros((5, W), np.float32) if c is p else jnp.zeros((5, W)))
    for c in (r, p):
        with pytest.raises(ValueError, match="prefix_len"):
            c.fork(0, 1, 6)
        with pytest.raises(KeyError):
            c.fork(0, 0)
        with pytest.raises(KeyError):
            c.fork(9, 1)
    assert list(p._seq_pages) == list(r._seq_pages) == [0]


# --------------------------------------------------------------------------- #
# the queue kernel over int8 pages
# --------------------------------------------------------------------------- #


def _twin_pools(kv_lens, page, width, seed, *, fork=None):
    """bf16 and int8 JAX caches filled with the same latents (optionally a
    forked family), and the port's view of the int8 one (same bytes)."""
    rng = np.random.default_rng(seed)
    lens = kv_lens if fork is None else [fork[0] + n for n in fork[1]]
    num_pages = sum(-(-l // page) for l in lens) + 4
    kv16 = ref.PagedKVCache(num_pages=num_pages, page_size=page, width=width,
                            dtype=jnp.bfloat16)
    kv8 = ref.PagedKVCache(num_pages=num_pages, page_size=page, width=width, dtype=jnp.int8)
    if fork is None:
        for rid, l in enumerate(kv_lens):
            data = rng.normal(0, 0.3, (l, width)).astype(np.float32)
            for kv in (kv16, kv8):
                kv.alloc(rid)
                kv.append(rid, data)
    else:
        prefix_len, suffixes = fork
        prefix = rng.normal(0, 0.3, (prefix_len, width)).astype(np.float32)
        sufs = [rng.normal(0, 0.3, (n, width)).astype(np.float32) for n in suffixes]
        for kv in (kv16, kv8):
            kv.alloc(0)
            kv.append(0, prefix)
            for rid in range(1, len(sufs)):
                kv.fork(0, rid, prefix_len)
            for rid, suf in enumerate(sufs):
                kv.append(rid, suf)
    return kv16, kv8


def _ref_decode(kv, q, **kw):
    rids = sorted(kv._seq_pages)
    bt, kv_len = kv.block_table(rids)
    return np.asarray(ref_ops.mla_decode_paged(
        jnp.asarray(q), kv.pages, jnp.asarray(bt), jnp.asarray(kv_len),
        kv_scales=kv.scales, scale=1.0 / q.shape[-1] ** 0.5, interpret=True,
        compute_dtype=jnp.float32, **kw))


def _port_decode(kv, q, **kw):
    rids = sorted(kv._seq_pages)
    bt, kv_len = kv.block_table(rids)
    scales = None if kv.scales is None else to_torch(kv.scales)
    return ops.mla_decode_paged(
        torch.from_numpy(q), to_torch(kv.pages), torch.from_numpy(bt), kv_len,
        kv_scales=scales, scale=1.0 / q.shape[-1] ** 0.5, compute_dtype=torch.float32,
        **kw).numpy()


@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("variant", ["amla", "base"])
def test_int8_queue_matches_reference_ragged(pallas_interpret, variant, num_splits):
    page, width, dv, hq = 32, 128, 64, 4
    kv_lens = [200, 37, 130, 0]
    kv16, kv8 = _twin_pools(kv_lens[:3], page, width, 30)
    kv8.alloc(3)  # an empty slot
    kv16.alloc(3)
    q = np.random.default_rng(31).normal(0, 0.3, (4, 1, hq, width)).astype(np.float32)
    kw = dict(d_v=dv, variant=variant, num_splits=num_splits, block_k=64)
    want = _ref_decode(kv8, q, **kw)
    got = _port_decode(kv8, q, **kw)
    assert np.abs(got - want).max() <= ATOL
    got16 = _port_decode(kv16, q, **kw)
    assert np.abs(got - got16).max() <= INT8_PARITY_ATOL
    assert np.abs(got[3]).max() == 0.0  # the zero-length slot
    assert np.abs(got[:3]).max() > 0.0


@pytest.mark.parametrize("variant", ["amla", "base"])
def test_int8_prefix_shared_family_matches_reference(pallas_interpret, variant):
    """A forked family over int8 pages through the group-prefix pass (K2′
    over K2-int8), against the reference's and against the unshared
    queue."""
    page, width, dv, hq, block_k = 16, 128, 64, 4, 32
    kv16, kv8 = _twin_pools(None, page, width, 32, fork=(3 * block_k, (7, 13, 21)))
    rids = [0, 1, 2]
    bt, kv_len = kv8.block_table(rids)
    ps_ref = ref_build_prefix(kv_len, bt, page_size=page, block_k=block_k)
    ps = build_prefix_schedule(kv_len, bt, page_size=page, block_k=block_k)
    assert ps.num_groups == ps_ref.num_groups == 1
    q = np.random.default_rng(33).normal(0, 0.3, (3, 1, hq, width)).astype(np.float32)
    kw = dict(d_v=dv, variant=variant, block_k=block_k)
    want = _ref_decode(kv8, q, schedule=ps_ref, **kw)
    shared = _port_decode(kv8, q, schedule=ps, **kw)
    plain = _port_decode(kv8, q, schedule=build_schedule(kv_len, block_k=block_k), **kw)
    assert np.abs(shared - want).max() <= ATOL
    assert np.abs(shared - plain).max() <= ATOL
    assert np.abs(shared - _port_decode(kv16, q, prefix_sharing=True, **kw)).max() <= INT8_PARITY_ATOL


def test_int8_session_matches_reference(pallas_interpret):
    """PagedDecodeSession over an int8 pool, both packages, same latents:
    admit, a step, a fork with a suffix (copy-on-write), another step."""
    d_k, d_v, g = 128, 64, 4
    lat = lambda n, s: np.random.default_rng(s).normal(0, 0.3, (n, d_k)).astype(np.float32)
    kw = dict(num_pages=12, page_size=32, d_k=d_k, d_v=d_v, scale=d_k ** -0.5)
    r = RefDecodeSession(interpret=True, cache_spec=ref.CacheSpec(dtype=jnp.int8), **kw)
    p = PagedDecodeSession(cache_spec=port.CacheSpec(dtype="int8"), device="cpu", **kw)
    for s in (r, p):
        assert s.admit(lat(50, 1)) == 0 and s.admit(lat(70, 2)) == 1
    queries = {0: lat(g, 10), 1: lat(g, 11)}
    steps = [({0: lat(1, 12)[0], 1: lat(1, 13)[0]}, None), (None, (0, lat(9, 14)))]
    for new, fork in steps:
        if fork is not None:
            assert r.admit_with_prefix(fork[0], fork[1], 40) == p.admit_with_prefix(
                fork[0], torch.from_numpy(fork[1]), 40) == 2
            queries[2] = lat(g, 15)
        out_r = r.step(queries, new)
        out_p = p.step(queries, new)
        for rid in queries:
            assert np.abs(np.asarray(out_r[rid]) - out_p[rid].numpy()).max() <= ATOL
    np.testing.assert_array_equal(np.asarray(r.kv.pages), p.kv.pages.numpy())
    np.testing.assert_array_equal(bits(r.kv.scales), bits(p.kv.scales.numpy()))


# --------------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------------- #


def _int8_pair():
    kv16, kv8 = _twin_pools([32], 16, 64, 40)
    bt, kv_len = kv8.block_table([0])
    return kv16, kv8, bt, kv_len


def _both_raise(exc, match, call):
    with pytest.raises(exc, match=match):
        call(ref_ops.mla_decode_paged, jnp.asarray, lambda a: a)
    with pytest.raises(exc, match=match):
        call(ops.mla_decode_paged, to_torch, torch.as_tensor)


def test_int8_without_scales_rejected():
    _, kv8, bt, kv_len = _int8_pair()
    _both_raise(ValueError, "scale pool", lambda f, arr, idx: f(
        arr(jnp.zeros((1, 1, 4, 64), jnp.float32)), arr(kv8.pages), idx(bt), kv_len,
        d_v=32, scale=0.1))


def test_int8_padded_scheduler_rejected():
    _, kv8, bt, kv_len = _int8_pair()
    _both_raise(ValueError, "padded", lambda f, arr, idx: f(
        arr(jnp.zeros((1, 1, 4, 64), jnp.float32)), arr(kv8.pages), idx(bt), kv_len,
        kv_scales=arr(kv8.scales), d_v=32, scale=0.1, scheduler="padded"))
    with pytest.raises(ValueError, match="queue"):
        PagedDecodeSession(num_pages=4, page_size=16, d_k=64, d_v=32, scale=0.1,
                           cache_spec=port.CacheSpec(dtype="int8"), scheduler="padded",
                           device="cpu")


def test_scales_with_bf16_pool_rejected():
    kv16, kv8, bt, kv_len = _int8_pair()
    _both_raise(ValueError, "int8 pools only", lambda f, arr, idx: f(
        arr(jnp.zeros((1, 1, 4, 64), jnp.float32)), arr(kv16.pages), idx(bt), kv_len,
        kv_scales=arr(kv8.scales), d_v=32, scale=0.1))
    _both_raise(ValueError, "one fp32 scale per page row", lambda f, arr, idx: f(
        arr(jnp.zeros((1, 1, 4, 64), jnp.float32)), arr(kv8.pages), idx(bt), kv_len,
        kv_scales=arr(kv8.scales[:, :3]), d_v=32, scale=0.1))


def test_cache_spec_and_int8_pool_layout():
    spec = port.CacheSpec("int8")
    assert spec.quantized and spec == port.CacheSpec(dtype="int8")
    assert spec.bytes_per_page(128, 576) == ref.CacheSpec("int8").bytes_per_page(128, 576)
    kv = port.LayeredPagedKVCache(num_layers=2, num_pages=3, page_size=4, width=8,
                                  spec=spec, device="cpu")
    assert kv.pages.dtype == torch.int8 and kv.scales.shape == (2, 3, 4)
    assert kv.layer_scales(1).shape == (3, 4)
    bf = port.LayeredPagedKVCache(num_layers=2, num_pages=3, page_size=4, width=8, device="cpu")
    assert bf.scales is None and bf.layer_scales(0) is None
