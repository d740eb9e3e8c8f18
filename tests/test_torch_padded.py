"""The port's padded (B, W) paged decode (K5) and its attention-level
``PagedDecodeSession`` against the JAX reference.

* The K5 plain version is within 2e-3 of the reference's
  ``mla_decode_paged_rows`` (Pallas, interpret mode) at fp32 compute: a
  ragged batch, a fragmented block table, a ``kv_len == 0`` slot, fp32
  compute over a bf16 pool, both rescale variants.
* ``padded_grid_items`` gives the reference's counts.
* ``PagedDecodeSession(scheduler="padded")`` and ``(scheduler="queue")``
  give the reference sessions' outputs (2e-3) and page bookkeeping over an
  admit / evict / fork sequence (the cases of
  ``tests/test_paged_decode.py``).

The CUDA kernel is held against the plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import decode_schedule as ref_sched
from repro.kernels.mla_decode_paged import mla_decode_paged_rows as ref_rows
from repro.runtime.serve_loop import PagedDecodeSession as RefDecodeSession
from repro_torch.kernels import decode_schedule as sched
from repro_torch.kernels import mla_decode_paged as mp
from repro_torch.kernels import ops
from repro_torch.runtime.kv_cache import OutOfPagesError
from repro_torch.runtime.serve_loop import PagedDecodeSession

ATOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's kernels run in interpret mode on this jax, which
    renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``; undone, with the
    traces made under it, after each test."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def bf16ish(shape, seed, scale=0.3):
    x = np.random.default_rng(seed).normal(0, scale, shape)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def paginate(c, kv_lens, page, *, num_pages, shuffle_seed=None, width=None):
    """Scatter contiguous (B, S, Dk) latents into a pool + block tables of
    ``width`` columns (tails padded with page 0); ``shuffle_seed`` places
    the pages by a random permutation."""
    b, _, dk = c.shape
    w = width or max(max(-(-int(l) // page) for l in kv_lens), 1)
    pool = np.zeros((num_pages, page, dk), np.float32)
    bt = np.zeros((b, w), np.int32)
    order = np.arange(num_pages)
    if shuffle_seed is not None:
        order = np.random.default_rng(shuffle_seed).permutation(num_pages)
    nxt = 0
    for bb in range(b):
        for j in range(-(-int(kv_lens[bb]) // page)):
            pid = int(order[nxt])
            nxt += 1
            lo, hi = j * page, min((j + 1) * page, int(kv_lens[bb]))
            pool[pid, : hi - lo] = c[bb, lo:hi]
            bt[bb, j] = pid
    return pool, bt


CASES = [
    # (kv_lens, page, shuffle, table width, pool dtype)
    pytest.param([37, 5, 70], 16, None, None, "float32", id="ragged"),
    pytest.param([100, 64, 0, 33], 32, 3, 6, "float32", id="fragmented-empty-slot"),
    pytest.param([130, 1, 96], 32, 7, None, "bfloat16", id="fp32-over-bf16-pool"),
]


@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("kv_lens,page,shuffle,width,pool_dtype", CASES)
def test_padded_rows_match_reference(pallas_interpret, kv_lens, page, shuffle, width,
                                     pool_dtype, variant):
    b, g, dk, dv = len(kv_lens), 8, 80, 64
    c = bf16ish((b, max(kv_lens), dk), 1)
    num_pages = sum(-(-l // page) for l in kv_lens) + 3
    pool, bt = paginate(c, kv_lens, page, num_pages=num_pages, shuffle_seed=shuffle,
                        width=width)
    q = bf16ish((b, g, dk), 2)
    kv = np.asarray(kv_lens, np.int32)
    # every 3rd row sits 20 positions earlier, so the causal mask cuts it
    pos = np.maximum(kv[:, None] - 1 - 20 * (np.arange(g)[None, :] % 3 == 0), 0).astype(np.int32)
    kw = dict(d_v=dv, variant=variant, scale=dk ** -0.5, softcap=None)
    jpool = jnp.asarray(pool, getattr(jnp, pool_dtype))
    want = np.asarray(ref_rows(jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(kv),
                               jnp.asarray(pos), interpret=True, **kw))
    tpool = torch.from_numpy(pool).to(getattr(torch, pool_dtype))
    got = mp.mla_decode_paged_rows(torch.from_numpy(q), tpool, torch.from_numpy(bt),
                                   torch.from_numpy(kv), torch.from_numpy(pos), **kw).numpy()
    assert np.abs(got - want).max() <= ATOL
    empty = kv == 0
    assert np.abs(got[empty]).max(initial=0.0) == 0.0
    assert np.abs(got[~empty]).max() > 0.0


@pytest.mark.parametrize("variant", ["amla", "base"])
def test_padded_matches_queue_through_ops(variant):
    """Padded and queue schedulers over the same pool agree (they differ
    only in the AMLA update granularity: a page vs a 512-row block)."""
    kv_lens = [300, 45, 0, 129]
    c = bf16ish((4, 300, 64), 5)
    pool, bt = paginate(c, kv_lens, 32, num_pages=20, shuffle_seed=1, width=10)
    q = torch.from_numpy(bf16ish((4, 1, 4, 64), 6))
    kw = dict(d_v=32, variant=variant, scale=0.125, compute_dtype=torch.float32)
    tpool, tbt = torch.from_numpy(pool), torch.from_numpy(bt)
    padded = ops.mla_decode_paged(q, tpool, tbt, kv_lens, scheduler="padded", **kw)
    queue = ops.mla_decode_paged(q, tpool, tbt, kv_lens, num_splits=2, **kw)
    assert (padded - queue).abs().max() <= ATOL
    assert padded[2].abs().max() == 0.0


def test_padded_grid_items_match_reference():
    for lens, w, page in (([0, 37, 128, 515], 6, 128), ([5, 5], 1, 8), ([70, 0, 33], 9, 16)):
        assert sched.padded_grid_items(lens, w, page) == ref_sched.padded_grid_items(lens, w, page)


def test_padded_rejections_match_reference():
    q = torch.zeros((1, 2, 4, 64))
    pool = torch.zeros((4, 16, 64))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="scheduler='queue'"):
        ops.mla_decode_paged(q, pool, bt, [20], scale=0.1, d_v=32, scheduler="padded",
                             q_positions=np.asarray([[18, 19]]))
    with pytest.raises(ValueError, match="unknown scheduler"):
        ops.mla_decode_paged(q, pool, bt, [20], scale=0.1, d_v=32, scheduler="grid")
    with pytest.raises(ValueError, match="at least one page column"):
        mp.mla_decode_paged_rows(torch.zeros((1, 2, 64)), pool, torch.zeros((1, 0), dtype=torch.int32),
                                 torch.tensor([0]), torch.zeros((1, 2), dtype=torch.int32), scale=0.1)


# --------------------------------------------------------------------------- #
# PagedDecodeSession against the reference's
# --------------------------------------------------------------------------- #


def _sessions(scheduler, variant, **kw):
    kw = dict(dict(num_pages=10, page_size=32, d_k=128, d_v=64, scale=128 ** -0.5,
                   variant=variant, scheduler=scheduler), **kw)
    return (RefDecodeSession(interpret=True, dtype=jnp.float32, **kw),
            PagedDecodeSession(dtype=torch.float32, device="cpu", **kw))


def _same_step(ref, port, queries, new=None):
    want = ref.step(queries, new)
    got = port.step({r: torch.from_numpy(q) for r, q in queries.items()},
                    None if new is None else {r: torch.from_numpy(x) for r, x in new.items()})
    assert set(got) == set(want)
    for rid in want:
        assert np.abs(got[rid].numpy() - np.asarray(want[rid])).max() <= ATOL, rid
    assert list(port.kv._free) == list(ref.kv._free)
    np.testing.assert_array_equal(port.kv._ref, ref.kv._ref)
    assert port.scheduler_stats == ref.scheduler_stats


@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("scheduler", ["padded", "queue"])
def test_session_admit_evict_fork_matches_reference(pallas_interpret, scheduler, variant):
    ref, port = _sessions(scheduler, variant)
    lat = lambda n, s: bf16ish((n, 128), s)
    g = 4
    for s in (ref, port):
        assert s.admit(lat(50, 1)) == 0 and s.admit(lat(70, 2)) == 1
        assert s.admit(lat(300, 3)) is None  # pool admission control
    _same_step(ref, port, {0: lat(g, 10), 1: lat(g, 11)}, {0: lat(1, 12)[0], 1: lat(1, 13)[0]})
    for s in (ref, port):
        s.evict(0)  # mid-stream eviction frees pages for a queued request
        assert s.admit(lat(60, 4)) == 2
    _same_step(ref, port, {1: lat(g, 14), 2: lat(g, 15)}, {1: lat(1, 16)[0], 2: lat(1, 17)[0]})
    # a forked child with its own suffix (copy-on-write of the boundary
    # page) and a full fork that only reads
    assert ref.admit_with_prefix(1, lat(9, 18), 40) == port.admit_with_prefix(
        1, torch.from_numpy(lat(9, 18)), 40) == 3
    assert ref.fork(2) == port.fork(2) == 4
    qs = {r: lat(g, 20 + r) for r in (1, 2, 3, 4)}
    _same_step(ref, port, qs, {3: lat(1, 30)[0]})
    _same_step(ref, port, qs)
    assert port.kv.seq_len(3) == 50 and port.kv.seq_len(4) == 61
    with pytest.raises(KeyError):
        port.attend({0: torch.from_numpy(lat(g, 1))})


def test_session_step_append_is_atomic():
    sess = PagedDecodeSession(num_pages=3, page_size=4, d_k=16, d_v=8, scale=0.25,
                              dtype=torch.float32, scheduler="padded", device="cpu")
    one = lambda n: torch.ones((n, 16))
    r1, r2 = sess.admit(one(4)), sess.admit(one(8))
    assert sess.kv.num_free_pages == 0
    q = {r1: one(2), r2: one(2)}
    with pytest.raises(OutOfPagesError):
        sess.step(q, {r1: one(1)[0], r2: one(1)[0]})
    assert sess.kv.seq_len(r1) == 4 and sess.kv.seq_len(r2) == 8
    sess.evict(r2)
    out = sess.step({r1: q[r1]}, {r1: one(1)[0]})
    assert sess.kv.seq_len(r1) == 5 and set(out) == {r1}
    assert sess.admit_with_prefix(r1, torch.zeros((0, 16))) == 2  # an empty suffix
