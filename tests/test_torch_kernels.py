"""The port's paged decode path (repro_torch.kernels) against the JAX
reference.

On the CPU the port's queue kernel (K2) and split-KV combine (K3) run
their plain PyTorch versions; they are held against the reference's
``ops.mla_decode_paged`` (its Pallas kernels in interpret mode, fp32
compute) and the pure-jnp oracle ``kernels/ref.mla_decode_ref`` at 2e-3 —
the reference's own fp32 tolerance for AMLA, whose int32 rescale
approximates the multiply by ``1 + eps`` (paper App. A).  Same inputs from
seeded numpy; ragged, non-page-aligned and fragmented tables, 1/2/4
splits, explicit positions, empty slots, both rescale variants.

The CUDA kernels themselves are held against these plain versions on a
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import decode_schedule as ref_sched
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels.mla_decode_combine import combine_split_partials as ref_combine
from repro.kernels.mla_decode_paged import clamp_tail_pages as ref_clamp
from repro_torch.kernels import decode_schedule as sched
from repro_torch.kernels import mla_decode_combine as port_combine
from repro_torch.kernels import mla_decode_paged as port_paged
from repro_torch.kernels import ops

ATOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.  The alias
    is undone after each test, and so are the jit traces made under it:
    a cached trace would let a later reference test of the same shapes
    skip the lookup that fails without the alias, and so change its
    outcome."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def bf16ish(shape, seed, scale=0.3):
    x = np.random.default_rng(seed).normal(0, scale, shape)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def paginate(c, kv_lens, page, *, num_pages, shuffle_seed=None):
    """Scatter contiguous (B, S, Dk) latents into a pool + block tables;
    with ``shuffle_seed`` the placement is a random permutation."""
    b, _, dk = c.shape
    w = max(max(-(-int(l) // page) for l in kv_lens), 1)
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
    # (b, sq, hq, dk, dv, page, block_k, kv_lens)
    pytest.param(3, 1, 4, 80, 64, 16, 32, [37, 5, 70], id="ragged-unaligned"),
    pytest.param(4, 1, 4, 128, 64, 32, 64, [7 * 64 + 13, 37, 0, 3 * 64], id="long-short-empty"),
    pytest.param(2, 3, 4, 80, 64, 16, 64, [129, 48], id="three-rows-per-request"),
]


@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("num_splits", [1, 2, 4])
@pytest.mark.parametrize("b,sq,hq,dk,dv,page,block_k,kv_lens", CASES)
def test_ops_matches_reference_and_oracle(
    pallas_interpret, b, sq, hq, dk, dv, page, block_k, kv_lens, num_splits, variant
):
    c = bf16ish((b, max(kv_lens), dk), 2)
    q = bf16ish((b, sq, hq, dk), 1)
    pool, bt = paginate(c, kv_lens, page, num_pages=sum(-(-l // page) for l in kv_lens) + 3,
                        shuffle_seed=7)
    scale = 1.0 / math.sqrt(dk)
    kv = np.asarray(kv_lens, np.int32)
    kw = dict(d_v=dv, variant=variant, scale=scale, block_k=block_k, num_splits=num_splits)
    want = np.asarray(ref_ops.mla_decode_paged(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(kv),
        interpret=True, compute_dtype=jnp.float32, **kw))
    got = ops.mla_decode_paged(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(bt),
        torch.from_numpy(kv), compute_dtype=torch.float32, **kw).numpy()
    assert got.shape == want.shape == (b, sq, hq, dv)
    assert np.abs(got - want).max() <= ATOL
    # the oracle: rows (Sq, Hq) flattened, each head at its token's position
    pos = np.maximum(kv - sq, 0)[:, None] + np.arange(sq)[None, :]
    oracle = np.asarray(ref_oracle.mla_decode_ref(
        jnp.asarray(q.reshape(b, sq * hq, dk)), jnp.asarray(c), jnp.asarray(kv),
        jnp.asarray(np.repeat(pos, hq, axis=1)), d_v=dv, scale=scale))
    assert np.abs(got - oracle.reshape(b, sq, hq, dv)).max() <= ATOL
    for r, l in enumerate(kv_lens):
        if l == 0:  # an empty slot is exactly zero through split + combine
            assert np.abs(got[r]).max() == 0.0


@pytest.mark.parametrize("variant", ["amla", "base"])
def test_q_positions_and_q_offset_match_reference(pallas_interpret, variant):
    b, sq, hq, dk, dv, page, block_k = 2, 3, 4, 80, 64, 16, 32
    kv_lens = [90, 41]
    c = bf16ish((b, max(kv_lens), dk), 4)
    q = bf16ish((b, sq, hq, dk), 5)
    pool, bt = paginate(c, kv_lens, page, num_pages=12, shuffle_seed=3)
    kv = np.asarray(kv_lens, np.int32)
    qpos = np.asarray([[40, 61, 89], [0, 17, 40]], np.int32)
    qoff = np.asarray([10, 3], np.int32)
    kw = dict(d_v=dv, variant=variant, scale=0.11, block_k=block_k, num_splits=2)
    J = lambda a: jnp.asarray(a)
    T = torch.from_numpy
    for extra_ref, extra_port in (
        (dict(q_positions=qpos), dict(q_positions=T(qpos))),
        (dict(q_offset=J(qoff)), dict(q_offset=T(qoff))),
        (dict(causal=False), dict(causal=False)),
    ):
        want = np.asarray(ref_ops.mla_decode_paged(
            J(q), J(pool), J(bt), J(kv), interpret=True, compute_dtype=jnp.float32,
            **kw, **extra_ref))
        got = ops.mla_decode_paged(T(q), T(pool), T(bt), T(kv),
                                   compute_dtype=torch.float32, **kw, **extra_port).numpy()
        assert np.abs(got - want).max() <= ATOL


def test_fragmented_table_equals_linear_one():
    """Physical placement is invisible: a shuffled pool gives the same
    output as a linear one, to the bit (same arithmetic, same order)."""
    b, hq, dk, dv, page, block_k, kv_lens = 3, 4, 80, 64, 16, 32, [100, 3, 64]
    c = bf16ish((b, max(kv_lens), dk), 8)
    q = torch.from_numpy(bf16ish((b, 1, hq, dk), 9))
    outs = []
    for seed in (None, 11):
        pool, bt = paginate(c, kv_lens, page, num_pages=16, shuffle_seed=seed)
        outs.append(ops.mla_decode_paged(
            q, torch.from_numpy(pool), torch.from_numpy(bt),
            np.asarray(kv_lens, np.int32), d_v=dv, scale=0.1, block_k=block_k,
            num_splits=2, compute_dtype=torch.float32))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("num_splits", [1, 2, 3])
@pytest.mark.parametrize("block_k", [32, 512])
def test_schedule_arrays_equal_reference(num_splits, block_k):
    kv_lens = [0, 1, 31, 32, 33, 511, 512, 513, 4096, 1100]
    a = sched.build_schedule(kv_lens, block_k=block_k, num_splits=num_splits)
    r = ref_sched.build_schedule(kv_lens, block_k=block_k, num_splits=num_splits)
    for x, y in zip(a.prefetch_arrays(), r.prefetch_arrays()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.dest_table, r.dest_table)
    np.testing.assert_array_equal(a.n_splits, r.n_splits)
    assert (a.num_dest_slots, a.num_items, a.queue_len) == (
        r.num_dest_slots, r.num_items, r.queue_len)
    assert sched.queue_grid_items(a, kv_lens, 16) == ref_sched.queue_grid_items(r, kv_lens, 16)


def test_scheduler_memoizes_like_reference():
    ours = sched.DecodeScheduler(block_k=32, num_splits=2)
    theirs = ref_sched.DecodeScheduler(block_k=32, num_splits=2)
    for lens, key in (([5, 40], (0, 1)), ([6, 41], (0, 1)), ([6, 64], (0, 1)),
                      ([6, 65], (0, 1)), ([6, 65], (0, 2))):
        ours.schedule(lens, extra_key=key)
        theirs.schedule(lens, extra_key=key)
        assert (ours.hits, ours.rebuilds) == (theirs.hits, theirs.rebuilds)


def test_clamp_tail_pages_equals_reference():
    rng = np.random.default_rng(0)
    bt = rng.integers(0, 40, (5, 6)).astype(np.int32)
    kv = np.asarray([0, 1, 16, 17, 96], np.int32)
    want = np.asarray(ref_clamp(jnp.asarray(bt), jnp.asarray(kv), 16, 30))
    got = port_paged.clamp_tail_pages(torch.from_numpy(bt), torch.from_numpy(kv), 16, 30)
    np.testing.assert_array_equal(got.numpy(), want)


def test_combine_matches_reference(pallas_interpret):
    """K3 alone on hand-built partials, including an empty partial
    (lse = -inf) and a request with no live split."""
    rng = np.random.default_rng(1)
    d, g, dv = 7, 5, 64
    o = rng.normal(0, 1, (d, g, dv)).astype(np.float32)
    lse = rng.normal(0, 2, (d, g, 1)).astype(np.float32)
    lse[2, 1] = -np.inf
    dest = np.asarray([[0, 1, 2], [3, 3, 3], [4, 5, 5]], np.int32)
    n_splits = np.asarray([3, 0, 2], np.int32)
    want = np.asarray(ref_combine(jnp.asarray(o), jnp.asarray(lse), jnp.asarray(dest),
                                  jnp.asarray(n_splits), interpret=True))
    got = port_combine.combine_split_partials(
        torch.from_numpy(o), torch.from_numpy(lse), torch.from_numpy(dest),
        torch.from_numpy(n_splits)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got[1]).max() == 0.0


def test_default_block_k_and_validation_match_reference():
    for page, w in ((128, 32), (128, 2), (16, 48), (600, 4)):
        assert ops.default_paged_block_k(page, w) == ref_ops.default_paged_block_k(page, w)
    q = torch.zeros((2, 1, 4, 80))
    pool = torch.zeros((8, 16, 80))
    bt = torch.zeros((2, 2), dtype=torch.int32)
    kv = np.asarray([20, 33], np.int32)
    jq, jpool, jbt = jnp.zeros((2, 1, 4, 80)), jnp.zeros((8, 16, 80)), jnp.zeros((2, 2), jnp.int32)
    bad = [
        (dict(kv_len=kv), "exceeds the block table's reach"),
        (dict(kv_len=np.asarray([20, 30], np.int32), block_k=24), "positive multiple"),
    ]
    for kw, msg in bad:
        kv_len = kw.pop("kv_len")
        with pytest.raises(ValueError, match=msg):
            ref_ops._validate_paged_geometry(jq, jpool, jbt, jnp.asarray(kv_len), kw.get("block_k"))
        with pytest.raises(ValueError, match=msg):
            ops.mla_decode_paged(q, pool, bt, kv_len, scale=0.1, **kw)
    with pytest.raises(ValueError, match="q feature width"):
        ops.mla_decode_paged(torch.zeros((2, 1, 4, 64)), pool, bt, [3, 4], scale=0.1)
    with pytest.raises(ValueError, match="block_tables must be"):
        ops.mla_decode_paged(q, pool, bt[:1], [3, 4], scale=0.1)
    kv2 = np.asarray([20, 30], np.int32)
    for qp, msg in ((np.asarray([[3], [31]]), "kv_len"), (np.asarray([[-1], [3]]), "non-negative"),
                    (np.asarray([[1, 2], [3, 4]]), "must be")):
        with pytest.raises(ValueError, match=msg):
            ops.mla_decode_paged(q, pool, bt, kv2, scale=0.1, q_positions=qp)
    with pytest.raises(ValueError, match="not both"):
        ops.mla_decode_paged(q, pool, bt, kv2, scale=0.1, q_positions=np.asarray([[3], [4]]),
                             q_offset=np.asarray([0, 0]))


@pytest.mark.parametrize("kw,exc,match", [
    # the padded grid derives positions from kv_len (the reference's error)
    (dict(scheduler="padded", q_positions=np.asarray([[4]])), NotImplementedError,
     "implemented for scheduler='queue'"),
    # the padded grid has no dequant path
    (dict(scheduler="padded", int8=True), ValueError, "does not support int8 pages"),
    # prefix sharing merges heterogeneous partials: no per-row lse
    (dict(prefix_sharing=True, return_partials=True), ValueError,
     "return_partials needs the plain queue scheduler"),
    (dict(scheduler="padded", prefix_sharing=True), ValueError,
     "prefix_sharing requires scheduler='queue'"),
], ids=["kw0", "kw1", "kw2", "kw3"])
def test_later_slices_raise_not_implemented(kw, exc, match):
    """The rejections that remain now that int8 pages, prefix sharing and
    the padded grid are ported: the reference's errors, with its classes
    and messages (the session-level features still to port raise
    ``NotImplementedError``, see test_torch_serve.py)."""
    int8 = kw.pop("int8", False)
    pool = torch.zeros((8, 16, 80), dtype=torch.int8 if int8 else torch.float32)
    extra = dict(kv_scales=torch.zeros((8, 16))) if int8 else {}
    with pytest.raises(exc, match=match):
        ops.mla_decode_paged(torch.zeros((1, 1, 4, 80)), pool,
                             torch.zeros((1, 2), dtype=torch.int32), [5], scale=0.1,
                             **extra, **kw)
    jextra = dict(kv_scales=jnp.zeros((8, 16))) if int8 else {}
    with pytest.raises(exc, match=match):
        ref_ops.mla_decode_paged(
            jnp.zeros((1, 1, 4, 80)), jnp.zeros((8, 16, 80), jnp.int8 if int8 else jnp.float32),
            jnp.zeros((1, 2), jnp.int32), jnp.asarray([5]), scale=0.1, interpret=True,
            **jextra, **kw)
