"""The port's shared-prefix decode (K2′, the hetero combine, the prefix
schedule, fork / admit_with_prefix in the sessions) against the JAX
reference.

* ``find_prefix_groups``, ``build_prefix_schedule``, ``hetero_dest_tables``
  and ``prefix_queue_grid_items`` give the reference's arrays on the cases
  of ``tests/test_prefix_sharing.py``; the ``schedule_prefix`` memo hits
  and rebuilds as the reference's does.
* ``ops.mla_decode_paged(prefix_sharing=True)`` is within 2e-3 of the
  reference's call (Pallas kernels in interpret mode) and of the unshared
  call; ``combine_hetero_partials`` within 1e-6 of the reference's.
* The smoke deepseek-v2-mla ``PagedServingSession`` at fp32 compute gives
  the reference session's greedy tokens and deterministic work counters
  for a forked pair (sharing off and on), full-fork twins, and an int8
  cache with a forked prefix (the seeds of
  ``tests/test_paged_model_serve.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.kernels import decode_schedule as ref_sched
from repro.kernels import ops as ref_ops
from repro.kernels.mla_decode_combine import combine_hetero_partials as ref_hetero
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.kv_cache import PagedKVCache as RefCache
from repro.runtime.serve_loop import PagedServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import decode_schedule as sched
from repro_torch.kernels import ops
from repro_torch.kernels.mla_decode_combine import combine_hetero_partials
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import PagedServingSession

PARITY_ATOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``; undone, with
    the traces made under it, after each test."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def bf16ish(shape, seed, scale=0.3):
    x = np.random.default_rng(seed).normal(0, scale, shape)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def fork_family(*, group_size, prefix_len, suffix_lens, page, dk, num_pages, seed=0):
    """A fork family in a reference PagedKVCache (fp32): parent prefix +
    ragged suffixes, the boundary page copied on write when the prefix is
    not page-aligned.  Returns ``(kv, rids)``."""
    kv = RefCache(num_pages=num_pages, page_size=page, width=dk, dtype=jnp.float32)
    kv.alloc(0)
    kv.append(0, bf16ish((prefix_len, dk), seed))
    rids = [0]
    for i in range(1, group_size):
        kv.fork(0, i, prefix_len)
        rids.append(i)
    for i, n in enumerate(suffix_lens):
        if n:
            kv.append(rids[i], bf16ish((n, dk), seed + 100 + i))
    return kv, rids


def mixed_families():
    """Two fork families, a loner and an empty live slot (page 16, dk 64)."""
    kv = RefCache(num_pages=96, page_size=16, width=64, dtype=jnp.float32)
    kv.alloc(0)
    kv.append(0, bf16ish((70, 64), 1))
    kv.fork(0, 1, 70)
    kv.fork(0, 2, 70)
    kv.alloc(3)
    kv.append(3, bf16ish((40, 64), 2))
    kv.fork(3, 4, 40)
    kv.alloc(5)
    kv.append(5, bf16ish((90, 64), 3))
    kv.alloc(6)
    for rid, n in [(0, 11), (1, 0), (2, 40), (3, 9), (4, 33)]:
        if n:
            kv.append(rid, bf16ish((n, 64), 10 + rid))
    return kv, list(range(7))


# (name, factory, block_k, num_splits)
FAMILIES = {
    "g1": (lambda: fork_family(group_size=1, prefix_len=100, suffix_lens=[37], page=32,
                               dk=64, num_pages=16), 64, 1),
    "g4-ragged-cow": (lambda: fork_family(group_size=4, prefix_len=135,
                                          suffix_lens=[20, 55, 3, 0], page=32, dk=64,
                                          num_pages=24), 64, 1),
    "g16-ragged": (lambda: fork_family(group_size=16, prefix_len=130,
                                       suffix_lens=[int(3 + 7 * i) % 60 for i in range(16)],
                                       page=32, dk=64, num_pages=60), 64, 1),
    "split-suffixes": (lambda: fork_family(group_size=4, prefix_len=3 * 32 + 5,
                                           suffix_lens=[200, 90, 17, 0], page=16, dk=64,
                                           num_pages=64), 32, 3),
    "mixed-families": (mixed_families, 32, 1),
    "member-inside-prefix": (lambda: fork_family(group_size=3, prefix_len=64,
                                                 suffix_lens=[10, 0, 0], page=16, dk=64,
                                                 num_pages=32), 32, 1),
}


def _eq_schedule(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a.prefetch_arrays(), b.prefetch_arrays()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.dest_table, b.dest_table)
    np.testing.assert_array_equal(a.n_splits, b.n_splits)
    assert (a.block_k, a.num_splits, a.num_items, a.num_requests) == (
        b.block_k, b.num_splits, b.num_items, b.num_requests)


def _eq_prefix_schedule(want, got):
    _eq_schedule(want.suffix, got.suffix)
    _eq_schedule(want.prefix, got.prefix)
    for f in dataclasses.fields(got.groups):
        x, y = getattr(want.groups, f.name), getattr(got.groups, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name
    np.testing.assert_array_equal(want.start_blocks, got.start_blocks)
    np.testing.assert_array_equal(want.prefix_lens, got.prefix_lens)
    for x, y in zip(want.hetero_dest_tables(), got.hetero_dest_tables()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_prefix_schedule_arrays_match_reference(case):
    factory, block_k, num_splits = FAMILIES[case]
    kv, rids = factory()
    bt, kv_len = kv.block_table(rids)
    for min_group in (2, 3):
        kw = dict(page_size=kv.page_size, block_k=block_k, num_splits=num_splits,
                  min_group=min_group)
        want = ref_sched.build_prefix_schedule(kv_len, bt, **kw)
        got = sched.build_prefix_schedule(kv_len, bt, **kw)
        _eq_prefix_schedule(want, got)
        assert ref_sched.prefix_queue_grid_items(want, kv_len, kv.page_size, query_rows=2) == \
            sched.prefix_queue_grid_items(got, kv_len, kv.page_size, query_rows=2)
        if case == "mixed-families":
            assert got.num_groups == (2 if min_group == 2 else 1)
    # the reference's flat groups all start at block 0
    assert not want.groups.group_start.any()


def test_schedule_prefix_memo_matches_reference():
    kv, rids = fork_family(group_size=4, prefix_len=135, suffix_lens=[20, 55, 3, 0],
                           page=32, dk=64, num_pages=24)
    bt, kv_len = kv.block_table(rids)
    want = ref_sched.DecodeScheduler(block_k=64, num_splits=2, min_group=2)
    got = sched.DecodeScheduler(block_k=64, num_splits=2, min_group=2)
    calls = [
        (kv_len, bt, (0, 1, 2, 3)),
        (kv_len + 1, bt, (0, 1, 2, 3)),  # same block counts: a hit
        (kv_len + 40, bt, (0, 1, 2, 3)),  # a request crosses a block
        (kv_len + 40, bt, (0, 1, 2, 3)),
        (kv_len + 40, bt[::-1].copy(), (3, 2, 1, 0)),  # another live set
    ]
    for lens, table, key in calls:
        a = want.schedule_prefix(lens, table, page_size=32, extra_key=key)
        b = got.schedule_prefix(lens, table, page_size=32, extra_key=key)
        _eq_prefix_schedule(a, b)
        assert (got.hits, got.rebuilds) == (want.hits, want.rebuilds)
    # the plain and prefix memos share the one slot, as in the reference
    want.schedule(kv_len, extra_key=(0,))
    got.schedule(kv_len, extra_key=(0,))
    assert (got.hits, got.rebuilds) == (want.hits, want.rebuilds) == (2, 4)


def test_padded_and_queue_grid_items_match_reference():
    lens = np.asarray([0, 37, 128, 515])
    assert sched.padded_grid_items(lens, 6, 128) == ref_sched.padded_grid_items(lens, 6, 128)
    s, rs = sched.build_schedule(lens, block_k=512), ref_sched.build_schedule(lens, block_k=512)
    assert sched.queue_grid_items(s, lens, 128, query_rows=3) == \
        ref_sched.queue_grid_items(rs, lens, 128, query_rows=3)
    starts = np.asarray([0, 1, 0, 1])
    _eq_schedule(ref_sched.build_schedule(lens, block_k=64, num_splits=2, start_blocks=starts),
                 sched.build_schedule(lens, block_k=64, num_splits=2, start_blocks=starts))


# --------------------------------------------------------------------------- #
# the kernels: group prefix (K2′) + hetero combine (K3)
# --------------------------------------------------------------------------- #


def _decode_pair(kv, rids, *, block_k, num_splits, variant, hq=2, dv=32, seed=50):
    bt, kv_len = kv.block_table(rids)
    q = bf16ish((len(rids), 1, hq, kv.width), seed)
    kw = dict(d_v=dv, variant=variant, scale=1.0 / kv.width ** 0.5, block_k=block_k,
              num_splits=num_splits)
    want = np.asarray(ref_ops.mla_decode_paged(
        jnp.asarray(q), kv.pages, jnp.asarray(bt), jnp.asarray(kv_len),
        prefix_sharing=True, interpret=True, **kw))
    pool = torch.from_numpy(np.array(kv.pages))
    tq, tbt = torch.from_numpy(q), torch.from_numpy(bt)
    shared = ops.mla_decode_paged(tq, pool, tbt, kv_len, prefix_sharing=True, **kw).numpy()
    unshared = ops.mla_decode_paged(tq, pool, tbt, kv_len, **kw).numpy()
    return want, shared, unshared, kv_len


@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("case", ["g1", "g4-ragged-cow", "g16-ragged", "split-suffixes",
                                  "mixed-families"])
def test_prefix_shared_decode_matches_reference(pallas_interpret, case, variant):
    factory, block_k, num_splits = FAMILIES[case]
    kv, rids = factory()
    want, shared, unshared, kv_len = _decode_pair(
        kv, rids, block_k=block_k, num_splits=num_splits, variant=variant)
    assert np.abs(shared - want).max() <= PARITY_ATOL
    assert np.abs(shared - unshared).max() <= PARITY_ATOL
    empty = np.asarray(kv_len) == 0
    assert np.abs(shared[empty]).max(initial=0.0) == 0.0


def test_group_prefix_pads_members_with_exact_zeros():
    """K2′'s plain path: padded member slots finalize to exact zeros with
    lse = -inf; real members equal the queue kernel on the stacked rows."""
    from repro_torch.kernels import mla_decode_paged as mp

    kv, rids = mixed_families()  # groups of 3 and 2 -> gmax 3, one pad slot
    bt, kv_len = kv.block_table(rids)
    ps = sched.build_prefix_schedule(kv_len, bt, page_size=16, block_k=32)
    g = ps.groups
    assert g.gmax == 3 and (g.group_member == -1).sum() == 1
    q = torch.from_numpy(bf16ish((7, 4, 64), 9))
    pos = torch.from_numpy(np.repeat(kv_len[:, None] - 1, 4, 1).astype(np.int32))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    o, lse = mp.mla_decode_paged_group_prefix(
        q, torch.from_numpy(np.array(kv.pages)), t(bt), pos, t(g.group_member),
        t(g.group_rep), t(ps.prefix_lens), *map(t, ps.prefix.prefetch_arrays()),
        d_v=32, scale=0.125, block_k=32, num_dest_slots=ps.prefix.num_dest_slots)
    assert o.shape == (ps.prefix.num_dest_slots * 3, 4, 32)
    pad = 1 * 3 + 2  # group 1, slot 2
    assert o[pad].abs().max() == 0.0 and torch.isneginf(lse[pad]).all()
    live = [0, 1, 2, 3, 4]
    assert torch.isfinite(lse[live]).all() and o[live].abs().max() > 0


def test_combine_hetero_partials_matches_reference(pallas_interpret):
    kv, rids = mixed_families()
    bt, kv_len = kv.block_table(rids)
    ps = sched.build_prefix_schedule(kv_len, bt, page_size=16, block_k=32, num_splits=2)
    dest, n_live = ps.hetero_dest_tables()
    rng = np.random.default_rng(4)
    d_suf, d_pref = ps.suffix.num_dest_slots, ps.prefix.num_dest_slots * ps.groups.gmax
    o = [rng.normal(0, 1, (d, 3, 32)).astype(np.float32) for d in (d_suf, d_pref)]
    lse = [rng.normal(0, 2, (d, 3, 1)).astype(np.float32) for d in (d_suf, d_pref)]
    lse[1][5] = -np.inf  # an empty (padded member) partial
    want = np.asarray(ref_hetero([jnp.asarray(a) for a in o], [jnp.asarray(a) for a in lse],
                                 jnp.asarray(dest), jnp.asarray(n_live), interpret=True))
    got = combine_hetero_partials([torch.from_numpy(a) for a in o],
                                  [torch.from_numpy(a) for a in lse],
                                  torch.from_numpy(dest), torch.from_numpy(n_live)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got[6]).max() == 0.0  # the empty request


def test_ops_rejects_mismatched_schedule_and_partials():
    q = torch.from_numpy(bf16ish((1, 1, 2, 64), 1))
    pool = torch.from_numpy(bf16ish((4, 32, 64), 2))
    bt = torch.zeros((1, 4), dtype=torch.int32)
    plain = sched.build_schedule([40], block_k=32)
    with pytest.raises(ValueError, match="PrefixSchedule"):
        ops.mla_decode_paged(q, pool, bt, [40], d_v=32, scale=0.1, block_k=32,
                             schedule=plain, prefix_sharing=True)
    for kw in (dict(prefix_sharing=True), dict(scheduler="padded")):
        with pytest.raises(ValueError, match="return_partials needs the plain queue"):
            ops.mla_decode_paged(q, pool, bt, [40], d_v=32, scale=0.1, return_partials=True,
                                 **kw)
    with pytest.raises(ValueError, match="prefix_sharing requires scheduler='queue'"):
        ops.mla_decode_paged(q, pool, bt, [40], d_v=32, scale=0.1, scheduler="padded",
                             prefix_sharing=True)


def test_return_partials_is_not_ported():
    """``return_partials`` on the plain queue returns ``(o, lse)``: ``o``
    equal to the call without it, and the per-row lse of the combined
    output (the softmax's normaliser over the request's keys), ``-inf`` for
    an empty request.  Padded and prefix-sharing calls raise the
    reference's ValueError (test_ops_rejects_mismatched_schedule_and_partials)."""
    q = torch.from_numpy(bf16ish((3, 1, 2, 64), 1))
    pool = torch.from_numpy(bf16ish((6, 32, 64), 2))
    bt = torch.tensor([[0, 1, 2], [3, 4, 5], [0, 0, 0]], dtype=torch.int32)
    kw = dict(d_v=32, scale=0.1, block_k=32, num_splits=2, compute_dtype=torch.float32)
    lens = [70, 40, 0]
    want = ops.mla_decode_paged(q, pool, bt, lens, **kw)
    o, lse = ops.mla_decode_paged(q, pool, bt, lens, return_partials=True, **kw)
    assert torch.equal(o, want) and lse.shape == (3, 1, 2)
    for b, n in enumerate(lens[:2]):
        rows = pool[bt[b].long()].reshape(-1, 64)[:n]
        s = (q[b, 0] @ rows.T) * 0.1  # (heads, keys), every key visible at the last row
        assert torch.allclose(lse[b, 0], torch.logsumexp(s, dim=-1), atol=1e-5)
    assert torch.equal(lse[2], torch.full((1, 2), -torch.inf))


# --------------------------------------------------------------------------- #
# the full-model session
# --------------------------------------------------------------------------- #

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16
STATS = ("decode_steps", "request_steps", "page_dmas", "page_dma_bytes", "rows_attended",
         "aliased_pages", "free_pages", "live_pages", "work_units", "prefill_chunks",
         "prefill_stall_steps", "first_tokens", "ttft_units_total", "max_inter_token_units")


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(REF_CFG)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(CFG)
    return (ref_model, ref_params), (model, convert_params(ref_params, CFG, device="cpu"))


def make_pair(models, **kw):
    (ref_model, ref_params), (model, params) = models
    kw = dict(dict(num_pages=48, page_size=PAGE, block_k=BLOCK_K, prefill_chunk=CHUNK), **kw)
    return RefSession(ref_model, ref_params, **kw), PagedServingSession(model, params, **kw)


def assert_same(ref, port, rids):
    for r in rids:
        assert port.outputs[r] == ref.outputs[r], r
    want, got = ref.work_stats(), port.work_stats()
    for k in STATS:
        assert got[k] == want[k], k
    assert port.scheduler_stats == ref.scheduler_stats
    np.testing.assert_array_equal(port.cache._ref, ref.cache._ref)


@pytest.mark.parametrize("prefix_sharing", [False, True])
def test_session_forked_pair_matches_reference(pallas_interpret, models, prefix_sharing):
    rng = np.random.default_rng(2)
    prefix = rng.integers(2, CFG.vocab_size, size=2 * BLOCK_K + 5).tolist()
    suf_a = rng.integers(2, CFG.vocab_size, size=6).tolist()
    suf_b = rng.integers(2, CFG.vocab_size, size=11).tolist()
    ref, port = make_pair(models, prefix_sharing=prefix_sharing)
    for s in (ref, port):
        ra = s.add_request(prefix + suf_a)
        assert s.admit_with_prefix(ra, suf_b, prefix_len=len(prefix)) == 1
        assert s.cache.num_aliased_pages() > 0
    for _ in range(8):
        ref.step()
        port.step()
    assert_same(ref, port, [0, 1])
    if prefix_sharing:
        assert port.page_dmas < port.rows_attended // PAGE


def test_session_full_fork_twins_match_reference(pallas_interpret, models):
    prompt = np.random.default_rng(3).integers(2, CFG.vocab_size, size=20).tolist()
    ref, port = make_pair(models, prefix_sharing=True)
    for s in (ref, port):
        parent = s.add_request(prompt)
        assert s.fork(parent) == 1
        assert s.cache.num_aliased_pages() == len(s.cache.seq_pages(parent))
    for _ in range(4):
        ref.step()
        port.step()
    assert port.outputs[1] == port.outputs[0]
    assert port.cache.seq_pages(1) != port.cache.seq_pages(0)  # the boundary page was copied
    assert_same(ref, port, [0, 1])
    with pytest.raises(ValueError, match="admit_with_prefix"):
        port.fork(0, prefix_len=3)
    with pytest.raises(KeyError):
        port.fork(7)
    assert port.close() == ref.close()


def test_session_int8_forked_prefix_matches_reference(pallas_interpret, models):
    rng = np.random.default_rng(2)
    prefix = rng.integers(2, CFG.vocab_size, size=2 * BLOCK_K + 5).tolist()
    suffix = rng.integers(2, CFG.vocab_size, size=7).tolist()
    ref, port = make_pair(models, kv_dtype="int8", prefix_sharing=True)
    for s in (ref, port):
        ra = s.add_request(prefix)
        assert s.admit_with_prefix(ra, suffix, prefix_len=len(prefix)) == 1
    for _ in range(6):
        ref.step()
        port.step()
    assert_same(ref, port, [0, 1])
    assert port.cache.quantized
    # The latents come out of two frameworks' fp32 layers, equal to a few
    # ulps, so a row's int8 codes may differ by one step where a value sits
    # on a rounding boundary; the pool bytes themselves are held bit-equal
    # on identical rows in tests/test_torch_quantized_cache.py.
    q_ref, q_port = np.asarray(ref.cache.pages, np.int32), port.cache.pages.numpy().astype(np.int32)
    assert np.abs(q_ref - q_port).max() <= 1 and (q_ref != q_port).mean() < 1e-3
    np.testing.assert_allclose(port.cache.scales.numpy(), np.asarray(ref.cache.scales), rtol=1e-5)
