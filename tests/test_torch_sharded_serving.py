"""Sharded paged serving in the port against the JAX reference
(``tests/test_sharded_serving.py`` is the acceptance spec), on the CPU.

* **Units**: ``route_request`` and ``shard_work_balance`` on both
  packages (the reference's cases, then seeded random fleets: the same
  shard every time), ``combine_shard_partials`` / ``combine_partials``
  against a full softmax and the reference (BIG_NEG and ``-inf`` shards
  weigh 0; an all-empty row is exact zeros).
* **return_partials** across two page pools: one request's KV split in
  two, each half attended with ``return_partials=True`` and merged with
  ``combine_shard_partials``, within 2e-3 of one pool holding all of it;
  ``o`` within 2e-3 and ``lse`` within 1e-5 of the reference's where
  finite.  The reference counts a request's last split slot again for
  each padding column of its ``dest_table`` row (fewer blocks than
  ``num_splits``); the port weighs padding 0, so its lse is the
  softmax's normaliser there too (held against a direct logsumexp).
* **Sessions** on the smoke deepseek-v2-mla at fp32 compute with the
  reference's converted weights and numpy-seeded prompts: greedy parity
  through ragged admission, a forked child and an early finish (port
  sharded = reference sharded = port single session), routing and output
  aliasing, fork families on one shard, admission churn, validation, and
  ``work_stats()`` (per shard, balance, ratios) equal to the reference's;
  ``head_shards=2``, speculation and budgeted prefill on the sharded
  session; a ``Mesh`` of CPU entries; the placement helpers, which
  copy no tensor that already lives on its device; ``to_device``; and
  the serve driver's ``--mesh 2x1 --device cpu``.

The reference runs under a function-scoped alias for jax 0.9.0's renamed
``pltpu.TPUMemorySpace``; its jit traces are shared across the module
(cleared at the module's start and end).  The card cases (head chunks bit
for bit, graphed sharded sessions) are in ``test_torch_step_graph_cuda.py``,
which imports no JAX.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.core import distributed as ref_dist
from repro.kernels import decode_schedule as ref_sched
from repro.kernels import ops as ref_ops
from repro.kernels.mla_decode_combine import BIG_NEG
from repro.launch import mesh as ref_mesh
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime import serve_loop as ref_loop
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core import distributed as dist
from repro_torch.core import tree
from repro_torch.kernels import decode_schedule as sched
from repro_torch.kernels import ops
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import elastic, sharding
from repro_torch.runtime import serve_loop as port_loop

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16


@pytest.fixture(scope="module")
def _module_traces():
    """Clear jax's caches when the module starts and ends, so the
    reference's interpret-mode traces are shared within the module only
    (see ``test_torch_fault_tolerance.py``)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def pallas_interpret(monkeypatch, _module_traces):
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(REF_CFG)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(CFG)
    return (ref_model, ref_params), (model, convert_params(ref_params, CFG, device="cpu"))


def _kw(kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("block_k", BLOCK_K)
    kw.setdefault("prefill_chunk", CHUNK)
    return kw


def make_sharded(models, **kw):
    _, (model, params) = models
    kw.setdefault("shards", 2)
    return port_loop.ShardedPagedServingSession(model, params, **_kw(kw))


def make_pair(models, **kw):
    """A reference and a port sharded session on the same weights."""
    (ref_model, ref_params), (model, params) = models
    kw.setdefault("shards", 2)
    kw = _kw(kw)
    return (ref_loop.ShardedPagedServingSession(ref_model, ref_params, **kw),
            port_loop.ShardedPagedServingSession(model, params, **kw))


def prompts_for(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in lengths]


def sweep_all(sess):
    return sum(s.cache.refcount_sweep()["live_pages"] for s in sess.shards)


# --------------------------------------------------------------------------- #
# routing and balance units
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mod", [sched, ref_sched], ids=["port", "reference"])
def test_route_request_reference_cases(mod):
    assert mod.route_request([4, 1, 2], [10, 10, 10], 1) == 1
    assert mod.route_request([2, 2], [3, 9], 1) == 1
    assert mod.route_request([0, 0, 0], [8, 8, 8], 1) == 0
    assert mod.route_request([0, 5], [1, 8], 2) == 1
    assert mod.route_request([1, 1], [1, 1], 2) is None
    assert mod.route_request([], [], 1) is None
    # a masked shard takes nothing; a trie hit lowers the pages needed and
    # wins a tie in live blocks before free pages do
    assert mod.route_request([0, 3], [8, 8], 1, shard_ok=[False, True]) == 1
    assert mod.route_request([2, 2], [9, 3], 4, shard_hit_pages=[0, 2]) == 1
    assert mod.route_request([2, 2], [1, 9], 3, shard_hit_pages=[3, 0]) == 0


def test_route_request_matches_reference_on_random_fleets():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 6))
        blocks = rng.integers(0, 6, n).tolist()
        free = rng.integers(0, 10, n).tolist()
        need = int(rng.integers(0, 8))
        ok = (rng.random(n) < 0.8).tolist() if rng.random() < 0.5 else None
        hits = rng.integers(0, 5, n).tolist() if rng.random() < 0.5 else None
        assert (sched.route_request(blocks, free, need, ok, hits)
                == ref_sched.route_request(blocks, free, need, ok, hits))


@pytest.mark.parametrize("mod", [sched, ref_sched], ids=["port", "reference"])
def test_shard_work_balance_imbalance_proxy(mod):
    even = mod.shard_work_balance([10, 10])
    assert even["imbalance"] == 1.0 and even["total"] == 20.0 and even["max"] == 10.0
    skew = mod.shard_work_balance([30, 10])
    assert skew["imbalance"] == pytest.approx(1.5) and skew["per_shard"] == [30.0, 10.0]
    assert mod.shard_work_balance([])["imbalance"] == 1.0
    assert mod.shard_work_balance([0, 0])["imbalance"] == 1.0
    assert sched.shard_work_balance([7, 3, 0]) == ref_sched.shard_work_balance([7, 3, 0])


# --------------------------------------------------------------------------- #
# cross-shard (o, lse) merge
# --------------------------------------------------------------------------- #


def _partials(z, v, cuts):
    o_parts, lse_parts = [], []
    for lo, hi in zip(cuts, cuts[1:]):
        zi = z[:, lo:hi]
        m = zi.max(-1, keepdims=True)
        p = np.exp(zi - m)
        o_parts.append((p @ v[lo:hi]) / p.sum(-1, keepdims=True))
        lse_parts.append((m + np.log(p.sum(-1, keepdims=True)))[..., 0])
    return np.stack(o_parts), np.stack(lse_parts)


def test_combine_shard_partials_reproduces_full_softmax():
    rng = np.random.default_rng(3)
    g, dv, n = 4, 8, 96
    z = rng.normal(0, 1, (g, n)).astype(np.float32)
    v = rng.normal(0, 1, (n, dv)).astype(np.float32)
    o, lse = _partials(z, v, [0, 40, 96])
    got = dist.combine_shard_partials(torch.from_numpy(o), torch.from_numpy(lse))
    p = np.exp(z - z.max(-1, keepdims=True))
    np.testing.assert_allclose(got.numpy(), (p @ v) / p.sum(-1, keepdims=True), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_dist.combine_shard_partials(o, lse)),
                               atol=1e-6)


@pytest.mark.parametrize("empty", [BIG_NEG, -np.inf], ids=["big_neg", "neg_inf"])
def test_combine_shard_partials_drops_empty_shards(empty):
    rng = np.random.default_rng(4)
    g, dv = 4, 8
    o = rng.normal(0, 1, (3, g, dv)).astype(np.float32)
    lse = rng.normal(0, 1, (3, g)).astype(np.float32)
    o_poison, lse_mask = o.copy(), lse.copy()
    o_poison[1] = 1e9  # an empty shard's payload, whatever it holds
    lse_mask[1] = empty
    got = dist.combine_shard_partials(o_poison, lse_mask)
    want = dist.combine_shard_partials(o[[0, 2]], lse[[0, 2]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    if empty == BIG_NEG:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref_dist.combine_shard_partials(o_poison, lse_mask)),
            atol=1e-6)
    o_poison[1] = np.nan  # not even NaN passes the mask
    assert torch.isfinite(dist.combine_shard_partials(o_poison, lse_mask)).all()
    all_empty = dist.combine_shard_partials(o_poison, np.full((3, g), empty, np.float32))
    assert float(all_empty.abs().max()) == 0.0 and not torch.isnan(all_empty).any()


def test_combine_partials_matches_reference():
    rng = np.random.default_rng(5)
    acc = rng.normal(0, 1, (3, 4, 8)).astype(np.float32)
    m = rng.normal(0, 2, (3, 4)).astype(np.float32)
    l = rng.uniform(0.5, 3, (3, 4)).astype(np.float32)
    l[:, 2] = 0.0  # a row no shard saw: zeros
    got = dist.combine_partials(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_dist.combine_partials(acc, m, l)),
                               atol=1e-6)
    assert float(got[2].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# return_partials across two page pools
# --------------------------------------------------------------------------- #


def _paginate(rows, page):
    """One request's (n, dk) rows -> a private page pool + block table."""
    n, dk = rows.shape
    n_pages = max(-(-n // page), 1)
    pool = np.zeros((n_pages + 1, page, dk), np.float32)  # +1 dummy page
    for j in range(n_pages):
        hi = min((j + 1) * page, n)
        pool[j, : hi - j * page] = rows[j * page : hi]
    return pool, np.arange(n_pages, dtype=np.int32)[None, :]


def test_return_partials_merges_across_two_pools(pallas_interpret):
    rng = np.random.default_rng(5)
    hq, dk, dv, n, cut = 4, 64, 32, 90, 48
    q = rng.normal(0, 0.3, (1, 1, hq, dk)).astype(np.float32)
    c = rng.normal(0, 0.3, (n, dk)).astype(np.float32)
    kw = dict(d_v=dv, scale=1.0 / dk**0.5, block_k=PAGE)
    tq = torch.from_numpy(q)
    pool, bt = _paginate(c, PAGE)
    full = ops.mla_decode_paged(tq, torch.from_numpy(pool), torch.from_numpy(bt), [n],
                                compute_dtype=torch.float32, **kw)
    parts = []
    for lo, hi in ((0, cut), (cut, n)):
        p, b = _paginate(c[lo:hi], PAGE)
        # num_splits=2 so the per-row lse itself comes from a split merge
        got = ops.mla_decode_paged(tq, torch.from_numpy(p), torch.from_numpy(b), [hi - lo],
                                   num_splits=2, return_partials=True,
                                   compute_dtype=torch.float32, **kw)
        want = ref_ops.mla_decode_paged(jnp.asarray(q), jnp.asarray(p), jnp.asarray(b),
                                        jnp.asarray([hi - lo], jnp.int32), num_splits=2,
                                        return_partials=True, interpret=True,
                                        compute_dtype=jnp.float32, **kw)
        assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= 2e-3
        assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1e-5
        parts.append(got)
    merged = dist.combine_shard_partials(torch.stack([o for o, _ in parts]),
                                         torch.stack([lse for _, lse in parts]))
    assert merged.shape == full.shape
    # 2e-3: the split-vs-unsplit parity budget (AMLA's exp2 accumulation
    # reassociates across the partition boundary)
    assert float((merged - full).abs().max()) <= 2e-3


def test_return_partials_lse_weighs_padding_and_empty_requests():
    """A request with fewer blocks than ``num_splits`` pads its
    ``dest_table`` row with its last live slot; the port weighs the padding
    0 (the reference counts that slot again per padding column), so the lse
    is the direct logsumexp of the scores.  An empty request's lse is
    ``-inf`` and its output zeros."""
    rng = np.random.default_rng(6)
    q = rng.normal(0, 0.3, (2, 1, 4, 64)).astype(np.float32)
    pool = rng.normal(0, 0.3, (8, PAGE, 64)).astype(np.float32)
    bt = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    o, lse = ops.mla_decode_paged(torch.from_numpy(q), torch.from_numpy(pool),
                                  torch.from_numpy(bt), [20, 0], d_v=32, scale=0.125,
                                  block_k=PAGE, num_splits=4, return_partials=True,
                                  compute_dtype=torch.float32)
    s = (q[0, 0] @ pool[:2].reshape(-1, 64)[:20].T) * 0.125
    np.testing.assert_allclose(lse[0, 0].numpy(), np.log(np.exp(s).sum(-1)), atol=1e-5)
    assert torch.equal(lse[1], torch.full((1, 4), -math.inf))
    assert float(o[1].abs().max()) == 0.0


def test_return_partials_rejects_non_queue_paths():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(0, 0.3, (1, 1, 4, 64)).astype(np.float32))
    pool, bt = _paginate(rng.normal(0, 0.3, (20, 64)).astype(np.float32), PAGE)
    kw = dict(d_v=32, scale=0.125, return_partials=True)
    for extra in (dict(scheduler="padded"), dict(prefix_sharing=True)):
        with pytest.raises(ValueError, match="queue"):
            ops.mla_decode_paged(q, torch.from_numpy(pool), torch.from_numpy(bt), [20],
                                 **kw, **extra)


# --------------------------------------------------------------------------- #
# the sharded session
# --------------------------------------------------------------------------- #


def churn(sess):
    """Ragged admission, a forked child, an early finish."""
    prompts = prompts_for(0, (5, 16, 9, 23))
    suffix = prompts_for(1, (6,))[0]
    rids = [sess.add_request(p) for p in prompts]
    assert None not in rids
    for _ in range(3):
        sess.step()
    kid = sess.admit_with_prefix(rids[3], suffix, prefix_len=PAGE)
    assert kid is not None
    for _ in range(3):
        sess.step()
    early = sess.finish(rids[1])
    for _ in range(2):
        sess.step()
    work = sess.work_stats()
    return [early] + [sess.finish(r) for r in (rids[0], rids[2], rids[3], kid)], work


@pytest.fixture(scope="module")
def ref_churn(models):
    """The reference's sharded churn run (its streams and work_stats),
    traced once for the module, under the alias."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    try:
        jax.clear_caches()
        (ref_model, ref_params), _ = models
        return churn(ref_loop.ShardedPagedServingSession(
            ref_model, ref_params, shards=2, **_kw({})))
    finally:
        mp.undo()


def test_sharded_greedy_parity_with_churn(models, ref_churn):
    """Port sharded = reference sharded = port single session, token for
    token; ``work_stats()`` equal to the reference's (per shard and
    balance included)."""
    (_, _), (model, params) = models
    got, work = churn(make_sharded(models))
    single, _ = churn(port_loop.PagedServingSession(model, params, **_kw({})))
    assert got == ref_churn[0] == single
    assert work == ref_churn[1]
    assert len(work["per_shard"]) == 2 and work["balance"]["imbalance"] >= 1.0


def test_sharded_head_chunks_match_reference(models, ref_churn):
    """``head_shards=2`` (two K2 + K3 calls a layer, over half the heads
    each) serves the same tokens and work as the reference's unchunked
    sharded session."""
    sess = make_sharded(models, head_shards=2)
    assert sess.head_shards == 2 and all(s.head_shards == 2 for s in sess.shards)
    got, work = churn(sess)
    assert got == ref_churn[0] and work == ref_churn[1]


def test_sharded_routing_spreads_and_outputs_alias(models):
    sess = make_sharded(models)
    pa, pb = prompts_for(2, (20, 12))
    ra, rb = sess.add_request(pa), sess.add_request(pb)
    # an empty fleet fills deterministically: shard 0 first, then the idle 1
    assert sess.shard_of(ra) == 0 and sess.shard_of(rb) == 1
    sess.step()
    # the outputs view is the shard session's own list
    assert sess.outputs[ra] is sess.shards[0].outputs[sess._where[ra][1]]
    assert len(sess.outputs[ra]) == 2  # prefill token + 1 step


def test_sharded_fork_family_stays_on_one_shard(models):
    sess = make_sharded(models)
    filler, parent_p = prompts_for(3, (8, 2 * PAGE + 5))
    sess.add_request(filler)  # occupies shard 0
    parent = sess.add_request(parent_p)  # routed to the idle shard 1
    home = sess.shard_of(parent)
    assert home == 1
    kids = [sess.admit_with_prefix(parent, s, prefix_len=PAGE) for s in prompts_for(4, (4, 7))]
    twin = sess.fork(parent)
    assert {sess.shard_of(r) for r in kids + [twin]} == {home}
    per_shard = [s.cache.num_aliased_pages() for s in sess.shards]
    assert per_shard[home] > 0 and sum(per_shard) == per_shard[home]


def test_sharded_admission_eviction_churn(models):
    sess = make_sharded(models, num_pages=4)
    pa, pb, pc = prompts_for(5, (20, 20, 20))
    ra, rb = sess.add_request(pa), sess.add_request(pb)
    assert sess.shard_of(ra) != sess.shard_of(rb)
    assert sess.add_request(pc) is None  # both pools lack 2 free pages
    assert sess.finish(ra)
    frees = [s.cache.num_free_pages for s in sess.shards]
    assert frees[sess.shard_of(rb)] < max(frees)  # only ra's shard drained
    rc = sess.add_request(pc)
    assert rc is not None and sess.shard_of(rc) != sess.shard_of(rb)


def test_sharded_add_request_and_constructor_validation(models):
    sess = make_sharded(models, num_pages=8, max_batch=2)
    with pytest.raises(ValueError, match="at least one prompt token"):
        sess.add_request([])
    with pytest.raises(ValueError, match="ONE shard"):
        sess.add_request(prompts_for(6, (4 * PAGE + 1,))[0])
    pa, pb, pc = prompts_for(6, (6, 6, 6))
    assert sess.add_request(pa) is not None and sess.add_request(pb) is not None
    assert sess.add_request(pc) is None  # global max_batch, pages to spare
    (_, _), (model, params) = models
    with pytest.raises(ValueError, match="not both"):
        port_loop.ShardedPagedServingSession(model, params, num_pages=8, mesh=object(),
                                             shards=2)
    with pytest.raises(ValueError, match="split evenly"):
        make_sharded(models, num_pages=9)
    with pytest.raises(ValueError, match="must divide"):
        make_sharded(models, head_shards=3)


def test_sharded_work_stats_aggregate(pallas_interpret, models):
    ref, port = make_pair(models)
    for sess in (ref, port):
        for p in prompts_for(7, (10, 18, 7)):
            assert sess.add_request(p) is not None
        for _ in range(4):
            sess.step()
    work = port.work_stats()
    assert work == ref.work_stats()
    for key in ("page_dmas", "rows_attended", "decode_steps"):
        assert work[key] == sum(st[key] for st in work["per_shard"])
    assert work["balance"]["imbalance"] >= 1.0
    stats = port.scheduler_stats
    assert stats == ref.scheduler_stats and stats["hits"] + stats["rebuilds"] >= 4
    assert port.prefill_compiles == ref.prefill_compiles == 1
    assert port.graph_captures == 0  # graphs are captured on a card only
    assert port.close() == ref.close()


def test_speculative_sharded_matches_single_host_and_reference(pallas_interpret, models):
    """Speculation is shard-local: the sharded stream equals one session's
    step for step and the reference's sharded one; ratios recompute from
    the summed counters."""
    (_, _), (model, params) = models
    prompts = prompts_for(3, (8, 10, 12))
    kw = dict(speculate="ngram", draft_k=3)
    single = port_loop.PagedServingSession(model, params, **_kw(dict(kw)))
    ref, port = make_pair(models, **kw)
    r_single = [single.add_request(p) for p in prompts]
    r_ref = [ref.add_request(p) for p in prompts]
    r_port = [port.add_request(p) for p in prompts]
    for _ in range(8):
        for s in (single, ref, port):
            s.step()
    for a, b, c in zip(r_single, r_ref, r_port):
        assert single.outputs[a] == ref.outputs[b] == port.outputs[c]
    agg = port.work_stats()
    assert agg == ref.work_stats()
    assert agg["accepted_tokens"] == sum(st["accepted_tokens"] for st in agg["per_shard"])
    assert agg["accepted_tokens_per_step"] == agg["accepted_tokens"] / agg["request_steps"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_interleaved_matches_phased_sharded(pallas_interpret, models, kv_dtype):
    """Budgeted prefill on the sharded session gives the phased streams,
    and the reference's phased sharded streams; no page leaks."""
    (ref_model, ref_params), _ = models
    prompts = prompts_for(4, (40, 8, 23, 70, 12))
    gen = 4

    def drain(sess):
        rids = [sess.add_request(p) for p in prompts]
        for _ in range(400):
            if all(len(sess.outputs[r]) > gen for r in rids):
                break
            sess.step()
        out = [sess.finish(r)[: gen + 1] for r in rids]
        assert sweep_all(sess) == 0
        sess.close()
        return out

    want = drain(ref_loop.ShardedPagedServingSession(
        ref_model, ref_params, shards=2, kv_dtype=kv_dtype, **_kw({})))
    for budget in (None, 3 * CHUNK):
        assert drain(make_sharded(models, prefill_budget=budget, kv_dtype=kv_dtype)) == want


def test_sharded_trie_routing_probes_read_only(models):
    """Routing probes every shard's trie without touching its LRU or its
    hit counts: only the admitting shard counts a hit, and a shard whose
    trie holds the template wins a tie in live blocks."""
    sess = make_sharded(models, prefix_cache="trie")
    template = prompts_for(8, (2 * BLOCK_K,))[0]
    first = sess.add_request(template + prompts_for(9, (5,))[0])
    home = sess.shard_of(first)
    sess.finish(first)  # the template stays retained on its shard
    stats = [s.trie.stats() for s in sess.shards]
    second = sess.add_request(template + prompts_for(10, (7,))[0])
    assert sess.shard_of(second) == home
    after = [s.trie.stats() for s in sess.shards]
    assert after[1 - home] == stats[1 - home]  # the other trie was probed read-only
    assert after[home]["hits"] == stats[home]["hits"] + 1
    assert sess.work_stats()["trie_hits"] == 1


# --------------------------------------------------------------------------- #
# mesh, placement, to_device, the serve driver
# --------------------------------------------------------------------------- #


def test_parse_mesh_spec_matches_reference():
    for spec in ("2x1", "4x2", "1X1"):
        assert port_mesh.parse_mesh_spec(spec) == ref_mesh.parse_mesh_spec(spec)
    for bad in ("2", "0x1", "axb", "2x1x1", "-1x2"):
        for mod in (port_mesh, ref_mesh):
            with pytest.raises(ValueError, match="bad mesh spec"):
                mod.parse_mesh_spec(bad)


def test_serving_mesh_on_the_cpu_and_its_shard_devices():
    mesh = port_mesh.make_serving_mesh("2x2", "cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert sharding.serving_shard_devices(mesh) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs a mesh"):
        sharding.serving_shard_devices(None)
    with pytest.raises(ValueError, match="lack 'data'"):
        sharding.serving_shard_devices(port_mesh.Mesh(mesh.devices, ("x", "model")))


def test_mesh_session_places_shards_and_chunks_heads(models, ref_churn):
    """A 2x2 CPU mesh: two data shards with 2-way head chunks, on the
    parameters' own tensors; the reference's streams and work."""
    (_, _), (model, params) = models
    sess = port_loop.ShardedPagedServingSession(
        model, params, mesh=port_mesh.make_serving_mesh("2x2", "cpu"), **_kw({}))
    assert sess.num_shards == 2 and sess.head_shards == 2
    for s in sess.shards:
        assert s.cache.device == torch.device("cpu")
        assert all(a is b for a, b in zip(tree.leaves(s.params), tree.leaves(params), strict=True))
    got, work = churn(sess)
    assert got == ref_churn[0] and work == ref_churn[1]


def test_placement_copies_nothing_already_in_place(models):
    (_, _), (_, params) = models
    assert elastic.serving_params_replica(params) is params
    assert sharding.shard_put(params, None) is params
    same = elastic.serving_params_replica(params, "cpu")
    for a, b in zip(tree.leaves(params), tree.leaves(same), strict=True):
        assert a is b
    moved = sharding.shard_put({"w": torch.ones(3)}, "meta")
    assert moved["w"].device.type == "meta"


def test_attach_shard_shares_the_parameters(models):
    sess = make_sharded(models)
    idx = sess.attach_shard()
    assert sess.shards[idx].params is sess.shards[0].params is sess._params


def test_to_device_moves_pools_and_drops_graphs(models):
    """``to_device`` is a no-op where the pool lives; a move (here to the
    meta device) moves the pool and the scales, keeps the bookkeeping, and
    the session's step drops its staged graph tensors before its next
    step (they hold the old addresses)."""
    (_, _), (model, params) = models
    sess = port_loop.PagedServingSession(model, params, kv_dtype="int8", **_kw({}))
    cache = sess.cache
    pages, scales = cache.pages, cache.scales
    assert cache.to_device(None) is cache and cache.to_device("cpu") is cache
    assert cache.pages is pages and cache.scales is scales
    rid = sess.add_request(prompts_for(11, (20,))[0])
    sess.step()
    staged = sess.step_graph._staged
    assert staged
    free, ref = list(cache._free), cache._ref.copy()
    cache.to_device("meta")
    assert cache.pages.device.type == "meta" and cache.scales.device.type == "meta"
    assert cache.device.type == "meta" and cache.seq_len(rid) == 21
    assert list(cache._free) == free and np.array_equal(cache._ref, ref)
    with pytest.raises((NotImplementedError, RuntimeError)):
        sess.step()  # the walk reads meta pages: no data to decode from
    assert sess.step_graph._staged is not staged
    assert sess.step_graph.graphs.device.type == "meta"


def test_serve_driver_mesh_backend(capsys):
    serve.main(["--cache", "paged", "--smoke", "--mesh", "2x1", "--requests", "2",
                "--gen-len", "3", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sharded over 2x1" in out and "served 2 requests" in out
    assert "mesh 2x1: 2 data shards x 1-way heads, 32 pages per shard pool" in out
    assert "shard work balance" in out and "teardown sweep: 64 pages free" in out


def test_serve_driver_mesh_requires_paged():
    with pytest.raises(SystemExit, match="--mesh needs --cache paged"):
        serve.main(["--mesh", "2x1", "--smoke", "--device", "cpu"])
