"""The port's token-budgeted prefill interleaving and SLA scheduling
against the JAX reference (``tests/test_interleaved_prefill.py`` is the
acceptance spec; its sharded case waits for the port's sharded sessions).

* **Planners**: ``plan_prefill_slices``, ``admission_order`` and
  ``latency_percentile`` give the reference's results on the reference's
  cases and on hypothesis-drawn inputs.
* **Sessions**: the smoke deepseek-v2-mla at fp32 compute with converted
  weights, the same numpy-seeded prompts through a reference session and
  a port session: interleaved (``prefill_budget``) and phased token
  streams, ``work_stats()`` as whole dicts, free lists and refcounts are
  equal, and interleaved equals phased.
* **Supervisor**: ``ServeSupervisor`` over both sessions gives the same
  results, ``stats()`` (``straggler_events`` aside: it reads the host
  clock) and ``latency_records()``, and the reference's own properties
  (skip-ahead, priority order, a deadline expiring mid-prefill, SLA
  victim selection) hold on the port.
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.kernels import decode_schedule as ref_sched
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime import serve_loop as ref_loop
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import decode_schedule as sched
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import serve_loop as port_loop

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16
BUDGET = 3 * CHUNK


@pytest.fixture(scope="module")
def _module_traces():
    """Clear jax's caches when the module starts and when it ends.  At the
    start: a reference kernel that failed to trace earlier in the process
    (without the alias below) leaves cache entries that make every later
    call of it trace and compile again.  At the end: a cached trace made
    under the alias would let a later reference test of the same shapes
    skip the lookup that fails without it.  Every test here that traces a
    reference kernel takes the alias, so within the module the traces are
    shared (the interpret-mode compiles are most of its time)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def pallas_interpret(monkeypatch, _module_traces):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``; undone after
    each test, the traces made under it when the module ends."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(REF_CFG)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(CFG)
    return (ref_model, ref_params), (model, convert_params(ref_params, CFG, device="cpu"))


def make_pair(models, **kw):
    """A reference session and a port session on the same weights."""
    (ref_model, ref_params), (model, params) = models
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("block_k", BLOCK_K)
    kw.setdefault("prefill_chunk", CHUNK)
    return (ref_loop.PagedServingSession(ref_model, ref_params, **kw),
            port_loop.PagedServingSession(model, params, **kw))


def prompts_for(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in lengths]


def pool_state(sess):
    """The free list (in order) and every page's refcount."""
    return list(sess.cache._free), sess.cache._ref.tolist()


def drain(sess, rids, gen_len, limit=400):
    """Step until every rid holds gen_len + 1 tokens; the outputs cut to
    that horizon."""
    for _ in range(limit):
        if all(len(sess.outputs[r]) > gen_len for r in rids):
            break
        sess.step()
    else:
        raise AssertionError("drain() did not converge")
    return {r: sess.finish(r)[: gen_len + 1] for r in rids}


def supervised(sess, subs, **kw):
    """``subs`` = [(prompt, submit kwargs)] through ServeSupervisor(sess);
    returns what the two packages must agree on and the supervisor."""
    sup = (port_loop if isinstance(sess, port_loop.PagedServingSession)
           else ref_loop).ServeSupervisor(sess, **kw)
    for p, skw in subs:
        sup.submit(p, **skw)
    results = sup.run()
    stats = sup.stats()
    stats.pop("straggler_events")
    out = (results, stats, sup.latency_records(), sorted(sup.abandoned_idx), pool_state(sess),
           sess.work_stats())
    assert sess.cache.refcount_sweep()["live_pages"] == 0
    sess.close()
    return out, sup


# --------------------------------------------------------------------------- #
# planners
# --------------------------------------------------------------------------- #


def test_planners_reference_cases():
    for plan in (sched.plan_prefill_slices, ref_sched.plan_prefill_slices):
        assert plan([64, 32], 48, 16) == [16, 32]
        assert plan([320, 16], 16, 16) == [16, 0]
        assert plan([10], 48, 16) == [10] and plan([40], 48, 16) == [40]
        assert plan([100], 40, 16) == [32]
        assert plan([64, 32], 0, 16) == [0, 0] and plan([], 64, 16) == []
        for bad in (([16], -1, 16), ([16], 16, 0)):
            with pytest.raises(ValueError):
                plan(*bad)
    for order in (sched.admission_order, ref_sched.admission_order):
        assert order([(0, 0, None), (1, 2, None), (2, 1, 5.0)]) == [1, 2, 0]
        assert order([(0, 1, None), (1, 1, 3.0), (2, 1, 1.0)]) == [2, 1, 0]
        assert order([(5, 0, None), (3, 0, None)]) == [3, 5]
    for pct in (port_loop.latency_percentile, ref_loop.latency_percentile):
        assert pct([4, 1, 3, 2], 50) == 2 and pct([4, 1, 3, 2], 99) == 4
        assert pct([7], 50) == 7 and pct([], 99) == 0.0
        with pytest.raises(ValueError):
            pct([1], 101)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), budget=st.integers(0, 300), chunk=st.integers(1, 64))
def test_plan_prefill_slices_matches_reference(seed, budget, chunk):
    rng = np.random.default_rng(seed)
    remaining = rng.integers(0, 400, size=int(rng.integers(0, 7))).tolist()
    got = sched.plan_prefill_slices(remaining, budget, chunk)
    assert got == ref_sched.plan_prefill_slices(remaining, budget, chunk)
    assert sum(got) <= budget and all(0 <= g <= r for g, r in zip(got, remaining))
    # every slice but a prompt's final tail is chunk-aligned
    assert all(g % chunk == 0 or g == r for g, r in zip(got, remaining))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), q=st.integers(0, 100))
def test_admission_order_and_percentile_match_reference(seed, q):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 9))
    items = [(int(i), int(rng.integers(0, 3)),
              None if rng.random() < 0.3 else float(rng.integers(0, 5))) for i in rng.permutation(n)]
    assert sched.admission_order(items) == ref_sched.admission_order(items)
    samples = rng.integers(0, 50, size=n).tolist()
    assert port_loop.latency_percentile(samples, q) == ref_loop.latency_percentile(samples, q)


def test_prefill_budget_validation(models):
    (ref_model, ref_params), (model, params) = models
    for cls, m, p in ((ref_loop.PagedServingSession, ref_model, ref_params),
                      (port_loop.PagedServingSession, model, params)):
        with pytest.raises(ValueError, match="prefill_budget"):
            cls(m, p, num_pages=8, page_size=PAGE, block_k=BLOCK_K, prefill_chunk=CHUNK,
                prefill_budget=CHUNK - 1)


# --------------------------------------------------------------------------- #
# interleaved-vs-phased greedy parity
# --------------------------------------------------------------------------- #

LENGTHS = [70, 9, 24, 40]
GEN = 4


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_interleaved_matches_phased_single_host(pallas_interpret, models, kv_dtype):
    prompts = prompts_for(3, LENGTHS)
    outs = {}
    for budget in (None, BUDGET):
        got = []
        for sess in make_pair(models, prefill_budget=budget, kv_dtype=kv_dtype):
            rids = [sess.add_request(p) for p in prompts]
            got.append((drain(sess, rids, GEN), sess.work_stats(), pool_state(sess)))
            assert sess.cache.refcount_sweep()["live_pages"] == 0
            sess.close()
        assert got[1] == got[0], budget  # tokens, work_stats, pool: port == reference
        outs[budget] = list(got[1][0].values())
    assert outs[None] == outs[BUDGET]


def test_interleaved_matches_phased_with_trie(pallas_interpret, models):
    rng = np.random.default_rng(5)
    template = rng.integers(2, CFG.vocab_size, size=2 * BLOCK_K).tolist()
    prompts = [template + rng.integers(2, CFG.vocab_size, size=5 + 7 * i).tolist()
               for i in range(4)]
    outs, hits = {}, {}
    for budget in (None, BUDGET):
        got = []
        for sess in make_pair(models, prefill_budget=budget, prefix_cache="trie"):
            rids = []
            for p in prompts:  # staggered: later prompts hit the retained template
                rids.append(sess.add_request(p))
                for _ in range(2):
                    sess.step()
            got.append((drain(sess, rids, GEN), sess.work_stats()))
            sess.reclaim_retained(64)
            assert sess.cache.refcount_sweep()["live_pages"] == 0
            got[-1] += (pool_state(sess),)
            sess.close()
        assert got[1] == got[0], budget
        outs[budget] = list(got[1][0].values())
        hits[budget] = got[1][1]["trie_hits"]
    assert outs[None] == outs[BUDGET]
    assert hits[BUDGET] >= 1 and hits[BUDGET] == hits[None]


# --------------------------------------------------------------------------- #
# no decode stall + the pending lifecycle
# --------------------------------------------------------------------------- #


def test_long_prompt_never_stalls_live_decode(pallas_interpret, models):
    short, long = prompts_for(0, [8])[0], prompts_for(1, [320])[0]
    got = []
    for sess in make_pair(models, prefill_budget=BUDGET):
        r0 = sess.add_request(short)
        for _ in range(10):
            if sess.outputs[r0]:
                break
            sess.step()
        r1 = sess.add_request(long)
        assert sess.prefill_pending == 1 and sess.resident_rids() == [r0, r1]
        # the live request emits one token every step while 20 chunks slice in
        while sess.prefill_pending:
            before = len(sess.outputs[r0])
            sess.step()
            assert len(sess.outputs[r0]) == before + 1
        work = sess.work_stats()
        assert work["prefill_stall_steps"] == 0 and work["prefill_chunks"] >= 320 // CHUNK
        got.append((sess.finish(r0), sess.finish(r1), work, pool_state(sess)))
        sess.close()
    assert got[1] == got[0]


def test_pending_finish_suspend_and_close_are_leak_free(pallas_interpret, models):
    """Mid-prefill finish (no tokens), teardown with a pending prompt in
    flight, and a mid-prefill suspend whose resume restarts the prompt and
    replays exactly (the stream of an unbudgeted session)."""
    long, prompt = prompts_for(2, [200])[0], prompts_for(6, [90])[0]
    got = []
    for base, sess in zip(make_pair(models), make_pair(models, prefill_budget=BUDGET)):
        rb = base.add_request(prompt)
        want = drain(base, [rb], GEN)[rb]
        base.close()
        rid = sess.add_request(long)
        sess.step()  # a partial prefill only
        assert sess.prefill_pending == 1
        backlog = sess.work_stats()["prefill_backlog_tokens"]
        assert sess.finish(rid) == [] and sess.prefill_pending == 0
        rid = sess.add_request(prompt)
        sess.step()
        rec = sess.suspend(rid)
        assert rec.outputs == [] and sess.prefill_pending == 0 and rid in sess.suspended
        mid = (sess.work_stats(), pool_state(sess))
        assert sess.resume(rid)
        tokens = drain(sess, [rid], GEN)[rid]
        assert tokens == want
        sess.add_request(long)
        sess.step()
        sweep = sess.close()  # a pending prompt in flight
        assert sweep["free_pages"] == 64
        got.append((want, backlog, mid, tokens, sess.work_stats(), pool_state(sess)))
    assert got[1] == got[0]


# --------------------------------------------------------------------------- #
# supervisor: skip-ahead, priority admission, deadlines, victim selection
# --------------------------------------------------------------------------- #


def test_supervisor_skip_ahead_admission(pallas_interpret, models):
    mid, huge, small = prompts_for(7, [180, 300, 30])
    (want, _), (got, sup) = (supervised(s, [(p, {}) for p in (mid, huge, small)], gen_len=3)
                             for s in make_pair(models, num_pages=24))
    assert got == want
    results, recs = got[0], got[2]
    assert set(results) == {0, 1, 2} and all(len(v) == 4 for v in results.values())
    # the 30-token prompt admits past the 300-token head that does not fit
    assert recs[2]["admit_step"] < recs[1]["admit_step"]


def test_supervisor_priority_admission_order(pallas_interpret, models):
    a, b = prompts_for(8, [100, 100])
    (want, _), (got, _) = (supervised(s, [(a, dict(priority=0)), (b, dict(priority=5))],
                                      gen_len=3)
                           for s in make_pair(models, num_pages=8))
    assert got == want
    assert set(got[0]) == {0, 1} and got[2][1]["admit_step"] < got[2][0]["admit_step"]


def test_deadline_expires_mid_prefill_with_zero_tokens(pallas_interpret, models):
    long, short = prompts_for(9, [320, 12])
    (want, _), (got, sup) = (
        supervised(s, [(long, dict(deadline=3)), (short, {})], gen_len=3)
        for s in make_pair(models, prefill_budget=BUDGET))
    assert got == want
    results, stats = got[0], got[1]
    assert 0 in sup.abandoned_idx and results[0] == [] and len(results[1]) == 4
    assert stats["abandoned"] == 1 and stats["prefill_stall_steps"] == 0


@pytest.mark.parametrize("seed, deadlines, victim_priority", [
    (10, (None, None), 0),  # equal slack and completion: the lower class loses
    (11, (1, 30), 2),       # the low class sits inside the deadline guard: spared
])
def test_victim_selection_by_sla(pallas_interpret, models, seed, deadlines, victim_priority):
    a, b = prompts_for(seed, [40, 40])
    got = []
    for sess in make_pair(models):
        sup = (port_loop if isinstance(sess, port_loop.PagedServingSession)
               else ref_loop).ServeSupervisor(sess, gen_len=4, deadline_guard=2)
        sup.submit(a, priority=0, deadline=deadlines[0])
        sup.submit(b, priority=2, deadline=deadlines[1])
        sup._admit(0)
        live = list(sup._live)
        assert len(live) == 2
        sup._suspend_victim(live)
        victim = next(iter(sess.suspended))
        assert sup._live[victim]["priority"] == victim_priority
        mid = (victim, sess.work_stats(), pool_state(sess))
        assert sess.resume(victim)
        got.append((mid, [sess.finish(r) for r in live], sess.work_stats(), pool_state(sess)))
        sess.close()
    assert got[1] == got[0]


def test_supervised_interleaved_matches_phased_end_to_end(pallas_interpret, models):
    rng = np.random.default_rng(12)
    subs = [(rng.integers(2, CFG.vocab_size, size=n).tolist(), dict(priority=pri, arrival=arr))
            for arr, n, pri in ((0, 260, 0), (2, 9, 2), (5, 17, 2), (9, 33, 1))]
    runs = {}
    for budget in (None, BUDGET):
        (want, _), (got, _) = (supervised(s, subs, gen_len=4, arrival_unit="work_units")
                               for s in make_pair(models, prefill_budget=budget))
        assert got == want, budget
        runs[budget] = got
    assert runs[None][0] == runs[BUDGET][0]
    assert runs[BUDGET][1]["prefill_stall_steps"] == 0
    assert runs[None][1]["prefill_stall_steps"] > 0
