"""The port's fault-tolerant serving against the JAX reference
(``tests/test_fault_tolerance.py`` is the acceptance spec; its
training-supervisor cases are in ``test_torch_train_loop.py``).

* **Units**: ``FaultEvent`` / ``FaultPlan`` validation and ordering,
  ``FaultPlan.generate(seed)`` giving the reference's ``describe()``, and
  the ``StragglerMonitor``'s EWMA kept clean under a burst, on both
  packages.
* **Suspend / resume** on the smoke deepseek-v2-mla at fp32 compute with
  converted weights: the same numpy-seeded prompts through a reference
  and a port session; token streams, ``work_stats()``, free lists and
  refcounts are equal after every suspend and resume (plain, speculative,
  a forked child re-aliasing its live parent's prefix, a child replayed
  standalone after its parent finished), ``replay_mismatches`` is 0, and
  a resumed stream equals the uninterrupted one.
* **Supervisor**: ``ServeSupervisor`` over both sessions gives the same
  results, ``stats()`` (``straggler_events`` aside where no slow shard is
  planned: it reads the host clock) and ``latency_records()`` under
  backoff, deadlines, pool pressure, abandon and slow-shard plans, and a
  ``shard_loss`` event is skipped on the one session; the supervised
  launch loop prints the reference's lines.
* **Shard lifecycle** on two logical shards
  (``ShardedPagedServingSession``): ``drain_shard`` stops admissions and
  keeps the live ones, ``attach_shard`` takes the next admission,
  ``fail_shard`` re-routes a shard's requests (a fork family together,
  re-aliasing its prefix), and the supervisor under ``shard_loss`` (never
  the last healthy shard), per-shard pool pressure and a seeded mid-stream
  loss gives the fault-free streams, on both packages alike.
"""

import argparse
import re

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime import fault_injection as ref_fi
from repro.runtime import fault_tolerance as ref_ft
from repro.runtime import serve_loop as ref_loop
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import fault_injection as port_fi
from repro_torch.runtime import fault_tolerance as port_ft
from repro_torch.runtime import serve_loop as port_loop

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16


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


def make_sharded_pair(models, **kw):
    """A reference and a port two-shard session on the same weights."""
    (ref_model, ref_params), (model, params) = models
    kw.setdefault("num_pages", 64)
    kw.setdefault("shards", 2)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("block_k", BLOCK_K)
    kw.setdefault("prefill_chunk", CHUNK)
    return (ref_loop.ShardedPagedServingSession(ref_model, ref_params, **kw),
            port_loop.ShardedPagedServingSession(model, params, **kw))


def pkg(sess):
    """The package a session comes from (its serve_loop module)."""
    port = (port_loop.PagedServingSession, port_loop.ShardedPagedServingSession)
    return port_loop if isinstance(sess, port) else ref_loop


def prompts_for(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in lengths]


def _caches(sess):
    return [s.cache for s in sess.shards] if hasattr(sess, "shards") else [sess.cache]


def pool_state(sess):
    """Every pool's free list (in order) and every page's refcount."""
    return [(list(c._free), c._ref.tolist()) for c in _caches(sess)]


def live_pages(sess):
    return sum(c.refcount_sweep()["live_pages"] for c in _caches(sess))


# --------------------------------------------------------------------------- #
# FaultPlan and StragglerMonitor units
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fi", [port_fi, ref_fi], ids=["port", "reference"])
def test_fault_event_validation_and_plan_order(fi):
    with pytest.raises(ValueError, match="unknown fault kind"):
        fi.FaultEvent(step=1, kind="meteor_strike")
    with pytest.raises(ValueError, match="step must be >= 0"):
        fi.FaultEvent(step=-1, kind="shard_loss")
    with pytest.raises(ValueError, match="shard must be >= 0"):
        fi.FaultEvent(step=1, kind="shard_loss", shard=-2)
    with pytest.raises(TypeError, match="FaultEvents"):
        fi.FaultPlan([("shard_loss", 3)])
    plan = fi.FaultPlan([fi.FaultEvent(step=5, kind="abandon"),
                         fi.FaultEvent(step=2, kind="slow_shard"),
                         fi.FaultEvent(step=5, kind="shard_loss", shard=1)])
    assert [e.step for e in plan] == [2, 5, 5]
    assert [e.kind for e in plan.events_at(5)] == ["shard_loss", "abandon"]
    assert plan.events_at(3) == [] and len(plan) == 3
    assert "slow_shard" in plan.describe()
    assert fi.FaultPlan([]).describe() == "no faults"
    with pytest.raises(ValueError, match="horizon"):
        fi.FaultPlan.generate(0, horizon=1)


@pytest.mark.parametrize("seed", [0, 3, 7, 8, 21])
@pytest.mark.parametrize("num_shards, kinds", [
    (1, ("shard_loss", "slow_shard", "pool_pressure")),
    (2, ("shard_loss", "slow_shard", "pool_pressure")),
    (1, ("slow_shard", "pool_pressure", "abandon")),
])
def test_fault_plan_generate_matches_reference(seed, num_shards, kinds):
    kw = dict(num_shards=num_shards, horizon=16, pool_pages=32, kinds=kinds)
    got, want = port_fi.FaultPlan.generate(seed, **kw), ref_fi.FaultPlan.generate(seed, **kw)
    assert got.describe() == want.describe()
    assert [e.describe() for e in got] == [e.describe() for e in want]
    assert got.describe() == port_fi.FaultPlan.generate(seed, **kw).describe()
    if num_shards == 1:  # no survivor to re-route onto: no shard loss
        assert all(e.kind != "shard_loss" for e in got)
    if "abandon" not in kinds:  # abandon is opt-in
        assert all(e.kind != "abandon" for e in got)
    assert all(1 <= e.step <= 8 for e in got if e.kind == "shard_loss")


@pytest.mark.parametrize("ft", [port_ft, ref_ft], ids=["port", "reference"])
def test_straggler_burst_keeps_being_flagged(ft):
    m = ft.StragglerMonitor(alpha=0.5, threshold=2.0)
    for s in range(4):
        assert not m.observe(s, 1.0)
    for s in range(4, 12):  # a burst 10x the baseline: every step flagged
        assert m.observe(s, 10.0)
    assert len(m.events) == 8 and m.ewma == pytest.approx(1.0)
    assert not m.observe(12, 1.5)
    assert m.ewma == pytest.approx(1.25)


# --------------------------------------------------------------------------- #
# suspend / resume on the paged session
# --------------------------------------------------------------------------- #


def test_suspend_resume_greedy_parity(pallas_interpret, models):
    """Mid-stream suspend frees every page of the request; resume replays
    it and the streams equal an uninterrupted run's."""
    prompts = prompts_for(0, [24, 17, 9])
    gen = 8
    got = []
    for base, sess in zip(make_pair(models), make_pair(models)):
        b_rids = [base.add_request(p) for p in prompts]
        for _ in range(gen - 1):
            base.step()
        want = [base.finish(r) for r in b_rids]
        rids = [sess.add_request(p) for p in prompts]
        trace = []
        for i in range(gen - 1):
            if i == 3:
                rec = sess.suspend(rids[1])
                assert rids[1] not in sess.active and rec.tokens == (
                    prompts[1] + rec.outputs[:-1])
                assert sess.cache.refcount_sweep()["live_sequences"] == 2
                trace.append((sess.work_stats(), pool_state(sess)))
            if i == 5:
                assert sess.resume_pending() == [rids[1]]
                trace.append((sess.work_stats(), pool_state(sess)))
            sess.step()
        while len(sess.outputs[rids[1]]) < gen:
            sess.step()
        out = [sess.finish(r)[:gen] for r in rids]
        assert out == want
        ws = sess.work_stats()
        assert ws["suspends"] == ws["resumes"] == 1 and ws["replay_mismatches"] == 0
        assert ws["replay_prefill_tokens"] > 0 and live_pages(sess) == 0
        got.append((out, trace, ws, pool_state(sess)))
    assert got[1] == got[0]


def test_suspend_resume_errors_discard_and_room(pallas_interpret, models):
    """Unknown and repeated suspends raise; discard keeps the output; a
    resume without room returns False and allocates nothing, then succeeds
    once the ballast lifts."""
    (p1,), (p2,) = prompts_for(1, [10]), prompts_for(2, [20])
    got = []
    for sess, small in zip(make_pair(models), make_pair(models, num_pages=8)):
        rid = sess.add_request(p1)
        with pytest.raises(KeyError, match="not live"):
            sess.suspend(999)
        with pytest.raises(KeyError, match="not suspended"):
            sess.resume(rid)
        sess.suspend(rid)
        with pytest.raises(KeyError, match="not live"):
            sess.suspend(rid)
        out = sess.discard_suspended(rid)
        assert len(out) == 1 and not sess.suspended and live_pages(sess) == 0
        rid = small.add_request(p2)
        small.step()
        small.suspend(rid)
        handle = small.hold_pages(8)
        assert small.cache.num_free_pages == 0
        assert small.resume(rid) is False
        assert rid in small.suspended and rid not in small.active
        mid = pool_state(small)
        small.release_pages(handle)
        with pytest.raises(KeyError, match="not a held ballast"):
            small.release_pages(handle)
        assert small.resume(rid) is True
        small.step()
        tokens = small.finish(rid)
        assert len(tokens) >= 2 and live_pages(small) == 0
        got.append((out, mid, tokens, small.work_stats(), pool_state(small)))
    assert got[1] == got[0]


def test_suspend_resume_speculative_pending_state(pallas_interpret, models):
    """A suspend between verify steps needs no rollback of its own; the
    resumed stream equals the undisturbed one."""
    prompts = prompts_for(3, [12, 18])
    target = 8

    def drive(sess, interrupt):
        rids = [sess.add_request(p) for p in prompts]
        for i in range(6):
            if interrupt and i == 2:
                sess.suspend(rids[0])
            if interrupt and i == 4:
                assert sess.resume(rids[0])
            sess.step()
        out1 = sess.finish(rids[1])[:target]
        while len(sess.outputs[rids[0]]) < target:
            sess.step()
        out0 = sess.finish(rids[0])[:target]
        ws = sess.work_stats()
        assert ws["replay_mismatches"] == 0 and live_pages(sess) == 0
        return [out0, out1], ws, pool_state(sess)

    runs = {flag: [drive(s, flag) for s in make_pair(models, speculate="ngram", draft_k=3)]
            for flag in (False, True)}
    for flag, (want, got) in runs.items():
        assert got == want, flag
    assert runs[False][1][0] == runs[True][1][0]


def test_suspend_forked_child_releases_only_unshared_pages(pallas_interpret, models):
    got = []
    for sess in make_pair(models):
        parent = sess.add_request(prompts_for(4, [40])[0])  # 3 pages
        child = sess.admit_with_prefix(parent, prompts_for(5, [20])[0], 32)
        for _ in range(2):
            sess.step()
        parent_pages = set(sess.cache.seq_pages(parent))
        child_pages = set(sess.cache.seq_pages(child))
        shared, private = parent_pages & child_pages, child_pages - parent_pages
        assert shared and private
        free_before = sess.cache.num_free_pages
        rec = sess.suspend(child)
        assert (rec.parent, rec.prefix_len) == (parent, 32)
        assert all(sess.cache.page_refcount(pid) == 1 for pid in shared)
        assert all(sess.cache.page_refcount(pid) == 0 for pid in private)
        assert sess.cache.num_free_pages == free_before + len(private)
        assert set(sess.cache.seq_pages(parent)) == parent_pages
        sess.cache.refcount_sweep()
        got.append((sorted(shared), sorted(private), pool_state(sess), sess.work_stats()))
    assert got[1] == got[0]


@pytest.mark.parametrize("parent_live", [True, False])
def test_resume_forked_child(pallas_interpret, models, parent_live):
    """With the parent live, a resumed child re-aliases the shared prefix
    and replays only its suffix; with the parent finished, it replays its
    whole history standalone.  Either way the family's streams equal the
    undisturbed run's."""
    prompts = prompts_for(6, [40, 20]) if parent_live else prompts_for(7, [32, 12])
    gen = 7 if parent_live else 6

    def drive(sess, interrupt):
        parent = sess.add_request(prompts[0])
        child = sess.admit_with_prefix(parent, prompts[1], 32)
        trace = []
        for i in range(gen):
            if interrupt and i == 2:
                sess.suspend(child)
                if not parent_live:
                    sess.finish(parent)
            if interrupt and i == (4 if parent_live else 3):
                before = sess.cache.num_aliased_pages()
                assert sess.resume(child)
                replayed = sess.work_stats()["replay_prefill_tokens"]
                if parent_live:
                    assert sess.cache.num_aliased_pages() >= before
                    assert 0 < replayed < len(prompts[1]) + 32 + gen  # the suffix only
                else:
                    assert sess.cache.num_aliased_pages() == 0
                trace.append((replayed, pool_state(sess)))
            sess.step()
        if not interrupt and not parent_live:
            sess.finish(parent)
        while len(sess.outputs[child]) < gen + 1:
            sess.step()
        assert sess.work_stats()["replay_mismatches"] == 0
        # the family's streams (the child's alone once its parent finished)
        outs = [list(sess.outputs[r])[: gen + 1] for r in (parent, child)
                if r in sess.outputs]
        for r in list(sess.active):
            sess.finish(r)
        assert live_pages(sess) == 0
        return outs, trace, sess.work_stats()

    runs = {flag: [drive(s, flag) for s in make_pair(models)] for flag in (False, True)}
    for flag, (want, got) in runs.items():
        assert got == want, flag
    assert runs[False][1][0] == runs[True][1][0]


def test_adopt_suspended_replays_under_a_new_rid(pallas_interpret, models):
    """A suspended record moved to another session of the same weights
    (the re-route path) replays there under a fresh rid and continues the
    same stream."""
    prompts = prompts_for(13, [30, 19])
    got = []
    for src, dst in zip(make_pair(models), make_pair(models)):
        rids = [src.add_request(p) for p in prompts]
        for _ in range(3):
            src.step()
        rec = src.suspend(rids[0])
        dst.add_request(prompts[1])
        new = dst.adopt_suspended(rec)
        assert new == 1 and dst.outputs[new] is rec.outputs
        for _ in range(3):
            src.step()
            dst.step()
        got.append((src.finish(rids[1]), dst.finish(new), dst.work_stats(), pool_state(dst)))
    assert got[1] == got[0]


# --------------------------------------------------------------------------- #
# the supervised serve loop
# --------------------------------------------------------------------------- #


def supervise(sess, prompts, *, keep_stragglers=False, **kw):
    """``prompts`` through ServeSupervisor(sess); what the packages must
    agree on."""
    sup = pkg(sess).ServeSupervisor(sess, **kw)
    idxs = [sup.submit(p) for p in prompts]
    results = sup.run()
    assert sorted(results) == idxs and live_pages(sess) == 0
    stats = sup.stats()
    if not keep_stragglers:
        stats.pop("straggler_events")
    out = (results, stats, sup.latency_records(), sorted(sup.abandoned_idx), sup.events,
           sess.work_stats(), pool_state(sess))
    sess.close()
    return out


def supervise_pair(sess_pair, prompts, **kw):
    want, got = (supervise(s, prompts, **kw) for s in sess_pair)
    assert got == want
    return got


def test_supervisor_requires_paged_session():
    for loop in (port_loop, ref_loop):
        with pytest.raises(ValueError, match="paged session"):
            loop.ServeSupervisor(object(), gen_len=4)


def test_supervisor_plain_run_and_backoff(pallas_interpret, models):
    """A calm run completes everything; ``max_batch=1`` queues the rest
    with backoff counted on each rejection."""
    results, st = supervise_pair(make_pair(models), prompts_for(15, [10, 14, 8]), gen_len=4)[:2]
    assert all(len(v) >= 4 for v in results.values())
    assert st["completed"] == 3 and st["abandoned"] == 0
    assert st["suspends"] == 0 and st["evictions"] == 0
    st = supervise_pair(make_pair(models, max_batch=1), prompts_for(16, [8, 9, 10]),
                        gen_len=3)[1]
    assert st["completed"] == 3 and st["admission_retries"] > 0


def test_supervisor_deadline_abandons_with_partial_output(pallas_interpret, models):
    results, st, _, abandoned = supervise_pair(
        make_pair(models), prompts_for(17, [10, 12]), gen_len=50, deadline=3)[:4]
    assert abandoned == [0, 1] and st["abandoned"] == 2 and st["completed"] == 0
    assert all(1 <= len(v) < 50 for v in results.values())


def test_supervisor_pool_pressure_evicts_and_recovers(pallas_interpret, models):
    """A pool-pressure fault squeezes the pool mid-stream: the supervisor
    suspends, waits out the ballast, resumes, and the outputs match the
    calm run exactly."""
    prompts = prompts_for(18, [15, 31, 14])  # just under page boundaries
    calm, calm_st = supervise_pair(make_pair(models, num_pages=12), prompts, gen_len=6)[:2]
    plan = port_fi.FaultPlan([port_fi.FaultEvent(step=1, kind="pool_pressure", pages=8,
                                                 duration=3)])
    ref_plan = ref_fi.FaultPlan([ref_fi.FaultEvent(step=1, kind="pool_pressure", pages=8,
                                                   duration=3)])
    want, got = (supervise(s, prompts, gen_len=6, plan=p)
                 for s, p in zip(make_pair(models, num_pages=12), (ref_plan, plan)))
    assert got == want
    squeezed, st = got[:2]
    assert st["faults_applied"] == 1 and st["suspends"] >= 1
    assert st["resumes"] == st["suspends"] and st["replay_mismatches"] == 0
    assert calm_st["suspends"] == 0 and calm == squeezed


@pytest.mark.parametrize("kind", ["abandon", "slow_shard", "shard_loss"])
def test_supervisor_fault_events(pallas_interpret, models, kind):
    """An abandon drops the oldest submission with its partial output; a
    slow shard is flagged by the straggler monitor; a shard loss is
    skipped on the one session."""
    ev = dict(abandon=dict(step=2), slow_shard=dict(step=3, duration=2, factor=9.0),
              shard_loss=dict(step=1, shard=1))[kind]
    gen = dict(abandon=6, slow_shard=8, shard_loss=4)[kind]
    prompts = prompts_for(dict(abandon=19, slow_shard=20, shard_loss=21)[kind], [10, 12])
    want, got = (supervise(s, prompts, gen_len=gen, keep_stragglers=True,
                           plan=fi.FaultPlan([fi.FaultEvent(kind=kind, **ev)]))
                 for s, fi in zip(make_pair(models), (ref_fi, port_fi)))
    # the straggler count reads the host clock: held by its own rule below
    strag = [w[1].pop("straggler_events") for w in (want, got)]
    assert got == want
    results, st = got[:2]
    if kind == "abandon":
        assert got[3] == [0] and len(results[0]) < 7 and len(results[1]) >= 6
        assert st["abandoned"] == 1 and st["completed"] == 1
    elif kind == "slow_shard":
        assert min(strag) >= 1 and st["completed"] == 2  # factor 9 > threshold 3
    else:
        assert st["faults_applied"] == 0 and st["faults_skipped"] == 1
        assert st["completed"] == 2


def test_supervisor_raises_on_unadmittable_prompt(pallas_interpret, models):
    for sess in make_pair(models, num_pages=4):
        sup = pkg(sess).ServeSupervisor(sess, gen_len=2)
        sup.submit(list(range(2, 2 + 2 * PAGE)))  # 2 of 4 pages: fine
        sup.submit(list(range(2, 2 + 10 * PAGE)))  # can never fit
        with pytest.raises(ValueError, match="can never be admitted|needs"):
            sup.run()


def test_serve_supervised_prints_the_reference_lines(pallas_interpret, models, capsys):
    """``launch/serve._serve_supervised`` over the two packages' sessions,
    a generated chaos plan with priority classes: the same plan, requests,
    counters and events (the wall-clock numbers and the straggler count
    aside)."""
    from repro.launch.serve import _serve_supervised as ref_supervised

    prompts = prompts_for(22, [10, 31, 15, 20])
    args = argparse.Namespace(chaos=5, gen_len=6, deadline=None, priority_classes=[2, 0, 1],
                              requests=len(prompts))
    lines = []
    for sess, fn in zip(make_pair(models, num_pages=12), (ref_supervised,
                                                          serve._serve_supervised)):
        fn(sess, [list(p) for p in prompts], args)
        out = capsys.readouterr().out
        keep = [re.sub(r"\d+ straggler events", "N straggler events", line)
                for line in out.splitlines()
                if line.startswith(("chaos plan", "request ", "supervision:", "latency", "  "))]
        lines.append(keep)
    assert lines[1] == lines[0]
    assert "chaos plan (seed 5)" in lines[1][0] and len(lines[1]) > 6


# --------------------------------------------------------------------------- #
# shard lifecycle: drain / fail / attach, and the supervisor over shards
# --------------------------------------------------------------------------- #


def test_drain_shard_stops_admission_keeps_live(pallas_interpret, models):
    outs = []
    for sess in make_sharded_pair(models):
        rids = [sess.add_request(p) for p in prompts_for(8, [10, 12])]
        assert {sess.shard_of(r) for r in rids} == {0, 1}  # routing spread them
        assert sess.drain_shard(1) == 1
        assert sess.shard_health == ["healthy", "draining"]
        more = [sess.add_request(p) for p in prompts_for(9, [8, 8])]
        assert all(sess.shard_of(r) == 0 for r in more)  # only the healthy shard admits
        victim = next(r for r in rids if sess.shard_of(r) == 1)
        sess.step()
        assert len(sess.outputs[victim]) == 2  # the draining shard still decodes
        outs.append([sess.finish(victim)] + [list(sess.outputs[r]) for r in rids + more
                                             if r != victim])
        assert sess.drain_shard(1) == 0  # idempotent; now empty
        outs.append((sess.work_stats(), pool_state(sess)))
    assert outs[2:] == outs[:2]


def test_attach_shard_grows_fleet_and_takes_traffic(pallas_interpret, models):
    outs = []
    for sess in make_sharded_pair(models):
        for p in prompts_for(10, [10, 12]):
            sess.add_request(p)
        idx = sess.attach_shard()
        assert idx == 2 and sess.num_shards == 3
        assert sess.shard_health == ["healthy"] * 3
        assert sess.shards[idx].cache.num_pages == sess._pages_per_shard
        rid = sess.add_request(prompts_for(11, [9])[0])  # the empty shard wins
        assert sess.shard_of(rid) == idx
        sess.step()
        assert len(sess.outputs[rid]) == 2
        ws = sess.work_stats()
        assert len(ws["per_shard"]) == 3 and len(ws["shard_health"]) == 3
        outs.append((ws, pool_state(sess), sess.close()))
    assert outs[1] == outs[0]


def test_fail_shard_reroutes_to_survivor(pallas_interpret, models):
    outs = []
    for sess in make_sharded_pair(models):
        rids = [sess.add_request(p) for p in prompts_for(12, [10, 12, 14])]
        sess.step()
        lost = [r for r in rids if sess.shard_of(r) == 1]
        assert lost
        res = sess.fail_shard(1)
        assert res["suspended"] == lost and res["resumed"] == lost
        assert sess.shard_health == ["healthy", "dead"]
        assert all(sess.shard_of(r) == 0 for r in rids)
        views = {r: sess.outputs[r] for r in rids}  # the same lists keep growing
        sess.step()
        assert all(len(views[r]) == 3 for r in rids)
        assert sess.shards[1].cache.refcount_sweep()["live_pages"] == 0
        assert sess.fail_shard(1) == {"suspended": [], "resumed": []}
        ws = sess.work_stats()
        assert ws["replay_mismatches"] == 0
        outs.append(([sess.finish(r) for r in rids], ws))
        assert live_pages(sess) == 0
    assert outs[1] == outs[0]


def test_fail_shard_keeps_fork_family_together(pallas_interpret, models):
    outs = []
    for sess in make_sharded_pair(models, num_pages=128):
        parent = sess.add_request(prompts_for(13, [40])[0])
        child = sess.admit_with_prefix(parent, prompts_for(14, [8])[0], 32)
        assert sess.shard_of(child) == sess.shard_of(parent)
        home = sess.shard_of(parent)
        sess.step()
        res = sess.fail_shard(home)
        assert set(res["resumed"]) == {parent, child}
        new_home = sess.shard_of(parent)
        assert new_home != home and sess.shard_of(child) == new_home
        # the prefix is aliased again on the new shard, not recomputed twice
        assert sess.shards[new_home].cache.num_aliased_pages() > 0
        sess.step()
        outs.append(([sess.finish(r) for r in (parent, child)], pool_state(sess)))
        assert live_pages(sess) == 0
    assert outs[1] == outs[0]


def test_supervisor_never_kills_last_healthy_shard(pallas_interpret, models):
    outs = []
    for sess, fi in zip(make_sharded_pair(models), (ref_fi, port_fi)):
        plan = fi.FaultPlan([fi.FaultEvent(step=1, kind="shard_loss", shard=0),
                             fi.FaultEvent(step=2, kind="shard_loss", shard=1)])
        got = supervise(sess, prompts_for(21, [10, 12, 9]), gen_len=4, plan=plan)
        st = got[1]
        assert st["faults_applied"] == 1 and st["faults_skipped"] == 1
        assert sess.shard_health.count("healthy") == 1
        outs.append(got)
    assert outs[1] == outs[0]


def test_sharded_pool_pressure_and_victims_by_fullest_shard(pallas_interpret, models):
    """Pool pressure on one shard of two: its ballast is held there, the
    supervisor evicts from the fullest pool, and the streams equal the
    calm run's; both packages alike."""
    prompts = prompts_for(18, [15, 31, 14, 29])
    calm = supervise(make_sharded_pair(models, num_pages=24)[1], prompts, gen_len=6)[0]
    outs = []
    for sess, fi in zip(make_sharded_pair(models, num_pages=24), (ref_fi, port_fi)):
        plan = fi.FaultPlan([fi.FaultEvent(step=1, kind="pool_pressure", pages=8, duration=3,
                                           shard=1)])
        outs.append(supervise(sess, prompts, gen_len=6, plan=plan))
    assert outs[1] == outs[0]
    results, st = outs[1][:2]
    assert st["faults_applied"] == 1 and st["suspends"] >= 1
    assert st["resumes"] == st["suspends"] and st["replay_mismatches"] == 0
    assert results == calm


@pytest.mark.parametrize("kv_dtype, speculate", [(None, "off"), ("int8", "ngram")])
def test_shard_loss_recovery_bit_identical(pallas_interpret, models, kv_dtype, speculate):
    """A seeded plan kills one of two shards mid-stream: every live request
    is suspended, re-routed and replayed, and completes with the fault-free
    run's greedy tokens (the common prefix: speculation may overshoot
    gen_len by up to draft_k - 1); no page leaks; the port's run equals the
    reference's."""
    prompts = prompts_for(22, [24, 17, 9, 30])
    gen = 8
    kw = dict(kv_dtype=kv_dtype, speculate=speculate, draft_k=3)
    base = supervise(make_sharded_pair(models, **kw)[1], prompts, gen_len=gen)[0]
    outs = []
    for sess, fi in zip(make_sharded_pair(models, **kw), (ref_fi, port_fi)):
        plan = fi.FaultPlan([fi.FaultEvent(step=3, kind="shard_loss", shard=1)])
        outs.append(supervise(sess, prompts, gen_len=gen, plan=plan))
        assert sess.shard_health == ["healthy", "dead"]
    assert outs[1] == outs[0]
    faulted, stats = outs[1][:2]
    assert sorted(faulted) == sorted(base) == list(range(len(prompts)))
    assert stats["abandoned"] == 0 and stats["suspends"] >= 1
    assert stats["resumes"] == stats["suspends"] and stats["replay_mismatches"] == 0
    for i in base:
        n = min(len(base[i]), len(faulted[i]))
        assert n >= gen and base[i][:n] == faulted[i][:n], f"request {i} diverged"


def test_serve_supervised_sharded_prints_the_reference_lines(pallas_interpret, models,
                                                             capsys):
    """``launch/serve._serve_supervised`` over two-shard sessions of both
    packages under a generated chaos plan of two shards: the same plan,
    requests, counters, shard health and events."""
    from repro.launch.serve import _serve_supervised as ref_supervised

    prompts = prompts_for(23, [10, 31, 15, 20])
    args = argparse.Namespace(chaos=3, gen_len=5, deadline=None, priority_classes=None,
                              requests=len(prompts))
    lines = []
    for sess, fn in zip(make_sharded_pair(models, num_pages=32),
                        (ref_supervised, serve._serve_supervised)):
        fn(sess, [list(p) for p in prompts], args)
        out = capsys.readouterr().out
        lines.append([re.sub(r"\d+ straggler events", "N straggler events", line)
                      for line in out.splitlines()
                      if line.startswith(("chaos plan", "request ", "supervision:", "latency",
                                          "shard health", "  "))])
    assert lines[1] == lines[0]
    assert "shard_loss" in lines[1][0] and any("lost" in x for x in lines[1])
