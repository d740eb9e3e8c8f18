"""The port's radix prefix trie, nested prefix grouping and trie-backed
paged serving against the JAX reference (``tests/test_prefix_trie.py`` is
the acceptance spec).

* **Trie mechanics**: the reference's unit cases and a seeded churn of
  admit / retain / reclaim / fork / free run on a reference cache + trie
  and on a port cache + trie side by side; after every operation both give
  the same results (matches, pinned pages, freed pages) and the same
  state: free list, refcounts, pins, block tables, ``pool_occupancy``,
  the sweep, the trie's stats, epoch and nodes.
* **Nested grouping**: ``find_prefix_groups(nested=True)``,
  ``build_prefix_schedule(nested=True)`` (group windows, hetero tables of
  width ``num_splits + max chain``) and ``prefix_queue_grid_items`` give
  the reference's arrays; the memoizing scheduler hits and rebuilds as the
  reference's.  Nested decode through ``ops.mla_decode_paged`` is within
  2e-3 at fp32 of the reference's call (Pallas in interpret mode).
* **Sessions**: the smoke deepseek-v2-mla at fp32 compute with
  ``prefix_cache="trie"`` (fp32, bf16 and int8 pages) gives the reference
  session's greedy tokens, work counters and page refcounts, under
  staggered template traffic and under pool-pressure eviction.
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
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime import kv_cache as ref_kv
from repro.runtime.serve_loop import PagedServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import decode_schedule as sched
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import kv_cache as port_kv
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


# --------------------------------------------------------------------------- #
# trie mechanics: the same operations on both packages
# --------------------------------------------------------------------------- #


def _trie_nodes(trie):
    """Every node as (parent blocks, blocks, pages, last_used), depth first
    in child order: the trie's whole state."""
    out, stack = [], [trie.root]
    while stack:
        node = stack.pop()
        for child in node.children.values():
            out.append((tuple(node.blocks), tuple(child.blocks), tuple(child.pages),
                        child.last_used))
            stack.append(child)
    return out


class Pair:
    """A reference cache + trie and a port cache + trie (width 8, fp32);
    ``run(fn)`` applies ``fn(cache, trie)`` to both, asserts equal results
    and equal state, and returns the result."""

    def __init__(self, num_pages=32, page_size=4, block_tokens=8, retain_pages=None):
        self.ref = ref_kv.PagedKVCache(num_pages=num_pages, page_size=page_size, width=8,
                                       dtype=jnp.float32)
        self.port = port_kv.PagedKVCache(num_pages=num_pages, page_size=page_size, width=8,
                                         dtype=torch.float32, device="cpu")
        self.ref_trie = ref_kv.PrefixTrie(self.ref, block_tokens=block_tokens,
                                          retain_pages=retain_pages)
        self.port_trie = port_kv.PrefixTrie(self.port, block_tokens=block_tokens,
                                            retain_pages=retain_pages)

    def run(self, fn):
        want = fn(self.ref, self.ref_trie)
        got = fn(self.port, self.port_trie)
        assert got == want
        self.check()
        return got

    def raises(self, exc, match, fn):
        for cache, trie in ((self.ref, self.ref_trie), (self.port, self.port_trie)):
            with pytest.raises(exc, match=match):
                fn(cache, trie)
        self.check()

    def check(self):
        r, p = self.ref, self.port
        assert list(p._free) == list(r._free)
        np.testing.assert_array_equal(p._ref, r._ref)
        np.testing.assert_array_equal(p._pin, r._pin)
        assert p._seq_pages == r._seq_pages and p._seq_len == r._seq_len
        assert p.live_sequences() == r.live_sequences()
        assert p.pool_occupancy() == r.pool_occupancy()
        assert p.refcount_sweep() == r.refcount_sweep()
        assert self.port_trie.stats() == self.ref_trie.stats()
        assert _trie_nodes(self.port_trie) == _trie_nodes(self.ref_trie)


def fill(cache, rid, n_tokens, seed=0):
    """Allocate ``rid`` and append ``n_tokens`` seeded rows."""
    rows = np.random.default_rng(seed).normal(size=(n_tokens, cache.width)).astype(np.float32)
    cache.alloc(rid)
    cache.append(rid, torch.from_numpy(rows) if isinstance(cache, port_kv.PagedKVCache)
                 else jnp.asarray(rows))


def toks(*blocks):
    """Block-sized token runs: toks(1, 2) = 8 ones then 8 twos."""
    return [b for b in blocks for _ in range(8)]


def retained(cache, trie, rid, tokens):
    """Finish with retention: insert the complete blocks, then free."""
    n_blocks = len(tokens) // trie.block_tokens
    pinned = trie.insert(tokens[: n_blocks * trie.block_tokens],
                         cache.seq_pages(rid)[: n_blocks * trie.pages_per_block])
    cache.free(rid)
    return pinned


def sc_validation(pair):
    for kw, match in ((dict(block_tokens=6), "multiple"),
                      (dict(block_tokens=8, retain_pages=-1), "retain_pages")):
        pair.raises(ValueError, match, lambda c, t: type(t)(c, **kw))


def sc_miss_counters(pair):
    assert pair.run(lambda c, t: t.match(toks(1, 2))) == (0, [])
    assert pair.port_trie.misses == 1 and pair.port_trie.hits == 0


def sc_roundtrip_partial_edge(pair):
    pair.run(lambda c, t: fill(c, 0, 24))
    pages = pair.run(lambda c, t: c.seq_pages(0))
    pair.run(lambda c, t: t.insert(toks(1, 2, 3), pages))
    pair.run(lambda c, t: c.free(0))
    assert pair.run(lambda c, t: t.match(toks(1, 2, 3))) == (24, pages)
    assert pair.run(lambda c, t: t.match(toks(1, 2, 9))) == (16, pages[:4])
    assert pair.port_trie.num_nodes == 1  # a partial match does not split
    assert pair.run(lambda c, t: t.match(toks(5))) == (0, [])
    assert pair.port_trie.stats()["hit_tokens"] == 40


def sc_split_on_divergence(pair):
    pair.run(lambda c, t: fill(c, 0, 24, seed=0))
    pair.run(lambda c, t: retained(c, t, 0, toks(1, 2, 3)))
    e0 = pair.port_trie.epoch
    pair.run(lambda c, t: fill(c, 1, 24, seed=1))
    assert pair.run(lambda c, t: retained(c, t, 1, toks(1, 2, 7))) == 2
    assert pair.port_trie.num_nodes == 3 and pair.port_trie.epoch > e0
    assert pair.run(lambda c, t: t.match(toks(1, 2, 7)))[0] == 24
    assert pair.run(lambda c, t: t.match(toks(1, 2, 3)))[0] == 24
    assert pair.port_trie.pinned_pages == 8


def sc_covered_prefix_pins_nothing(pair):
    pair.run(lambda c, t: fill(c, 0, 24))
    pair.run(lambda c, t: t.insert(toks(1, 2, 3), c.seq_pages(0)))
    assert pair.run(lambda c, t: t.insert(toks(1, 2), c.seq_pages(0)[:4])) == 0
    pair.run(lambda c, t: c.free(0))


def sc_lru_eviction(pair):
    pair.run(lambda c, t: fill(c, 0, 16, seed=0))
    pair.run(lambda c, t: retained(c, t, 0, toks(1, 2)))
    pair.run(lambda c, t: fill(c, 1, 16, seed=1))
    pair.run(lambda c, t: retained(c, t, 1, toks(5, 6)))
    pair.run(lambda c, t: t.match(toks(1, 2)))  # [5, 6] becomes the coldest
    assert pair.run(lambda c, t: t.reclaim(1)) == 4
    assert pair.run(lambda c, t: t.match(toks(5, 6), count=False)) == (0, [])
    assert pair.run(lambda c, t: t.match(toks(1, 2), count=False))[0] == 16


def sc_reclaim_skips_live_aliases(pair):
    pair.run(lambda c, t: fill(c, 0, 16, seed=0))
    pair.run(lambda c, t: retained(c, t, 0, toks(1, 2)))
    pair.run(lambda c, t: c.adopt_pages(7, t.match(toks(1, 2), count=False)[1], 16))
    assert pair.run(lambda c, t: t.reclaim(4)) == 0
    pair.run(lambda c, t: c.free(7))
    assert pair.run(lambda c, t: t.reclaim(4)) == 4


def sc_retain_budget(pair):
    for rid, blocks in ((0, (1, 2)), (1, (5, 6))):
        pair.run(lambda c, t: fill(c, rid, 16, seed=rid))
        pair.run(lambda c, t: retained(c, t, rid, toks(*blocks)))
        assert pair.port_trie.pinned_pages == 4
    assert pair.run(lambda c, t: t.match(toks(1, 2), count=False)) == (0, [])
    assert pair.run(lambda c, t: t.match(toks(5, 6), count=False))[0] == 16


def sc_pin_and_adopt_validation(pair):
    pair.raises(ValueError, "free list", lambda c, t: c.pin_pages([0]))
    pair.run(lambda c, t: fill(c, 0, 8))
    pair.raises(ValueError, "retention pin", lambda c, t: c.unpin_pages(c.seq_pages(0)))
    pages = pair.run(lambda c, t: c.seq_pages(0))
    pair.raises(ValueError, "page-aligned", lambda c, t: c.adopt_pages(1, pages, 7))
    pair.raises(KeyError, "already allocated", lambda c, t: c.adopt_pages(0, pages, 8))
    pair.run(lambda c, t: c.free(0))
    pair.raises(ValueError, "free", lambda c, t: c.adopt_pages(1, pages, 8))


def seeded_churn(seed):
    """The reference's seeded admit / finish(retain) / reclaim / fork+COW /
    free interleaving, on both packages (48 pages of 4, 24-page budget)."""
    def run(pair):
        rng = np.random.default_rng(seed)
        templates = [toks(1, 2), toks(1, 2, 3), toks(5, 6), toks(1, 9)]
        live, next_rid = {}, 0
        for step in range(120):
            op = int(rng.integers(0, 5))
            if op == 0 and pair.port.num_free_pages >= 6:
                prompt = list(templates[rng.integers(len(templates))])
                prompt.extend(int(x) for x in rng.integers(50, 60, size=4))
                matched, pages = pair.run(lambda c, t: t.match(prompt[: (len(prompt) // 8) * 8]))
                rid, next_rid = next_rid, next_rid + 1
                tail = rng.normal(size=(len(prompt) - matched, 8)).astype(np.float32)

                def admit(c, t):
                    c.adopt_pages(rid, pages, matched) if matched else c.alloc(rid)
                    c.append(rid, torch.from_numpy(tail) if c is pair.port
                             else jnp.asarray(tail))
                pair.run(admit)
                live[rid] = prompt
            elif op == 1 and live:
                rid = int(rng.choice(list(live)))
                prompt = live.pop(rid)
                pair.run(lambda c, t: retained(c, t, rid, prompt))
            elif op == 2:
                n = int(rng.integers(1, 6))
                pair.run(lambda c, t: t.reclaim(n))
            elif op == 3 and live:
                src = int(rng.choice(list(live)))
                rid, next_rid = next_rid, next_rid + 1
                rows = rng.normal(size=(3, 8)).astype(np.float32)

                def fork(c, t):
                    c.fork(src, rid)
                    c.append(rid, torch.from_numpy(rows) if c is pair.port else jnp.asarray(rows))
                pair.run(fork)
                live[rid] = list(live[src])
            elif op == 4 and live:
                rid = int(rng.choice(list(live)))
                live.pop(rid)
                pair.run(lambda c, t: c.free(rid))
        for rid in list(live):
            pair.run(lambda c, t: c.free(rid))
        assert pair.run(lambda c, t: t.clear()) >= 0
        assert pair.port.refcount_sweep()["free_pages"] == pair.port.num_pages
        np.testing.assert_array_equal(pair.port.pages.numpy(), np.asarray(pair.ref.pages))
    return run


SCENARIOS = {
    "validation": (sc_validation, {}),
    "miss-counters": (sc_miss_counters, {}),
    "roundtrip-partial-edge": (sc_roundtrip_partial_edge, {}),
    "split-on-divergence": (sc_split_on_divergence, {}),
    "covered-prefix": (sc_covered_prefix_pins_nothing, {}),
    "lru-eviction": (sc_lru_eviction, {}),
    "reclaim-skips-live-aliases": (sc_reclaim_skips_live_aliases, {}),
    "retain-budget": (sc_retain_budget, dict(retain_pages=4)),
    "pin-adopt-validation": (sc_pin_and_adopt_validation, {}),
    **{f"churn-{s}": (seeded_churn(s), dict(num_pages=48, retain_pages=24))
       for s in (42, 7, 11)},
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trie_matches_reference(name):
    scenario, kw = SCENARIOS[name]
    pair = Pair(**kw)
    scenario(pair)
    pair.check()


# --------------------------------------------------------------------------- #
# nested (trie-topology) prefix scheduling
# --------------------------------------------------------------------------- #


def bf16ish(shape, seed, scale=0.3):
    x = np.random.default_rng(seed).normal(0, scale, shape)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def nested_family(*, page=32, dk=64, seed=1):
    """The reference test's family: root (2 blocks of 64) shared by 6,
    inner (2 more) shared by requests 0-3; ragged suffixes."""
    kv = ref_kv.PagedKVCache(num_pages=96, page_size=page, width=dk, dtype=jnp.float32)
    kv.alloc(0)
    kv.append(0, bf16ish((128, dk), seed))
    kv.append(0, bf16ish((128, dk), seed + 1))
    rids = [0]
    for r in range(1, 4):
        kv.fork(0, r, 256)
        rids.append(r)
    for r in range(4, 6):
        kv.fork(0, r, 128)
        rids.append(r)
    for r, n in zip(rids, [20, 55, 3, 0, 40, 9]):
        if n:
            kv.append(r, bf16ish((n, dk), 100 + r))
    return kv, rids


def template_family(*, page=16, dk=64, seed=2):
    """The trie serve phase's shape at small size (blocks of 32): four
    requests share blocks [0, 2), pairs share [2, 3) (three groups,
    chains of 2), a loner, and an empty request."""
    kv = ref_kv.PagedKVCache(num_pages=64, page_size=page, width=dk, dtype=jnp.float32)
    kv.alloc(0)
    kv.append(0, bf16ish((64, dk), seed))
    kv.fork(0, 2, 64)
    kv.append(0, bf16ish((32, dk), seed + 1))
    kv.append(2, bf16ish((32, dk), seed + 2))
    kv.fork(0, 1, 96)
    kv.fork(2, 3, 96)
    for r, n in ((0, 5), (1, 40), (2, 9), (3, 1)):
        kv.append(r, bf16ish((n, dk), 20 + r))
    kv.alloc(4)
    kv.append(4, bf16ish((33, dk), 30))
    kv.alloc(5)
    return kv, list(range(6))


FAMILIES = {
    "nested": (nested_family, 64, 1),
    "nested-2-splits": (nested_family, 64, 2),
    "template": (template_family, 32, 2),
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
@pytest.mark.parametrize("nested", [True, False])
def test_nested_schedule_arrays_match_reference(case, nested):
    factory, block_k, num_splits = FAMILIES[case]
    kv, rids = factory()
    bt, kv_len = kv.block_table(rids)
    for min_group in (2, 3):
        kw = dict(page_size=kv.page_size, block_k=block_k, num_splits=num_splits,
                  min_group=min_group, nested=nested)
        want = ref_sched.build_prefix_schedule(kv_len, bt, **kw)
        got = sched.build_prefix_schedule(kv_len, bt, **kw)
        _eq_prefix_schedule(want, got)
        for r in rids:
            assert got.groups.chain_of_req(r) == want.groups.chain_of_req(r)
        assert sched.prefix_queue_grid_items(got, kv_len, kv.page_size, query_rows=3) == \
            ref_sched.prefix_queue_grid_items(want, kv_len, kv.page_size, query_rows=3)
    if case == "template" and nested:
        got = sched.build_prefix_schedule(kv_len, bt, page_size=16, block_k=32, num_splits=2,
                                          nested=True)
        spans = sorted((int(s), int(e), tuple(int(m) for m in got.groups.group_member[g] if m >= 0))
                       for g, (s, e) in enumerate(zip(got.groups.group_start,
                                                      got.groups.shared_blocks)))
        assert spans == [(0, 2, (0, 1, 2, 3)), (2, 3, (0, 1)), (2, 3, (2, 3))]
        assert got.hetero_dest_tables()[0].shape == (6, 2 + 2)
        assert got.prefix.item_block[: got.prefix.num_items].tolist() == [0, 1, 2, 2]


def test_nested_groups_follow_trie_topology():
    kv, rids = nested_family()
    bt, kv_len = kv.block_table(rids)
    g = sched.find_prefix_groups(bt, kv_len, page_size=32, block_k=64, nested=True)
    got = sorted((int(g.group_start[i]), int(g.shared_blocks[i]),
                  tuple(int(x) for x in g.group_member[i] if x >= 0))
                 for i in range(g.num_groups))
    assert got == [(0, 2, (0, 1, 2, 3, 4, 5)), (2, 4, (0, 1, 2, 3))]
    assert g.chain_of_req(0) == ((0, 0), (1, 0)) and g.chain_of_req(4) == ((0, 4),)
    flat = sched.find_prefix_groups(bt, kv_len, page_size=32, block_k=64)
    assert flat.num_groups == 1 and int(flat.shared_blocks[0]) == 2
    nested = sched.build_prefix_schedule(kv_len, bt, page_size=32, block_k=64, nested=True)
    plain = sched.build_prefix_schedule(kv_len, bt, page_size=32, block_k=64)
    an = sched.prefix_queue_grid_items(nested, kv_len, 32)
    af = sched.prefix_queue_grid_items(plain, kv_len, 32)
    assert an["page_dmas"] < af["page_dmas"]
    assert nested.start_blocks.tolist() == [4, 4, 4, 4, 2, 2]


def test_nested_scheduler_memo_matches_reference():
    kv, rids = nested_family()
    bt, kv_len = kv.block_table(rids)
    want = ref_sched.DecodeScheduler(block_k=64, num_splits=2, nested=True)
    got = sched.DecodeScheduler(block_k=64, num_splits=2, nested=True)
    key = tuple(rids)
    for lens, table, extra in ((kv_len, bt, (key, 0)), (kv_len, bt, (key, 0)),
                               (kv_len, bt, (key, 1)), (kv_len + 70, bt, (key, 1))):
        a = want.schedule_prefix(lens, table, page_size=32, extra_key=extra)
        b = got.schedule_prefix(lens, table, page_size=32, extra_key=extra)
        _eq_prefix_schedule(a, b)
        assert (got.hits, got.rebuilds) == (want.hits, want.rebuilds)
    assert (got.hits, got.rebuilds) == (1, 3)  # an epoch change rebuilds


@pytest.mark.parametrize("variant", ["amla", "base"])
@pytest.mark.parametrize("case", ["nested", "template"])
def test_nested_shared_decode_matches_reference(pallas_interpret, case, variant):
    """K2′ over windows past block 0, the suffix pass and the hetero K3 at
    chains of 2 (plain versions) against the reference's Pallas kernels and
    against the unshared port call."""
    factory, block_k, num_splits = FAMILIES[case]
    kv, rids = factory()
    bt, kv_len = kv.block_table(rids)
    q = bf16ish((len(rids), 1, 4, kv.width), 50)
    kw = dict(d_v=32, variant=variant, scale=kv.width ** -0.5, block_k=block_k,
              num_splits=num_splits)
    ps_ref = ref_sched.build_prefix_schedule(kv_len, bt, page_size=kv.page_size,
                                             block_k=block_k, num_splits=num_splits,
                                             nested=True)
    want = np.asarray(ref_ops.mla_decode_paged(
        jnp.asarray(q), kv.pages, jnp.asarray(bt), jnp.asarray(kv_len), schedule=ps_ref,
        interpret=True, **kw))
    ps = sched.build_prefix_schedule(kv_len, bt, page_size=kv.page_size, block_k=block_k,
                                     num_splits=num_splits, nested=True)
    assert ps.groups.group_start.max() > 0
    pool, tq, tbt = torch.from_numpy(np.array(kv.pages)), torch.from_numpy(q), torch.from_numpy(bt)
    got = ops.mla_decode_paged(tq, pool, tbt, kv_len, schedule=ps, **kw).numpy()
    unshared = ops.mla_decode_paged(tq, pool, tbt, kv_len, **kw).numpy()
    assert np.abs(got - want).max() <= PARITY_ATOL
    assert np.abs(got - unshared).max() <= PARITY_ATOL
    empty = np.asarray(kv_len) == 0
    assert np.abs(got[empty]).max(initial=0.0) == 0.0


# --------------------------------------------------------------------------- #
# sessions: automatic admission against the reference
# --------------------------------------------------------------------------- #

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16
STATS = ("decode_steps", "request_steps", "query_rows", "accepted_tokens", "page_dmas",
         "page_dma_bytes", "rows_attended", "aliased_pages", "free_pages", "live_pages",
         "retained_pages", "trie_hits", "trie_misses", "trie_admissions", "trie_hit_rate",
         "prefix_tokens_reused", "prefix_tokens_reused_per_admission", "trie_evicted_pages",
         "work_units", "prefill_chunks", "prefill_stall_steps", "first_tokens",
         "ttft_units_total", "max_inter_token_units")


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(REF_CFG)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(CFG)
    return (ref_model, ref_params), (model, convert_params(ref_params, CFG, device="cpu"))


def make_pair(models, **kw):
    (ref_model, ref_params), (model, params) = models
    kw = dict(dict(num_pages=96, page_size=PAGE, block_k=BLOCK_K, prefill_chunk=CHUNK), **kw)
    return RefSession(ref_model, ref_params, **kw), PagedServingSession(model, params, **kw)


def assert_same(ref, port):
    assert port.outputs == ref.outputs
    want, got = ref.work_stats(), port.work_stats()
    for k in STATS:
        assert got[k] == want[k], k
    assert port.scheduler_stats == ref.scheduler_stats
    np.testing.assert_array_equal(port.cache._ref, ref.cache._ref)
    np.testing.assert_array_equal(port.cache._pin, ref.cache._pin)
    assert list(port.cache._free) == list(ref.cache._free)
    if ref.trie is not None:
        assert port.trie.stats() == ref.trie.stats()
        assert _trie_nodes(port.trie) == _trie_nodes(ref.trie)


def template_stream(seed, n, template_blocks=2):
    rng = np.random.default_rng(seed)
    template = rng.integers(2, CFG.vocab_size, size=template_blocks * BLOCK_K).tolist()
    return [template + rng.integers(2, CFG.vocab_size, size=5 + i).tolist() for i in range(n)]


def staggered(sessions, prompts):
    """The reference test's waves of 2 admissions with overlapping
    lifetimes, on every session in step; returns their outputs and close()
    reports, checking a (reference, port) pair agrees after every wave."""
    check = (lambda: assert_same(*sessions)) if len(sessions) == 2 else (lambda: None)
    outs = [{} for _ in sessions]
    live = []
    for wave in range(len(prompts) // 2):
        for j in range(2):
            rids = [s.add_request(prompts[wave * 2 + j]) for s in sessions]
            assert None not in rids and len(set(rids)) == 1
            live.append(rids[0])
        for _ in range(3):
            for s in sessions:
                s.step()
        check()
        if wave % 2 == 1:
            for r in live[:2]:
                for s, o in zip(sessions, outs):
                    o[r] = s.finish(r)
            live = live[2:]
    for _ in range(4):
        for s in sessions:
            s.step()
    check()
    for r in live:
        for s, o in zip(sessions, outs):
            o[r] = s.finish(r)
    stats = [s.work_stats() for s in sessions]
    return outs, stats, [s.close() for s in sessions]


@pytest.mark.parametrize("kv_dtype,speculate", [
    (None, "off"), ("bf16", "off"), ("int8", "off"), (None, "ngram"),
], ids=["fp32", "bf16", "int8", "fp32-speculate"])
def test_trie_session_matches_reference(pallas_interpret, models, kv_dtype, speculate):
    """Trie-backed admission (with n-gram speculation too: verify rows over
    nested groups) against the reference session, and against trie off."""
    prompts = template_stream(7, 8)
    ref, port = make_pair(models, prefix_cache="trie", kv_dtype=kv_dtype, speculate=speculate,
                          draft_k=3)
    (want, got), (ws_ref, ws), (sweep_ref, sweep) = staggered((ref, port), prompts)
    assert got == want and sweep == sweep_ref
    assert ws["trie_hits"] >= 6 and ws["prefix_tokens_reused"] >= 6 * 2 * BLOCK_K
    assert sweep["free_pages"] == 96
    # greedy tokens as with the trie off (the reference's own claim)
    _, off = make_pair(models, kv_dtype=kv_dtype, speculate=speculate, draft_k=3)
    (off_out,), (off_ws,), _ = staggered((off,), prompts)
    assert off_out == got and ws["page_dma_bytes"] < off_ws["page_dma_bytes"]


def test_trie_session_under_eviction_matches_reference(pallas_interpret, models):
    """A 12-page pool holds at most two retained 2-block templates: the
    third forces LRU reclaim at admission; both sessions agree on tokens,
    counters and which pages were evicted."""
    rng = np.random.default_rng(3)
    templates = [rng.integers(2, CFG.vocab_size, size=2 * BLOCK_K).tolist() for _ in range(3)]
    prompts = [templates[i // 2] + rng.integers(2, CFG.vocab_size, size=4 + i).tolist()
               for i in range(6)]
    ref, port = make_pair(models, num_pages=12, prefix_cache="trie")
    for p in prompts:
        rids = [s.add_request(p) for s in (ref, port)]
        assert rids[0] is not None and rids[0] == rids[1]
        for _ in range(4):
            ref.step()
            port.step()
        for s in (ref, port):
            s.finish(rids[0])
        assert_same(ref, port)
    ws = port.work_stats()
    assert ws["trie_evicted_pages"] > 0 and ws["trie_hits"] >= 3
    assert port.reclaim_retained(100) == ref.reclaim_retained(100) > 0
    assert_same(ref, port)
    assert port.close() == ref.close()


def test_trie_session_validation_and_lifecycle(models):
    _, (model, params) = models
    kw = dict(num_pages=16, page_size=PAGE, block_k=BLOCK_K)
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedServingSession(model, params, prefix_cache="trie", prefill_chunk=24, **kw)
    with pytest.raises(ValueError, match="cache policy"):
        PagedServingSession(model, params, prefix_cache="lru", **kw)
    off = PagedServingSession(model, params, prefill_chunk=CHUNK, **kw)
    ws = off.work_stats()
    for key in ("live_pages", "retained_pages", "trie_hits", "trie_misses", "trie_admissions",
                "trie_hit_rate", "prefix_tokens_reused", "prefix_tokens_reused_per_admission",
                "trie_evicted_pages"):
        assert ws[key] == 0
    assert off.reclaim_retained(8) == 0 and off.trie is None
    on = PagedServingSession(model, params, prefix_cache="trie", retain_pages=4,
                             prefill_chunk=CHUNK, **kw)
    assert on.prefix_sharing and on._scheduler.nested and on.trie.retain_pages == 4
    handle = on.hold_pages(5)
    assert on.cache.num_free_pages == 11 and on.work_stats()["live_pages"] == 5
    with pytest.raises(KeyError):
        on.release_pages(handle + 1)
    assert on.close()["free_pages"] == 16  # close releases the ballast
