"""The port's speculative decoding against the JAX reference
(``tests/test_speculative_decode.py`` is the acceptance spec, less its
sharded case):

* **rollback**: ``truncate`` on a port cache and a reference cache, after
  the same appends, forks and copy-on-write faults, leaves the same block
  tables, free list, refcounts and rows; a seeded admit / fork /
  speculate / evict churn keeps both equal to each other and to a host
  mirror of every request's rows;
* **drafting**: ``NGramProposer`` proposes the reference's drafts;
* **multi-row decode**: ``ops.mla_decode_paged(q_positions=...)``
  validates as the reference does, a fused k-row call equals the 1-row
  calls it replaces, and both are within 2e-3 of the reference's Pallas
  kernel (interpret mode);
* **sessions**: the smoke deepseek-v2-mla at fp32 compute with
  ``speculate="ngram"`` (fp32, bf16 and int8 pages; n-gram drafts, and
  scripted drafts that make every step accept some and roll back the
  rest) gives the reference session's greedy tokens and work counters,
  tokens that extend the ``speculate="off"`` stream, and under fork /
  admit / finish churn the same tokens and a clean pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime import kv_cache as ref_kv
from repro.runtime.serve_loop import NGramProposer as RefProposer
from repro.runtime.serve_loop import PagedServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import kv_cache as port_kv
from repro_torch.runtime.serve_loop import NGramProposer, PagedServingSession

PARITY_ATOL = 2e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``; undone, with
    the traces made under it, after each test."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


def rows(n, width, seed, scale=0.3):
    return np.random.default_rng(seed).normal(0, scale, (n, width)).astype(np.float32)


class Caches:
    """The same operations on a reference and a port ``PagedKVCache``
    (fp32, width 16); every call returns the port's result after checking
    the reference's is equal, and the two caches' state after it."""

    def __init__(self, num_pages=8, page_size=4):
        self.ref = ref_kv.PagedKVCache(num_pages=num_pages, page_size=page_size, width=16,
                                       dtype=jnp.float32)
        self.port = port_kv.PagedKVCache(num_pages=num_pages, page_size=page_size, width=16,
                                         dtype=torch.float32, device="cpu")

    def __getattr__(self, name):
        def call(*args):
            conv = lambda a, torch_side: (
                (torch.from_numpy(a) if torch_side else jnp.asarray(a))
                if isinstance(a, np.ndarray) else a)
            want = getattr(self.ref, name)(*(conv(a, False) for a in args))
            got = getattr(self.port, name)(*(conv(a, True) for a in args))
            if name == "gather_contiguous":
                want, got = np.asarray(want), got.numpy()
                np.testing.assert_array_equal(got, want)
            else:
                assert got == want, name
            self.check()
            return got
        return call

    def check(self):
        r, p = self.ref, self.port
        assert list(p._free) == list(r._free)
        np.testing.assert_array_equal(p._ref, r._ref)
        assert p._seq_pages == r._seq_pages and p._seq_len == r._seq_len
        np.testing.assert_array_equal(p.pages.numpy(), np.asarray(r.pages))


# --------------------------------------------------------------------------- #
# truncate: rollback bookkeeping
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("length,new_len", [
    (10, 10), (10, 8), (10, 4), (10, 3), (9, 0), (4, 1),
])
def test_truncate_frees_tail_pages_and_keeps_prefix(length, new_len):
    kv = Caches()
    data = rows(length, 16, length * 31 + new_len)
    kv.alloc(0)
    kv.append(0, data)
    kv.truncate(0, new_len)
    keep = -(-new_len // 4)
    assert kv.seq_len(0) == new_len and len(kv.seq_pages(0)) == keep
    assert kv.port.num_free_pages == 8 - keep
    if new_len:
        np.testing.assert_array_equal(kv.gather_contiguous(0), data[:new_len])


def test_truncate_double_truncate_and_validation():
    kv = Caches()
    kv.alloc(0)
    kv.append(0, rows(10, 16, 0))
    kv.truncate(0, 10)  # to the current length: nothing to do
    assert kv.seq_len(0) == 10 and len(kv.seq_pages(0)) == 3
    kv.truncate(0, 7)
    state = (kv.seq_len(0), kv.seq_pages(0), kv.port.num_free_pages)
    kv.truncate(0, 7)
    assert (kv.seq_len(0), kv.seq_pages(0), kv.port.num_free_pages) == state
    for cache in (kv.ref, kv.port):
        with pytest.raises(KeyError):
            cache.truncate(99, 0)
        with pytest.raises(ValueError, match="cannot extend"):
            cache.truncate(0, 8)
        with pytest.raises(ValueError, match="must be in"):
            cache.truncate(0, -1)
    kv.check()


def test_truncate_forked_child_frees_only_unshared_tail():
    """A child's rejected rows release its own fresh tail page, never a
    page the parent still holds; its copy-on-write boundary copy stays."""
    kv = Caches(num_pages=10)
    parent = rows(10, 16, 2)
    kv.alloc(0)
    kv.append(0, parent)
    kv.fork(0, 1)
    ppages = kv.seq_pages(0)
    kv.append(1, rows(6, 16, 3))  # COW of the boundary page, then a new page
    cpages = kv.seq_pages(1)
    assert cpages[:2] == ppages[:2] and cpages[2] != ppages[2]
    free_before = kv.port.num_free_pages
    kv.truncate(1, 10)
    assert kv.seq_pages(1) == cpages[:3]
    assert [kv.page_refcount(p) for p in (ppages[0], ppages[2], cpages[2])] == [2, 1, 1]
    assert kv.port.num_free_pages == free_before + 1
    np.testing.assert_array_equal(kv.gather_contiguous(0), parent)
    np.testing.assert_array_equal(kv.gather_contiguous(1), parent)


def test_truncate_into_shared_prefix_releases_refcounts_not_pages():
    kv = Caches()
    data = rows(8, 16, 4)
    kv.alloc(0)
    kv.append(0, data)
    kv.fork(0, 1)
    a, b = kv.seq_pages(0)
    kv.truncate(1, 4)
    assert kv.seq_pages(1) == [a] and kv.page_refcount(a) == 2 and kv.page_refcount(b) == 1
    np.testing.assert_array_equal(kv.gather_contiguous(1), data[:4])


@pytest.mark.parametrize("seed", range(4))
def test_truncate_churn_matches_reference_and_mirror(seed):
    """Seeded admit / fork / speculate (append k, accept a prefix) / evict:
    both caches stay equal after every operation, refcounts are conserved,
    and every live request's rows equal a host mirror."""
    rng = np.random.default_rng(seed)
    kv = Caches(num_pages=16)
    live, mirror, nid = [], {}, 0
    for step in range(40):
        op = int(rng.integers(0, 4))
        if op == 0 or not live:
            n = int(rng.integers(1, 9))
            if kv.has_room(None, n):
                data = rows(n, 16, 1000 + 7 * seed + step)
                kv.alloc(nid)
                kv.append(nid, data)
                mirror[nid] = data
                live.append(nid)
                nid += 1
        elif op == 1:
            src = int(rng.choice(live))
            kv.fork(src, nid)
            mirror[nid] = mirror[src].copy()
            live.append(nid)
            nid += 1
        elif op == 2:
            r = int(rng.choice(live))
            k = int(rng.integers(1, 5))
            if kv.has_room(r, k):
                spec = rows(k, 16, 2000 + 7 * seed + step)
                kv.append(r, spec)
                accept = int(rng.integers(0, k + 1))
                kv.truncate(r, len(mirror[r]) + accept)
                mirror[r] = np.concatenate([mirror[r], spec[:accept]])
        else:
            r = live.pop(int(rng.integers(0, len(live))))
            kv.free(r)
            mirror.pop(r)
        p = kv.port
        assert int(p._ref.sum()) == sum(len(p.seq_pages(r)) for r in live)
        assert p.num_free_pages == 16 - int((p._ref > 0).sum())
    for r in live:
        np.testing.assert_array_equal(kv.gather_contiguous(r), mirror[r])


# --------------------------------------------------------------------------- #
# NGramProposer
# --------------------------------------------------------------------------- #


def test_ngram_drafts_match_reference():
    cases = [([5, 1, 2, 3, 1, 2, 3, 1, 2], 3, [3, 1, 2]),
             ([9, 1, 2, 3, 1, 2], 4, [3, 1, 2, 2]),
             ([7, 8, 9], 4, [9, 9, 9, 9]),
             ([], 2, [0, 0])]
    for hist, k, want in cases:
        assert NGramProposer().propose(hist, k) == want == RefProposer().propose(hist, k)
    rng = np.random.default_rng(0)
    for i in range(200):
        hist = rng.integers(0, 6 if i % 2 else 40, size=int(rng.integers(0, 60))).tolist()
        k = int(rng.integers(1, 6))
        n = (int(rng.integers(1, 4)), 1)
        ours = NGramProposer(max_n=n[0], min_n=n[1]).propose(hist, k)
        assert ours == RefProposer(max_n=n[0], min_n=n[1]).propose(hist, k)
        assert len(ours) == k
    with pytest.raises(ValueError, match="min_n"):
        NGramProposer(max_n=0)
    with pytest.raises(ValueError, match="k >= 1"):
        NGramProposer().propose([1, 2], 0)


# --------------------------------------------------------------------------- #
# ops.mla_decode_paged: the multi-row surface
# --------------------------------------------------------------------------- #


def spec_kernel_args(kv_lens=(21, 13), sq=3, hq=2, dk=32, page=8):
    b = len(kv_lens)
    rng = np.random.default_rng(0)
    q = rng.normal(0, 0.3, (b, sq, hq, dk)).astype(np.float32)
    c = rng.normal(0, 0.3, (b, max(kv_lens), dk)).astype(np.float32)
    num_pages = sum(-(-l // page) for l in kv_lens) + 1
    w = max(-(-l // page) for l in kv_lens)
    pool = np.zeros((num_pages, page, dk), np.float32)
    bt = np.zeros((b, w), np.int32)
    nxt = 0
    for bb, l in enumerate(kv_lens):
        for j in range(-(-l // page)):
            hi = min((j + 1) * page, l)
            pool[nxt, : hi - j * page] = c[bb, j * page : hi]
            bt[bb, j] = nxt
            nxt += 1
    return q, pool, bt, np.asarray(kv_lens, np.int32)


def test_q_positions_validation_matches_reference():
    q, pool, bt, kv_len = spec_kernel_args()
    good = np.stack([np.arange(l - 3, l) for l in (21, 13)]).astype(np.int32)
    bad = [
        (NotImplementedError, "scheduler='queue'", dict(q_positions=good, scheduler="padded")),
        (ValueError, "not both", dict(q_positions=good, q_offset=np.zeros(2, np.int32))),
        (ValueError, "causal=False", dict(q_positions=good, causal=False)),
        (ValueError, "q_positions must be", dict(q_positions=good[:, :2])),
        (ValueError, "non-negative", dict(q_positions=np.asarray([[-1, 1, 2], [0, 1, 2]]))),
        (ValueError, "strictly increasing",
         dict(q_positions=np.asarray([[18, 19, 20], [5, 5, 6]]))),
        (ValueError, "append the k rows",
         dict(q_positions=np.asarray([[18, 19, 21], [10, 11, 12]]))),
    ]
    for exc, match, kw in bad:
        with pytest.raises(exc, match=match):
            ref_ops.mla_decode_paged(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                     jnp.asarray(kv_len), d_v=16, scale=0.2, interpret=True,
                                     **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                        for k, v in kw.items()})
        with pytest.raises(exc, match=match):
            ops.mla_decode_paged(torch.from_numpy(q), torch.from_numpy(pool),
                                 torch.from_numpy(bt), kv_len, d_v=16, scale=0.2, **kw)


def test_fused_k_rows_match_single_rows_and_reference(pallas_interpret):
    """Row j of a fused k-row verify call equals the 1-row decode at
    kv_len = pos + 1 it replaces, and the reference's fused call; positions
    equal to the derived ramp give the ramp's result bit for bit."""
    q, pool, bt, kv_len = spec_kernel_args(kv_lens=(21, 13), sq=3)
    qp = np.stack([np.arange(l - 3, l) for l in kv_len]).astype(np.int32)
    kw = dict(d_v=16, scale=0.2)
    tq, tpool, tbt = torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(bt)
    fused = ops.mla_decode_paged(tq, tpool, tbt, kv_len, q_positions=qp, **kw).numpy()
    ramp = ops.mla_decode_paged(tq, tpool, tbt, kv_len, **kw).numpy()
    np.testing.assert_array_equal(fused, ramp)
    want = np.asarray(ref_ops.mla_decode_paged(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(kv_len),
        q_positions=jnp.asarray(qp), interpret=True, **kw))
    assert np.abs(fused - want).max() <= PARITY_ATOL
    for b, l in enumerate(kv_len):
        for j, pos in enumerate(qp[b]):
            one = ops.mla_decode_paged(tq[b : b + 1, j : j + 1], tpool, tbt[b : b + 1],
                                       [pos + 1], **kw).numpy()
            np.testing.assert_allclose(fused[b, j], one[0, 0], atol=1e-5)


# --------------------------------------------------------------------------- #
# sessions against the reference
# --------------------------------------------------------------------------- #

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16
STATS = ("decode_steps", "request_steps", "query_rows", "accepted_tokens",
         "accepted_tokens_per_step", "page_dmas", "page_dma_bytes",
         "page_dma_bytes_per_accepted_token", "rows_attended", "aliased_pages", "free_pages",
         "live_pages", "work_units", "prefill_chunks", "prefill_stall_steps", "first_tokens",
         "ttft_units_total", "max_inter_token_units")


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(REF_CFG)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(CFG)
    return (ref_model, ref_params), (model, convert_params(ref_params, CFG, device="cpu"))


def make_pair(models, **kw):
    (ref_model, ref_params), (model, params) = models
    kw = dict(dict(num_pages=64, page_size=PAGE, block_k=BLOCK_K, prefill_chunk=CHUNK), **kw)
    return RefSession(ref_model, ref_params, **kw), PagedServingSession(model, params, **kw)


def prompts_for(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in lengths]


def assert_same(ref, port):
    assert port.outputs == ref.outputs
    want, got = ref.work_stats(), port.work_stats()
    for k in STATS:
        assert got[k] == want[k], k
    assert port.scheduler_stats == ref.scheduler_stats
    assert port.decode_compiles == ref.decode_compiles
    for r in port.active:
        assert port.cache.seq_len(r) == ref.cache.seq_len(r)
        assert port.cache.seq_len(r) == len(port._prompt[r]) + len(port.outputs[r]) - 1
    np.testing.assert_array_equal(port.cache._ref, ref.cache._ref)
    assert list(port.cache._free) == list(ref.cache._free)


class ScriptedDrafts:
    """Drafts from known greedy streams: the first ``right`` are the tokens
    that follow, the rest wrong, so every verify step accepts exactly
    ``right`` drafts and rolls the rest back."""

    def __init__(self, streams, right):
        self.streams, self.right = streams, right

    def propose(self, history, k):
        hist = list(history)
        stream = next(s for s in self.streams if s[: len(hist)] == hist)
        cont = stream[len(hist) : len(hist) + k]
        cont += [0] * (k - len(cont))
        return cont[: self.right] + [(t + 1) % CFG.vocab_size for t in cont[self.right :]]


@pytest.mark.parametrize("kv_dtype,drafts", [
    (None, "ngram"), ("bf16", "ngram"), ("int8", "ngram"), (None, "scripted"),
    ("int8", "scripted"),
])
def test_speculative_session_matches_reference(pallas_interpret, models, kv_dtype, drafts):
    """Step for step the reference's tokens, counters and page state (the
    rollback exact: rows = prompt + outputs - 1 after every step), and an
    extension of the speculate="off" stream; scripted drafts (2 of 3
    right) make every step accept 3 tokens and roll one row back."""
    prompts = prompts_for(0, (8, 12))
    _, off = make_pair(models, kv_dtype=kv_dtype)
    for p in prompts:
        off.add_request(p)
    for _ in range(24):
        off.step()
    assert off.work_stats()["accepted_tokens_per_step"] == 1.0
    kw = dict(speculate="ngram", draft_k=4, kv_dtype=kv_dtype)
    if drafts == "scripted":
        kw["draft_proposer"] = ScriptedDrafts(
            [p + off.outputs[r] for r, p in enumerate(prompts)], 2)
    ref, port = make_pair(models, **kw)
    for p in prompts:
        assert ref.add_request(p) == port.add_request(p)
    for _ in range(6):
        ref.step()
        port.step()
        assert_same(ref, port)
    ws = port.work_stats()
    assert ws["query_rows"] == 4 * ws["request_steps"]
    assert ws["accepted_tokens"] >= ws["request_steps"]
    if drafts == "scripted":
        assert ws["accepted_tokens_per_step"] == 3.0
    for r, out in port.outputs.items():
        assert off.outputs[r][: len(out)] == out
    assert port.close() == ref.close()


def test_speculative_churn_fork_admit_evict_matches_reference(pallas_interpret, models):
    """Fork, admit_with_prefix and finish under speculation (draft_k 3):
    twins stay token-identical, both packages agree throughout, and
    retiring everything returns every page."""
    prompts = prompts_for(5, (9, 14))
    ref, port = make_pair(models, num_pages=48, speculate="ngram", draft_k=3)
    both = (ref, port)
    r0 = [s.add_request(prompts[0]) for s in both][0]
    for _ in range(2):
        for s in both:
            s.step()
    child = [s.fork(r0) for s in both][0]
    r1 = [s.add_request(prompts[1]) for s in both][0]
    for _ in range(3):
        for s in both:
            s.step()
    assert_same(ref, port)
    assert port.outputs[child] == port.outputs[r0]
    suffix = prompts_for(6, (4,))[0]
    kid = [s.admit_with_prefix(r1, suffix) for s in both][0]
    assert port._prompt[kid] == ref._prompt[kid]
    for s in both:
        s.step()
        s.finish(child)
        s.finish(r1)
        s.step()
    assert_same(ref, port)
    for s in both:
        s.finish(r0)
        s.finish(kid)
    assert port.cache.num_free_pages == 48
    assert port.work_stats()["accepted_tokens_per_step"] >= 1.0


def test_speculative_session_validation(models):
    _, (model, params) = models
    kw = dict(num_pages=8, page_size=PAGE, block_k=BLOCK_K, prefill_chunk=CHUNK)
    with pytest.raises(ValueError, match="draft policy"):
        PagedServingSession(model, params, speculate="medusa", **kw)
    with pytest.raises(ValueError, match="draft_k=1 buys nothing"):
        PagedServingSession(model, params, speculate="ngram", draft_k=1, **kw)

    class Fixed:
        def propose(self, history, k):
            return [3] * k

    sess = PagedServingSession(model, params, speculate="ngram", draft_k=2,
                               draft_proposer=Fixed(), **kw)
    assert sess._proposer.propose([1], 2) == [3, 3]
    rid = sess.add_request(prompts_for(1, (5,))[0])
    sess.step()
    assert 2 <= len(sess.outputs[rid]) <= 3 and sess.query_rows == 2
    assert sess.close()["free_pages"] == 8
