"""The port's paged serving session against the JAX reference's, end to end
on the deepseek-v2-mla smoke config at fp32 compute, with converted
weights: greedy tokens are identical, one schedule is built per step (not
per layer), and the deterministic work counters agree.

Geometry and seeds follow ``tests/test_paged_model_serve.py``
(``PAGE, BLOCK_K, CHUNK = 16, 32, 16``), chosen there because every step's
top-2 logit gap on this untrained model stays above 1e-2 — far above the
2e-3 the two sides' logits can differ by — so greedy equality is a fair
test.  Also: the entry points raise without CUDA unless given
``device="cpu"``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.serve_loop import PagedServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.kv_cache import LayeredPagedKVCache, PagedKVCache
from repro_torch.runtime.serve_loop import PagedServingSession

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK = 16, 32, 16


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


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(REF_CFG)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(CFG)
    return (ref_model, ref_params), (model, convert_params(ref_params, CFG, device="cpu"))


def make_pair(models, **kw):
    (ref_model, ref_params), (model, params) = models
    kw.setdefault("num_pages", 48)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("block_k", BLOCK_K)
    kw.setdefault("prefill_chunk", CHUNK)
    return RefSession(ref_model, ref_params, **kw), PagedServingSession(model, params, **kw)


def prompts_for(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in lengths]


COMMON_STATS = (
    "decode_steps", "request_steps", "query_rows", "accepted_tokens", "page_dmas",
    "page_dma_bytes", "rows_attended", "aliased_pages", "free_pages", "live_pages",
    "work_units", "prefill_chunks", "prefill_stall_steps", "first_tokens",
    "ttft_units_total", "max_inter_token_units",
)


def assert_same_counters(ref, port):
    assert port.scheduler_stats == ref.scheduler_stats
    want, got = ref.work_stats(), port.work_stats()
    for k in COMMON_STATS:
        assert got[k] == want[k], k
    assert port.prefill_compiles == ref.prefill_compiles
    assert port.decode_compiles == ref.decode_compiles


@pytest.mark.parametrize("num_splits", [1, 2])
def test_greedy_tokens_match_reference_ragged_prompts(pallas_interpret, models, num_splits):
    """Page-aligned, unaligned and multi-chunk prompts; 8 decode steps."""
    ref, port = make_pair(models, num_splits=num_splits)
    prompts = prompts_for(0, (5, 16, 9, 23))
    rrids = [ref.add_request(p) for p in prompts]
    prids = [port.add_request(p) for p in prompts]
    assert rrids == prids
    for _ in range(8):
        ref.step()
        port.step()
    for r in rrids:
        assert port.outputs[r] == ref.outputs[r]
        assert len(port.outputs[r]) == 9
    stats = port.scheduler_stats
    assert stats["hits"] + stats["rebuilds"] == 8  # one schedule per step
    assert_same_counters(ref, port)
    got, want = port.close(), ref.close()
    assert got == {k: want[k] for k in got}


def test_greedy_tokens_match_reference_mid_stream_admit_evict(pallas_interpret, models):
    """A tight pool: the third request admits only onto the first one's
    recycled pages (seed 2 keeps every top-2 gap wide, as in the
    reference's own test)."""
    pa, pb, pc = prompts_for(2, (20, 12, 40))
    ref, port = make_pair(models, num_pages=5)
    for s in (ref, port):
        a, b = s.add_request(pa), s.add_request(pb)
        assert (a, b) == (0, 1)
        assert s.add_request(pc) is None
        for _ in range(3):
            s.step()
    assert port.finish(0) == ref.finish(0)
    assert list(port.cache._free) == list(ref.cache._free)
    assert port.add_request(pc) == ref.add_request(pc) == 2
    for _ in range(8):
        ref.step()
        port.step()
    assert port.outputs[1] == ref.outputs[1]
    assert port.outputs[2] == ref.outputs[2]
    assert_same_counters(ref, port)


def test_serve_stream_matches_reference_stream(pallas_interpret, models):
    """The launch/serve stream loop over both sessions: same results."""
    from repro.launch.serve import _serve_stream as ref_stream

    ref, port = make_pair(models, num_pages=6, max_batch=2)
    prompts = prompts_for(5, (30, 7, 18, 3))
    want, n_want, _ = ref_stream(ref, list(prompts), 5, len(prompts))
    got, n_got, _ = serve._serve_stream(port, list(prompts), 5, len(prompts))
    assert got == want and n_got == n_want


def test_admission_validation_and_unported_options(models):
    _, (model, params) = models
    sess = PagedServingSession(model, params, num_pages=4, page_size=PAGE, block_k=BLOCK_K,
                               prefill_chunk=CHUNK)
    with pytest.raises(ValueError, match="at least one prompt token"):
        sess.add_request([])
    with pytest.raises(ValueError, match="never be admitted"):
        sess.add_request(prompts_for(9, (4 * PAGE + 1,))[0])
    assert sess.add_request(prompts_for(9, (4 * PAGE,))[0]) is not None
    assert sess.add_request(prompts_for(9, (PAGE,))[0]) is None
    with pytest.raises(KeyError):
        sess.finish(7)
    # ported since: head chunks (held against the reference in
    # test_torch_sharded_serving.py), which must divide the heads
    assert PagedServingSession(model, params, num_pages=4, page_size=PAGE,
                               head_shards=2).head_shards == 2
    with pytest.raises(ValueError, match="must divide"):
        PagedServingSession(model, params, num_pages=4, page_size=PAGE, head_shards=3)
    # ported since: budgeted interleaving (held against the reference in
    # test_torch_interleaved_prefill.py), whose budget must cover a chunk
    sb = PagedServingSession(model, params, num_pages=4, page_size=PAGE, block_k=BLOCK_K,
                             prefill_chunk=CHUNK, prefill_budget=64)
    assert sb.prefill_budget == 64 and sb.prefill_pending == 0
    with pytest.raises(ValueError, match="below prefill_chunk"):
        PagedServingSession(model, params, num_pages=4, page_size=PAGE, block_k=BLOCK_K,
                            prefill_chunk=CHUNK, prefill_budget=CHUNK - 1)
    # ported since: an int8, prefix-sharing session, the trie and n-gram
    # speculation build (their serving is held against the reference in
    # test_torch_prefix_sharing.py, test_torch_prefix_trie.py and
    # test_torch_speculative.py)
    s8 = PagedServingSession(model, params, num_pages=4, page_size=PAGE, block_k=BLOCK_K,
                             kv_dtype="int8", prefix_sharing=True)
    assert s8.cache.quantized and s8.prefix_sharing
    for kw in (dict(speculate="ngram"), dict(prefix_cache="trie", prefill_chunk=CHUNK)):
        PagedServingSession(model, params, num_pages=4, page_size=PAGE, block_k=BLOCK_K, **kw)
    # ported since: suspend/resume (test_torch_fault_tolerance.py)
    with pytest.raises(KeyError, match="not live"):
        sess.suspend(7)
    with pytest.raises(KeyError):
        sess.admit_with_prefix(7, [3])
    with pytest.raises(ValueError, match="at least one suffix token"):
        sess.admit_with_prefix(0, [])


@pytest.mark.parametrize("flags,keys", [
    ([], ["served 3 requests, 9 decode tokens"]),
    (["--prefill-budget", "64", "--priority-classes", "2,0,1"],
     ["served 3/3 requests, 12 decode tokens", "0 suspends / 0 resumes",
      "latency (work units): TTFT p50/p99 ", " 0 decode-stall chunks)"]),
    (["--chaos", "3"],
     ["chaos plan (seed 3): step 1: pool_pressure (shard=0 32 pages for 2); step 2: "
      "slow_shard (shard=0 x5 for 2)", "served 3/3 requests", "2 faults applied (0 skipped)",
      "step 1: pool pressure — 32 pages held for 2 steps"]),
])
def test_launch_serve_cli_on_cpu(capsys, flags, keys):
    # --cache dense is the default, as in the reference; these are paged runs
    serve.main(["--cache", "paged", "--smoke", "--requests", "3", "--gen-len", "3",
                "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "teardown sweep: 64 pages free (clean)" in out
    for key in keys:
        assert key in out, key
    if flags:
        for i in range(3):
            assert f"request {i} done: 4 tokens" in out
        for bad, match in ((["--priority-classes", "1,x"], "comma-separated integers"),
                           (["--chaos", "1"], "--chaos/--deadline/--priority-classes need "
                                              "--cache paged"),
                           (["--prefill-budget", "64"], "--prefill-budget needs --cache paged")):
            with pytest.raises(SystemExit, match=match):
                serve.main(["--smoke", "--device", "cpu", *bad])


def test_launch_serve_cli_int8_shared_prefix_demo_on_cpu(capsys):
    serve.main(["--cache", "paged", "--smoke", "--kv-dtype", "int8", "--shared-prefix",
                "--gen-len", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "shared-prefix demo: parent 0 + children [1, 2]" in out
    assert "pages aliased across 2 layers (zero rows copied)" in out
    for rid in (0, 1, 2):
        assert f"request {rid} done: 4 tokens" in out
    assert "teardown sweep: 64 pages free (clean)" in out
    for flag in (["--kv-dtype", "int8"], ["--shared-prefix"]):
        with pytest.raises(SystemExit, match=f"{flag[0]} needs --cache paged"):
            serve.main(["--smoke", "--device", "cpu", *flag])


@pytest.mark.parametrize("flags,keys", [
    (["--prefix-cache", "trie"],
     ["prefix cache: 2/3 admissions hit (0.67 hit rate), 128 prefix tokens reused",
      "live / ", " retained / ", " evicted"]),
    (["--speculate", "ngram", "--draft-k", "3"],
     ["speculative (ngram, draft_k=3): ", " accepted/step; ", " KB page DMA per accepted token"]),
])
def test_launch_serve_cli_trie_and_speculation_on_cpu(capsys, flags, keys):
    """The reference's summary lines; --page-size 16 --block-k 32 keep the
    trie's two-block template at 64 tokens on the CPU."""
    serve.main(["--cache", "paged", "--smoke", "--requests", "3", "--gen-len", "3",
                "--page-size", "16", "--block-k", "32", "--prefill-chunk", "16",
                "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "teardown sweep: 64 pages free (clean)" in out
    for key in keys:
        assert key in out, key
    for bad, match in ((["--speculate", "ngram"], "--speculate needs --cache paged"),
                       (["--prefix-cache", "trie"], "--prefix-cache needs --cache paged"),
                       (["--cache", "paged", "--retain-pages", "4"],
                        "--retain-pages needs --prefix-cache trie")):
        with pytest.raises(SystemExit, match=match):
            serve.main(["--smoke", "--device", "cpu", *bad])


@pytest.fixture
def no_cuda(monkeypatch):
    """Behave as a machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_cpu_is_named(no_cuda, models):
    _, (model, params) = models
    with pytest.raises(RuntimeError, match="needs CUDA"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        LayeredPagedKVCache(num_layers=1, num_pages=2, page_size=4, width=8)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        PagedKVCache(num_pages=2, page_size=4, width=8)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        serve.main(["--smoke", "--requests", "1", "--gen-len", "1"])
    with pytest.raises(RuntimeError, match="needs CUDA"):
        convert_params({}, CFG)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    assert p["layers"][0]["attn"]["w_uk"].device.type == "cpu"
    assert p["layers"][0]["attn"]["w_uk"].dtype == torch.float32
