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
    for kw in (dict(speculate="ngram"), dict(prefix_cache="trie"), dict(prefill_budget=64),
               dict(prefix_sharing=True), dict(head_shards=2), dict(kv_dtype="int8")):
        with pytest.raises(NotImplementedError):
            PagedServingSession(model, params, num_pages=4, page_size=PAGE, **kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        sess.fork(0)


def test_launch_serve_cli_on_cpu(capsys):
    # --cache dense is the default, as in the reference; this is the paged run
    serve.main(["--cache", "paged", "--smoke", "--requests", "3", "--gen-len", "3",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 decode tokens" in out
    assert "teardown sweep: 64 pages free (clean)" in out


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
