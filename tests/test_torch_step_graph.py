"""The decode steps of the port's serving sessions split into host staging
and a device walk over fixed buffers (``repro_torch.runtime.step_graph``),
checked on the CPU, where the walk runs uncaptured over the same buffers.

* The staged paged walk against the JAX reference's ``lm_decode_step_paged``
  (Pallas in interpret mode) at fp32 compute on the deepseek-v2-mla smoke
  config, over fp32, bf16 and int8 pages, across steps where requests
  cross a KV block (a schedule rebuild) and a request finishes (a new
  batch size): logits within 2e-3 (the reference's AMLA fp32 tolerance, as
  in ``test_torch_model.py``; both sides round the latents to bf16 pages
  the same way; 3e-2 over int8 pages, the reference's int8 bound) and
  identical greedy tokens; and against the parent's eager walk
  (unpadded schedule, positions as a device tensor): bit for bit.
* The dense staged walk against the JAX ``ServingSession`` (tokens) and
  the eager ``decode_step`` over host lengths (logits, bit for bit).
* A queue padded to capacity with ``item_valid = 0`` gives bit-identical
  output through the plain K2 + K3; the capacity is the bucket times the
  least power of two that holds the queue, and a step whose queue outgrows
  it stages (and on the card captures) a key of its own.
* Launch accounting: with stand-ins for the CUDA graph API and for the
  kernel library (as ``test_torch_gqa_mma.py`` uses), a replayed step adds
  the launches recorded at capture, each time; warm-ups and the capture
  are not counted.
* The repairs: an ``S > 1`` step hands ``ops.mla_decode_paged`` host
  positions; bf16 unembedding multiplies by an fp32 table made with the
  parameters, and a call leaves them as they were.
"""

import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro.models.model_zoo import build_model as ref_build_model
from repro.runtime.kv_cache import LayeredPagedKVCache as RefCache
from repro.runtime.serve_loop import ServingSession as RefSession
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_schedule as sched
from repro_torch.kernels import gqa_decode as port_gqa
from repro_torch.kernels import mla_decode_combine as port_combine
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.mla_layer import mla_scale
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import step_graph
from repro_torch.runtime.kv_cache import LayeredPagedKVCache
from repro_torch.runtime.serve_loop import PagedServingSession, ServingSession

REF_CFG = ref_get_config("deepseek-v2-mla", smoke=True)
CFG = get_config("deepseek-v2-mla", smoke=True)
PAGE, BLOCK_K, CHUNK, NUM_PAGES = 16, 32, 16, 24
TOL = {"f32": 2e-3, "bf16": 2e-3, "int8": 3e-2}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the reference's queue kernel run in interpret mode on this jax,
    which renamed ``pltpu.TPUMemorySpace`` to ``MemorySpace``.  The alias
    is undone after each test, and so are the jit traces made under it
    (a cached trace would change a later reference test's outcome)."""
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace, raising=False)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights():
    ref_params = ref_build_model(REF_CFG).init(jax.random.PRNGKey(0))
    return ref_params, convert_params(ref_params, CFG, device="cpu")


def parent_walk(params, plan, cache, *, num_splits):
    """The decode walk as the parent commit ran it, eagerly: fresh device
    copies of the staged arrays, the unpadded schedule, the positions as a
    device tensor, every layer through ``ops.mla_decode_paged``."""
    b, s = plan.tokens.shape
    t = lambda a: torch.as_tensor(a, device=cache.device)
    bt, kv_len, pos = t(plan.block_tables), t(plan.kv_len), t(plan.positions)
    x = tf.embed_tokens(params, t(plan.tokens), cfg=CFG)
    for l, p_l in enumerate(params["layers"]):
        lat, q = tf.paged_attn_inputs(p_l, x, pos, cfg=CFG)
        cache.write_layer_tokens(l, t(plan.pids), t(plan.offs), lat.reshape(b * s, -1))
        attn = ops.mla_decode_paged(
            q, cache.layer_pages(l), bt, kv_len, kv_scales=cache.layer_scales(l),
            d_v=CFG.mla.d_latent, scale=mla_scale(CFG), block_k=plan.block_k,
            num_splits=num_splits, schedule=plan.schedule, compute_dtype=torch.float32,
        )
        x = tf.paged_layer_post(p_l, x, attn, cfg=CFG)
    return tf.paged_logits(params, x, cfg=CFG)


def _caches(kv):
    ref_dtype, dtype = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
                        "int8": (jnp.int8, torch.int8)}[kv]
    geom = dict(num_layers=CFG.n_layers, num_pages=NUM_PAGES, page_size=PAGE, width=80)
    return (RefCache(**geom, dtype=ref_dtype),
            LayeredPagedKVCache(**geom, dtype=dtype, device="cpu"),
            LayeredPagedKVCache(**geom, dtype=dtype, device="cpu"))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_staged_walk_matches_reference_and_parent_walk(pallas_interpret, weights, kv):
    """Prompts of 30, 9 and 62 tokens, 6 steps: requests 0 and 2 cross a
    32-row KV block at the third step (a schedule rebuild on the same
    buffers) and request 1 finishes before the fifth (B 3 -> 2: buffers of
    their own)."""
    ref_params, params = weights
    rcache, gcache, pcache = _caches(kv)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in (30, 9, 62)]
    for rid, prompt in enumerate(prompts):
        for c in (rcache, gcache, pcache):
            c.alloc(rid)
        ref_tf.lm_prefill_paged(ref_params, prompt, cfg=REF_CFG, cache=rcache, rid=rid,
                                chunk=CHUNK, table_width=NUM_PAGES, block_k=BLOCK_K,
                                interpret=True, compute_dtype=jnp.float32)
        for c in (gcache, pcache):
            tf.lm_prefill_paged(params, prompt, cfg=CFG, cache=c, rid=rid, chunk=CHUNK,
                                table_width=NUM_PAGES, block_k=BLOCK_K,
                                compute_dtype=torch.float32)
    step = step_graph.PagedDecodeStep(
        params, gcache, cfg=CFG, scheduler=sched.DecodeScheduler(block_k=BLOCK_K, num_splits=2),
        table_width=NUM_PAGES, block_k=BLOCK_K, num_splits=2, compute_dtype=torch.float32)
    rids, tokens = [0, 1, 2], np.asarray([[7], [300], [41]])
    for i in range(6):
        if i == 4:
            rids, tokens = [0, 2], tokens[[0, 2]]
            for c in (rcache, gcache, pcache):
                c.free(1)
        want = np.asarray(ref_tf.lm_decode_step_paged(
            ref_params, tokens.astype(np.int32), cfg=REF_CFG, cache=rcache, rids=rids,
            table_width=NUM_PAGES, block_k=BLOCK_K, num_splits=2, interpret=True,
            compute_dtype=jnp.float32))
        got = step(tokens, rids)
        plan = tf.stage_decode_step_paged(tokens, cfg=CFG, cache=pcache, rids=rids,
                                          table_width=NUM_PAGES, block_k=BLOCK_K, num_splits=2)
        parent = parent_walk(params, plan, pcache, num_splits=2)
        assert got.shape == want.shape == (len(rids), 1, CFG.vocab_size)
        assert np.abs(got.numpy() - want).max() <= TOL[kv], i
        assert torch.equal(got, parent), i
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1)), i
        tokens = want.argmax(-1)
    assert torch.equal(gcache.pages, pcache.pages)
    assert step.graphs.captures == 0  # the CPU walks uncaptured
    assert step.scheduler.rebuilds == 3  # first step, the block crossing, the finish


def test_staged_buffers_keep_their_addresses(weights):
    """One set of tensors per batch size, refilled in place each step; the
    queue holds the padded schedule of the step."""
    _, params = weights
    sess = PagedServingSession(build_model(CFG), params, num_pages=NUM_PAGES, page_size=PAGE,
                               block_k=BLOCK_K, num_splits=2, prefill_chunk=CHUNK)
    rng = np.random.default_rng(4)
    for n in (30, 5):
        sess.add_request(rng.integers(2, CFG.vocab_size, size=n).tolist())
    step = sess.step_graph
    ptrs = None
    for _ in range(4):
        sess.step()
        inputs, queue, staged = step._staged[2, 16]
        now = [t.data_ptr() for t in (inputs.tokens, inputs.kv_len, *queue.items)]
        assert ptrs is None or now == ptrs
        ptrs = now
        padded = sched.pad_queue(staged, 16)
        assert staged is sess._scheduler.current
        for t, a in zip(queue.items, padded.prefetch_arrays()):
            assert t.shape == (16,) and np.array_equal(t.numpy(), a)
        assert np.array_equal(inputs.kv_len.numpy(), [sess.cache.seq_len(r) for r in sess.active])
    assert sess.graph_captures == 0 and step.shapes == [(2, 16)]


def test_a_queue_that_outgrows_its_capacity_takes_a_key_of_its_own(weights):
    """16-row KV blocks, prompts of 95, 95 and 60 tokens: 16 queue items
    (capacity 16) until the second step's appends take two requests into
    a seventh block (18 items, capacity 32).  Every step's logits equal
    the parent's eager walk, bit for bit, and the second key's tensors are
    its own."""
    _, params = weights
    gcache, pcache = _caches("bf16")[1:]
    rng = np.random.default_rng(6)
    for rid, n in enumerate((95, 95, 60)):
        prompt = rng.integers(2, CFG.vocab_size, size=n).tolist()
        for c in (gcache, pcache):
            c.alloc(rid)
            tf.lm_prefill_paged(params, prompt, cfg=CFG, cache=c, rid=rid, chunk=CHUNK,
                                table_width=NUM_PAGES, block_k=16, compute_dtype=torch.float32)
    step = step_graph.PagedDecodeStep(
        params, gcache, cfg=CFG, scheduler=sched.DecodeScheduler(block_k=16, num_splits=2),
        table_width=NUM_PAGES, block_k=16, num_splits=2, compute_dtype=torch.float32)
    tokens = np.asarray([[7], [300], [41]])
    for i in range(4):
        got = step(tokens, [0, 1, 2])
        plan = tf.stage_decode_step_paged(tokens, cfg=CFG, cache=pcache, rids=[0, 1, 2],
                                          table_width=NUM_PAGES, block_k=16, num_splits=2)
        assert torch.equal(got, parent_walk(params, plan, pcache, num_splits=2)), i
        assert step.shapes == ([(3, 16)] if i == 0 else [(3, 16), (3, 32)]), i
        tokens = got.argmax(-1).numpy()
    old, new = step._staged[3, 16], step._staged[3, 32]
    assert new[1].items[0].shape == (32,) and new[0].tokens.data_ptr() != old[0].tokens.data_ptr()
    assert step.scheduler.current.queue_len == 32 and step.scheduler.current.num_items == 18


def test_queue_capacity_is_the_bucket_times_a_power_of_two():
    cap = sched.queue_capacity
    assert [cap(n) for n in (0, 1, 16, 17, 32, 33, 48, 64, 65, 1000)] == \
        [16, 16, 16, 32, 32, 64, 64, 64, 128, 1024]
    assert [cap(n, 1) for n in (0, 1, 3, 5)] == [1, 1, 4, 8]
    assert [cap(n, 0) for n in (1, 2, 3)] == [1, 2, 4]
    for n in range(1, 3000, 7):  # never more than twice a bucketed queue
        q = -(-n // 16) * 16
        assert q <= cap(q) < 2 * q or cap(q) == 16


def test_graph_step_takes_one_row_per_request(weights):
    _, params = weights
    cache = LayeredPagedKVCache(num_layers=CFG.n_layers, num_pages=4, page_size=PAGE, width=80,
                                dtype=torch.float32, device="cpu")
    cache.alloc(0)
    step = step_graph.PagedDecodeStep(params, cache, cfg=CFG, scheduler=sched.DecodeScheduler(
        block_k=BLOCK_K), table_width=4, block_k=BLOCK_K, num_splits=1)
    with pytest.raises(ValueError, match="one token per request"):
        step(np.zeros((1, 2), np.int64), [0])
    assert cache.seq_len(0) == 0  # nothing reserved


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-mla"])
def test_dense_staged_walk_matches_reference_and_eager_step(pallas_interpret, arch):
    """The session's staged walk against the JAX session (greedy tokens over
    a finish and a re-admission) and each step's logits against the eager
    ``decode_step`` over host lengths, on a copy of the caches."""
    import dataclasses

    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), attn_impl="pallas_interpret")
    cfg = get_config(arch, smoke=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = convert_params(ref_params, cfg, device="cpu")
    ref = RefSession(ref_model, ref_params, batch_size=2, max_len=64)
    port = ServingSession(model, params, batch_size=2, max_len=64)
    run, checked = port.step_graph.graphs.run, []

    def check(key, walk, eager=False):
        # the parent's eager step, on a copy of the caches taken before the walk
        cache = [{k: t.clone() for k, t in c.items()} for c in port.cache]
        want, _ = model.decode_step(params, cache, torch.as_tensor(
            port.last_token[:, None].astype(np.int64)), port.cache_len.copy())
        got = run(key, walk, eager=eager)
        checked.append(torch.equal(got, want))
        return got

    port.step_graph.graphs.run = check
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 12)]
    for s in (ref, port):
        assert (s.add_request(prompts[0]), s.add_request(prompts[1])) == (0, 1)
        for _ in range(5):
            s.step()
        s.finish(0)
        assert s.add_request(prompts[2]) == 2
        for _ in range(3):
            s.step()
    assert port.outputs == ref.outputs
    assert checked == [True] * 8
    assert port.graph_captures == 0


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("num_splits", [1, 2, 3])
def test_padded_queue_is_bit_identical(pool, num_splits):
    rng = np.random.default_rng(num_splits)
    kv_lens = np.asarray([0, 1, 33, 200, 95], np.int32)
    page, block_k, width, w = 16, 32, 64, 16
    num_pages = 90
    bt = rng.permutation(num_pages)[: 5 * w].reshape(5, w).astype(np.int32)
    pages = torch.from_numpy(rng.normal(0, 1, (num_pages, page, width)).astype(np.float32))
    scales = None
    if pool == "int8":
        pages = torch.from_numpy(rng.integers(-127, 128, (num_pages, page, width)).astype(np.int8))
        scales = torch.from_numpy(rng.uniform(0.01, 0.02, (num_pages, page)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (5, 1, 4, width)).astype(np.float32))
    s = sched.build_schedule(kv_lens, block_k=block_k, num_splits=num_splits)
    cap = sched.queue_capacity(s.queue_len + 1)
    padded = sched.pad_queue(s, cap)
    assert padded.queue_len == cap > s.queue_len and padded.num_items == s.num_items
    assert not padded.item_valid[s.queue_len:].any()
    kw = dict(kv_scales=scales, d_v=48, scale=0.125, block_k=block_k, num_splits=num_splits,
              compute_dtype=torch.float32)
    args = (q, pages, torch.from_numpy(bt), torch.from_numpy(kv_lens))
    want = ops.mla_decode_paged(*args, schedule=s, **kw)
    assert torch.equal(ops.mla_decode_paged(*args, schedule=padded, **kw), want)
    queue = ops._schedule_tensors(padded, "cpu")
    assert torch.equal(ops.mla_decode_paged(*args, schedule=queue, **kw), want)
    with pytest.raises(ValueError, match="does not fit"):
        sched.pad_queue(padded, cap - 16)


# --------------------------------------------------------------------------- #
# launch accounting, with stand-ins for CUDA graphs and the kernel library
# --------------------------------------------------------------------------- #
class _Lib:
    """Stands in for the kernel library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


class _Graph:
    captured = replays = 0

    def replay(self):
        _Graph.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA graph API as stand-ins that run nothing on a card: a
    capture runs the walk once, a replay only counts itself."""
    lib = _Lib()
    modes = []
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(port_gqa, "_sm_count", lambda device: 132)
    stream = types.SimpleNamespace(cuda_stream=0, wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)

    @contextlib.contextmanager
    def graph(g, pool=None):
        assert pool == "pool"
        _Graph.captured += 1
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    _Graph.captured = _Graph.replays = 0
    return lib, modes


def test_replay_adds_the_captured_launches(fake_cuda):
    """A bf16 K6 launch and a K3 launch as the walk: the two warm-ups and
    the capture launch them three times and count nothing; every replay
    counts one K6 (tensor-core) and one K3 launch."""
    lib, modes = fake_cuda
    rn = lambda shape, seed: torch.from_numpy(
        np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16)
    q, k, v = rn((2, 2, 4, 64), 0), rn((2, 2, 1300, 64), 1), rn((2, 2, 1300, 64), 2)
    lens = torch.full((2,), 1300, dtype=torch.int32)
    pos = torch.full((2, 4), 1299, dtype=torch.int32)
    o, lse = torch.zeros((3, 4, 64)), torch.zeros((3, 4, 1))
    dest, n_splits = port_gqa.split_tables(1, 3, torch.device("cpu"))

    def walk():
        port_gqa._decode_cuda(q, k, v, lens, pos, variant="amla", scale=1 / math.sqrt(64),
                              block_k=512, softcap=None, window=None)
        return port_combine._combine_cuda([o], [lse], dest, n_splits)
    graphs = step_graph.StepGraphs("cuda")
    assert graphs.enabled
    k6, k3 = port_gqa.gqa_decode_rows, port_combine.combine_split_partials
    before = (k6.launches, k6.mma_launches, k3.launches)
    for n in range(1, 5):
        graphs.run(7, walk)
        assert (k6.launches, k6.mma_launches, k3.launches) == tuple(b + n for b in before)
        assert _Graph.replays == n
    assert graphs.captures == _Graph.captured == 1
    names = [name for name, _ in lib.calls]
    assert names == ["amla_gqa_decode", "amla_combine_split_partials"] * 3
    assert modes == ["error", 0]  # the second warm-up under sync debug mode, then restored
    graphs.run(7, walk, eager=True)  # an eager run counts as it launches
    assert k6.launches == before[0] + 5 and len(lib.calls) == 8


def test_failed_capture_takes_its_launches_back(fake_cuda):
    lib, _ = fake_cuda
    graphs = step_graph.StepGraphs("cuda")
    before = step_graph.launch_counts()

    def walk():
        port_combine.combine_split_partials.launches += 1
        if _Graph.captured:
            raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.run("k", walk)
    assert graphs.captures == 0 and step_graph.launch_counts() == before


def test_cpu_runs_the_walk_uncaptured():
    graphs = step_graph.StepGraphs("cpu")
    calls = []
    assert not graphs.enabled
    assert graphs.run("k", lambda: calls.append(1) or torch.ones(2)).sum() == 2
    assert graphs.captures == 0 and calls == [1]


# --------------------------------------------------------------------------- #
# the repairs
# --------------------------------------------------------------------------- #
def test_multi_row_step_hands_host_positions(weights, monkeypatch):
    """An S > 1 step passes the host positions as ``q_positions`` (so their
    values are checked wherever the tensors lie); S = 1 passes none."""
    _, params = weights
    seen = []
    real = ops.mla_decode_paged

    def recording(*a, q_positions=None, **k):
        seen.append(q_positions)
        return real(*a, q_positions=q_positions, **k)

    monkeypatch.setattr(ops, "mla_decode_paged", recording)
    cache = LayeredPagedKVCache(num_layers=CFG.n_layers, num_pages=8, page_size=PAGE, width=80,
                                dtype=torch.float32, device="cpu")
    for rid, n in ((0, 20), (1, 3)):
        cache.alloc(rid)
        tf.lm_prefill_paged(params, list(range(2, 2 + n)), cfg=CFG, cache=cache, rid=rid,
                            chunk=CHUNK, block_k=BLOCK_K, compute_dtype=torch.float32)
    seen.clear()
    tf.lm_decode_step_paged(params, np.asarray([[5, 6, 7], [8, 9, 10]]), cfg=CFG, cache=cache,
                            rids=[0, 1], block_k=BLOCK_K, compute_dtype=torch.float32)
    assert len(seen) == CFG.n_layers
    for pos in seen:
        assert isinstance(pos, np.ndarray)
        np.testing.assert_array_equal(pos, [[20, 21, 22], [3, 4, 5]])
    seen.clear()
    tf.lm_decode_step_paged(params, np.asarray([[5], [8]]), cfg=CFG, cache=cache, rids=[0, 1],
                            block_k=BLOCK_K, compute_dtype=torch.float32)
    assert seen == [None] * CFG.n_layers


def test_bf16_unembed_uses_the_fp32_table_made_at_load():
    """The fp32 copy is made with the parameters (``keep_fp32_table``, as
    ``lm_init`` and ``convert_params`` call it), never by ``unembed``, and
    gives the logits the parent's per-call cast gave, bit for bit."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(0, 1, (50, 16)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 16)).astype(np.float32))
    # what the parent computed: the whole table cast per call
    logits = torch.matmul(x.to(torch.bfloat16).to(torch.float32), table.T.to(torch.float32))
    want = 30.0 * torch.tanh(logits / 30.0)
    bare = {"table": table}
    assert torch.equal(layers.unembed(bare, x, softcap=30.0), want)
    assert list(bare) == ["table"]  # a call adds nothing to the parameters
    params = layers.keep_fp32_table({"table": table})
    copy = params["table_f32"]
    assert copy.dtype == torch.float32 and torch.equal(copy, table.float())
    params["table"] = table.clone().fill_(0)  # the copy, not the table, is multiplied
    got = layers.unembed(params, x, softcap=30.0)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert params["table_f32"] is copy and list(params) == ["table", "table_f32"]
    # fp32 tables keep no copy, and unembedding multiplies the table itself
    p32 = layers.keep_fp32_table({"table": table.float()})
    assert torch.equal(layers.unembed(p32, x, dtype=torch.float32), x @ table.float().T)
    assert "table_f32" not in p32


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-mla"])
def test_bf16_parameters_are_built_with_the_fp32_table(weights, arch):
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init(torch.Generator("cpu").manual_seed(0), "cpu",
                                   dtype=torch.bfloat16)
    table = params.get("unembed", params["embed"])
    assert table["table"].dtype == torch.bfloat16
    assert torch.equal(table["table_f32"], table["table"].float())
    p32 = build_model(cfg).init(torch.Generator("cpu").manual_seed(0), "cpu", dtype=torch.float32)
    assert "table_f32" not in p32.get("unembed", p32["embed"])
    _, converted = weights  # fp32 reference leaves: no copy
    assert list(converted["embed"]) == ["table"]
