"""The serving sessions' decode steps replayed from CUDA graphs, against the
same walk run eagerly on the card (``step_graph.graphs.enabled`` cleared
on a session: what ``StepGraphs.run(..., eager=True)`` does for one step),
on the smoke configs
with random weights.  Every test is marked ``cuda`` and skips without a
card; this file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_step_graph_cuda.py

Greedy tokens must be identical over 16 steps, and logits within 2e-3, the
card checks' floor in ``chip_smoke.py`` (the graph replays the very kernels
the eager walk launches, on the same inputs, so they are expected to agree
bit for bit; the bound leaves room for a cuBLAS algorithm chosen
differently under capture).  The steps cross KV blocks (a schedule
rebuild replayed by the same graph), grab new pages (block tables that
change between replays), finish a request and admit another (a new batch
size: a new capture).  The dense sessions run the GQA, MLA, MoE, Mamba-2,
RG-LRU hybrid and qwen2-vl (M-RoPE) smoke stacks.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_schedule import queue_capacity
from repro_torch.kernels import mla_decode_combine as port_combine
from repro_torch.kernels import mla_decode_paged as port_paged
from repro_torch.models import moe
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import step_graph
from repro_torch.runtime.serve_loop import (
    PagedServingSession,
    ServingSession,
    ShardedPagedServingSession,
)

TOL = 2e-3
PAGE, BLOCK_K = 16, 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def record_logits(sess):
    """Record each decode step's logits (on the CPU) as the session's
    step graphs return them, after the replay or the eager walk."""
    seen, run = [], sess.step_graph.graphs.run

    def rec(*a, **k):
        out = run(*a, **k)
        seen.append(out.float().cpu())
        return out

    sess.step_graph.graphs.run = rec
    return seen


def params_for(arch, dtype):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator("cuda").manual_seed(0), "cuda", dtype=dtype)


def run_eagerly(sess):
    """Make ``sess`` walk its decode steps eagerly on the card."""
    sess.step_graph.graphs.enabled = False
    return sess


def serve_paged(model, params, graphs, **kw):
    """Prompts of 5, 30, 62 and 17 tokens (30 and 62 cross a 32-row KV
    block after 2 steps), 16 steps; request 0 finishes after step 6 and a
    13-token prompt is admitted after step 10."""
    sess = PagedServingSession(model, params, num_pages=40, page_size=PAGE, block_k=BLOCK_K,
                               num_splits=2, prefill_chunk=16, **kw)
    if not graphs:
        run_eagerly(sess)
    seen = record_logits(sess)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, model.cfg.vocab_size, size=n).tolist() for n in (5, 30, 62, 17)]
    for p in prompts:
        assert sess.add_request(p) is not None
    tables = []
    for i in range(16):
        if i == 6:
            sess.finish(0)
        if i == 10:
            assert sess.add_request(rng.integers(2, model.cfg.vocab_size, size=13).tolist())
        sess.step()
        tables.append(sess.cache.block_table(sess.active, width=sess.table_width))
    return sess, seen, tables


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_graph_matches_eager_walk(cuda_device, dtype, kv_dtype):
    model, params = params_for("deepseek-v2-mla", dtype)
    counts = step_graph.launch_counts()
    graph, g_logits, tables = serve_paged(model, params, True, kv_dtype=kv_dtype)
    g_counts = step_graph.launch_counts()
    eager, e_logits, _ = serve_paged(model, params, False, kv_dtype=kv_dtype)
    e_counts = step_graph.launch_counts()
    assert graph.outputs == eager.outputs
    assert len(g_logits) == len(e_logits) == 16
    worst = max((a - b).abs().max().item() for a, b in zip(g_logits, e_logits))
    print(f"max |graph - eager| = {worst:.3e}")
    assert worst <= TOL
    # batch sizes 4, 3, 4 at queue capacity 16: one capture each (B 4
    # once), each graph replayed over steps whose kv_len, positions and
    # block tables changed
    assert graph.graph_captures == graph.decode_compiles == 2
    assert graph.step_graph.shapes == [(4, 16), (3, 16)]
    assert eager.graph_captures == 0
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(tables[:5], tables[1:6]))
    assert graph.scheduler_stats["rebuilds"] > graph.graph_captures
    # a replay counts what the eager walk launches
    for key in g_counts:
        assert g_counts[key] - counts[key] == e_counts[key] - g_counts[key], key
    queue = ("mla_decode_paged_queue_rows", "int8_launches" if kv_dtype else "launches")
    assert g_counts[queue] - counts[queue] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-mla", "qwen3-moe-30b-a3b",
                                  "granite-moe-3b-a800m", "mamba2-370m", "recurrentgemma-2b",
                                  "qwen2-vl-7b"])
def test_dense_graph_matches_eager_walk(cuda_device, arch):
    """Also the MoE, Mamba-2 and RG-LRU stacks: a recurrent or SSM layer's
    state is advanced by every step, so the capture's warm-ups must leave
    it as they found it; and qwen2-vl, whose M-RoPE positions the graph
    builds on the card from the staged cache lengths."""
    model, params = params_for(arch, torch.bfloat16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, model.cfg.vocab_size, size=n).tolist() for n in (5, 40, 12)]
    runs = []
    for graphs in (True, False):
        sess = ServingSession(model, params, batch_size=2, max_len=64)
        if not graphs:
            run_eagerly(sess)
        seen = record_logits(sess)
        sess.add_request(prompts[0])
        sess.add_request(prompts[1])
        for i in range(16):
            if i == 8:
                sess.finish(0)
                sess.add_request(prompts[2])
            sess.step()
        runs.append((sess, seen))
    (graph, g_logits), (eager, e_logits) = runs
    assert graph.outputs == eager.outputs
    worst = max((a - b).abs().max().item() for a, b in zip(g_logits, e_logits))
    print(f"max |graph - eager| = {worst:.3e}")
    assert worst <= TOL
    assert (graph.graph_captures, eager.graph_captures) == (1, 0)


@pytest.mark.cuda
def test_one_graph_reads_its_buffers_at_every_replay(cuda_device):
    graphs = step_graph.StepGraphs(cuda_device)
    buf = torch.zeros(8, device=cuda_device)
    walk = lambda: buf * 2 + 1
    outs = []
    for v in (1.0, 5.0, -3.0):
        buf.fill_(v)
        outs.append(graphs.run("k", walk).clone())
    assert graphs.captures == 1
    assert [o[0].item() for o in outs] == [3.0, 11.0, -5.0]


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["item", "host_copy"])
def test_a_walk_that_reads_the_host_fails_to_capture(cuda_device, bad):
    """A host value read inside the walk (a sync, or a copy from host
    memory) fails the warm-up under sync debug mode: the capture raises and
    nothing runs eagerly instead; the counts are not left moved."""
    graphs = step_graph.StepGraphs(cuda_device)
    x = torch.ones(4, device=cuda_device)
    walks = {
        "item": lambda: x * x.sum().item(),
        "host_copy": lambda: x + torch.as_tensor(np.arange(4.0, dtype=np.float32), device=x.device),
    }
    before = port_paged.mla_decode_paged_queue_rows.launches, port_combine.combine_split_partials.launches
    with pytest.raises(RuntimeError):
        graphs.run("k", walks[bad])
    assert graphs.captures == 0
    assert torch.cuda.get_sync_debug_mode() == 0
    assert (port_paged.mla_decode_paged_queue_rows.launches,
            port_combine.combine_split_partials.launches) == before


def serve_budgeted_and_suspended(model, params, graphs, scenario):
    """``scenario="budget"``: prompts of 5, 30, 62 and 17 tokens admitted
    under ``prefill_budget=32``, so they join the live batch one by one
    (batch sizes 1..4: a capture each) while later slices land; 16 steps.
    ``scenario="suspend"``: the same prompts phased; request 1 is suspended
    after step 3 and resumed after step 6, and request 2 is suspended while
    request 3 runs and resumed at step 10 (a replay rewrites the rows the
    decode graphs read)."""
    sess = PagedServingSession(model, params, num_pages=40, page_size=PAGE, block_k=BLOCK_K,
                               num_splits=2, prefill_chunk=16,
                               prefill_budget=32 if scenario == "budget" else None)
    if not graphs:
        run_eagerly(sess)
    seen = record_logits(sess)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, model.cfg.vocab_size, size=n).tolist() for n in (5, 30, 62, 17)]
    for p in prompts:
        assert sess.add_request(p) is not None
    for i in range(16):
        if scenario == "suspend":
            if i in (3, 8):
                sess.suspend({3: 1, 8: 2}[i])
            if i in (6, 10):
                assert sess.resume({6: 1, 10: 2}[i])
        sess.step()
    return sess, seen


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["budget", "suspend"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_budgeted_and_resumed_sessions_replay_the_eager_walk(cuda_device, dtype, scenario):
    model, params = params_for("deepseek-v2-mla", dtype)
    graph, g_logits = serve_budgeted_and_suspended(model, params, True, scenario)
    eager, e_logits = serve_budgeted_and_suspended(model, params, False, scenario)
    assert graph.outputs == eager.outputs
    assert len(g_logits) == len(e_logits) > 0
    worst = max((a - b).abs().max().item() for a, b in zip(g_logits, e_logits))
    print(f"{scenario}: {graph.graph_captures} captures {graph.step_graph.shapes}, "
          f"max |graph - eager| = {worst:.3e}")
    assert worst <= TOL
    ws = graph.work_stats()
    if scenario == "budget":
        assert ws["prefill_stall_steps"] == 0 and graph.graph_captures >= 3
    else:
        assert ws["suspends"] == ws["resumes"] == 2 and ws["replay_mismatches"] == 0
    for sess in (graph, eager):
        sess.close()


@pytest.mark.cuda
def test_no_decode_graph_reads_a_pending_prompt(cuda_device):
    """While a 96-token prompt slices in under a budget of one 16-token
    chunk a step, the live requests decode from graphs: the staged block
    table holds only their rows, and NaN written over every page of the
    pending prompt after each step leaves their logits bit-equal to a run
    without it."""
    model, params = params_for("deepseek-v2-mla", torch.bfloat16)
    rng = np.random.default_rng(3)
    live_prompts = [rng.integers(2, model.cfg.vocab_size, size=n).tolist() for n in (7, 40)]
    long = rng.integers(2, model.cfg.vocab_size, size=96).tolist()
    runs = []
    for poison in (False, True):
        sess = PagedServingSession(model, params, num_pages=40, page_size=PAGE,
                                   block_k=BLOCK_K, num_splits=2, prefill_chunk=16,
                                   prefill_budget=16)
        seen = record_logits(sess)
        live = [sess.add_request(p) for p in live_prompts]
        while any(not sess.outputs[r] for r in live):
            sess.step()
        pending = sess.add_request(long)
        del seen[:]
        while sess.prefill_pending:
            sess.step()
            if not sess.prefill_pending:
                break
            cap = queue_capacity(sess._scheduler.current.queue_len,
                                 sess._scheduler.queue_bucket)
            staged = sess.step_graph._staged[(len(sess.active), cap)][0]
            bt, kv = sess.cache.block_table(sess.active, width=sess.table_width)
            assert staged.block_tables.shape[0] == len(sess.active) == len(live)
            assert torch.equal(staged.kv_len.cpu(), torch.from_numpy(kv))
            visible = {int(p) for row, n in zip(bt, kv) for p in row[: -(-int(n) // PAGE)]}
            assert not visible & set(sess.cache.seq_pages(pending))
            if poison:
                for pid in sess.cache.seq_pages(pending):
                    sess.cache.pages[:, pid] = float("nan")
        runs.append([s.clone() for s in seen])
        assert all(torch.isfinite(s).all() for s in runs[-1])
        sess.close()
    assert len(runs[0]) >= 4
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_moe_bf16_products_on_card_match_cpu(cuda_device):
    """On a CUDA tensor cuBLAS writes the fp32 expert products itself
    (``bmm(out_dtype=float32)``): the card's bf16 ``moe_apply`` equals the
    CPU's widened products within 1e-4 of the largest magnitude."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu", dtype=torch.bfloat16)
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, _ = moe.moe_apply(p, x, cfg=cfg, dtype=torch.bfloat16)
    got, _ = moe.moe_apply({k: v.to(cuda_device) for k, v in p.items()}, x.to(cuda_device),
                           cfg=cfg, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-4, f"max |card - CPU| / max |CPU| = {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sharded_head_chunks_graph_matches_eager_walk(cuda_device, dtype):
    """Two logical shards with two head chunks each: every shard replays
    graphs of a walk that launches K2 and K3 once per head chunk; tokens
    and logits equal the eager walk's, and the replays count the eager
    walk's launches."""
    model, params = params_for("deepseek-v2-mla", dtype)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, model.cfg.vocab_size, size=n).tolist() for n in (5, 30, 62, 17)]
    runs = []
    for graphs in (True, False):
        sess = ShardedPagedServingSession(model, params, shards=2, head_shards=2, num_pages=40,
                                          page_size=PAGE, block_k=BLOCK_K, num_splits=2,
                                          prefill_chunk=16)
        seen = []
        for shard in sess.shards:
            if not graphs:
                run_eagerly(shard)
            seen.append(record_logits(shard))
        rids = [sess.add_request(p) for p in prompts]
        before = step_graph.launch_counts()
        for _ in range(8):
            sess.step()
        after = step_graph.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        runs.append(([list(sess.outputs[r]) for r in rids], seen, delta,
                     [s.graph_captures for s in sess.shards]))
    (g_out, g_seen, g_delta, g_caps), (e_out, e_seen, e_delta, e_caps) = runs
    assert g_out == e_out and g_delta == e_delta
    assert min(g_caps) >= 1 and e_caps == [0, 0]
    worst = max((a - b).abs().max().item()
                for gs, es in zip(g_seen, e_seen) for a, b in zip(gs, es))
    print(f"max |graph - eager| = {worst:.3e}")
    assert worst <= TOL
    # 2 layers x 8 steps x 2 shards x 2 head chunks
    assert g_delta["mla_decode_paged_queue_rows", "launches"] == 2 * 8 * 2 * 2
    assert g_delta["combine_split_partials", "launches"] == 2 * 8 * 2 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("g", [8, 64, 256])
def test_head_chunks_of_k2_are_bit_equal(cuda_device, g):
    """K2 + K3 over each half of the query rows equals the matching rows of
    the call over all of them, bit for bit (bf16 rows on the tensor-core
    body; at G 256 the tile height changes between the full call and its
    halves when the grid is near the SM count)."""
    from repro_torch.kernels import ops

    gen = torch.Generator("cuda").manual_seed(g)
    q = torch.randn((3, 1, g, 80), generator=gen, device="cuda").to(torch.bfloat16)
    pool = torch.randn((24, PAGE, 80), generator=gen, device="cuda").to(torch.bfloat16)
    bt = torch.arange(24, dtype=torch.int32, device="cuda").reshape(3, 8)
    kw = dict(d_v=64, scale=0.1, block_k=BLOCK_K, num_splits=2)
    lens = [100, 7, 128]
    full, lse = ops.mla_decode_paged(q, pool, bt, lens, return_partials=True, **kw)
    for lo, hi in ((0, g // 2), (g // 2, g)):
        part, plse = ops.mla_decode_paged(q[:, :, lo:hi].contiguous(), pool, bt, lens,
                                          return_partials=True, **kw)
        assert torch.equal(part, full[:, :, lo:hi]) and torch.equal(plse, lse[:, :, lo:hi])
