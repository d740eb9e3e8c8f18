#!/usr/bin/env python3
"""Where the time of a decode step (or a train step) of the PyTorch/CUDA port
goes, from a ``torch.profiler`` trace (CPU + CUDA) on the card.

    python3 src/repro_torch/launch/decode_trace.py [--src DIR] [--cells ...] [--steps N]

Serves the cells of ``chip_smoke.py``'s serve phases at their published
widths (random bf16 weights from seed 0, no depth cut), each in steady
state after its prompts are admitted:

* ``paged``: deepseek-v2-mla through ``PagedServingSession(num_pages 32,
  page 128, num_splits 2, prefill_chunk 32, max_batch 4)``, prompts of
  37, 300, 513 and 1100 tokens;
* ``gemma``: gemma2-2b through ``ServingSession(batch 4, max_len 8192)``,
  prompts of 5, 300, 1100 and 4500 tokens;
* ``dense-mla``: the paged cell's weights and prompts through
  ``ServingSession(batch 4, max_len 2048)``;
* ``qwen3-moe``, ``mamba2``, ``recurrentgemma``, ``qwen2-vl`` (not by
  default): the families and vlm phases' dense cells, qwen3-moe-30b-a3b
  (prompts of 5, 300, 1100 and 4500 tokens), mamba2-370m (37, 300, 1100,
  4500), recurrentgemma-2b and qwen2-vl-7b (text-only; 5, 300, 1100,
  4500) through ``ServingSession(batch 4, max_len 8192)``;
* ``k2-pad`` (not by default; needs this tree's ``src``): no session, K2 + K3
  alone at a pool of realistic size, with the work queue padded as the
  decode graphs pad it (:func:`k2_padding_cell`);
* ``train`` (not by default): a training step, not a decode step:
  ``chip_smoke.py``'s train phase (c), qwen1.5-0.5b at full width, fp32
  master parameters from seed 0, ``SyntheticLMData`` batches of 8 x 2048
  tokens, remat, amla (:func:`train_cell`); its window is ``train_step``;
* ``moe-ranks`` (not by default): no trace, the host clock only:
  ``chip_smoke.py``'s cell (h), qwen3-moe-30b-a3b's tensor-parallel
  serve step on 1 x 2 gloo ranks of this card, prefill and ``--timed``
  decode steps, with each call's gloo calls and bytes
  (:func:`moe_ranks_cell`; one JSON line per rank).

Each cell runs ``--warm`` decode steps, then times ``--timed`` steps by the
host clock (each ending in a device sync), then traces ``--steps`` steps.
Every traced step is a window on the host clock (``decode_step`` user
annotation, ending in a device sync); inside it the device's activity
(kernels, copies, sets) is split into:

* ``host_gap_ms``: the window minus the union of device activity (the
  device is idle, waiting for the host);
* ``attention_ms``: the port's hand-written kernels (K2 ``mla_decode_queue``,
  K3 ``combine``, K4 ``mla_decode_rows``, K6 ``gqa_decode``, ...);
* ``cublas_ms``: matrix products (kernels named ``gemm``, ``cutlass``,
  ``nvjet``, ``xmma`` or ``cublas``);
* ``small_ops_ms``: every other kernel (norms, RoPE, casts, indexing,
  scatter, argmax);
* ``copy_ms``: host/device copies and sets;

each the sum of its events' durations (per step), and ``busy_share`` the
union of device activity over the window (traced); ``lead_ms`` is the host time
from the window's start to the first device activity (staging, launch),
``tail_ms`` from the last device activity to the window's end (the greedy
tokens' copy to the host and the session's bookkeeping).  The profiler
slows the host, so the traced window is longer than a ``timed`` step.
The timed steps carry no profiler: CUDA events around each CUDA graph
replay give ``replay_ms_per_step``, the device time of the graphed walk,
and ``replay_share_untraced`` its sum over the timed steps' (0 where a
step replays no graph).  One JSON line per cell.

``--src`` puts another tree's ``src`` first on the path (to trace a parent
commit with this script, run by its path so that the ``repro_torch`` it
lives in is not imported); by default the tree this script lives in.  The
sessions are built through their plain constructors, so the script runs on
any tree whose sessions take these arguments.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ATTENTION = ("mla_decode_queue", "combine_kernel", "mla_decode_rows", "gqa_decode",
             "gqa_rows", "flash_prefill", "mla_decode_padded")
CUBLAS = ("gemm", "cutlass", "nvjet", "xmma", "cublas")
PAGED_PROMPTS, GEMMA_PROMPTS = (37, 300, 513, 1100), (5, 300, 1100, 4500)
# cell -> (arch, prompt lengths), served dense at max_len 8192
FAMILY_CELLS = {
    "qwen3-moe": ("qwen3-moe-30b-a3b", GEMMA_PROMPTS),
    "mamba2": ("mamba2-370m", (37, 300, 1100, 4500)),
    "recurrentgemma": ("recurrentgemma-2b", GEMMA_PROMPTS),
    "qwen2-vl": ("qwen2-vl-7b", GEMMA_PROMPTS),
}


def kind_of(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ATTENTION):
        return "attention"
    if any(k in low for k in CUBLAS):
        return "cublas"
    return "small_ops"


def union_ms(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def split_trace(path: str, window: str = "decode_step") -> dict:
    """Per-step split of the device's activity inside each ``window``
    annotation of a chrome trace (times in µs there, ms here)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    windows = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("name") == window and e.get("cat") == "user_annotation")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    steps, names = [], {}
    for w0, w1 in windows:
        parts = {"attention": 0.0, "cublas": 0.0, "small_ops": 0.0, "copy": 0.0}
        counts = {k: 0 for k in parts}
        spans = []
        for e in device:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b <= a:
                continue
            kind = kind_of(e["name"]) if e["cat"] == "kernel" else "copy"
            parts[kind] += (b - a) / 1e3
            counts[kind] += 1
            spans.append((a, b))
            if e["cat"] == "kernel":
                n, t = names.get(e["name"], (0, 0.0))
                names[e["name"]] = (n + 1, t + (b - a) / 1e3)
        wall = (w1 - w0) / 1e3
        busy = union_ms(spans)
        lead = (min(a for a, _ in spans) - w0) / 1e3 if spans else wall
        tail = (w1 - max(b for _, b in spans)) / 1e3 if spans else 0.0
        steps.append(dict(wall_ms=wall, busy_ms=busy, host_gap_ms=wall - busy,
                          lead_ms=lead, tail_ms=tail, busy_share=busy / wall,
                          **{f"{k}_ms": v for k, v in parts.items()},
                          launches={k: v for k, v in counts.items()}))
    if not steps:
        raise SystemExit(f"no {window} windows in {path}")
    keys = [k for k in steps[0] if k != "launches"]
    mean = {k: float(np.mean([s[k] for s in steps])) for k in keys}
    mean["launches"] = {k: float(np.mean([s["launches"][k] for s in steps]))
                        for k in steps[0]["launches"]}
    mean["per_step"] = [{k: s[k] for k in ("wall_ms", "busy_ms", "host_gap_ms")} for s in steps]
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    mean["top_kernels"] = [(n[:90], c / len(steps), t / len(steps)) for n, (c, t) in top]
    return mean


def steady_state(step, warm: int, timed: int, traced: int, window: str = "decode_step") -> dict:
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    times, replays = [], []
    replay = torch.cuda.CUDAGraph.replay

    def timed_replay(graph):  # CUDA events around each graph replay of a timed step
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        replay(graph)
        t1.record()
        events.append((t0, t1))

    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        for _ in range(timed):
            events = []
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            replays.append(sum(a.elapsed_time(b) for a, b in events))
    finally:
        torch.cuda.CUDAGraph.replay = replay
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            with torch.profiler.record_function(window):
                step()
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        split = split_trace(path, window)
    split["timed_ms_per_step"] = times
    # untraced: the device time of the step's graph replays over its host time
    split["replay_ms_per_step"] = replays
    split["replay_share_untraced"] = float(np.sum(replays) / np.sum(times))
    return split


def prompts_for(cfg, lens):
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in lens]


def captures_of(sess):
    return getattr(sess, "graph_captures", None)


def paged_cell(model, params, args):
    from repro_torch.runtime.serve_loop import PagedServingSession

    sess = PagedServingSession(model, params, num_pages=32, page_size=128, num_splits=2,
                               prefill_chunk=32, max_batch=4)
    for p in prompts_for(model.cfg, PAGED_PROMPTS):
        if sess.add_request(p) is None:
            raise SystemExit("paged cell: admission failed")
    out = steady_state(sess.step, args.warm, args.timed, args.steps)
    out["graph_captures"] = captures_of(sess)
    sess.close()
    return out


def dense_cell(model, params, prompt_lens, max_len, args):
    from repro_torch.runtime.serve_loop import ServingSession

    sess = ServingSession(model, params, batch_size=4, max_len=max_len)
    for p in prompts_for(model.cfg, prompt_lens):
        if sess.add_request(p) is None:
            raise SystemExit("dense cell: admission failed")
    out = steady_state(sess.step, args.warm, args.timed, args.steps)
    out["graph_captures"] = captures_of(sess)
    return out


def k2_padding_cell(args):
    """K2 + K3 (``ops.mla_decode_paged`` over an ``ops.DeviceQueue``, as a
    graphed decode walk calls them in each layer) at deepseek-v2-mla's
    latent width over a pool an H100 holds beside its weights: 3000 pages
    of 128 bf16 rows (0.41 GiB a layer), 64 requests of 1000-8000 tokens
    (seed 0), block_k 512, 2 splits, the block table as wide as the pool
    (as ``PagedServingSession`` makes it).  The work queue three ways:
    as the schedule builds it, padded to its graph capacity
    (``decode_schedule.queue_capacity``), and padded to 64 x the pool's
    blocks (the capacity per batch the graphs were first keyed on).  Mean
    ms of ``--timed`` calls each by CUDA events, in the order schedule,
    capacity, pool, pool, capacity, schedule; outputs compared bit for
    bit with the schedule's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_schedule as sched
    from repro_torch.kernels import ops
    from repro_torch.models.mla_layer import mla_scale

    cfg = get_config("deepseek-v2-mla")
    num_pages, page, b, block_k, splits = 3000, 128, 64, 512, 2
    width = cfg.mla.d_latent + cfg.mla.d_rope
    rng = np.random.default_rng(0)
    lens = rng.integers(1000, 8001, size=b).astype(np.int32)
    need = -(-lens // page)
    if need.sum() > num_pages:
        raise SystemExit("k2-pad: the requests do not fit in the pool")
    perm, bt, used = rng.permutation(num_pages).astype(np.int32), np.zeros((b, num_pages),
                                                                           np.int32), 0
    for r, n in enumerate(need):
        bt[r, :n] = perm[used:used + n]
        used += n
    gen = torch.Generator("cuda").manual_seed(0)
    pages = torch.randn((num_pages, page, width), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    q = torch.randn((b, 1, cfg.n_heads, width), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    bt_t, lens_t = torch.from_numpy(bt).cuda(), torch.from_numpy(lens).cuda()
    s = sched.build_schedule(lens, block_k=block_k, num_splits=splits)
    pool_blocks = -(-num_pages * page // block_k)
    lengths = {"schedule": s.queue_len, "capacity": sched.queue_capacity(s.queue_len),
               "pool": -(-b * pool_blocks // 16) * 16}
    queues = {k: ops._schedule_tensors(s if n == s.queue_len else sched.pad_queue(s, n), "cuda")
              for k, n in lengths.items()}

    def call(queue):
        return ops.mla_decode_paged(q, pages, bt_t, lens_t, d_v=cfg.mla.d_latent,
                                    scale=mla_scale(cfg), block_k=block_k, num_splits=splits,
                                    schedule=queue)

    want = call(queues["schedule"])
    equal = {k: bool(torch.equal(call(v), want)) for k, v in queues.items()}
    times = {k: [] for k in queues}
    for k in ("schedule", "capacity", "pool", "pool", "capacity", "schedule"):
        call(queues[k])
        torch.cuda.synchronize()
        for _ in range(args.timed):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            call(queues[k])
            t1.record()
            t1.synchronize()
            times[k].append(t0.elapsed_time(t1))
    return {"num_items": s.num_items, "queue_len": lengths, "bit_equal": equal,
            "ms": {k: float(np.mean(v)) for k, v in times.items()},
            "ms_runs": {k: [float(np.mean(v[:args.timed])), float(np.mean(v[args.timed:]))]
                        for k, v in times.items()},
            "kv_tokens": int(lens.sum()), "pages_used": int(need.sum())}


def train_cell(args):
    """Train steps of qwen1.5-0.5b at full width (``chip_smoke.py``'s train
    phase (c)): the window is one whole step (data, forward, backward,
    AdamW), ending in the loss's copy to the host; ``attention_ms`` is K7
    (the forward and the remat recompute), the blockwise backward falls
    in ``cublas_ms`` (its fp32 products) and ``small_ops_ms``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    params, opt, comp = init_train_state(model, torch.Generator("cuda").manual_seed(0), "cuda")
    train_step = make_train_step(model, TrainConfig(peak_lr=3e-4, warmup_steps=2,
                                                    total_steps=100, remat=True))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=2048, global_batch=8, seed=0)
    state = [params, opt, comp, 0]

    def step():
        p, o, c, i = state
        p, o, c, m = train_step(p, o, c, data.batch_at(i), i)
        float(m["loss"])
        state[:] = [p, o, c, i + 1]

    res = steady_state(step, args.warm, args.timed, args.steps, window="train_step")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def _moe_rank(rank, src, store, steps, out):
    """One of :func:`moe_ranks_cell`'s two ranks (a spawned process on
    ``cuda:0``): puts ``(rank, results)`` or ``(rank, traceback)`` on
    ``out``."""
    import traceback

    try:
        sys.path.insert(0, os.path.abspath(src))
        import torch.distributed as dist

        from repro_torch.configs import get_config
        from repro_torch.core import distributed, tree
        from repro_torch.launch.mesh import init_process_group, rank_mesh
        from repro_torch.models import transformer
        from repro_torch.models.model_zoo import build_model
        from repro_torch.runtime import mesh_ctx, sharding
        from repro_torch.runtime.serve_loop import jit_serve_fns

        torch.backends.cuda.matmul.allow_tf32 = False
        init_process_group("gloo", rank=rank, world_size=2, store=dist.FileStore(store, 2),
                           device="cuda")
        cfg = get_config("qwen3-moe-30b-a3b")
        model = build_model(cfg)
        mesh = rank_mesh("1x2", "cuda")
        like = model.init(None, "meta")
        prefill, decode, sh = jit_serve_fns(model, mesh, like, model.init_cache(like, 4, 2048),
                                            policy="tp")
        flat = dict(tree.leaves_with_paths(sh["params"]))
        local = transformer.lm_init(torch.Generator("cuda").manual_seed(0), cfg,
                                    device=torch.device("cuda"), dtype=model.dtype,
                                    keep=lambda p, t: sharding.shard_one(t, flat[p]).clone())
        shapes = {p: t.shape for p, t in tree.leaves_with_paths(like)}
        params = tree.map_with_paths(lambda p, t: sharding.from_local(t, flat[p], shapes[p]),
                                     local)
        cflat = dict(tree.leaves_with_paths(sh["cache"]))
        cache = tree.map_with_paths(lambda p, t: sharding.from_local(
            sharding.shard_one(t, cflat[p]).clone(), cflat[p], t.shape),
            model.init_cache(local, 4, 2048))
        prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(4, 64))
        tokens = [torch.as_tensor(prompts, dtype=torch.int64, device="cuda")]
        mesh_ctx.TP_COUNTS.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, calls, gib = [], [], []
        for i in range(1 + steps):  # the prefill, then one token a step at per-row lengths
            call = prefill(tokens[0]) if i == 0 else decode(tokens[-1])
            extra = () if i == 0 else (np.full((4,), 63 + i, np.int32),)
            n0 = sum(distributed.COLLECTIVES.values())
            b0 = sum(distributed.COLLECTIVE_BYTES.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = call(params, cache, tokens[-1], *extra)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            calls.append(sum(distributed.COLLECTIVES.values()) - n0)
            gib.append((sum(distributed.COLLECTIVE_BYTES.values()) - b0) / 2**30)
            tokens.append(logits[:, -1].argmax(-1)[:, None])
        out.put((rank, dict(ms=ms, gloo_calls=calls, gloo_gib=gib,
                            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                            resident_gib=sum(t.nbytes for t in tree.leaves(local)) / 2**30,
                            counts=dict(mesh_ctx.TP_COUNTS),
                            tokens=torch.cat(tokens[1:], 1).cpu().tolist())))
        dist.destroy_process_group()
    except Exception:  # the parent reports the rank's traceback
        out.put((rank, traceback.format_exc()))


def moe_ranks_cell(args) -> list:
    """``chip_smoke.py``'s cell (h), timed on its own: qwen3-moe-30b-a3b
    at full width under ``tp`` on 1 x 2 gloo ranks of this card (two
    spawned processes, each drawing its shards from seed 0), 4 prompts of
    64 tokens (seed 0) prefilled into a 2048-row cache, then ``--timed``
    greedy decode steps; each call timed by the host clock ending in a
    device sync, with its gloo calls and bytes.  No trace: the step is
    gloo-bound.  Runs on any tree whose ``jit_serve_fns`` and
    ``lm_init(keep=)`` take these arguments (``--src``: a parent's, whose
    ranks gather the experts at their use).  Returns each rank's
    results."""
    import queue

    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=_moe_rank, args=(r, args.src, store, args.timed, out),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < 2:
            rank, value = out.get(timeout=1800)
            if isinstance(value, str):
                raise RuntimeError(f"moe-ranks: rank {rank} failed:\n{value}")
            res[rank] = value
    except queue.Empty:
        raise RuntimeError("moe-ranks: the ranks did not finish in 1800 s") from None
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
    return [res[0], res[1]]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  os.pardir, os.pardir))
    ap.add_argument("--cells", nargs="+", default=["paged", "gemma", "dense-mla"],
                    choices=["paged", "gemma", "dense-mla", "k2-pad", "train", "moe-ranks",
                             *FAMILY_CELLS])
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--timed", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_trace: CUDA is not available; this script traces the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; src {os.path.abspath(args.src)}", flush=True)
    if "k2-pad" in args.cells:
        print(json.dumps({"cell": "k2 queue padding", "label": args.label, "card": smi,
                          **k2_padding_cell(args)}), flush=True)
    if "train" in args.cells:
        print(json.dumps({"cell": "qwen1.5-0.5b train", "label": args.label, "card": smi,
                          **train_cell(args)}), flush=True)
        torch.cuda.empty_cache()
    if "moe-ranks" in args.cells:
        for rank, res in enumerate(moe_ranks_cell(args)):
            print(json.dumps({"cell": "qwen3-moe-30b-a3b tp 1x2 ranks", "rank": rank,
                              "label": args.label, "card": smi, **res}), flush=True)
    if "gemma" in args.cells:
        cfg = get_config("gemma2-2b")
        model = build_model(cfg)
        params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
        res = dense_cell(model, params, GEMMA_PROMPTS, 8192, args)
        print(json.dumps({"cell": "gemma2-2b dense", "label": args.label, "card": smi, **res}),
              flush=True)
        del model, params
        torch.cuda.empty_cache()
    for cell in (c for c in FAMILY_CELLS if c in args.cells):
        arch, prompt_lens = FAMILY_CELLS[cell]
        model = build_model(get_config(arch))
        params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
        res = dense_cell(model, params, prompt_lens, 8192, args)
        print(json.dumps({"cell": f"{arch} dense", "label": args.label, "card": smi, **res}),
              flush=True)
        del model, params, res
        torch.cuda.empty_cache()
    if {"paged", "dense-mla"} & set(args.cells):
        cfg = get_config("deepseek-v2-mla")
        model = build_model(cfg)
        params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
        if "paged" in args.cells:
            res = paged_cell(model, params, args)
            print(json.dumps({"cell": "deepseek-v2-mla paged", "label": args.label, "card": smi,
                              **res}), flush=True)
        if "dense-mla" in args.cells:
            res = dense_cell(model, params, PAGED_PROMPTS, 2048, args)
            print(json.dumps({"cell": "deepseek-v2-mla dense", "label": args.label, "card": smi,
                              **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
