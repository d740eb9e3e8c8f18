#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA H100 (``python3 chip_smoke.py`` from the repository
root) and exits nonzero on any failure:

1. **Build** the hand-written CUDA kernels from ``src/repro_torch/csrc``.
2. **Kernel phase**: the paged AMLA decode kernel (K2) and the split-KV
   combine (K3) on the card, held against their plain PyTorch versions on
   the same inputs, bf16 and fp32, at full width (Dk 576, Dv 512, page 128,
   block_k 512) for a decode step (G = 128 rows) and a prefill chunk
   (G = 4096 rows); ragged kv_len (0, 1, unaligned, 8 blocks), one and two
   splits, causal row positions.  Each kernel is timed beside its bound,
   its plain version and, where one exists, a single PyTorch call.
3. **Serve phase**: ``deepseek-v2-mla`` at its published widths, random
   bf16 weights from a seed, served through ``PagedServingSession`` and the
   ``launch/serve`` stream loop: 4 ragged prompts, 16 greedy tokens each,
   ``num_splits=2``.  The kernel launch counters must show that every
   prefill chunk and decode step of every layer went through K2 and K3.

Imports nothing of JAX or of the JAX package.  Takes no arguments.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
# Kernel vs plain version on the same inputs (outputs are O(1)).
# fp32 "base": only summation order and expf-vs-torch.exp ulps differ.
# fp32 "amla": the 1.5*eps mantissa compensation of the int32 rescale is an
# approximation (paper App. A, up to ~1e-3 relative); where the two exps
# differ by an ulp at a bf16 rounding boundary of 1/r, kernel and plain pick
# different S16 and so make different approximation errors — the reference
# holds AMLA to 2e-3 at fp32 for the same reason.  bf16: p*S16 is rounded to
# bf16 before P.V, so an ulp of exp can move a probability by 2^-8.
TOL = {
    (torch.float32, "base"): 1e-4,
    (torch.float32, "amla"): 2e-3,
    (torch.bfloat16, "base"): 1e-2,
    (torch.bfloat16, "amla"): 1e-2,
}
DK, DV, PAGE, BLOCK_K = 576, 512, 128, 512


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Mean ms per call on the card, CUDA events around each call, the L2
    cache overwritten between calls (the serve path reads each layer's
    pages cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.add_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# --------------------------------------------------------------------------- #
# kernel phase
# --------------------------------------------------------------------------- #


def make_case(seed, kv_lens, g, dtype, num_splits, q_pos_fn):
    """Random pool + fragmented block tables + queries on the card."""
    from repro_torch.kernels import decode_schedule as sched

    rng = np.random.default_rng(seed)
    kv = np.asarray(kv_lens, np.int32)
    w = max(1, int(max(-(-int(l) // PAGE) for l in kv)))
    num_pages = len(kv) * w + 5
    bt = rng.permutation(num_pages)[: len(kv) * w].reshape(len(kv), w).astype(np.int32)
    pages = torch.randn(
        (num_pages, PAGE, DK), generator=torch.Generator("cuda").manual_seed(seed),
        device="cuda", dtype=torch.float32,
    ).to(dtype)
    q = torch.randn(
        (len(kv), g, DK), generator=torch.Generator("cuda").manual_seed(seed + 1),
        device="cuda", dtype=torch.float32,
    ).to(dtype)
    q_pos = np.stack([q_pos_fn(int(l), g) for l in kv]).astype(np.int32)
    s = sched.build_schedule(kv, block_k=BLOCK_K, num_splits=num_splits)
    dev = lambda a: torch.as_tensor(a, dtype=torch.int32, device="cuda")
    return dict(
        q=q, pages=pages, bt=dev(bt), kv=dev(kv), kv_host=kv, q_pos=dev(q_pos),
        q_pos_host=q_pos, items=[dev(a) for a in s.prefetch_arrays()],
        dest=dev(s.dest_table), n_splits=dev(s.n_splits), sched=s,
    )


def decode_positions(kv_len, g):
    # one token of 128 heads at the end of the cache, except every 5th
    # row, which sits earlier so the causal mask cuts its keys
    pos = np.full((g,), max(kv_len - 1, 0))
    pos[::5] = np.maximum(kv_len - 1 - 300, 0)
    return pos


def prefill_positions(kv_len, g, heads=128):
    # a 32-token chunk ending at kv_len: row r is token r // heads
    return np.maximum(kv_len - g // heads, 0) + np.arange(g) // heads


def run_k2(case, variant, plain):
    from repro_torch.kernels import mla_decode_paged as mp

    fn = mp._queue_rows_plain if plain else mp.mla_decode_paged_queue_rows
    kw = dict(
        d_v=DV, variant=variant, scale=1.0 / math.sqrt(192), block_k=BLOCK_K,
        num_dest_slots=case["sched"].num_dest_slots, softcap=None,
    )
    if plain:
        return fn(case["q"], case["pages"], case["bt"], case["kv"], case["q_pos"],
                  case["items"], **kw)
    return fn(case["q"], case["pages"], case["bt"], case["kv"], case["q_pos"],
              *case["items"], **kw)


def run_k3(case, o_part, lse, plain):
    from repro_torch.kernels import mla_decode_combine as mc

    fn = mc._combine_plain if plain else mc.combine_split_partials
    return fn(o_part, lse, case["dest"], case["n_splits"])


def k2_bound(case):
    """Least time for K2's work: bytes (each input once, outputs once) over
    the memory rate vs operations the causal mask leaves over the peak."""
    q, pages = case["q"], case["pages"]
    isz = pages.element_size()
    kv, pos = case["kv_host"], case["q_pos_host"]
    g = q.shape[1]
    d = case["sched"].num_dest_slots
    nbytes = (q.numel() * q.element_size() + int(kv.sum()) * DK * isz
              + 4 * (case["bt"].numel() + kv.size + pos.size
                     + sum(t.numel() for t in case["items"]))
              + 4 * d * g * (DV + 1))
    keys = np.minimum(kv[:, None], pos + 1) * (kv[:, None] > 0)
    ops = 2.0 * float(keys.sum()) * (DK + DV)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_bound(case):
    ns = case["sched"].n_splits.astype(np.int64)
    b, g = len(ns), case["q"].shape[1]
    nbytes = 4 * (int(ns.sum()) * g * (DV + 1) + b * g * DV + ns.size * (1 + case["sched"].num_splits))
    ops = 3.0 * int(ns.sum()) * g * DV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(case):
    """One PyTorch call computing K2+K3's result: scaled_dot_product_attention
    over a contiguous copy of the same pages (the copy is made beforehand
    and not timed; the port never calls this)."""
    q, pages = case["q"], case["pages"]
    kv, pos = case["kv_host"], case["q_pos_host"]
    b, g, _ = q.shape
    s_max = int(kv.max())
    bt = case["bt"].long()
    n_pg = -(-s_max // PAGE)
    c = pages[bt[:, :n_pg]].reshape(b, n_pg * PAGE, DK)[:, :s_max]
    k = c[:, None]
    v = c[:, None, :, :DV]
    kpos = torch.arange(s_max, device="cuda")
    mask = (kpos[None, None, None, :] < case["kv"].long()[:, None, None, None]) & (
        kpos[None, None, None, :] <= case["q_pos"].long()[:, None, :, None])
    qq = q[:, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qq, k, v, attn_mask=mask, scale=1.0 / math.sqrt(192))


def kernel_phase(flush):
    """Hold K2 and K3 against their plain versions; returns timing rows."""
    log("== kernel phase: K2 (paged AMLA decode) and K3 (split-KV combine) "
        "vs their plain PyTorch versions ==")
    checks = [
        # (name, kv_lens, G, positions, num_splits)
        ("decode", [0, 1, 200, 513, 1116, 4096], 128, decode_positions, 1),
        ("decode", [0, 1, 200, 513, 1116, 4096], 128, decode_positions, 2),
        ("prefill", [1100], 4096, prefill_positions, 1),
        ("prefill", [4096], 4096, prefill_positions, 2),
    ]
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, lens, g, pos_fn, ns in checks:
            for variant in ("amla", "base"):
                case = make_case(7, lens, g, dtype, ns, pos_fn)
                o_k, lse_k = run_k2(case, variant, plain=False)
                o_p, lse_p = run_k2(case, variant, plain=True)
                out_k = run_k3(case, o_k, lse_k, plain=False)
                out_p = run_k3(case, o_p, lse_p, plain=True)
                out_k3_on_plain = run_k3(case, o_p, lse_p, plain=False)
                torch.cuda.synchronize()
                s = case["sched"]
                live = sorted(set(s.item_dest[s.item_valid == 1].tolist()))
                err_o = (o_k[live] - o_p[live]).abs().max().item()
                fin = torch.isfinite(lse_p[live])
                if not torch.equal(fin, torch.isfinite(lse_k[live])):
                    raise SystemExit(f"K2 {name}: empty-row lse pattern differs")
                err_lse = (lse_k[live][fin] - lse_p[live][fin]).abs().max().item()
                err_out = (out_k - out_p).abs().max().item()
                err_k3 = (out_k3_on_plain - out_p).abs().max().item()
                zero_rows = [i for i, l in enumerate(lens) if l == 0]
                if zero_rows and out_k[zero_rows].abs().max().item() != 0.0:
                    raise SystemExit(f"K2+K3 {name}: kv_len == 0 rows are not exact zeros")
                if not torch.isfinite(out_k).all():
                    raise SystemExit(f"K2+K3 {name}: non-finite output")
                tol = TOL[dtype, variant]
                key2 = ("mla_decode_paged_queue_rows", dtype, variant)
                key3 = ("combine_split_partials", dtype, variant)
                worst[key2] = max(worst.get(key2, 0.0), err_o, err_lse, err_out)
                worst[key3] = max(worst.get(key3, 0.0), err_k3)
                log(f"  {name:7s} {str(dtype)[6:]:8s} {variant} G={g} splits={ns} "
                    f"kv={lens}: K2 o {err_o:.3e} lse {err_lse:.3e}, K2+K3 {err_out:.3e}, "
                    f"K3 {err_k3:.3e} (tol {tol:g})")
                if max(err_o, err_lse, err_out, err_k3) > tol:
                    raise SystemExit(f"kernel phase: {name} {dtype} {variant} exceeds tol {tol}")
    for (kname, dtype, variant), err in worst.items():
        log(f"  max |kernel - plain| {kname} {str(dtype)[6:]} {variant}: {err:.3e} "
            f"(tol {TOL[dtype, variant]:g})")

    # Timing at the serve phase's decode shape (bf16, 4 requests after 16
    # decode steps, two splits) and at its prefill-chunk shape.
    rows = {}
    timed = [
        ("decode", make_case(11, [37 + 16, 300 + 16, 513 + 16, 1100 + 16], 128,
                             torch.bfloat16, 2, lambda l, g: np.full((g,), l - 1))),
        ("prefill", make_case(12, [1100], 4096, torch.bfloat16, 1, prefill_positions)),
    ]
    for shape, case in timed:
        o_p, lse_p = run_k2(case, "amla", plain=True)
        t2 = time_cuda(lambda: run_k2(case, "amla", plain=False), 20, flush)
        t2p = time_cuda(lambda: run_k2(case, "amla", plain=True), 5, flush)
        t3 = time_cuda(lambda: run_k3(case, o_p, lse_p, plain=False), 50, flush)
        t3p = time_cuda(lambda: run_k3(case, o_p, lse_p, plain=True), 20, flush)
        tlib = time_cuda(sdpa_call(case), 20, flush)
        b2, by2 = k2_bound(case)
        b3, by3 = k3_bound(case)
        log(f"  time {shape} (bf16, G={case['q'].shape[1]}, kv={case['kv_host'].tolist()}): "
            f"K2 {t2:.4f} ms (bound {b2:.4f} ms by {by2}, plain {t2p:.4f} ms, "
            f"SDPA on a contiguous copy {tlib:.4f} ms); K3 {t3:.4f} ms "
            f"(bound {b3:.5f} ms by {by3}, plain {t3p:.4f} ms)")
        rows[shape] = dict(k2=(t2, t2p, b2, by2, tlib), k3=(t3, t3p, b3, by3))
    return worst, rows


# --------------------------------------------------------------------------- #
# serve phase
# --------------------------------------------------------------------------- #


def small_reference_check():
    """The smoke-size model (fp32) through the kernels on the card and
    through the plain versions on the CPU, same weights and tokens (the
    CPU run's greedy picks are fed to both): logits must agree."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("deepseek-v2-mla", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator("cpu").manual_seed(3), "cpu")
    to_cuda = lambda t: {k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict) else (
        [to_cuda(v) for v in t] if isinstance(t, list) else t.cuda())
    p_gpu = to_cuda(p_cpu)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 77)]
    worst = 0.0
    caches = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        caches[dev] = model.init_paged_cache(params, num_pages=24, page_size=16)
    kw = dict(cfg=cfg, block_k=32, compute_dtype=torch.float32, table_width=24)
    last = []
    for rid, prompt in enumerate(prompts):
        outs = {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            caches[dev].alloc(rid)
            outs[dev] = tf.lm_prefill_paged(params, prompt, cache=caches[dev], rid=rid,
                                            chunk=16, **kw)
        worst = max(worst, (outs["cuda"].cpu() - outs["cpu"]).abs().max().item())
        last.append(int(torch.argmax(outs["cpu"][0])))
    for _ in range(6):
        outs = {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            outs[dev] = tf.lm_decode_step_paged(
                params, np.asarray(last)[:, None], cache=caches[dev], rids=[0, 1, 2],
                num_splits=2, **kw)
        worst = max(worst, (outs["cuda"].cpu() - outs["cpu"]).abs().max().item())
        last = torch.argmax(outs["cpu"][:, 0], dim=-1).tolist()
    tol = 2e-3
    log(f"small-input reference ({cfg.name}, fp32, 3 prompts + 6 steps): max |logits on "
        f"card - logits of the plain CPU path| = {worst:.3e} (tol {tol:g}: AMLA's fp32 "
        f"tolerance, see TOL)")
    if not worst <= tol:
        raise SystemExit("small-input reference check failed")


def serve_phase():
    """deepseek-v2-mla at published widths through PagedServingSession."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.launch.serve import _serve_stream
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import PagedServingSession

    cfg = get_config("deepseek-v2-mla")
    prompt_lens, gen_len, num_pages = (37, 300, 513, 1100), 16, 32
    free, total = torch.cuda.mem_get_info()
    per_layer = (cfg.param_count() - 2 * cfg.vocab_size * cfg.d_model) // cfg.n_layers
    # weights + pool + 8 GiB for activations and the fp32 unembedding
    fixed = 2 * 2 * cfg.vocab_size * cfg.d_model + 8 * 2**30
    per_layer_bytes = 2 * per_layer + 2 * num_pages * PAGE * DK
    n_layers = min(cfg.n_layers, int((free - fixed) // per_layer_bytes))
    if n_layers < cfg.n_layers:
        log(f"DEPTH CUT: {n_layers} of {cfg.n_layers} layers fit in "
            f"{free / 2**30:.1f} GiB free")
        import dataclasses

        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    log(f"== serve phase: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads, latent "
        f"{cfg.mla.d_latent}+{cfg.mla.d_rope}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, bf16, {cfg.param_count() / 1e9:.2f} B params ==")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"random bf16 weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    sess = PagedServingSession(model, params, num_pages=num_pages, page_size=PAGE,
                               num_splits=2, prefill_chunk=32, max_batch=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    timing = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def call(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            timing[name] += time.perf_counter() - t
            return out
        return call

    sess.add_request = timed("prefill", sess.add_request)
    sess.step = timed("decode", sess.step)
    mp.mla_decode_paged_queue_rows.launches = 0
    mc.combine_split_partials.launches = 0
    results, tokens_out, dt = _serve_stream(sess, list(prompts), gen_len, len(prompts))
    torch.cuda.synchronize()
    k2, k3 = mp.mla_decode_paged_queue_rows.launches, mc.combine_split_partials.launches
    work = sess.work_stats()
    sweep = sess.close()
    chunks, steps = work["prefill_chunks"], work["decode_steps"]
    n_prompt = sum(prompt_lens)
    log(f"served {len(results)} requests: prefill {n_prompt} tokens in {chunks} chunks, "
        f"{timing['prefill']:.3f} s ({n_prompt / timing['prefill']:.1f} tok/s); decode "
        f"{tokens_out} tokens in {steps} steps, {timing['decode']:.3f} s "
        f"({tokens_out / timing['decode']:.2f} tok/s, "
        f"{1e3 * timing['decode'] / steps:.1f} ms/step); wall {dt:.3f} s")
    log(f"launches: K2 mla_decode_paged_queue_rows {k2}, K3 combine_split_partials {k3}; "
        f"expected layers x (prefill chunks + decode steps) = {cfg.n_layers} x "
        f"({chunks} + {steps}) = {cfg.n_layers * (chunks + steps)}")
    log(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; teardown sweep "
        f"{sweep['free_pages']} pages free")
    if k2 <= 0 or k3 <= 0 or k2 != cfg.n_layers * (chunks + steps) or k3 != k2:
        raise SystemExit("serve phase: kernel launch counts do not match the main path")
    for rid, out in results.items():
        if len(out) != gen_len + 1 or not all(0 <= t < cfg.vocab_size for t in out):
            raise SystemExit(f"serve phase: request {rid} returned {out}")
    log(f"tokens: { {r: results[r][:6] for r in sorted(results)} }")
    return k2, k3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("== build ==")
    t0 = time.perf_counter()
    _build.load()
    res = _build.last_build()
    log(f"built {res.path} in {res.seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  " + line.strip())

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    worst, rows = kernel_phase(flush)
    del flush
    small_reference_check()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k2, k3 = serve_phase()

    err = lambda name: max(v for k, v in worst.items() if k[0] == name)
    d2, d3 = rows["decode"]["k2"], rows["decode"]["k3"]
    kernels = [
        dict(name="mla_decode_paged_queue_rows", route="cuda",
             source="src/repro_torch/csrc/mla_decode_paged.cu",
             replaces="src/repro/kernels/mla_decode_paged.py:490", launches=k2,
             max_abs_err=err("mla_decode_paged_queue_rows"), ms=d2[0], plain_ms=d2[1],
             bound_ms=d2[2], bound_by=d2[3], library_ms=d2[4]),
        dict(name="combine_split_partials", route="cuda",
             source="src/repro_torch/csrc/mla_decode_combine.cu",
             replaces="src/repro/kernels/mla_decode_combine.py:83", launches=k3,
             max_abs_err=err("combine_split_partials"), ms=d3[0], plain_ms=d3[1],
             bound_ms=d3[2], bound_by=d3[3], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
