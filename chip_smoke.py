#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA H100 (``python3 chip_smoke.py`` from the repository
root) and exits nonzero on any failure:

1. **Build** the hand-written CUDA kernels from ``src/repro_torch/csrc``.
2. **Kernel phase**: every kernel on the card against its plain PyTorch
   version on the same inputs, bf16 and fp32, ``amla`` and ``base``:
   the paged AMLA decode kernel (K2) and the split-KV combine (K3) at full
   width (Dk 576, Dv 512, page 128, block_k 512) for a decode step and a
   prefill chunk; the GQA decode (K6) and flash prefill (K7) kernels at
   the head geometries of gemma2-2b (8/4 x 256, window 4096, softcap 50),
   qwen2.5-3b (16/2 x 128) and qwen1.5-0.5b (16/16 x 64); the contiguous
   MLA decode (K4) at 128 heads for a decode step and a 512-token prefill.
   Cases include kv_len 0 (rows must be exact zeros), ragged kv_len and
   contexts longer than the window.  Each kernel is timed beside its
   bound, its plain version and, where one exists, a single PyTorch call.
3. **Small references**: the smoke-size models (fp32) through the kernels
   on the card and the plain versions on the CPU — deepseek-v2-mla over
   the paged path, gemma2-2b and deepseek-v2-mla through the dense
   ``ServingSession`` — must agree (logits within 2e-3, same tokens).
4. **Dense serve phase, gemma2-2b** at its published widths (26 layers,
   random bf16 weights from a seed) through ``ServingSession(batch 4,
   max_len 8192)`` and the ``launch/serve`` stream loop: prompts of 5,
   300, 1100 and 4500 tokens, 16 greedy tokens each.  K6 and K7 launch
   counts must match the layers x calls of the path.
5. **Paged serve phase**: ``deepseek-v2-mla`` at its published widths
   (60 layers) through ``PagedServingSession``: 4 ragged prompts, 16
   greedy tokens each, ``num_splits=2``; every prefill chunk and decode
   step of every layer must go through K2 and K3.
6. **Dense serve phase, deepseek-v2-mla**: the same weights and prompts
   through ``ServingSession(batch 4, max_len 2048)``; every prefill and
   decode step of every layer must go through K4.

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
# dense kernel phase: K6 (GQA decode), K7 (flash prefill), K4 (MLA rows)
# --------------------------------------------------------------------------- #

# (name, Hq, Hkv, Dh, window, softcap) of the dense path's head geometries
GQA_GEOMETRIES = [
    ("gemma2-2b", 8, 4, 256, 4096, 50.0),
    ("qwen2.5-3b", 16, 2, 128, None, None),
    ("qwen1.5-0.5b", 16, 16, 64, None, None),
]


def randn(shape, seed, dtype):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def visible_keys(kv, q_pos, window, causal=True):
    """(B, R) count of keys each row sees: k < kv_len, k <= q_pos (causal),
    k > q_pos - window."""
    kv = np.asarray(kv, np.int64)[:, None]
    pos = np.asarray(q_pos, np.int64)
    hi = np.minimum(kv, pos + 1) if causal else np.broadcast_to(kv, pos.shape)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return np.clip(hi - lo, 0, None)


def bound(nbytes, ops, dtype):
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``ops``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gqa_case(kernel, geom, b, sq, s, kv, dtype, seed):
    """Inputs of one K6 or K7 call on the card.  K6 gets q rows (B, Hkv, G,
    Dh) with G = Sq * group at the last Sq positions below kv_len, and
    k/v as transposed views of (B, S, Hkv, Dh) tensors, as the dense layer
    hands them over; K7 gets (B, Hq, Sq, Dh) queries at positions 0..Sq-1
    and a (B, Hkv, S, Dh) cache."""
    name, hq, hkv, dh, window, softcap = geom
    group = hq // hkv
    kv = np.asarray(kv, np.int32)
    if kernel == "K6":
        q_pos = np.maximum(kv - sq, 0)[:, None] + np.arange(sq)[None, :]
        rows_pos = np.repeat(q_pos, group, axis=1)
        q = randn((b, hkv, sq * group, dh), seed, dtype)
        k = randn((b, s, hkv, dh), seed + 1, dtype).transpose(1, 2)
        v = randn((b, s, hkv, dh), seed + 2, dtype).transpose(1, 2)
    else:
        rows_pos = np.broadcast_to(np.arange(sq), (b, sq))
        q = randn((b, hq, sq, dh), seed, dtype)
        k = randn((b, hkv, s, dh), seed + 1, dtype)
        v = randn((b, hkv, s, dh), seed + 2, dtype)
    return dict(kernel=kernel, geom=geom, q=q, k=k, v=v, kv_host=kv, pos_host=rows_pos,
                kv=torch.as_tensor(kv, device="cuda"),
                pos=torch.as_tensor(np.array(rows_pos), dtype=torch.int32, device="cuda"),
                kw=dict(scale=1.0 / math.sqrt(dh), softcap=softcap, window=window))


def run_gqa(case, variant, plain):
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd

    q, k, v, kv, kw = case["q"], case["k"], case["v"], case["kv"], case["kw"]
    blk = min(512, max(k.shape[2], 128))
    if case["kernel"] == "K6":
        if plain:
            return gd._decode_plain(q, k, v, kv, case["pos"], variant=variant, block_k=blk, **kw)
        return gd.gqa_decode_rows(q, k, v, kv, case["pos"], variant=variant, **kw)
    if plain:
        return fp._prefill_plain(q, k, v, kv, variant=variant, block_k=blk, causal=True, **kw)
    return fp.flash_prefill(q, k, v, kv, variant=variant, **kw)


def gqa_bound(case):
    """K6/K7: q, the K and V rows some row of a head group sees (once),
    the fp32 output; 4 * Dh operations per (row, visible key)."""
    _, hq, hkv, dh, window, _ = case["geom"]
    q, isz = case["q"], case["q"].element_size()
    keys = visible_keys(case["kv_host"], case["pos_host"], window)
    heads_per_row = hkv if case["kernel"] == "K6" else hq
    lo = np.maximum(case["pos_host"].min(axis=1) - (window or 10**9) + 1, 0)
    hi = np.minimum(case["kv_host"], case["pos_host"].max(axis=1) + 1)
    kv_rows = int(np.clip(hi - lo, 0, None).sum()) * hkv
    nbytes = (q.numel() * isz + 2 * kv_rows * dh * isz + q.numel() * 4
              + 4 * (case["kv_host"].size + case["pos_host"].size))
    return bound(nbytes, 4.0 * dh * float(keys.sum()) * heads_per_row, q.dtype)


def gqa_sdpa(case):
    """One scaled_dot_product_attention call computing the same function
    (no softcap), GQA by enable_gqa, a boolean mask for kv_len / causal /
    window; timed as a yardstick only (the port never calls it)."""
    _, hq, hkv, dh, window, softcap = case["geom"]
    if softcap is not None:
        return None
    b = case["q"].shape[0]
    q = case["q"]
    if case["kernel"] == "K6":  # rows (Sq * group) of a kv head -> (B, Hq, Sq, Dh)
        g = q.shape[2]
        q = q.reshape(b, hkv, g // (hq // hkv), hq // hkv, dh).transpose(2, 3).reshape(b, hq, -1, dh)
        pos = torch.as_tensor(case["pos_host"][:, :: hq // hkv], device="cuda")
    else:
        pos = case["pos"]
    s = case["k"].shape[2]
    kpos = torch.arange(s, device="cuda")[None, None, None, :]
    mask = (kpos < case["kv"].long()[:, None, None, None]) & (kpos <= pos.long()[:, None, :, None])
    if window:
        mask &= kpos > pos.long()[:, None, :, None] - window
    f = torch.nn.functional.scaled_dot_product_attention
    k, v = case["k"], case["v"]
    return lambda: f(q, k, v, attn_mask=mask, scale=case["kw"]["scale"], enable_gqa=True)


def mla_case(b, g, s, kv, q_pos, dtype, seed):
    kv = np.asarray(kv, np.int32)
    return dict(q=randn((b, g, DK), seed, dtype), c=randn((b, s, DK), seed + 1, dtype),
                kv_host=kv, pos_host=np.asarray(q_pos, np.int32),
                kv=torch.as_tensor(kv, device="cuda"),
                pos=torch.as_tensor(np.asarray(q_pos, np.int32), device="cuda"))


def run_k4(case, variant, plain):
    from repro_torch.kernels import mla_decode as md

    kw = dict(d_v=DV, variant=variant, scale=1.0 / math.sqrt(192))
    if plain:
        blk = md.contiguous_block_k(512, case["c"].shape[1])
        return md._rows_plain(case["q"], case["c"], case["kv"], case["pos"], block_k=blk,
                              softcap=None, **kw)
    return md.mla_decode_rows(case["q"], case["c"], case["kv"], case["pos"], **kw)


def k4_bound(case):
    """K4: q, the latent rows some row sees (once), the fp32 output;
    2 * (Dk + Dv) operations per (row, visible key)."""
    q, isz = case["q"], case["q"].element_size()
    keys = visible_keys(case["kv_host"], case["pos_host"], None)
    rows = np.minimum(case["kv_host"], case["pos_host"].max(axis=1) + 1)
    nbytes = (q.numel() * isz + int(rows.sum()) * DK * isz + q.shape[0] * q.shape[1] * DV * 4
              + 4 * (case["kv_host"].size + case["pos_host"].size))
    return bound(nbytes, 2.0 * (DK + DV) * float(keys.sum()), q.dtype)


def k4_sdpa(case):
    q, c = case["q"], case["c"]
    s = c.shape[1]
    kpos = torch.arange(s, device="cuda")[None, None, None, :]
    mask = (kpos < case["kv"].long()[:, None, None, None]) & (
        kpos <= case["pos"].long()[:, None, :, None])
    f = torch.nn.functional.scaled_dot_product_attention
    qq, k, v = q[:, None], c[:, None], c[:, None, :, :DV]
    return lambda: f(qq, k, v, attn_mask=mask, scale=1.0 / math.sqrt(192))


def dense_cases(dtype):
    """Every K6/K7/K4 check: kv_len 0, ragged kv_len, contexts longer than
    the gemma2 window, decode and prefill shapes."""
    out = []
    for i, geom in enumerate(GQA_GEOMETRIES):
        gemma = geom[4] is not None
        s = 8192 if gemma else 2048
        kv = [0, 305, 1116, 4516] if gemma else [0, 1, 777, 2048]
        out.append((f"K6 {geom[0]} decode", gqa_case("K6", geom, 4, 1, s, kv, dtype, 10 + i)))
        out.append((f"K6 {geom[0]} 8-token prefill", gqa_case("K6", geom, 2, 8, s, [8, 4999 if gemma else 1500], dtype, 20 + i)))
        sq = 8192 if gemma else 1024
        out.append((f"K7 {geom[0]} prefill", gqa_case("K7", geom, 2, sq, sq, [sq, 0], dtype, 30 + i)))
    out.append(("K4 decode", mla_case(4, 128, 2048, [0, 53, 529, 1116],
                                      np.repeat(np.maximum(np.asarray([0, 53, 529, 1116]) - 1, 0)[:, None], 128, 1),
                                      dtype, 40)))
    out.append(("K4 prefill", mla_case(1, 512 * 128, 2048, [512], (np.arange(512 * 128) // 128)[None, :],
                                       dtype, 41)))
    return out


def dense_kernel_phase(flush):
    """Hold K4, K6 and K7 against their plain versions on the card, then
    time them at the dense serve phases' shapes."""
    log("== kernel phase: K6 (GQA decode), K7 (flash prefill), K4 (contiguous MLA "
        "decode) vs their plain PyTorch versions ==")
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in dense_cases(dtype):
            is_k4 = name.startswith("K4")
            for variant in ("amla", "base"):
                run = run_k4 if is_k4 else run_gqa
                got = run(case, variant, plain=False)
                want = run(case, variant, plain=True)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = TOL[dtype, variant]
                empty = case["kv_host"] == 0
                if empty.any() and got[torch.as_tensor(empty, device="cuda")].abs().max().item() != 0.0:
                    raise SystemExit(f"{name}: rows with no visible key are not exact zeros")
                if not torch.isfinite(got).all():
                    raise SystemExit(f"{name}: non-finite output")
                key = name.split()[0]
                worst[key, dtype, variant] = max(worst.get((key, dtype, variant), 0.0), err)
                log(f"  {name:28s} {str(dtype)[6:]:8s} {variant} kv={case['kv_host'].tolist()}: "
                    f"max |kernel - plain| {err:.3e} (tol {tol:g})")
                if err > tol:
                    raise SystemExit(f"dense kernel phase: {name} {dtype} {variant} exceeds tol {tol}")
            del case
            torch.cuda.empty_cache()
    for (kname, dtype, variant), err in sorted(worst.items(), key=str):
        log(f"  max |kernel - plain| {kname} {str(dtype)[6:]} {variant}: {err:.3e} "
            f"(tol {TOL[dtype, variant]:g})")

    # Timing, bf16 amla, at the serve phases' shapes: gemma2-2b decode after
    # 16 steps (the session's whole 8192-row cache, kv = prompt + 16) and
    # the prefill of its 1100-token prompt (bucket 2048, kv_len = bucket);
    # deepseek-v2-mla decode after 16 steps and its 513-token prefill
    # (bucket 1024, G = 1024 * 128).  The other geometries are timed too.
    bf = torch.bfloat16
    gemma = GQA_GEOMETRIES[0]
    timed = [
        ("K6", "gemma2-2b decode", gqa_case("K6", gemma, 4, 1, 8192, [21, 316, 1116, 4516], bf, 50)),
        ("K7", "gemma2-2b prefill 2048", gqa_case("K7", gemma, 1, 2048, 8192, [2048], bf, 51)),
        ("K7", "gemma2-2b prefill 8192", gqa_case("K7", gemma, 1, 8192, 8192, [8192], bf, 52)),
        ("K4", "deepseek decode", mla_case(4, 128, 2048, [53, 316, 529, 1116],
                                           np.repeat(np.asarray([52, 315, 528, 1115])[:, None], 128, 1), bf, 53)),
        ("K4", "deepseek prefill 1024", mla_case(1, 1024 * 128, 2048, [1024],
                                                 (np.arange(1024 * 128) // 128)[None, :], bf, 54)),
    ]
    for geom in GQA_GEOMETRIES[1:]:
        timed.append(("K6", f"{geom[0]} decode", gqa_case("K6", geom, 4, 1, 2048, [21, 316, 1116, 2048], bf, 55)))
        timed.append(("K7", f"{geom[0]} prefill 1024", gqa_case("K7", geom, 1, 1024, 2048, [1024], bf, 56)))
    rows = {}
    for kname, shape, case in timed:
        run, bnd, lib = (run_k4, k4_bound, k4_sdpa) if kname == "K4" else (run_gqa, gqa_bound, gqa_sdpa)
        t = time_cuda(lambda: run(case, "amla", plain=False), 10, flush)
        tp = time_cuda(lambda: run(case, "amla", plain=True), 3, flush)
        call = lib(case)
        tlib = time_cuda(call, 10, flush) if call is not None else None
        b, by = bnd(case)
        lib_txt = f"SDPA {tlib:.4f} ms" if tlib is not None else "SDPA none (SDPA has no softcap)"
        log(f"  time {kname} {shape} (bf16, kv={case['kv_host'].tolist()}): {t:.4f} ms "
            f"(bound {b:.4f} ms by {by}, plain {tp:.4f} ms, {lib_txt})")
        rows[kname, shape] = (t, tp, b, by, tlib)
        del case
        torch.cuda.empty_cache()
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


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def perturbed(tree, gen, rel=2e-7):
    """``tree`` with every float tensor scaled by ``1 + rel * N(0, 1)``
    drawn from ``gen``: a difference of the size an fp32 product summed in
    another order makes."""
    if isinstance(tree, dict):
        return {k: perturbed(v, gen, rel) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturbed(v, gen, rel) for v in tree]
    if not tree.is_floating_point():
        return tree
    return tree * (1 + rel * torch.randn(tree.shape, generator=gen, dtype=tree.dtype))


def dense_session_logits(cfg, params, prompts):
    """Every prefill's and decode step's logits (on the CPU) and the greedy
    outputs of a small ServingSession run: 2 slots, 6 steps, a finish, a
    third prompt into the recycled slot, 3 more steps."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import ServingSession

    model = build_model(cfg)
    seen = []
    prefill, decode = model.prefill, model.decode_step

    def rec_prefill(*a, **k):
        out = prefill(*a, **k)
        seen.append(out[0].float().cpu())
        return out

    def rec_decode(*a, **k):
        out = decode(*a, **k)
        seen.append(out[0].float().cpu())
        return out

    model.prefill, model.decode_step = rec_prefill, rec_decode
    sess = ServingSession(model, params, batch_size=2, max_len=64)
    sess.add_request(prompts[0])
    sess.add_request(prompts[1])
    for _ in range(6):
        sess.step()
    sess.finish(0)
    sess.add_request(prompts[2])
    for _ in range(3):
        sess.step()
    return seen, dict(sess.outputs)


def small_dense_check():
    """Smoke gemma2-2b and deepseek-v2-mla (fp32 weights) through
    ServingSession on the card and on the CPU, same weights and prompts:
    the same greedy tokens, and every prefill's and decode step's logits as
    close as the CPU path is to itself under fp32-sized noise.

    The dense path feeds attention bf16 inputs whatever the model's dtype
    (``ops.gqa_attention`` and ``ops.mla_decode`` cast q, k, v and read the
    cache rounded to bf16, as the reference does), so where the card's
    fp32 products and the CPU's differ in the last bit, an attention input
    can land one bf16 step (2^-8 relative) apart.  The tolerance is
    therefore 4x the largest logit difference of the CPU path against
    itself on weights perturbed by 2e-7 relative (three seeds), and never
    below 2e-3.  The kernels themselves are held to their tolerances in the
    kernel phases."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    diff = lambda a, b: max((x - y).abs().max().item() for x, y in zip(a, b))
    for arch in ("gemma2-2b", "deepseek-v2-mla"):
        cfg = get_config(arch, smoke=True)
        p_cpu = build_model(cfg).init(torch.Generator("cpu").manual_seed(5), "cpu")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 12)]
        cpu, cpu_out = dense_session_logits(cfg, p_cpu, prompts)
        card, card_out = dense_session_logits(cfg, to_device(p_cpu, "cuda"), prompts)
        noise = max(
            diff(cpu, dense_session_logits(
                cfg, perturbed(p_cpu, torch.Generator("cpu").manual_seed(s)), prompts)[0])
            for s in (1, 2, 3))
        tol = max(2e-3, 4 * noise)
        worst = diff(card, cpu)
        log(f"small dense reference ({cfg.name}, fp32, ServingSession, 3 prompts, 9 steps): "
            f"max |logits on card - logits of the plain CPU path| = {worst:.3e} (tol {tol:.3e} "
            f"= max(2e-3, 4 x {noise:.3e}, the CPU path against itself on weights perturbed "
            f"by 2e-7)); greedy tokens {'equal' if card_out == cpu_out else 'DIFFER'}")
        if not worst <= tol or card_out != cpu_out:
            raise SystemExit(f"small dense reference check failed for {arch}")


def timed_session(sess):
    """Wrap add_request and step with device-synchronised host timers."""
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
    return timing


def dense_serve(cfg, model, params, prompt_lens, gen_len, max_len, counters):
    """Serve prompts of ``prompt_lens`` through ServingSession(batch 4,
    max_len) with the launch/serve stream loop; ``counters`` (wrapper
    functions) are set to 0 just before and read just after."""
    from repro_torch.launch.serve import _serve_stream
    from repro_torch.runtime.serve_loop import ServingSession

    sess = ServingSession(model, params, batch_size=4, max_len=max_len)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    timing = timed_session(sess)
    steps = 0
    step = sess.step

    def counted_step():
        nonlocal steps
        steps += int(sess.active_mask.any())
        step()

    sess.step = counted_step
    for fn in counters:
        fn.launches = 0
    results, tokens_out, dt = _serve_stream(sess, list(prompts), gen_len, len(prompts))
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    buckets = [sess._bucket_len(n) for n in prompt_lens]
    n_prompt = sum(prompt_lens)
    log(f"served {len(results)} requests: prefill {n_prompt} tokens (buckets {buckets}) in "
        f"{timing['prefill']:.3f} s ({n_prompt / timing['prefill']:.1f} tok/s); decode "
        f"{tokens_out} tokens in {steps} steps, {timing['decode']:.3f} s "
        f"({tokens_out / timing['decode']:.2f} tok/s, {1e3 * timing['decode'] / steps:.1f} "
        f"ms/step); wall {dt:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for rid, out in results.items():
        if len(out) != gen_len + 1 or not all(0 <= t < cfg.vocab_size for t in out):
            raise SystemExit(f"dense serve: request {rid} returned {out}")
    log(f"tokens: { {r: results[r][:6] for r in sorted(results)} }")
    return results, launches, buckets, steps


def gemma_dense_phase():
    """gemma2-2b at published widths (26 layers, bf16, seed 0) through the
    dense ServingSession: prompts of 5 (bucket 8: prefilled through K6),
    300, 1100 and 4500 tokens (past the 4096-key window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("gemma2-2b")
    log(f"== dense serve phase: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads x {cfg.head_dim}, window {cfg.window}, softcaps "
        f"{cfg.attn_softcap}/{cfg.final_softcap}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, bf16, {cfg.param_count() / 1e9:.2f} B params ==")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"random bf16 weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    _, (k6, k7), buckets, steps = dense_serve(
        cfg, model, params, (5, 300, 1100, 4500), 16, 8192, (gd.gqa_decode_rows, fp.flash_prefill))
    want7 = cfg.n_layers * sum(b > 8 for b in buckets)
    want6 = cfg.n_layers * (steps + sum(b <= 8 for b in buckets))
    log(f"launches: K6 gqa_decode_rows {k6} (expected layers x (decode steps + prefills "
        f"with bucket <= 8) = {want6}), K7 flash_prefill {k7} (expected layers x prefills "
        f"with bucket > 8 = {want7})")
    if k6 <= 0 or k7 <= 0 or k6 != want6 or k7 != want7:
        raise SystemExit("gemma2-2b dense phase: kernel launch counts do not match the main path")
    return k6, k7


def mla_dense_phase(cfg, model, params, prompt_lens, paged_results):
    """deepseek-v2-mla at published widths through the dense ServingSession,
    on the paged phase's weights and prompts: K4 at every prefill and
    decode step of every layer.  Token agreement with the paged phase is
    printed as information: the two paths round bf16 in different orders."""
    from repro_torch.kernels import mla_decode as md

    log(f"== dense serve phase: {cfg.name} ({cfg.n_layers} layers, the paged phase's "
        f"weights), ServingSession(batch 4, max_len 2048) ==")
    torch.cuda.reset_peak_memory_stats()
    results, (k4,), buckets, steps = dense_serve(
        cfg, model, params, prompt_lens, 16, 2048, (md.mla_decode_rows,))
    want4 = cfg.n_layers * (len(prompt_lens) + steps)
    log(f"launches: K4 mla_decode_rows {k4} (expected layers x (prefills + decode steps) "
        f"= {cfg.n_layers} x ({len(prompt_lens)} + {steps}) = {want4})")
    agree = [sum(a == b for a, b in zip(results[r], paged_results[r])) for r in sorted(results)]
    log(f"greedy tokens equal to the paged phase's, per request (of {len(results[0])}): {agree}")
    if k4 <= 0 or k4 != want4:
        raise SystemExit("deepseek-v2-mla dense phase: K4 launch count does not match the main path")
    return k4


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
    timing = timed_session(sess)
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
    return k2, k3, (cfg, model, params, prompt_lens, results)


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
    dworst, drows = dense_kernel_phase(flush)
    del flush
    small_reference_check()
    small_dense_check()
    torch.cuda.empty_cache()
    k6, k7 = gemma_dense_phase()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k2, k3, paged = serve_phase()
    k4 = mla_dense_phase(*paged)
    del paged

    err = lambda name: max(v for k, v in worst.items() if k[0] == name)
    derr = lambda name: max(v for k, v in dworst.items() if k[0] == name)
    d2, d3 = rows["decode"]["k2"], rows["decode"]["k3"]
    t4, t6, t7 = drows["K4", "deepseek decode"], drows["K6", "gemma2-2b decode"], drows[
        "K7", "gemma2-2b prefill 2048"]
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
        dict(name="mla_decode_rows", route="cuda", source="src/repro_torch/csrc/mla_decode.cu",
             replaces="src/repro/kernels/mla_decode.py:401", launches=k4,
             max_abs_err=derr("K4"), ms=t4[0], plain_ms=t4[1], bound_ms=t4[2],
             bound_by=t4[3], library_ms=t4[4]),
        dict(name="gqa_decode_rows", route="cuda", source="src/repro_torch/csrc/gqa_decode.cu",
             replaces="src/repro/kernels/gqa_decode.py:147", launches=k6,
             max_abs_err=derr("K6"), ms=t6[0], plain_ms=t6[1], bound_ms=t6[2],
             bound_by=t6[3], library_ms=t6[4]),
        dict(name="flash_prefill", route="cuda", source="src/repro_torch/csrc/flash_prefill.cu",
             replaces="src/repro/kernels/flash_prefill.py:149", launches=k7,
             max_abs_err=derr("K7"), ms=t7[0], plain_ms=t7[1], bound_ms=t7[2],
             bound_by=t7[3], library_ms=t7[4]),
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
