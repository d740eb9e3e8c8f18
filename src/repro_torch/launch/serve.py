"""Serving entry point (counterpart of ``repro/launch/serve.py``).

Runs a request stream through one of two cache backends:

* ``--cache dense`` (default; default arch ``qwen1.5-0.5b``):
  :class:`ServingSession`, a fixed batch of ``--batch`` slots with
  ``--max-len`` cache rows each, bucketed prefill, GQA attention through
  the K6/K7 kernels (MLA through K4);
* ``--cache paged`` (default arch ``deepseek-v2-mla``):
  :class:`PagedServingSession`, the full model decoding over a
  LayeredPagedKVCache via the AMLA paged kernels, with chunked
  prefill-into-pages and one decode schedule per step shared by all
  layers.

Random weights come from ``--seed``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve [--cache dense|paged] \\
        [--arch NAME] --smoke --requests 6 --gen-len 16 [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the run fails without it; ``cpu``
runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.kv_cache import OutOfPagesError
from repro_torch.runtime.serve_loop import PagedServingSession, ServingSession


def _serve_stream(sess, pending, gen_len, requests):
    """Admit-as-room-allows / step / finish loop."""
    live: dict[int, int] = {}  # rid -> remaining tokens
    done = 0
    t0 = time.time()
    tokens_out = 0
    results: dict[int, list[int]] = {}
    idle_steps = 0
    while done < requests:
        # admit as many queued prompts as there is room (slots or pages)
        while pending:
            rid = sess.add_request(pending[0])
            if rid is None:
                break
            pending.pop(0)
            # Phased admission emits the first token inside add_request.
            live[rid] = gen_len
            print(f"admitted request {rid} ({len(pending)} queued)")
        if not live and pending:
            raise SystemExit(
                f"request of {len(pending[0])} tokens cannot be admitted "
                f"even with an idle session — increase --num-pages/--page-size"
            )
        before = {rid: len(sess.outputs[rid]) for rid in live}
        try:
            sess.step()
        except OutOfPagesError:
            # Pool exhausted by decode-time growth: retire the most-complete
            # live request early (its output is kept), then retry the step.
            victim = max(live, key=lambda r: len(sess.outputs[r]))
            out = sess.finish(victim)
            results[victim] = out
            done += 1
            del live[victim]
            print(
                f"pool full: retired request {victim} early with "
                f"{len(out)} tokens: {out[:8]}..."
            )
            continue
        step_emitted = 0
        for rid in list(live):
            emitted = len(sess.outputs[rid]) - before[rid]
            tokens_out += emitted
            step_emitted += emitted
            live[rid] -= emitted
            if live[rid] <= 0:
                out = sess.finish(rid)
                results[rid] = out
                done += 1
                print(f"request {rid} done: {len(out)} tokens: {out[:8]}...")
                del live[rid]
        idle_steps = 0 if step_emitted else idle_steps + 1
        if idle_steps > 64 + sum(len(p) for p in pending):
            raise SystemExit(
                f"serve stream stalled: {idle_steps} consecutive steps "
                f"with no tokens emitted ({len(live)} live, "
                f"{len(pending)} queued)"
            )
    dt = time.time() - t0
    return results, tokens_out, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="default: qwen1.5-0.5b (dense) / deepseek-v2-mla (paged)")
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense",
                    help="cache backend: contiguous per-slot caches, or the "
                    "layered paged latent pool")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--block-k", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) launches the CUDA kernels; cpu runs "
                    "their plain PyTorch versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = args.arch or ("deepseek-v2-mla" if args.cache == "paged" else "qwen1.5-0.5b")
    cfg = get_config(arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(args.seed), device)
    if args.cache == "paged":
        sess = PagedServingSession(
            model,
            params,
            num_pages=args.num_pages,
            page_size=args.page_size,
            block_k=args.block_k,
            prefill_chunk=args.prefill_chunk,
            max_batch=args.batch,
        )
    else:
        sess = ServingSession(model, params, batch_size=args.batch, max_len=args.max_len)
    print(f"serving {arch} with the {args.cache} cache backend on {device}")
    rng = np.random.default_rng(args.seed)
    pending = [
        rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 24))).tolist()
        for _ in range(args.requests)
    ]
    _, tokens_out, dt = _serve_stream(sess, pending, args.gen_len, args.requests)
    print(
        f"served {args.requests} requests, {tokens_out} decode tokens "
        f"in {dt:.1f}s ({tokens_out / max(dt, 1e-9):.1f} tok/s)"
    )
    # Bucketed prefill keeps this O(log max_len) for a ragged prompt stream
    # (dense), and exactly one chunk shape (paged).
    print(f"prefill compiles: {sess.prefill_compiles}")
    if args.cache != "paged":
        return
    stats = sess.scheduler_stats
    work = sess.work_stats()
    print(
        f"decode schedules: {stats['rebuilds']} built, {stats['hits']} "
        f"step reuses across {work['decode_steps']} steps x "
        f"{cfg.n_layers} layers; {work['page_dmas']} page DMAs "
        f"({work['page_dma_bytes'] / 1e6:.2f} MB at model cache dtype)"
    )
    sweep = sess.close()
    print(f"teardown sweep: {sweep['free_pages']} pages free (clean)")


if __name__ == "__main__":
    main()
