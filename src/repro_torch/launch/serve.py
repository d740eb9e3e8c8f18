"""Serving entry point (counterpart of ``repro/launch/serve.py``).

Runs a request stream through one of two cache backends:

* ``--cache dense`` (default; default arch ``qwen1.5-0.5b``):
  :class:`ServingSession`, a fixed batch of ``--batch`` slots with
  ``--max-len`` cache rows each, bucketed prefill, GQA attention through
  the K6/K7 kernels (MLA through K4); every registered arch, the MoE
  (``qwen3-moe-30b-a3b``, ``granite-moe-3b-a800m``), Mamba-2
  (``mamba2-370m``), RG-LRU hybrid (``recurrentgemma-2b``) and
  vision-language (``qwen2-vl-7b``, text-only prompts) stacks included;
  the encoder-decoder ``seamless-m4t-medium`` has no session (the
  reference's launcher has no encoder-decoder path either) and exits
  naming ``EncDecModel.init_cache`` / ``decode_step``;
* ``--cache paged`` (default arch ``deepseek-v2-mla``):
  :class:`PagedServingSession`, the full model decoding over a
  LayeredPagedKVCache via the AMLA paged kernels, with chunked
  prefill-into-pages and one decode schedule per step shared by all
  layers.  ``--kv-dtype int8`` stores the latent pages as int8 with
  per-row scales; ``--shared-prefix`` serves a forked system-prompt family
  (a parent and two ``admit_with_prefix`` children) with group-batched
  prefix attention instead of the request stream; ``--prefix-cache trie``
  reuses prompt prefixes through the radix trie (the stream's prompts then
  open with a shared two-block template), ``--retain-pages`` caps the pages
  it retains; ``--speculate ngram --draft-k K`` verifies ``K - 1`` n-gram
  drafts per request per step; ``--prefill-budget N`` interleaves
  chunk-aligned prefill slices of at most ``N`` tokens a step with decode.
  ``--mesh DxM`` (paged only) serves through
  :class:`~repro_torch.runtime.serve_loop.ShardedPagedServingSession`:
  the pool and the decode queue split over ``D`` data shards with
  ``M``-way head chunks each, over a
  :func:`~repro_torch.launch.mesh.make_serving_mesh` of distinct cards
  (every entry the CPU with ``--device cpu``); it prints the mesh, each
  shard's work and the shards' balance.  One card runs a ``1xM`` mesh; more
  data shards on it are logical ones (``shards=`` in the session).

``--chaos SEED``, ``--deadline STEPS`` or ``--priority-classes P0,P1,..``
(all ``--cache paged``) serve the stream through the supervised loop
(:class:`~repro_torch.runtime.serve_loop.ServeSupervisor`): a seeded
fault plan (shard loss on a sharded session, slow shard, pool pressure),
deadlines, priority admission, recoverable eviction by replay; the run
exits nonzero if a request is lost, a replay diverges or a page leaks on
any shard.

Random weights come from ``--seed``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve [--cache dense|paged] \\
        [--arch NAME] --smoke --requests 6 --gen-len 16 [--device cuda|cpu] \\
        [--kv-dtype bf16|int8] [--shared-prefix] [--prefix-cache trie \\
        [--retain-pages N]] [--speculate ngram [--draft-k K]] \\
        [--prefill-budget N] [--chaos SEED] [--deadline STEPS] \\
        [--priority-classes P0,P1,...] [--mesh DxM]

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
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.kv_cache import OutOfPagesError
from repro_torch.runtime.serve_loop import (
    PagedServingSession,
    ServeSupervisor,
    ServingSession,
    ShardedPagedServingSession,
    check_session_servable,
)


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
            # Phased admission emits the first token inside add_request;
            # under a prefill budget it arrives later as a step's delta, so
            # the request owes one more emission.
            live[rid] = gen_len + (0 if sess.outputs[rid] else 1)
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
        # Steps without emissions are normal while a budget slices a long
        # prompt in; a loop that never emits again is a stall.
        idle_steps = 0 if step_emitted else idle_steps + 1
        if idle_steps > 64 + sum(len(p) for p in pending):
            raise SystemExit(
                f"serve stream stalled: {idle_steps} consecutive steps "
                f"with no tokens emitted ({len(live)} live, "
                f"{len(pending)} queued)"
            )
    dt = time.time() - t0
    return results, tokens_out, dt


def _serve_supervised(sess, pending, args):
    """The stream through :class:`ServeSupervisor`: a seeded
    :class:`FaultPlan` with ``--chaos`` (generated plans never abandon, and
    their shard loss materialises only on a sharded session, so every
    request must complete), ``--deadline`` and ``--priority-classes``
    (round-robin over the submissions).  Exits nonzero if a request is
    lost, a replay diverges, a request is abandoned without a deadline or
    a page leaks on any shard."""
    from repro_torch.runtime.fault_injection import FaultPlan

    sharded = hasattr(sess, "shards")
    plan = None
    if args.chaos is not None:
        plan = FaultPlan.generate(
            args.chaos, num_shards=sess.num_shards if sharded else 1,
            horizon=max(2, args.gen_len),
            pool_pages=sess._pages_per_shard if sharded else sess.cache.num_pages)
        print(f"chaos plan (seed {args.chaos}): {plan.describe()}")
    sup = ServeSupervisor(sess, gen_len=args.gen_len, deadline=args.deadline, plan=plan)
    classes = args.priority_classes or [0]
    for i, prompt in enumerate(pending):
        sup.submit(prompt, priority=classes[i % len(classes)])
    t0 = time.time()
    results = sup.run()
    dt = time.time() - t0
    stats = sup.stats()
    tokens_out = stats["tokens_out"]
    for idx in sorted(results):
        tag = "abandoned" if idx in sup.abandoned_idx else "done"
        out = results[idx]
        print(f"request {idx} {tag}: {len(out)} tokens: {out[:8]}...")
    print(
        f"served {len(results)}/{args.requests} requests, {tokens_out} decode tokens in "
        f"{dt:.1f}s ({tokens_out / max(dt, 1e-9):.1f} tok/s) over {stats['steps']} "
        f"supervised steps"
    )
    print(
        f"supervision: {stats['faults_applied']} faults applied "
        f"({stats['faults_skipped']} skipped), {stats['suspends']} suspends / "
        f"{stats['resumes']} resumes, {stats['replay_prefill_tokens']} replay prefill "
        f"tokens, {stats['evictions']} pool evictions, {stats['admission_retries']} "
        f"admission retries, {stats['straggler_events']} straggler events, "
        f"{stats['abandoned']} abandoned"
    )
    print(
        f"latency (work units): TTFT p50/p99 {stats['ttft_units_p50']:.0f}/"
        f"{stats['ttft_units_p99']:.0f}, per-token p50/p99 {stats['tpot_units_p50']:.0f}/"
        f"{stats['tpot_units_p99']:.0f} over {stats['work_units']} units "
        f"({stats['prefill_chunks']} prefill chunks, {stats['prefill_stall_steps']} "
        f"decode-stall chunks)"
    )
    if sharded:
        print(f"shard health: {sess.shard_health}")
    for event in sup.events:
        print(f"  {event}")
    # Leak audit: after the stream drains, every shard pool must be empty.
    for i, cache in enumerate([s.cache for s in sess.shards] if sharded else [sess.cache]):
        sweep = cache.refcount_sweep()
        if sweep["live_sequences"] or sweep["live_pages"]:
            raise SystemExit(f"page leak on shard {i} after drain: {sweep}")
    # close() also clears retained trie prefixes and asserts a free pool.
    sweep = sess.close()
    print(f"teardown sweep: {sweep['free_pages']} pages free (clean)")
    if len(results) != args.requests:
        raise SystemExit(f"lost requests: {args.requests - len(results)} of "
                         f"{args.requests} never completed")
    if stats["replay_mismatches"]:
        raise SystemExit(f"{stats['replay_mismatches']} replay(s) diverged from the original "
                         "stream (suspend/resume is supposed to be exact)")
    if stats["abandoned"] and args.deadline is None:
        raise SystemExit(f"{stats['abandoned']} request(s) abandoned without a --deadline: "
                         "a generated chaos plan must complete everything")


def _shared_prefix_demo(sess, cfg, seed, gen_len):
    """Forked system-prompt traffic: one parent, aliased children."""
    rng = np.random.default_rng(seed)
    system = rng.integers(2, cfg.vocab_size, size=48).tolist()
    parent = sess.add_request(system)
    if parent is None:
        raise SystemExit(
            "shared-prefix demo: the system prompt does not fit — raise "
            "--num-pages/--batch"
        )
    kids = []
    for _ in range(2):
        suffix = rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 10)))
        kid = sess.admit_with_prefix(parent, suffix.tolist())
        if kid is None:
            raise SystemExit(
                "shared-prefix demo: could not admit a forked child — raise "
                "--num-pages/--batch (needs the parent plus two children live)"
            )
        kids.append(kid)
    print(
        f"shared-prefix demo: parent {parent} + children {kids}; "
        f"{sess.work_stats()['aliased_pages']} pages aliased across "
        f"{cfg.n_layers} layers (zero rows copied)"
    )
    for _ in range(gen_len):
        sess.step()
    for rid in [parent] + kids:
        out = sess.finish(rid)
        print(f"request {rid} done: {len(out)} tokens: {out[:8]}...")


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
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default=None,
                    help="paged only: latent-cache storage dtype; int8 "
                    "stores per-row-scaled int8 pages (dequant fused into "
                    "the kernel); default = model dtype")
    ap.add_argument("--speculate", choices=("off", "ngram"), default="off",
                    help="paged only: draft-verify speculative decode; "
                    "'ngram' drafts from each request's own history and "
                    "verifies draft-k rows per fused step (greedy outputs "
                    "identical to off)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative rows per step (1 pending token + "
                    "draft-k-1 drafts); >= 2")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="paged only: serve a forked system-prompt family "
                    "with group-batched prefix attention")
    ap.add_argument("--prefix-cache", choices=("off", "trie"), default="off",
                    help="paged only: automatic longest-prefix reuse via a "
                    "radix trie over block-aligned page runs; admissions "
                    "alias matched blocks and prefill only the tail, "
                    "finished prompts retain their prefix pages (LRU-"
                    "evicted under pool pressure); the prompt stream gets a "
                    "shared template so hits occur")
    ap.add_argument("--retain-pages", type=int, default=None,
                    help="prefix-cache trie: cap on pages pinned by "
                    "retained prefixes; default unbounded (pool pressure "
                    "still reclaims LRU subtrees)")
    ap.add_argument("--prefill-budget", type=int, default=None, metavar="TOKENS",
                    help="paged only: per-step prefill token budget; admission "
                    "enqueues the prompt and each step interleaves chunk-aligned "
                    "prefill slices with decode (>= --prefill-chunk; greedy "
                    "outputs identical to phased admission)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="paged only: DxM serving mesh, e.g. 2x1: the page pool "
                    "and decode queue over D data shards with M-way head chunks "
                    "each, one card per mesh entry (the CPU in every entry with "
                    "--device cpu)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="paged only: the supervised serve loop under a seeded "
                    "FaultPlan (shard loss on --mesh, slow shard, pool pressure); "
                    "every request must complete with its exact greedy output or "
                    "the run exits nonzero")
    ap.add_argument("--deadline", type=int, default=None, metavar="STEPS",
                    help="paged only: per-request decode-step deadline; late "
                    "requests are abandoned with their partial output (implies "
                    "the supervised loop)")
    ap.add_argument("--priority-classes", default=None, metavar="P0,P1,...",
                    help="paged only: integer priority classes assigned "
                    "round-robin to the requests (higher admits first; ties by "
                    "deadline slack, then submission order); implies the "
                    "supervised loop")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) launches the CUDA kernels; cpu runs "
                    "their plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.priority_classes is not None:
        try:
            args.priority_classes = [int(x) for x in args.priority_classes.split(",")
                                     if x.strip()]
        except ValueError:
            raise SystemExit(f"--priority-classes must be comma-separated integers, "
                             f"got {args.priority_classes!r}")
        if not args.priority_classes:
            raise SystemExit("--priority-classes must name at least one class")
    supervised = (args.chaos is not None or args.deadline is not None
                  or args.priority_classes is not None)
    if supervised and args.cache != "paged":
        raise SystemExit("--chaos/--deadline/--priority-classes need --cache paged "
                         "(recoverable eviction/replay and priority admission ride the "
                         "paged pool's refcounted free + chunked re-prefill)")
    if args.prefill_budget is not None and args.cache != "paged":
        raise SystemExit("--prefill-budget needs --cache paged (budgeted prefill slices "
                         "ride the chunked paged prefill path; dense admission is "
                         "monolithic)")
    if args.cache != "paged":
        if args.kv_dtype is not None:
            raise SystemExit("--kv-dtype needs --cache paged (dense caches "
                             "store activations at the model dtype)")
        if args.shared_prefix:
            raise SystemExit("--shared-prefix needs --cache paged")
        if args.speculate != "off":
            raise SystemExit("--speculate needs --cache paged (rollback rides "
                             "the paged pool's refcounted truncate; dense slots "
                             "have no page bookkeeping to roll back)")
        if args.prefix_cache != "off":
            raise SystemExit("--prefix-cache needs --cache paged (the trie "
                             "pins refcounted pages; dense slots have none)")
    if args.retain_pages is not None and args.prefix_cache == "off":
        raise SystemExit("--retain-pages needs --prefix-cache trie")
    if args.mesh and args.cache != "paged":
        raise SystemExit("--mesh needs --cache paged (the dense backend has no "
                         "sharded session)")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        try:
            mesh = make_serving_mesh(args.mesh, device)
        except ValueError as e:
            raise SystemExit(str(e))
    arch = args.arch or ("deepseek-v2-mla" if args.cache == "paged" else "qwen1.5-0.5b")
    cfg = get_config(arch, smoke=args.smoke)
    try:
        check_session_servable(cfg)
    except ValueError as e:
        raise SystemExit(str(e))
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(args.seed), device)
    if args.cache == "paged":
        kw = dict(
            num_pages=args.num_pages,
            page_size=args.page_size,
            block_k=args.block_k,
            prefill_chunk=args.prefill_chunk,
            prefix_sharing=args.shared_prefix,
            max_batch=args.batch,
            kv_dtype=args.kv_dtype,
            speculate=args.speculate,
            draft_k=args.draft_k,
            prefix_cache=args.prefix_cache,
            retain_pages=args.retain_pages,
            prefill_budget=args.prefill_budget,
        )
        sess = (PagedServingSession(model, params, **kw) if mesh is None
                else ShardedPagedServingSession(model, params, mesh=mesh, **kw))
    else:
        sess = ServingSession(model, params, batch_size=args.batch, max_len=args.max_len)
    backend = args.cache + (f" (sharded over {args.mesh})" if mesh is not None else "")
    print(f"serving {arch} with the {backend} cache backend on {device}")
    if mesh is not None:
        print(f"mesh {args.mesh}: {sess.num_shards} data shards x {sess.head_shards}-way "
              f"heads, {args.num_pages // sess.num_shards} pages per shard pool")
    if args.shared_prefix:
        _shared_prefix_demo(sess, cfg, args.seed, args.gen_len)
        stats = sess.scheduler_stats
        print(
            f"scheduler: {stats['rebuilds']} rebuilds, {stats['hits']} "
            f"reuse hits; prefill compiles: {sess.prefill_compiles}"
        )
        sweep = sess.close()
        print(f"teardown sweep: {sweep['free_pages']} pages free (clean)")
        return
    rng = np.random.default_rng(args.seed)
    template = []
    if args.prefix_cache == "trie":
        # Template traffic: every prompt opens with the same two-block
        # template, so admissions after the first hit the trie.
        template = rng.integers(2, cfg.vocab_size, size=2 * sess.block_k).tolist()
    pending = [
        template + rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 24))).tolist()
        for _ in range(args.requests)
    ]
    if supervised:
        _serve_supervised(sess, pending, args)
        return
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
        f"({work['page_dma_bytes'] / 1e6:.2f} MB at "
        f"{args.kv_dtype or 'model'} cache dtype)"
    )
    if args.speculate != "off":
        print(
            f"speculative ({args.speculate}, draft_k={args.draft_k}): "
            f"{work['accepted_tokens']} tokens over {work['request_steps']} "
            f"request-steps = {work['accepted_tokens_per_step']:.2f} accepted/step; "
            f"{work['page_dma_bytes_per_accepted_token'] / 1e3:.2f} KB page DMA per "
            f"accepted token"
        )
    if args.prefix_cache == "trie":
        print(
            f"prefix cache: {work['trie_hits']}/{work['trie_admissions']} admissions "
            f"hit ({work['trie_hit_rate']:.2f} hit rate), "
            f"{work['prefix_tokens_reused']} prefix tokens reused "
            f"({work['prefix_tokens_reused_per_admission']:.1f}/adm); pool: "
            f"{work['live_pages']} live / {work['retained_pages']} retained / "
            f"{work['free_pages']} free pages, {work['trie_evicted_pages']} evicted"
        )
    if mesh is not None:
        bal = work["balance"]
        for i, st in enumerate(work["per_shard"]):
            print(f"shard {i}: {st['page_dmas']} page DMAs, {st['decode_steps']} decode "
                  f"steps, {st['free_pages']} pages free")
        print(f"shard work balance: max/mean = {bal['imbalance']:.2f} "
              f"({bal['max']:.0f}/{bal['mean']:.1f} page DMAs)")
    # Teardown leak audit: close() clears the trie and sweeps every pool.
    sweep = sess.close()
    print(f"teardown sweep: {sweep['free_pages']} pages free (clean)")


if __name__ == "__main__":
    main()
