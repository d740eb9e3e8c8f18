#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA H100 (``python3 chip_smoke.py`` from the repository
root) and exits nonzero on any failure:

1. **Build** the hand-written CUDA kernels from ``src/repro_torch/csrc``;
   ptxas's registers and spills of all 24 instantiations of the
   tensor-core row body (the queue kernel K2/K2' with bf16 q over bf16 or
   int8 pages, the padded kernel K5 and the contiguous kernel K4 over bf16
   rows, the GQA decode K6 and the flash prefill K7 over bf16 K/V;
   16/32-row tiles, amla/base) and their dynamic shared memory are
   printed, and a spill or a missing line fails the run.
2. **Kernel phase**: every kernel on the card against its plain PyTorch
   version on the same inputs, bf16 and fp32, ``amla`` and ``base``:
   the paged AMLA decode kernel (K2) and the split-KV combine (K3) at full
   width (Dk 576, Dv 512, page 128, block_k 512) for a decode step and a
   prefill chunk, and K2's tensor-core body (bf16 q over bf16 pages) over
   ragged kv_len (0, 1, 15, 16, 127, 129, 511, 513, 1116), G of 1, 17, 128
   and 512, softcap and per-row causal rows; K2 over int8 pages
   (K2-int8; bf16 q on the tensor-core body), the shared-prefix group
   kernel (K2') with the heterogeneous combine, and the padded-grid kernel
   (K5); the GQA decode (K6) and flash prefill (K7) kernels at
   the head geometries of gemma2-2b (8/4 x 256, window 4096, softcap 50),
   qwen2.5-3b (16/2 x 128) and qwen1.5-0.5b (16/16 x 64); the contiguous
   MLA decode (K4) at 128 heads for a decode step and a 512-token prefill;
   then K4 and K5 on the tensor-core body (bf16 q over bf16 rows): ragged
   kv_len, G of 1, 17 and 128, K4 over a batch-sliced cache, K5 at pages
   of 16, 64, 128 and 512 rows behind fragmented tables.  Every bf16 K2,
   K4, K5, K6 and K7 call must count one tensor-core launch, every fp32
   one none; a bf16 K6 call split over its KV blocks one combine (K3)
   launch, held against the plain version walked in the same splits.
   Cases include kv_len 0 (rows must be exact zeros), ragged kv_len and
   contexts longer than the window.  Each kernel is timed beside its
   bound, its plain version and, where one exists, a single PyTorch call.
   Every bound in this script is the wrapper's own charge for the call
   (its cost function, the one the dry run counts, read under an
   ``OpCounter``: :func:`charged`) at the card's peaks for the operands'
   dtype (``roofline.analysis.kernel_bound``).
3. **Small references**: the smoke-size models (fp32) through the kernels
   on the card and the plain versions on the CPU — deepseek-v2-mla over
   the paged path (bf16 pages, its decode steps replayed from a CUDA graph
   of ``PagedDecodeStep``; int8 pages with a forked family), gemma2-2b
   and deepseek-v2-mla through the dense ``ServingSession`` (graphs) —
   must agree.
4. **Dense serve phase, gemma2-2b** at its published widths (26 layers,
   random bf16 weights from a seed) through ``ServingSession(batch 4,
   max_len 8192)`` and the ``launch/serve`` stream loop: prompts of 5,
   300, 1100 and 4500 tokens, 16 greedy tokens each.  K6 and K7 launch
   counts must match the layers x calls of the path, all on the
   tensor-core body, with one K3 launch per split K6 call.  Every decode
   step replays the session's CUDA graph (one capture); its first 3 steps
   are held against the eager walk on the same state (greedy tokens equal,
   the largest logit difference printed; the eager runs' launches are not
   counted).
5. **Paged serve phase**: ``deepseek-v2-mla`` at its published widths
   (60 layers) through ``PagedServingSession``: 4 ragged prompts, 16
   greedy tokens each, ``num_splits=2``; every prefill chunk and decode
   step of every layer must go through K2 (its tensor-core body) and K3.
   Decode steps replay a CUDA graph per live batch size, the first 3 held
   against the eager walk as in 4.
6. **Shared-prefix serve phases**: the same weights through
   ``PagedServingSession(prefix_sharing=True)``, over bf16 pages and then
   over int8 pages (``kv_dtype="int8"``): an 1100-token system prompt,
   three ``admit_with_prefix`` children, a 513-token loner, 16 greedy
   steps; every decode step of every layer runs the group-prefix kernel
   (K2'), the queue kernel (K2, or K2-int8) and the combine, with exact
   launch counts, every K2 and K2' through the tensor-core body.
7. **Dense serve phase, deepseek-v2-mla**: the same weights and prompts
   through ``ServingSession(batch 4, max_len 2048)``; every prefill and
   decode step of every layer must go through K4's tensor-core body;
   graphs and the hold against the eager walk as in 4.
8. **K3 phase** (run right after the kernel phases): the split-KV combine against its plain version and timed
   at the shapes of its three uses: after K2 at the paged decode step and
   prefill chunk, the two-source merge of a shared-prefix step, and K6's
   splits at the three GQA head geometries (``--k3-only`` runs the build
   and this phase alone, and prints its times as one JSON line).
9. **Padded decode phase**: ``PagedDecodeSession(scheduler="padded")`` at
   full MLA attention width, 4 synthetic prompts + 16 steps through K5's
   tensor-core body, held against the same inputs through
   ``scheduler="queue"``.
10. **Nested-prefix and verify kernel phase** (after the other kernel
    phases): K2' over the nested groups of a prefix trie (windows that
    start past block 0), the suffix K2 and the hetero K3 at chains of 2
    (a table num_splits + 2 wide), over bf16 and int8 pools; K2 at the
    verify shape (4 token rows x 128 heads at explicit positions), the
    fused call against its single-row calls; each timed beside its bound,
    its plain version and one SDPA call.
11. **Small trie and speculation references**: the smoke model (fp32) with
    ``prefix_cache="trie"`` (tokens equal to the CPU path's and to trie
    off) and ``speculate="ngram", draft_k=4`` over bf16 and int8 pages
    (tokens and counters equal to the CPU path's, an extension of
    ``speculate="off"``).
12. **Trie serve phase**: deepseek-v2-mla at published widths with
    ``prefix_cache="trie"``: template prompts that share a 1024-token
    system prompt and two 1536-token templates, a loner, 16 steps, a late
    admission from retained pages; trie counts equal the prompts' own,
    three nested groups every step, exact K2/K2'/K3 counts, and a warm
    admission equal bit for bit to a cold one.
13. **Speculation serve phase**: the paged phase's weights and prompts with
    ``speculate="ngram", draft_k=4``: exact rollback after every step,
    exact K2/K3 counts, acceptance and ms per accepted token printed.
14. **Small interleaving and suspend references**: the smoke model (fp32)
    admitted under ``prefill_budget`` and with requests suspended and
    resumed by replay (one while its prefill is pending): tokens equal to
    the phased, uninterrupted stream exactly, ``replay_mismatches`` 0, and
    equal to the CPU path's.
15. **SLA serve phase**: the paged phase's weights under one burst of the
    reference's multi-tenant SLA traffic through ``ServeSupervisor``,
    phased and with ``prefill_budget=96``: TTFT per class and per-token
    latency (work units and host ms), graph captures; no stall chunks when
    interleaved, equal units per token and first tokens, exact K2/K3
    counts, a clean teardown.
16. **Suspend / replay and chaos phase**: the same weights; suspend and
    resume of a plain request, a forked child (re-aliased on its live
    parent, then replayed standalone) and a prompt still pending under a
    budget, each resumed request's rows held against a copy taken before
    (rows prefilled on their original chunk boundaries bit-equal, the rest
    within 1e-2 of the row's max); then ``ServeSupervisor`` fault free and
    under pool pressure, a slow shard and an abandon: resumes = suspends
    >= 1, the straggler flagged, no page leaked.

17. **Families kernel phase** (with the other kernel phases): K6 and K7,
    bf16 and fp32, ``amla`` and ``base``, against their plain versions at
    the head geometries of qwen3-moe-30b-a3b (32/4 x 128), granite-moe
    (24/8 x 64), internlm2-20b (48/8 x 128) and recurrentgemma-2b (MQA,
    10/1 x 256, window 2048, at kv_len 0, 1, 2047, 2049 and 4500), the
    two served in 19 at the shapes 19 gives them (8192-row caches, K7 at
    each prefill's length), timed beside their bound, plain version and
    one SDPA call.
18. **Small family references**: smoke qwen3-moe, granite-moe, mamba2
    and recurrentgemma (fp32) through the dense ``ServingSession`` on the
    card (kernels, graphs) and on the CPU, held as in 3, with a 300-token
    prompt past the SSD chunk and one block of the RG-LRU scan.
19. **Families phase**: qwen3-moe-30b-a3b (48 layers, 30.5 B
    parameters), mamba2-370m (48 Mamba-2 layers) and recurrentgemma-2b
    (18 RG-LRU + 8 local-attention layers) at published widths and full
    depth through ``ServingSession(batch 4, max_len 8192)`` and the
    ``launch/serve`` stream loop: 4 prompts up to 4500 tokens, 16 greedy
    tokens each; K6/K7/K3 launches equal to attention layers x calls (0
    for mamba2), one graph per session whose first 3 steps equal the eager
    walk bit for bit (tokens and logits), prefill tokens/s, decode
    ms/step, peak memory, and qwen3-moe's decode beside the time to read
    all experts' weights.
20. **vlm / encdec kernel phase** (with the other kernel phases): K6 and K7
    (and K3 after the split K6 calls), bf16 and fp32, ``amla`` and
    ``base``, against their plain versions at the shapes 22 gives them:
    qwen2-vl-7b's G = 7 rows of Dh 128 (decode over 8192 and 2048 rows,
    the bucket-8 prompt, K7 at 512 / 2048 / 8192 and its vision prefill of
    1024 positions), seamless-m4t-medium's 16 x 64 heads (K7 **non-causal**
    over 1024 frames for the encoder and the prompt's cross-attention, K7
    causal over the 256-row self cache, K6 for the decode step's self- and
    cross-attention); timed beside their bound, plain version and one SDPA
    call.
21. **Small vlm / encdec references**: smoke qwen2-vl-7b (text-only
    ``ServingSession``; the vision prefill + graphed decode steps) and
    smoke seamless-m4t-medium (``init_cache`` + ``decode_step``), fp32,
    on the card and on the CPU, held as in 3.
22. **vlm / encdec phase** (last): qwen2-vl-7b (28 layers, 7.62 B
    parameters) text-only through ``ServingSession(batch 4, max_len
    8192)`` as in 19 (prompts 5, 300, 1100, 4500; graph = eager bit for
    bit), then on the same weights 4 requests of 256 patch embeddings and
    768 text tokens prefilled as one batch (``lm_apply`` over
    ``mrope_positions`` with ``embeds_override``, the reference's
    ``dryrun.lower_prefill`` form) and 16 graphed greedy steps (graph =
    eager, the M-RoPE position jump printed); seamless-m4t-medium (12 +
    12 layers) over 4 x 1024 frames: ``init_cache``, ``decode_step`` over
    a 32-token prompt, 16 eager greedy steps.  K6/K7/K3 launches equal to
    layers x calls per path; prefill s and tokens/s, decode ms/step,
    peak memory.
23. **Train phase** (after all serving): (a) the attention Function
    (``core.attention.multi_head_attention`` on inputs that need a
    gradient) at qwen1.5-0.5b's 16 x 64 heads over 2 x 2048 tokens, bf16
    and fp32 inputs, amla and base, and at smoke deepseek-v2-mla's
    expanded MLA widths (Dk 48, Dv 32: K7 at 64 with zero columns): one
    K7 launch per call, its forward within 1e-2 (bf16) / 2e-3 (fp32) of
    ``blockwise_attention``'s, its backward equal to
    ``torch.autograd.grad`` through ``blockwise_attention`` on the same
    inputs and within one bf16 step (2^-7 of the largest magnitude, fewer
    than 1% of elements differing) of that gradient taken on the CPU; (b)
    smoke qwen1.5-0.5b and deepseek-v2-mla, fp32, 3 remat
    ``make_train_step`` steps, each taken on the card and on the CPU from
    the CPU's state before it: loss, grad_norm, first moment and
    parameters at the tolerances of ``tests/test_torch_train_loop.py``;
    (b'') smoke qwen3-moe-30b-a3b at bf16 compute, whose expert products'
    gradient on the card is ``moe._WideProducts``': one MoE layer's
    expert weight gradients and one train step (loss, grad_norm, the
    experts' first moments) against the CPU's (:func:`moe_train_check`);
    (c) qwen1.5-0.5b at full width (24
    layers, 0.46 B fp32 master parameters from seed 0 on the card),
    ``SyntheticLMData`` seed 0, batch 8 x 2048 tokens, remat, amla, 10
    steps, peak lr 3e-4, warmup 2: each step's loss, grad_norm, lr and
    ms; the steady ms/step (steps 2-10), tokens/s, peak GiB and the
    model-FLOPs share of the bf16 peak; gates: finite losses, the last
    below the first, K7 = 24 x 2 x 10 launches (the forward and the remat
    recompute), all on the tensor-core body; (d) the serve handoff: the
    final state through ``CheckpointManager(async_save=True)`` and back
    (bit for bit), ``serving_params`` (bf16 + the fp32 table copy), 4
    prompts x 8 greedy tokens through ``ServingSession`` equal to those
    of the in-memory trained parameters (K7, K6, K3 launches counted);
    (b') between (b) and (c), int8 gradient compression on the card: smoke
    deepseek-v2-mla and recurrentgemma-2b gradient trees compressed with
    threefry noise drawn on the card, bit for bit the CPU's, and one int8
    ``make_train_step`` step on the card.
24. **Head-chunk kernel phase** (with the other kernel phases): K2 and K3
    over each half of 128 heads (``head_shards = 2``) against the matching
    rows of the 128-head call, bit for bit, at the decode shape and at a
    prefill chunk's 4096 rows; K2 at G = 64 against its plain version,
    timed beside its bound, plain version and one SDPA call.
25. **Small sharded reference**: the smoke model (fp32) through one
    session and ``ShardedPagedServingSession`` (2 shards, then 2 shards x
    2 head chunks) on the card and 2 shards on the CPU: greedy tokens
    equal in all four.
26. **Sharded serve phase** (after the paged phase, on its weights, one
    parameter set for every shard): (a) ``ShardedPagedServingSession(
    shards=2)`` over the paged phase's prompts and 16 + 16 pages, graphed:
    routing, tokens and the first step's logits against the single
    session, ms/step, balance, captures and K2 = K3 = layers x (chunks +
    steps) per shard; (b) the same with 2 head chunks: tokens equal to
    (a), K2 = K3 = 2 x (a); (c) ``return_partials`` across two pools merged
    by ``combine_shard_partials`` within 2e-3 of one pool (fp32); (d)
    ``fail_shard(1)`` after 4 steps, tokens equal to (a)'s, then
    ``attach_shard()`` on the same parameter tensors (allocated memory
    grows by its pool only) taking the next admission, every pool free at
    the teardown; (e) ``ServeSupervisor`` under a ``shard_loss``: every
    result complete, ``replay_mismatches`` 0.
27. **Split-KV kernel check** (with the other kernel phases):
    ``core.distributed.gqa_split_kv_decode`` (K6 with ``return_partials``
    per sequence shard, one LSE merge) at qwen2.5-3b's decode (B 4, 16 / 2
    heads x 128, kv_len 4096 / 8192 / 16384 / 32000 of a 32768-row cache)
    over 1, 2 and 4 logical shards, bf16 and fp32, amla and base, against
    its plain version and the monolithic K6 (+ K3) call, per request row
    within 5e-3 of the row's norm (and the absolute TOL); two wrong merges
    of the same partials must fail that gate; K6 without partials
    bit-equal to its partials merged by K3; timed beside its bound, the
    plain version and one SDPA call.
28. **Small seqkv reference**: smoke qwen2.5-3b (fp32) decoded under
    ``mesh_ctx(seqkv)`` over 4 logical shards on the card and the CPU:
    tokens equal.
29. **seqkv phase** (after the vlm / encdec phase): qwen2.5-3b at full
    width (36 layers, bf16, seed 0), 4 prompts of 4096-32000 tokens in a
    ``ServingSession(batch 4, max_len 32768)``, then 16 greedy steps from
    that cache plain and through ``jit_serve_fns``' decode (inputs placed
    once on the 1 x 1 nccl mesh) under ``mesh_ctx(seqkv)`` over 1 x 1, 1 x
    2 and 1 x 4 logical shards: ms/step, K6 = layers x steps x shards and
    no K3, the first step's logits within 2e-2 of the largest plain
    logit, at least 60 of the 64 tokens equal to plain's.  Train (c') in
    23: 3 ``jit_train_step`` steps on the 1 x 1 nccl mesh from (c)'s
    state, each bit-equal to ``make_train_step``'s, and
    ``reshard_train_state`` bit-equal, timed.
30. **Roofline phase** (``repro_torch.roofline``): one untimed step of
    the train phase's cell (qwen1.5-0.5b, 8 x 2048, remat) and of the
    dense deepseek-v2-mla decode step (batch 4, the cache filled to its
    2048 rows) counted by ``OpCounter`` on the card and, at the same
    shapes, on meta-device stand-ins: flops and bytes equal within 1e-6,
    both counts and every kernel's charge printed; the three roofline
    terms of each, the dominant one and the measured ms over the bound
    (the train phase's steady ms/step; the eager decode step timed here),
    the train cell's model-FLOPs share, and the decode cell's memory term
    at least its weights' bytes over 3.35 TB/s; then ``python -m
    repro_torch.launch.dryrun --archs qwen1.5-0.5b --shapes decode_32k
    --meshes single`` on the card's host: exit 0, ``[OK]``, ``0 failed``.
31. **Tensor-parallel kernel check** (with the other kernel phases): K4
    at G 64 (decode and the 64-token prompt over 64 of deepseek-v2-mla's
    128 heads), K6 at 8 query heads over 1 kv head (+ K3: 4 splits of the
    2048-row cache) and K7 at 8 heads, and at 5 query heads over 1 kv head
    at Dh 256 in a 2048-key window (recurrentgemma-2b's rank), one rank's
    shapes in phase 32,
    against their plain versions (bf16 and fp32, amla and base), timed
    beside their bounds, the plain versions and SDPA.
32. **Tensor-parallel phase** (after the ranks phase): ``jit_serve_fns``
    split by ``model`` on 1 x 2 gloo ranks on the card: (c)
    deepseek-v2-mla at full width (60 layers, bf16, amla) under ``tp``,
    (d) qwen2.5-3b at full width (36 layers) under ``tp_fsdp``; 4 prompts
    of 64 tokens and 16 decode steps ((d): 8), held against the one-process run
    from the same weights (:func:`tp_phase`): tokens, logits, each rank's
    parameter bytes, split counts, launches at the rank's shapes; (h)
    qwen3-moe-30b-a3b at full width (48 layers) under ``tp``, its experts
    split by expert (each rank multiplies its 64 of 128), 8 decode steps,
    the same gates (at fp32 compute: tokens in proportion and rerouted
    tokens first at near-ties) and no expert stack gathered; (j)
    mamba2-370m (48 Mamba-2 layers) under ``tp_fsdp`` and (k)
    recurrentgemma-2b (26 layers: RG-LRU and local attention) under
    ``tp``, their blocks split by heads and channels, 4 decode steps, the
    same gates and no block leaf gathered; then
    (g) qwen2.5-3b at full width under ``fsdp`` on 2 x 1 ranks, each rank
    its data shards of (d)'s weights and 2 of the 4 rows, every layer
    gathered at its use, 2 decode steps, held against the same steps of
    (d)'s one-process runs: tokens,
    logits, launches, layers x calls layer gathers, the gathered bytes
    alive at once within what the step gathers of its largest layer plus
    its largest gathered table, each rank's peak below 0.85 of the whole
    model's parameter bytes.
33. **Ranks phase** (after the seqkv phase; two gloo ranks on the card):
    (a) qwen2.5-3b seqkv decode on 1 x 2 ranks from the seqkv phase's
    cache (16 steps; the parameters handed whole, nothing gathered),
    bit-equal to the logical 1 x 2 run; (b) qwen1.5-0.5b training on 2 x 1
    ranks under ``fsdp`` and ``tp_fsdp`` (2 steps, remat), each step held
    by rank 0 against ``make_train_step`` from the same gathered state,
    the layers gathered at their use (again in the recompute): the
    gathered bytes alive at once within what the step gathers of its
    largest layer plus its largest gathered table; each rank's peak and
    gloo calls and bytes a step printed; between the ``tp_fsdp`` steps
    the state saved by rank (``CheckpointManager(async_save=True)``, each
    rank its shards) and restored against the whole initial state, every
    shard and placement bit-equal, the second step run from the restored
    state, each rank's save and restore seconds and shard bytes printed
    (:func:`ranks_phase`).
34. **Tensor-parallel train phase** (after phase 32): qwen1.5-0.5b at
    full width (24 layers) split by ``model`` on 1 x 2 ranks, (e) ``tp``
    at fp32 compute and (f) ``tp_fsdp`` at bf16, and (i) smoke qwen3-moe
    at bf16 under ``tp`` (its experts split by expert), 1 step each, held
    against the one-rank step (:func:`tp_train_phase`).

Imports nothing of JAX or of the JAX package.  Takes no arguments, or
``--k3-only`` (the build and phase 8), or ``--k6-ab OTHER_TREE/src``
(K6 without partials at phase 27's shapes from both trees, bit for bit:
:func:`k6_ab`).
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

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
SLEEP_CYCLES = 4_000_000  # ~2 ms of device clock before each timed call
# The kernels on the tensor-core row body (bf16 q), with their instantiations
# (rows' type x 16/32-row tiles x amla/base) and the block_k their shared
# memory is printed at: K2/K2' (bf16 and int8 pools, 512-row blocks), K5 (one
# block per 128-row page), K4 (512-row blocks of the 2048-row dense cache),
# K6 and K7 (bf16 K/V rows of their own, 512-key blocks, printed at Dh 256).
MMA_KERNELS = {
    "mla_decode_queue_mma_kernel": (8, BLOCK_K),
    "mla_decode_padded_mma_kernel": (4, PAGE),
    "mla_decode_rows_mma_kernel": (4, BLOCK_K),
    "gqa_decode_mma_kernel": (4, BLOCK_K),
    "flash_prefill_mma_kernel": (4, BLOCK_K),
}
GQA_MMA_KERNELS = ("gqa_decode_mma_kernel", "flash_prefill_mma_kernel")


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header (``== ...``) after the seconds since
    the script started."""
    if msg.startswith("=="):
        msg = f"[{time.perf_counter() - T0:.1f} s] {msg}"
    print(msg, flush=True)


def time_cuda(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Mean ms per call on the card, CUDA events around each call, the L2
    cache overwritten between calls (the serve path reads each layer's
    pages cold).  A 2 ms device sleep before each call lets the host
    enqueue the wrapper's work before the first event fires, so the time
    is the device's, not the host's enqueue (a plain version that waits
    for the device inside still counts its host time); 0.2 ms did not
    cover the group-prefix wrapper's enqueue on a slow host."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.add_(1)
        torch.cuda._sleep(SLEEP_CYCLES)
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


def run_k2(case, variant, plain, softcap=None):
    """K2 (K2-int8 when the case has scales) or its plain version."""
    from repro_torch.kernels import mla_decode_paged as mp

    kw = dict(
        d_v=DV, variant=variant, scale=1.0 / math.sqrt(192), block_k=BLOCK_K,
        num_dest_slots=case["sched"].num_dest_slots, softcap=softcap,
    )
    args = (case["q"], case["pages"], case["bt"], case["kv"], case["q_pos"])
    if plain:
        return mp._queue_rows_plain(*args, case["items"], case.get("scales"), **kw)
    return mp.mla_decode_paged_queue_rows(*args, *case["items"], case.get("scales"), **kw)


def run_k3(case, o_part, lse, plain):
    from repro_torch.kernels import mla_decode_combine as mc

    fn = mc._combine_plain if plain else mc.combine_split_partials
    return fn(o_part, lse, case["dest"], case["n_splits"])


QUEUE, GROUP = "mla_decode_paged_queue_rows", "mla_decode_paged_group_prefix"
COMBINE = "combine_split_partials"


def charged(fn, name):
    """``(flops, bytes)`` that the wrapper ``name`` charges (its own cost
    function, the dry run's) for the work of one call of ``fn``, read under
    a counter; the launches it makes come after every launch-count check
    and before the main path's counts are set to 0."""
    from repro_torch.roofline.op_cost import OpCounter

    with OpCounter() as c:
        fn()
    torch.cuda.synchronize()
    return c.charges[name].flops, c.charges[name].bytes


def bound(cost, dtype):
    """(least ms, what bounds it) for a charge ``cost`` = ``(flops,
    bytes)`` at the card's peaks for ``dtype``
    (``roofline.analysis.kernel_bound``)."""
    from repro_torch.roofline import analysis

    return analysis.kernel_bound(*cost, dtype)


def k2_bound(case):
    """K2's bound: the queue wrapper's charge for the case."""
    return bound(charged(lambda: run_k2(case, "amla", plain=False), QUEUE), case["q"].dtype)


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


def hold_k2_k3(case, name, dtype, variant, worst, softcap=None):
    """K2 and K3 against their plain versions on one case: every written
    slot's partial and lse, the combined rows (kv_len 0 exact zeros, all
    finite), and K3 alone on the plain partials.  A bf16 case must go
    through the tensor-core body (one more ``mma_launches``), an fp32 case
    must not."""
    from repro_torch.kernels import mla_decode_paged as mp

    lens, g, ns = case["kv_host"].tolist(), case["q"].shape[1], case["sched"].num_splits
    n_mma = mp.mla_decode_paged_queue_rows.mma_launches
    o_k, lse_k = run_k2(case, variant, plain=False, softcap=softcap)
    mma = mp.mla_decode_paged_queue_rows.mma_launches - n_mma
    if mma != int(dtype == torch.bfloat16):
        raise SystemExit(f"K2 {name} {dtype}: {mma} tensor-core launches, expected "
                         f"{int(dtype == torch.bfloat16)}")
    o_p, lse_p = run_k2(case, variant, plain=True, softcap=softcap)
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
    err_lse = (lse_k[live][fin] - lse_p[live][fin]).abs().max().item() if fin.any() else 0.0
    if (~fin).any() and o_k[live][~fin[..., 0]].abs().max().item() != 0.0:
        raise SystemExit(f"K2 {name}: rows without a visible key are not exact zeros")
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
    log(f"  {name:7s} {str(dtype)[6:]:8s} {variant} G={g} splits={ns} kv={lens}"
        f"{'' if softcap is None else f' softcap={softcap:g}'}: K2 o {err_o:.3e} lse "
        f"{err_lse:.3e}, K2+K3 {err_out:.3e}, K3 {err_k3:.3e} (tol {tol:g})")
    if max(err_o, err_lse, err_out, err_k3) > tol:
        raise SystemExit(f"kernel phase: {name} {dtype} {variant} exceeds tol {tol}")


def chunk_positions(kv_len, g, heads=32):
    # a 4-token chunk of 32 heads ending at kv_len: row r is token r // heads
    return np.maximum(kv_len - g // heads, 0) + np.arange(g) // heads


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
                hold_k2_k3(make_case(7, lens, g, dtype, ns, pos_fn), name, dtype, variant, worst)
    # The tensor-core body (bf16 q over bf16 pages) around every edge of its
    # chunks (16-key value chunks, 128-key score strips, 512-row blocks), on
    # one row, a ragged 17-row tile, 128 rows and 512 rows (32-row tiles);
    # then softcap with per-row causal prefill rows.
    ragged = [0, 1, 15, 16, 127, 129, 511, 513, 1116]
    for g in (1, 17, 128, 512):
        for ns in (1, 2):
            for variant in ("amla", "base"):
                hold_k2_k3(make_case(13, ragged, g, torch.bfloat16, ns, decode_positions),
                           "ragged", torch.bfloat16, variant, worst)
    for variant in ("amla", "base"):
        hold_k2_k3(make_case(14, [1116, 300, 3, 0], 128, torch.bfloat16, 2, chunk_positions),
                   "chunk", torch.bfloat16, variant, worst, softcap=30.0)
    for (kname, dtype, variant), err in worst.items():
        log(f"  max |kernel - plain| {kname} {str(dtype)[6:]} {variant}: {err:.3e} "
            f"(tol {TOL[dtype, variant]:g})")

    # Timing of K2 at the serve phase's decode shape (bf16, 4 requests after
    # 16 decode steps, two splits) and at its prefill-chunk shape; K3 is
    # timed at the shapes of its three uses in k3_phase.
    rows = {}
    timed = [
        ("decode", make_case(11, [37 + 16, 300 + 16, 513 + 16, 1100 + 16], 128,
                             torch.bfloat16, 2, lambda l, g: np.full((g,), l - 1))),
        ("prefill", make_case(12, [1100], 4096, torch.bfloat16, 1, prefill_positions)),
    ]
    for shape, case in timed:
        t2 = time_cuda(lambda: run_k2(case, "amla", plain=False), 20, flush)
        t2p = time_cuda(lambda: run_k2(case, "amla", plain=True), 5, flush)
        tlib = time_cuda(sdpa_call(case), 20, flush)
        b2, by2 = k2_bound(case)
        log(f"  time {shape} (bf16, G={case['q'].shape[1]}, kv={case['kv_host'].tolist()}): "
            f"K2 {t2:.4f} ms (bound {b2:.4f} ms by {by2}, plain {t2p:.4f} ms, "
            f"SDPA on a contiguous copy {tlib:.4f} ms)")
        rows[shape] = (t2, t2p, b2, by2, tlib)
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


def gqa_case(kernel, geom, b, sq, s, kv, dtype, seed, causal=True):
    """Inputs of one K6 or K7 call on the card.  K6 gets q rows (B, Hkv, G,
    Dh) with G = Sq * group at the last Sq positions below kv_len, and
    k/v as transposed views of (B, S, Hkv, Dh) tensors, as the dense layer
    hands them over; K7 gets (B, Hq, Sq, Dh) queries at positions 0..Sq-1
    and a (B, Hkv, S, Dh) cache, causal or not (an encoder, a
    cross-attention: every key below kv_len visible)."""
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
                causal=causal, kv=torch.as_tensor(kv, device="cuda"),
                pos=torch.as_tensor(np.array(rows_pos), dtype=torch.int32, device="cuda"),
                kw=dict(scale=1.0 / math.sqrt(dh), softcap=softcap, window=window))


def run_gqa(case, variant, plain):
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd

    q, k, v, kv, kw = case["q"], case["k"], case["v"], case["kv"], case["kw"]
    blk = min(512, max(k.shape[2], 128))
    if case["kernel"] == "K6":
        if plain:  # walked in the kernel's own splits
            return gd.attend_plain(q, k, v, kv, case["pos"], variant=variant, block_k=blk,
                                   num_splits=gd.split_count(q, k, blk), **kw)
        return gd.gqa_decode_rows(q, k, v, kv, case["pos"], variant=variant, **kw)
    causal = case["causal"]
    if plain:
        return fp._prefill_plain(q, k, v, kv, variant=variant, block_k=blk, causal=causal, **kw)
    return fp.flash_prefill(q, k, v, kv, variant=variant, causal=causal, **kw)


def gqa_bound(case):
    """K6/K7's bound: the wrapper's charge for the case."""
    name = "gqa_decode_rows" if case["kernel"] == "K6" else "flash_prefill"
    return bound(charged(lambda: run_gqa(case, "amla", plain=False), name), case["q"].dtype)


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
    mask = kpos < case["kv"].long()[:, None, None, None]
    if case["causal"]:
        mask = mask & (kpos <= pos.long()[:, None, :, None])
    if window:
        mask = mask & (kpos > pos.long()[:, None, :, None] - window)
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
    """K4's bound: the wrapper's charge for the case."""
    return bound(charged(lambda: run_k4(case, "amla", plain=False), "mla_decode_rows"),
                 case["q"].dtype)


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
    worst = hold_dense_cases(dense_cases)

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
    return worst, time_dense_rows(timed, flush)


def hold_dense_cases(cases_of):
    """Hold every K4/K6/K7 case of ``cases_of(dtype)`` (bf16, then fp32)
    against its plain version, ``amla`` and ``base``, with the tensor-core
    and K3 launch counts checked per call; returns the largest error per
    (kernel, dtype, variant)."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import mla_decode_combine as mc

    worst = {}
    counted = lambda: (md.mla_decode_rows.mma_launches, gd.gqa_decode_rows.mma_launches,
                       fp.flash_prefill.mma_launches, mc.combine_split_partials.launches)
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in cases_of(dtype):
            kname = name.split()[0]
            bf = dtype == torch.bfloat16
            splits = 1 if kname != "K6" else gd.split_count(
                case["q"], case["k"], min(512, max(case["k"].shape[2], 128)))
            for variant in ("amla", "base"):
                run = run_k4 if kname == "K4" else run_gqa
                n0 = counted()
                got = run(case, variant, plain=False)
                mma = tuple(a - b for a, b in zip(counted(), n0))
                want_mma = (int(bf and kname == "K4"), int(bf and kname == "K6"),
                            int(bf and kname == "K7"), int(splits > 1))
                if mma != want_mma:
                    raise SystemExit(f"{name} {dtype}: (K4, K6, K7) tensor-core and K3 launches "
                                     f"{mma}, expected {want_mma}")
                want = run(case, variant, plain=True)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = TOL[dtype, variant]
                empty = case["kv_host"] == 0
                if empty.any() and got[torch.as_tensor(empty, device="cuda")].abs().max().item() != 0.0:
                    raise SystemExit(f"{name}: rows with no visible key are not exact zeros")
                if not torch.isfinite(got).all():
                    raise SystemExit(f"{name}: non-finite output")
                worst[kname, dtype, variant] = max(worst.get((kname, dtype, variant), 0.0), err)
                log(f"  {name:28s} {str(dtype)[6:]:8s} {variant} kv={case['kv_host'].tolist()}: "
                    f"max |kernel - plain| {err:.3e} (tol {tol:g})"
                    f"{', tensor-core body' if any(mma[:3]) else ''}"
                    f"{f', {splits} splits + K3' if splits > 1 else ''}")
                if err > tol:
                    raise SystemExit(f"dense kernel phase: {name} {dtype} {variant} exceeds tol {tol}")
            del case
            torch.cuda.empty_cache()
    for (kname, dtype, variant), err in sorted(worst.items(), key=str):
        log(f"  max |kernel - plain| {kname} {str(dtype)[6:]} {variant}: {err:.3e} "
            f"(tol {TOL[dtype, variant]:g})")
    return worst


def time_dense_rows(timed, flush):
    """Time each (kernel, shape, case) of ``timed`` (bf16, amla) beside its
    bound, its plain version and one SDPA call; returns
    {(kernel, shape): (ms, plain ms, bound ms, bound by, SDPA ms or None)}."""
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
    return rows


# (name, Hq, Hkv, Dh, window, softcap) of the MoE, hybrid and internlm2 stacks
FAMILY_GEOMETRIES = [
    ("qwen3-moe-30b-a3b", 32, 4, 128, None, None),
    ("granite-moe-3b-a800m", 24, 8, 64, None, None),
    ("recurrentgemma-2b", 10, 1, 256, 2048, None),
    ("internlm2-20b", 48, 8, 128, None, None),
]


def family_cases(dtype):
    """K6/K7 at the families' head geometries.  The two the families phase
    serves at full width get the shapes it gives them: qwen3-moe decode
    over the 8192-row cache at kv_len 0, 1, 2047 and 4516 (16 splits
    merged by K3), its 5-token prompt's bucket of 8 through K6, and the
    buckets 512, 2048 and 8192 through K7 (kv_len = bucket);
    recurrentgemma's MQA (G = 10 at Dh 256) over its 2048-key window at
    kv_len 0, 1, 2047, 2049 and 4500, and its exact-length prefills (5
    tokens through K6; 300, 1100 and 4500 through K7).  granite-moe and
    internlm2 at kv_len 0, 1, 777 and 2048, an 8-token (bucket) prefill
    through K6 and a 2048-token one through K7."""
    out = []
    for i, geom in enumerate(FAMILY_GEOMETRIES):
        name = geom[0]
        if geom[4]:
            kv = [0, 1, 2047, 2049, 4500]
            out.append((f"K6 {name} decode", gqa_case("K6", geom, 5, 1, 8192, kv, dtype, 60 + i)))
            out.append((f"K6 {name} 5-token prefill",
                        gqa_case("K6", geom, 2, 5, 8192, [5, 4500], dtype, 70 + i)))
            out.append((f"K7 {name} prefill",
                        gqa_case("K7", geom, 5, 4500, 8192, [4500, 2049, 2047, 1, 0], dtype, 80 + i)))
            for j, sq in enumerate((300, 1100)):
                out.append((f"K7 {name} prefill {sq}",
                            gqa_case("K7", geom, 1, sq, 8192, [sq], dtype, 110 + 10 * j)))
        elif name == "qwen3-moe-30b-a3b":
            out.append((f"K6 {name} decode",
                        gqa_case("K6", geom, 4, 1, 8192, [0, 1, 2047, 4516], dtype, 60 + i)))
            out.append((f"K6 {name} 8-token prefill",
                        gqa_case("K6", geom, 2, 8, 8192, [8, 4999], dtype, 70 + i)))
            for j, sq in enumerate((512, 2048, 8192)):
                out.append((f"K7 {name} prefill {sq}",
                            gqa_case("K7", geom, 2, sq, 8192, [sq, 0], dtype, 130 + 10 * j)))
        else:
            out.append((f"K6 {name} decode",
                        gqa_case("K6", geom, 4, 1, 2048, [0, 1, 777, 2048], dtype, 60 + i)))
            out.append((f"K6 {name} 8-token prefill",
                        gqa_case("K6", geom, 2, 8, 2048, [8, 1500], dtype, 70 + i)))
            out.append((f"K7 {name} prefill",
                        gqa_case("K7", geom, 2, 2048, 2048, [2048, 0], dtype, 80 + i)))
    return out


def family_kernel_phase(flush):
    """K6 and K7 at the families' head geometries against their plain
    versions, then timed (bf16, amla) at the families phase's shapes:
    decode over the 8192-row cache after 16 steps, and the prefill of the
    1100-token prompt (bucket 2048; recurrentgemma: exact, 4500 tokens)."""
    log("== kernel phase: K6 and K7 at the MoE / hybrid / internlm2 head geometries ==")
    worst = hold_dense_cases(family_cases)
    bf, timed = torch.bfloat16, []
    for i, geom in enumerate(FAMILY_GEOMETRIES):
        name = geom[0]
        s = 8192 if name in ("qwen3-moe-30b-a3b", "recurrentgemma-2b") else 2048
        kv = [21, 316, 1116, 4516 if s == 8192 else 2048]
        timed.append(("K6", f"{name} decode", gqa_case("K6", geom, 4, 1, s, kv, bf, 90 + i)))
        sq = 4500 if geom[4] else 2048
        timed.append(("K7", f"{name} prefill {sq}", gqa_case("K7", geom, 1, sq, s, [sq], bf, 95 + i)))
    return worst, time_dense_rows(timed, flush)


# (name, Hq, Hkv, Dh, window, softcap) of the vision-language and
# encoder-decoder stacks
VLM_ENCDEC_GEOMETRIES = [
    ("qwen2-vl-7b", 28, 4, 128, None, None),
    ("seamless-m4t-medium", 16, 16, 64, None, None),
]
VISION_MAX_LEN, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN = 2048, 1024, 32, 256


def vlm_encdec_cases(dtype):
    """K6/K7 at the shapes the vlm / encdec phase gives them.  qwen2-vl-7b
    (G = 7 rows of Dh 128 per KV head): decode over the session's
    8192-row cache at kv_len 0, 1, 2047 and 4516 and over the vision
    cache's 2048 rows after the 1024-position prefill, the 5-token
    prompt's bucket of 8 through K6, K7 at the buckets 512, 2048 and 8192
    (kv_len = bucket) and the vision prefill (1024 positions over the
    2048-row cache).  seamless-m4t-medium (MHA 16 x 64): the encoder (K7
    non-causal over 1024 frames, a second request's kv_len short of them),
    the target prompt's self-attention (K7 causal, 32 tokens over the
    256-row cache) and cross-attention (K7 non-causal, 32 queries over
    1024 frames), and the decode step's self-attention (K6 over 256 rows)
    and cross-attention (K6, q_pos 1023: every frame visible)."""
    vl, sm = VLM_ENCDEC_GEOMETRIES
    f, p, m = ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN
    out = [
        ("K6 qwen2-vl-7b decode", gqa_case("K6", vl, 4, 1, 8192, [0, 1, 2047, 4516], dtype, 150)),
        ("K6 qwen2-vl-7b vision decode",
         gqa_case("K6", vl, 4, 1, VISION_MAX_LEN, [1025, 1030, 1035, 1040], dtype, 151)),
        ("K6 qwen2-vl-7b 8-token prefill", gqa_case("K6", vl, 2, 8, 8192, [8, 4999], dtype, 152)),
        ("K7 qwen2-vl-7b vision prefill 1024",
         gqa_case("K7", vl, 2, 1024, VISION_MAX_LEN, [1024, 0], dtype, 153)),
        ("K7 seamless encoder 1024 (non-causal)",
         gqa_case("K7", sm, 2, f, f, [f, 700], dtype, 160, causal=False)),
        ("K7 seamless cross prompt 32 (non-causal)",
         gqa_case("K7", sm, 2, p, f, [f, f], dtype, 161, causal=False)),
        ("K7 seamless self prompt 32", gqa_case("K7", sm, 2, p, m, [p, 0], dtype, 162)),
        ("K6 seamless self decode", gqa_case("K6", sm, 4, 1, m, [33, 40, 48, 1], dtype, 163)),
        ("K6 seamless cross decode", gqa_case("K6", sm, 4, 1, f, [f] * 4, dtype, 164)),
    ]
    for j, sq in enumerate((512, 2048, 8192)):
        out.append((f"K7 qwen2-vl-7b prefill {sq}",
                    gqa_case("K7", vl, 2, sq, 8192, [sq, 0], dtype, 170 + j)))
    return out


def vlm_encdec_kernel_phase(flush):
    """K6 and K7 (and K3 after the split K6 calls) at the vlm and encdec
    shapes against their plain versions, then timed (bf16, amla) at the
    phase's own shapes: qwen2-vl-7b decode after 16 steps over the 8192-row
    cache, its 2048 bucket and its batch-4 vision prefill; seamless's
    encoder, its prompt's cross- and self-attention and its decode step's
    cross- and self-attention (batch 4)."""
    log("== kernel phase: K6 and K7 at the vision-language (qwen2-vl-7b, G 7 x 128) and "
        "encoder-decoder (seamless-m4t-medium, 16 x 64, non-causal over 1024 frames) shapes ==")
    worst = hold_dense_cases(vlm_encdec_cases)
    bf = torch.bfloat16
    vl, sm = VLM_ENCDEC_GEOMETRIES
    f, p, m = ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN
    timed = [
        ("K6", "qwen2-vl-7b decode", gqa_case("K6", vl, 4, 1, 8192, [21, 316, 1116, 4516], bf, 180)),
        ("K7", "qwen2-vl-7b prefill 2048", gqa_case("K7", vl, 1, 2048, 8192, [2048], bf, 181)),
        ("K7", "qwen2-vl-7b vision prefill 1024",
         gqa_case("K7", vl, 4, 1024, VISION_MAX_LEN, [1024] * 4, bf, 182)),
        ("K7", "seamless encoder 1024", gqa_case("K7", sm, 4, f, f, [f] * 4, bf, 183, causal=False)),
        ("K7", "seamless cross prompt 32", gqa_case("K7", sm, 4, p, f, [f] * 4, bf, 184, causal=False)),
        ("K7", "seamless self prompt 32", gqa_case("K7", sm, 4, p, m, [p] * 4, bf, 185)),
        ("K6", "seamless cross decode", gqa_case("K6", sm, 4, 1, f, [f] * 4, bf, 186)),
        ("K6", "seamless self decode", gqa_case("K6", sm, 4, 1, m, [p + 16] * 4, bf, 187)),
    ]
    return worst, time_dense_rows(timed, flush)


# --------------------------------------------------------------------------- #
# third-slice kernel phase: K2-int8, K2′ (+ the hetero K3), K5
# --------------------------------------------------------------------------- #


def int8_case(seed, kv_lens, g, dtype, num_splits, q_pos_fn):
    """``make_case`` with the pool quantized by the cache's own write path
    (symmetric per-row int8 + fp32 scales)."""
    from repro_torch.runtime.kv_cache import _quantize_rows

    case = make_case(seed, kv_lens, g, torch.float32, num_splits, q_pos_fn)
    case["pages"], case["scales"] = _quantize_rows(case["pages"])
    case["q"] = case["q"].to(dtype)
    return case


def family_case(seed, pool_dtype, dtype, steps=16):
    """The int8 serve phase's decode batch after ``steps`` steps, on the
    card: a 1100-row prefix forked three times (suffixes 7, 40, 300), every
    family member ``steps`` rows longer, a 513-row loner (+ ``steps``).
    The family shares 2 complete 512-row blocks: one group of 4."""
    from repro_torch.kernels import decode_schedule as sched
    from repro_torch.runtime.kv_cache import PagedKVCache

    gen = torch.Generator("cuda").manual_seed(seed)
    rows = lambda n: torch.randn((n, DK), generator=gen, device="cuda")
    kv = PagedKVCache(num_pages=48, page_size=PAGE, width=DK, dtype=pool_dtype, device="cuda")
    kv.alloc(0)
    kv.append(0, rows(1100))
    for rid, n in ((1, 7), (2, 40), (3, 300)):
        kv.fork(0, rid)
        kv.append(rid, rows(n))
    kv.alloc(4)
    kv.append(4, rows(513))
    for rid in range(5):
        kv.append(rid, rows(steps))
    rids = list(range(5))
    bt, kv_len = kv.block_table(rids, width=kv.num_pages)
    ps = sched.build_prefix_schedule(kv_len, bt, page_size=PAGE, block_k=BLOCK_K, num_splits=2)
    if ps.num_groups != 1 or ps.groups.gmax != 4:
        raise SystemExit(f"family case: expected one group of 4, got {ps.groups}")
    q = torch.randn((5, 128, DK), generator=gen, device="cuda").to(dtype)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")
    pos = np.repeat((kv_len - 1)[:, None], 128, 1).astype(np.int32)
    g = ps.groups
    return dict(kv=kv, q=q, bt=dev(bt), kv_host=kv_len, kv_len=dev(kv_len), q_pos=dev(pos), ps=ps,
                member=dev(g.group_member), rep=dev(g.group_rep), prefix_lens=dev(ps.prefix_lens),
                pitems=[dev(a) for a in ps.prefix.prefetch_arrays()],
                sitems=[dev(a) for a in ps.suffix.prefetch_arrays()],
                hetero=[dev(a) for a in ps.hetero_dest_tables()])


def run_group_prefix(fc, variant, plain):
    """K2′ (or its plain version) over the family's shared blocks."""
    from repro_torch.kernels import mla_decode_paged as mp

    kw = dict(d_v=DV, variant=variant, scale=1.0 / math.sqrt(192), block_k=BLOCK_K,
              num_dest_slots=fc["ps"].prefix.num_dest_slots, softcap=None)
    args = (fc["q"], fc["kv"].pages, fc["bt"], fc["q_pos"], fc["member"], fc["rep"],
            fc["prefix_lens"])
    if plain:
        return mp._group_prefix_plain(*args, fc["pitems"], fc["kv"].scales, **kw)
    return mp.mla_decode_paged_group_prefix(*args, *fc["pitems"], fc["kv"].scales, **kw)


def run_suffix(fc, variant, plain):
    """The suffix pass of the same step: K2 (K2-int8 on an int8 pool)."""
    case = dict(q=fc["q"], pages=fc["kv"].pages, bt=fc["bt"], kv=fc["kv_len"],
                q_pos=fc["q_pos"], items=fc["sitems"], sched=fc["ps"].suffix,
                scales=fc["kv"].scales)
    return run_k2(case, variant, plain)


def run_k5(case, variant, plain):
    from repro_torch.kernels import mla_decode_paged as mp

    fn = mp._padded_rows_plain if plain else mp.mla_decode_paged_rows
    return fn(case["q"], case["pages"], case["bt"], case["kv"], case["q_pos"], d_v=DV,
              variant=variant, scale=1.0 / math.sqrt(192), softcap=None)


def padded_case(seed, kv_lens, dtype, width):
    case = make_case(seed, kv_lens, 128, dtype, 1, decode_positions)
    case["bt"] = torch.nn.functional.pad(case["bt"], (0, width - case["bt"].shape[1]))
    return case


def sdpa_rows(q, c, lens):
    """One scaled_dot_product_attention call over contiguous ``c (B, S,
    Dk)`` (``lens`` rows live per request, all visible to every row): the
    library yardstick, timed only."""
    kpos = torch.arange(c.shape[1], device="cuda")
    mask = kpos[None, None, None, :] < torch.as_tensor(lens, device="cuda")[:, None, None, None]
    f = torch.nn.functional.scaled_dot_product_attention
    qq, k, v = q[:, None], c[:, None], c[:, None, :, :DV]
    return lambda: f(qq, k, v, attn_mask=mask, scale=1.0 / math.sqrt(192))


def dequant_rows(kv, rid, lo, hi, dtype):
    """Rows [lo, hi) of ``rid`` dequantized to ``dtype`` (contiguous)."""
    c = kv.gather_contiguous(rid)[lo:hi]
    return c.to(dtype)


def slice3_kernel_phase(flush):
    """Hold K2-int8, K2′ (+ the hetero combine) and K5 against their plain
    versions on the card, hold prefix sharing against the unshared queue,
    then time them at the serve phases' shapes."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.kernels import ops

    log("== kernel phase: K2-int8 (int8 pages), K2' (shared-prefix groups) + K3-hetero, "
        "K5 (padded grid) vs their plain PyTorch versions ==")
    worst = {}

    def note(key, err, tol, what):
        worst[key] = max(worst.get(key, 0.0), err)
        log(f"  {what}: max |kernel - plain| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise SystemExit(f"slice-3 kernel phase: {what} exceeds tol {tol}")

    for dtype in (torch.bfloat16, torch.float32):
        for variant in ("amla", "base"):
            tol = TOL[dtype, variant]
            tag = f"{str(dtype)[6:]} {variant}"
            # K2-int8 (+ K3): decode and prefill-chunk shapes, kv_len 0; the
            # two-split 4096-row chunk is the serve phase's 32-row-tile shape
            for name, lens, g, pos_fn, ns in (
                ("decode", [0, 1, 200, 513, 1116, 4096], 128, decode_positions, 2),
                ("prefill", [1100], 4096, prefill_positions, 1),
                ("prefill", [4096], 4096, prefill_positions, 2),
            ):
                case = int8_case(7, lens, g, dtype, ns, pos_fn)
                n_mma = mp.mla_decode_paged_queue_rows.mma_launches
                o_k, lse_k = run_k2(case, variant, plain=False)
                mma = mp.mla_decode_paged_queue_rows.mma_launches - n_mma
                if mma != int(dtype == torch.bfloat16):
                    raise SystemExit(f"K2-int8 {name} {dtype}: {mma} tensor-core launches, "
                                     f"expected {int(dtype == torch.bfloat16)}")
                o_p, lse_p = run_k2(case, variant, plain=True)
                out_k = run_k3(case, o_k, lse_k, plain=False)
                out_p = run_k3(case, o_p, lse_p, plain=True)
                torch.cuda.synchronize()
                live = sorted(set(case["sched"].item_dest[case["sched"].item_valid == 1].tolist()))
                fin = torch.isfinite(lse_p[live])
                if not torch.equal(fin, torch.isfinite(lse_k[live])):
                    raise SystemExit(f"K2-int8 {name}: empty-row lse pattern differs")
                err = max((o_k[live] - o_p[live]).abs().max().item(),
                          (lse_k[live][fin] - lse_p[live][fin]).abs().max().item(),
                          (out_k - out_p).abs().max().item())
                zero = [i for i, l in enumerate(lens) if l == 0]
                if zero and out_k[zero].abs().max().item() != 0.0:
                    raise SystemExit("K2-int8: kv_len == 0 rows are not exact zeros")
                note(("K2-int8", dtype, variant), err, tol,
                     f"K2-int8 {name} G={g} kv={lens} {tag}"
                     f"{', tensor-core body' if mma else ''}")
            # K2' + the suffix pass + K3-hetero, bf16 and int8 pools; bf16 q
            # runs the tensor-core body in both passes over either pool
            for pool in (torch.bfloat16, torch.int8):
                fc = family_case(8, pool, dtype)
                mma = dtype == torch.bfloat16
                n_mma = (mp.mla_decode_paged_group_prefix.mma_launches,
                         mp.mla_decode_paged_queue_rows.mma_launches)
                o_k, lse_k = run_group_prefix(fc, variant, plain=False)
                o_p, lse_p = run_group_prefix(fc, variant, plain=True)
                so_k, slse_k = run_suffix(fc, variant, plain=False)
                got = (mp.mla_decode_paged_group_prefix.mma_launches - n_mma[0],
                       mp.mla_decode_paged_queue_rows.mma_launches - n_mma[1])
                if got != (int(mma), int(mma)):
                    raise SystemExit(f"K2' {str(pool)[6:]} pool, q {dtype}: tensor-core launches "
                                     f"(K2', suffix K2) {got}, expected {(int(mma),) * 2}")
                so_p, slse_p = run_suffix(fc, variant, plain=True)
                out_k = mc.combine_hetero_partials([so_k, o_k], [slse_k, lse_k], *fc["hetero"])
                out_p = mc._combine_plain(torch.cat([so_p, o_p]), torch.cat([slse_p, lse_p]),
                                          *fc["hetero"])
                torch.cuda.synchronize()
                err = max((o_k - o_p).abs().max().item(), (lse_k - lse_p).abs().max().item(),
                          (out_k - out_p).abs().max().item())
                if not torch.isfinite(out_k).all():
                    raise SystemExit("K2' + K3-hetero: non-finite output")
                note(("K2'" if pool == torch.bfloat16 else "K2' int8", dtype, variant), err,
                     2e-3 if dtype == torch.float32 else tol,
                     f"K2' + K3-hetero {str(pool)[6:]} pool, group of 4 (G=512 stacked), {tag}"
                     f"{', tensor-core body' if mma else ''}")
                # prefix sharing against the unshared queue, through ops
                args = (fc["q"][:, None], fc["kv"].pages, fc["bt"], fc["kv_host"])
                kw = dict(kv_scales=fc["kv"].scales, d_v=DV, variant=variant,
                          scale=1.0 / math.sqrt(192), compute_dtype=dtype)
                # two splits split these requests where the prefix ends, so
                # the unshared call takes one: a different partition
                shared = ops.mla_decode_paged(*args, prefix_sharing=True, num_splits=2, **kw)
                unshared = ops.mla_decode_paged(*args, num_splits=1, **kw)
                err = (shared - unshared).abs().max().item()
                note(("shared-vs-unshared", dtype, variant), err,
                     2e-3 if dtype == torch.float32 else tol,
                     f"prefix_sharing=True vs unshared on the card, {str(pool)[6:]} pool, {tag}")
                del fc
            # K5: ragged, kv_len 0, a fragmented 24-column table
            case = padded_case(9, [0, 37, 300, 513, 1100], dtype, 24)
            n_mma = mp.mla_decode_paged_rows.mma_launches
            got, want = run_k5(case, variant, plain=False), run_k5(case, variant, plain=True)
            mma = mp.mla_decode_paged_rows.mma_launches - n_mma
            if mma != int(dtype == torch.bfloat16):
                raise SystemExit(f"K5 {dtype}: {mma} tensor-core launches")
            torch.cuda.synchronize()
            if got[0].abs().max().item() != 0.0 or not torch.isfinite(got).all():
                raise SystemExit("K5: kv_len == 0 rows are not exact zeros, or non-finite")
            note(("K5", dtype, variant), (got - want).abs().max().item(), tol,
                 f"K5 decode kv={case['kv_host'].tolist()} W=24 {tag}"
                 f"{', tensor-core body' if mma else ''}")
            torch.cuda.empty_cache()

    # Timing, bf16 amla, at the serve phases' shapes.
    rows = {}
    bf = torch.bfloat16
    fc = family_case(10, torch.int8, bf)
    ps = fc["ps"]
    # K2-int8 at the int8 phase's suffix pass
    t = time_cuda(lambda: run_suffix(fc, "amla", plain=False), 20, flush)
    tp = time_cuda(lambda: run_suffix(fc, "amla", plain=True), 5, flush)
    start = ps.start_blocks * BLOCK_K
    lens = np.maximum(fc["kv_host"] - start, 0)
    b, by = bound(charged(lambda: run_suffix(fc, "amla", plain=False), QUEUE), bf)
    c = torch.stack([torch.nn.functional.pad(
        dequant_rows(fc["kv"], r, int(start[r]), int(fc["kv_host"][r]), bf),
        (0, 0, 0, int(lens.max()) - int(lens[r]))) for r in range(5)])
    tlib = time_cuda(sdpa_rows(fc["q"], c, lens), 20, flush)
    rows["K2-int8"] = (t, tp, b, by, tlib)
    log(f"  time K2-int8 int8 serve decode suffix pass (bf16, suffix rows {lens.tolist()}, "
        f"2 splits; tensor-core body): {t:.4f} ms (bound {b:.5f} ms by {by}, plain {tp:.4f} ms, SDPA on a "
        f"dequantized contiguous copy {tlib:.4f} ms)")
    # K2' at the same step's prefix pass
    t = time_cuda(lambda: run_group_prefix(fc, "amla", plain=False), 20, flush)
    tp = time_cuda(lambda: run_group_prefix(fc, "amla", plain=True), 5, flush)
    plen = int(ps.prefix_lens[0])
    qg = fc["q"][ps.groups.group_member[0]].reshape(1, 4 * 128, DK)
    b, by = bound(charged(lambda: run_group_prefix(fc, "amla", plain=False), GROUP), bf)
    c = dequant_rows(fc["kv"], 0, 0, plen, bf)[None]
    tlib = time_cuda(sdpa_rows(qg, c, [plen]), 20, flush)
    rows["K2' int8"] = (t, tp, b, by, tlib)
    log(f"  time K2' int8 serve decode prefix pass (bf16, 1 group of 4 = 512 stacked rows, "
        f"{plen} shared rows; tensor-core body): {t:.4f} ms (bound {b:.5f} ms by {by}, plain {tp:.4f} ms, SDPA "
        f"on a dequantized contiguous copy {tlib:.4f} ms)")
    del fc, c
    # K2' at the same group shape over a bf16 pool (the tensor-core body)
    fc = family_case(10, torch.bfloat16, bf)
    plen = int(fc["ps"].prefix_lens[0])
    t = time_cuda(lambda: run_group_prefix(fc, "amla", plain=False), 20, flush)
    tp = time_cuda(lambda: run_group_prefix(fc, "amla", plain=True), 5, flush)
    qg = fc["q"][fc["ps"].groups.group_member[0]].reshape(1, 4 * 128, DK)
    b, by = bound(charged(lambda: run_group_prefix(fc, "amla", plain=False), GROUP), bf)
    c = dequant_rows(fc["kv"], 0, 0, plen, bf)[None]
    tlib = time_cuda(sdpa_rows(qg, c, [plen]), 20, flush)
    rows["K2'"] = (t, tp, b, by, tlib)
    log(f"  time K2' over a bf16 pool, the same group (bf16, 512 stacked rows, {plen} shared "
        f"rows; tensor-core body): {t:.4f} ms (bound {b:.5f} ms by {by}, plain {tp:.4f} ms, "
        f"SDPA on a contiguous copy {tlib:.4f} ms)")
    del fc, c
    # K2-int8 at PR 12's K2 decode shape, beside K2 on the same bf16 rows
    case = int8_case(11, [37 + 16, 300 + 16, 513 + 16, 1100 + 16], 128, bf, 2,
                     lambda l, g: np.full((g,), l - 1))
    t = time_cuda(lambda: run_k2(case, "amla", plain=False), 20, flush)
    b, by = k2_bound(case)
    rows["K2-int8 at the K2 decode shape"] = (t, None, b, by, None)
    log(f"  time K2-int8 at the K2 decode shape (bf16, kv={case['kv_host'].tolist()}, 2 "
        f"splits; tensor-core body): {t:.4f} ms (bound {b:.5f} ms by {by})")
    # K5 at the padded phase's shape
    case = padded_case(12, [37 + 16, 300 + 16, 513 + 16, 1100 + 16], bf, 24)
    case["q_pos"] = torch.as_tensor(np.repeat((case["kv_host"] - 1)[:, None], 128, 1),
                                    dtype=torch.int32, device="cuda")
    case["q_pos_host"] = np.repeat((case["kv_host"] - 1)[:, None], 128, 1)
    t = time_cuda(lambda: run_k5(case, "amla", plain=False), 20, flush)
    tp = time_cuda(lambda: run_k5(case, "amla", plain=True), 5, flush)
    b, by = bound(charged(lambda: run_k5(case, "amla", plain=False), "mla_decode_paged_rows"), bf)
    tlib = time_cuda(sdpa_call(case), 20, flush)
    rows["K5"] = (t, tp, b, by, tlib)
    log(f"  time K5 padded decode (bf16, kv={case['kv_host'].tolist()}, W=24): {t:.4f} ms "
        f"(bound {b:.5f} ms by {by}, plain {tp:.4f} ms, SDPA on a contiguous copy "
        f"{tlib:.4f} ms)")
    for key in sorted({k[0] for k in worst}):
        log(f"  max |kernel - plain| {key}: {max(v for k, v in worst.items() if k[0] == key):.3e}")
    return worst, rows


# --------------------------------------------------------------------------- #
# tenth-slice kernel phase: nested prefix groups and the verify shape
# --------------------------------------------------------------------------- #


def nested_family_case(seed, pool_dtype, dtype, steps=16):
    """The trie serve phase's decode batch after ``steps`` steps, on the
    card: a 1024-row system prompt S shared by four requests, S + 512 rows
    T1 shared by A and B, S + another 512 rows T2 shared by C and D
    (suffixes 37, 300, 40, 7), a 513-row loner, each ``steps`` rows longer.
    Nested grouping gives three groups, [0, 2) of 4 and [2, 3) of 2 twice,
    so A-D each merge two prefix partials: the hetero table is num_splits
    + 2 = 4 wide."""
    from repro_torch.kernels import decode_schedule as sched
    from repro_torch.runtime.kv_cache import PagedKVCache

    gen = torch.Generator("cuda").manual_seed(seed)
    rows = lambda n: torch.randn((n, DK), generator=gen, device="cuda")
    kv = PagedKVCache(num_pages=48, page_size=PAGE, width=DK, dtype=pool_dtype, device="cuda")
    kv.alloc(0)
    kv.append(0, rows(1024))
    kv.fork(0, 2)
    kv.append(0, rows(512))
    kv.append(2, rows(512))
    kv.fork(0, 1)
    kv.fork(2, 3)
    for rid, n in ((0, 37), (1, 300), (2, 40), (3, 7)):
        kv.append(rid, rows(n))
    kv.alloc(4)
    kv.append(4, rows(513))
    for rid in range(5):
        kv.append(rid, rows(steps))
    bt, kv_len = kv.block_table(list(range(5)), width=kv.num_pages)
    ps = sched.build_prefix_schedule(kv_len, bt, page_size=PAGE, block_k=BLOCK_K, num_splits=2,
                                     nested=True)
    g = ps.groups
    spans = sorted((int(a), int(b), int(n)) for a, b, n in
                   zip(g.group_start, g.shared_blocks, g.group_size))
    dest, n_live = ps.hetero_dest_tables()
    if spans != [(0, 2, 4), (2, 3, 2), (2, 3, 2)] or dest.shape != (5, 4):
        raise SystemExit(f"nested family: expected groups [0,2)x4, [2,3)x2 twice and a 4-wide "
                         f"hetero table, got {spans}, {dest.shape}")
    q = torch.randn((5, 128, DK), generator=gen, device="cuda").to(dtype)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")
    pos = np.repeat((kv_len - 1)[:, None], 128, 1).astype(np.int32)
    return dict(kv=kv, q=q, bt=dev(bt), kv_host=kv_len, kv_len=dev(kv_len), q_pos=dev(pos), ps=ps,
                member=dev(g.group_member), rep=dev(g.group_rep), prefix_lens=dev(ps.prefix_lens),
                pitems=[dev(a) for a in ps.prefix.prefetch_arrays()],
                sitems=[dev(a) for a in ps.suffix.prefetch_arrays()],
                hetero=[dev(dest), dev(n_live)])


def verify_case(seed, dtype):
    """K2 at the speculation phase's verify shape: the paged phase's four
    requests after 16 steps with 4 draft rows appended, S = 4 token rows x
    128 heads each (G = 512) at explicit positions kv_len - 4 + row // 128,
    two splits."""
    return make_case(seed, [37 + 16 + 4, 300 + 16 + 4, 513 + 16 + 4, 1100 + 16 + 4], 4 * 128,
                     dtype, 2, prefill_positions)


def nested_group_rows(fc, dtype):
    """One SDPA yardstick call for K2' over the nested groups: each group's
    stacked member queries over its own window's rows, padded to the
    longest window and masked."""
    ps, g = fc["ps"], fc["ps"].groups
    gmax = g.gmax
    qs, cs, lens = [], [], []
    for i in range(g.num_groups):
        members = [int(m) for m in g.group_member[i] if m >= 0]
        q = fc["q"][members].reshape(len(members) * 128, DK)
        qs.append(torch.nn.functional.pad(q, (0, 0, 0, gmax * 128 - q.shape[0])))
        lo, hi = int(g.group_start[i]) * BLOCK_K, int(g.shared_blocks[i]) * BLOCK_K
        cs.append(dequant_rows(fc["kv"], int(g.group_rep[i]), lo, hi, dtype))
        lens.append(hi - lo)
    width = max(lens)
    c = torch.stack([torch.nn.functional.pad(x, (0, 0, 0, width - x.shape[0])) for x in cs])
    return torch.stack(qs), c, lens


def trie_kernel_phase(flush):
    """Hold K2' over nested group windows (past block 0), the suffix pass
    and the hetero K3 at chains of 2 against their plain versions, over
    bf16 and int8 pools, amla and base, bf16 and fp32 queries; then K2 at
    the verify shape (S = 4 rows per request at explicit positions), and
    the fused verify call through ``ops`` against its positions' ramp and
    its single-row calls.  Then time K2' nested, K3 at chain 2 and K2 at
    S = 4 beside their bounds, plain versions and one SDPA call."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.kernels import ops

    log("== kernel phase: K2' over nested groups + K3 at chains of 2, and K2 at the verify "
        "shape (S = 4 rows), vs their plain PyTorch versions ==")
    worst, rows = {}, {}

    def note(key, err, tol, what):
        worst[key] = max(worst.get(key, 0.0), err)
        log(f"  {what}: max |kernel - plain| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise SystemExit(f"tenth-slice kernel phase: {what} exceeds tol {tol}")

    for dtype in (torch.bfloat16, torch.float32):
        for variant in ("amla", "base"):
            tol = TOL[dtype, variant] if dtype == torch.bfloat16 else 2e-3
            tag = f"{str(dtype)[6:]} {variant}"
            for pool in (torch.bfloat16, torch.int8):
                fc = nested_family_case(18, pool, dtype)
                mma = dtype == torch.bfloat16
                n_mma = (mp.mla_decode_paged_group_prefix.mma_launches,
                         mp.mla_decode_paged_queue_rows.mma_launches)
                o_k, lse_k = run_group_prefix(fc, variant, plain=False)
                so_k, slse_k = run_suffix(fc, variant, plain=False)
                got = (mp.mla_decode_paged_group_prefix.mma_launches - n_mma[0],
                       mp.mla_decode_paged_queue_rows.mma_launches - n_mma[1])
                if got != (int(mma), int(mma)):
                    raise SystemExit(f"nested K2' {str(pool)[6:]} pool, q {dtype}: tensor-core "
                                     f"launches (K2', suffix K2) {got}, expected "
                                     f"{(int(mma),) * 2}")
                o_p, lse_p = run_group_prefix(fc, variant, plain=True)
                so_p, slse_p = run_suffix(fc, variant, plain=True)
                n3 = mc.combine_split_partials.launches
                out_k = mc.combine_hetero_partials([so_k, o_k], [slse_k, lse_k], *fc["hetero"])
                n3 = mc.combine_split_partials.launches - n3
                out_p = mc._combine_plain(torch.cat([so_p, o_p]), torch.cat([slse_p, lse_p]),
                                          *fc["hetero"])
                out_k3 = mc.combine_hetero_partials([so_p, o_p], [slse_p, lse_p], *fc["hetero"])
                torch.cuda.synchronize()
                live = torch.isfinite(lse_p)
                if not torch.equal(live, torch.isfinite(lse_k)) or n3 != 1:
                    raise SystemExit(f"nested K2': empty-row lse pattern differs, or {n3} K3 "
                                     "launches")
                err = max((o_k - o_p).abs().max().item(),
                          (lse_k[live] - lse_p[live]).abs().max().item(),
                          (out_k - out_p).abs().max().item())
                if not torch.isfinite(out_k).all():
                    raise SystemExit("nested K2' + K3-hetero: non-finite output")
                note(("K2' nested", dtype, variant), err, tol,
                     f"nested K2' (3 groups, windows [0,2) and [2,3)) + suffix K2 + K3 at "
                     f"chains of 2, {str(pool)[6:]} pool, {tag}"
                     f"{', tensor-core body' if mma else ''}")
                note(("K3 chain 2", dtype, variant), (out_k3 - out_p).abs().max().item(), K3_TOL,
                     f"K3 alone at chains of 2 (4-wide table) on the plain partials, {tag}")
                # the nested schedule through ops against the unshared queue
                args = (fc["q"][:, None], fc["kv"].pages, fc["bt"], fc["kv_host"])
                kw = dict(kv_scales=fc["kv"].scales, d_v=DV, variant=variant,
                          scale=1.0 / math.sqrt(192), compute_dtype=dtype)
                shared = ops.mla_decode_paged(*args, schedule=fc["ps"], **kw)
                unshared = ops.mla_decode_paged(*args, num_splits=1, **kw)
                note(("nested-vs-unshared", dtype, variant),
                     (shared - unshared).abs().max().item(), tol,
                     f"nested schedule vs unshared through ops, {str(pool)[6:]} pool, {tag}")
                del fc
            case = verify_case(19, dtype)
            hold_k2_k3(case, "verify", dtype, variant, worst)
            # the fused verify call through ops: explicit positions equal to
            # the ramp give the ramp's result bit for bit; each token row
            # equals its single-row call at kv_len = position + 1
            b = case["q"].shape[0]
            q4 = case["q"].reshape(b, 4, 128, DK)
            pos = torch.as_tensor(case["kv_host"][:, None] - 4 + np.arange(4)[None],
                                  dtype=torch.int32)
            kw = dict(d_v=DV, variant=variant, scale=1.0 / math.sqrt(192), block_k=BLOCK_K,
                      num_splits=2, compute_dtype=dtype)
            fused = ops.mla_decode_paged(q4, case["pages"], case["bt"], case["kv_host"],
                                         q_positions=pos.numpy(), **kw)
            ramp = ops.mla_decode_paged(q4, case["pages"], case["bt"], case["kv_host"], **kw)
            err = 0.0
            for j in range(4):
                one = ops.mla_decode_paged(q4[:, j : j + 1].contiguous(), case["pages"],
                                           case["bt"], pos[:, j].numpy() + 1, **kw)
                err = max(err, (one[:, 0] - fused[:, j]).abs().max().item())
            torch.cuda.synchronize()
            if not torch.equal(fused, ramp):
                raise SystemExit("verify: explicit q_positions differ from the derived ramp")
            note(("verify-vs-single", dtype, variant), err, tol,
                 f"fused 4-row verify vs 4 single-row calls through ops, {tag}")
            torch.cuda.empty_cache()

    bf = torch.bfloat16
    fc = nested_family_case(20, bf, bf)
    t = time_cuda(lambda: run_group_prefix(fc, "amla", plain=False), 20, flush)
    tp = time_cuda(lambda: run_group_prefix(fc, "amla", plain=True), 5, flush)
    qg, c, lens = nested_group_rows(fc, bf)
    b, by = bound(charged(lambda: run_group_prefix(fc, "amla", plain=False), GROUP), bf)
    tlib = time_cuda(sdpa_rows(qg, c, lens), 20, flush)
    rows["K2' nested"] = (t, tp, b, by, tlib)
    log(f"  time K2' over nested groups (bf16, 3 groups of 4/2/2 x 128 stacked rows, windows "
        f"{lens} rows; tensor-core body): {t:.4f} ms (bound {b:.5f} ms by {by}, plain "
        f"{tp:.4f} ms, SDPA on the windows' contiguous rows {tlib:.4f} ms)")
    so, slse = run_suffix(fc, "amla", plain=False)
    o, lse = run_group_prefix(fc, "amla", plain=False)
    merge = lambda: mc.combine_hetero_partials([so, o], [slse, lse], *fc["hetero"])
    plain = lambda: mc._combine_plain(torch.cat([so, o]), torch.cat([slse, lse]), *fc["hetero"])
    t, tp = time_cuda(merge, 50, flush), time_cuda(plain, 20, flush)
    b, by = bound(charged(merge, COMBINE), torch.float32)
    rows["K3 chain 2"] = (t, tp, b, by, None)
    log(f"  time K3 hetero at chains of 2 (B=5, G=128, table 4 wide, splits "
        f"{fc['hetero'][1].tolist()}): {t:.4f} ms (bound {b:.5f} ms by {by}, plain {tp:.4f} ms)")
    del fc, c, qg
    case = verify_case(21, bf)
    t = time_cuda(lambda: run_k2(case, "amla", plain=False), 20, flush)
    tp = time_cuda(lambda: run_k2(case, "amla", plain=True), 5, flush)
    tlib = time_cuda(sdpa_call(case), 20, flush)
    b, by = k2_bound(case)
    rows["K2 verify"] = (t, tp, b, by, tlib)
    log(f"  time K2 at the verify shape (bf16, S = 4 x 128 rows, kv={case['kv_host'].tolist()}, "
        f"2 splits; tensor-core body): {t:.4f} ms (bound {b:.5f} ms by {by}, plain {tp:.4f} ms, "
        f"SDPA on a contiguous copy {tlib:.4f} ms)")
    for key in sorted({k[0] for k in worst}):
        log(f"  max |kernel - plain| {key}: {max(v for k, v in worst.items() if k[0] == key):.3e}")
    return worst, rows


# --------------------------------------------------------------------------- #
# K3 phase: the split-KV combine at the shapes of its three uses
# --------------------------------------------------------------------------- #

# K3 against its plain version on the same fp32 partials: only expf ulps and
# the kernel's fused multiply-adds differ.
K3_TOL = 1e-5


def k3_inputs_of(fn):
    """K3's inputs ``(o_part, lse, dest_table, n_splits)`` as a producer
    hands them over: ``fn`` runs with the combine replaced by a recorder,
    which launches nothing and returns zeros."""
    from repro_torch.kernels import mla_decode_combine as mc

    real, got = mc.combine_split_partials, []

    def record(o_part, lse, dest_table, n_splits):
        got.append((o_part, lse, dest_table, n_splits))
        return torch.zeros((dest_table.shape[0],) + tuple(o_part.shape[1:]), device=o_part.device)

    mc.combine_split_partials = record
    try:
        fn()
    finally:
        mc.combine_split_partials = real
    return got[-1]


def k3_cases():
    """K3's inputs at the shapes of its uses, bf16 amla producers: (a) K2's
    partials at the paged serve phase's decode step (4 requests after 16
    steps, 2 splits) and (b) at its prefill chunk (G = 32 tokens x 128
    heads, 4096 keys, 2 splits); (c) the bf16 shared-prefix step's suffix
    slots (K2) and prefix member rows (K2'), merged from two sources; (d)-(f)
    K6's splits at the dense kernel phase's decode case of each GQA head
    geometry (B 4 x Hkv columns)."""
    bf = torch.bfloat16
    last = lambda l, g: np.full((g,), l - 1)
    for shape, case in (
        ("(a) paged decode", make_case(11, [37 + 16, 300 + 16, 513 + 16, 1100 + 16], 128, bf, 2, last)),
        ("(b) prefill chunk", make_case(12, [4096], 4096, bf, 2, prefill_positions)),
    ):
        o, lse = run_k2(case, "amla", plain=False)
        yield shape, [o], [lse], case["dest"], case["n_splits"]
    fc = family_case(10, bf, bf)
    so, slse = run_suffix(fc, "amla", plain=False)
    o, lse = run_group_prefix(fc, "amla", plain=False)
    yield "(c) hetero merge", [so, o], [slse, lse], *fc["hetero"]
    for i, geom in enumerate(GQA_GEOMETRIES):
        gemma = geom[4] is not None
        kv = [0, 305, 1116, 4516] if gemma else [0, 1, 777, 2048]
        case = gqa_case("K6", geom, 4, 1, 8192 if gemma else 2048, kv, bf, 10 + i)
        o, lse, dest, n_splits = k3_inputs_of(lambda: run_gqa(case, "amla", plain=False))
        yield f"({'def'[i]}) K6 {geom[0]}", [o], [lse], dest, n_splits


def kernel_device_ms(fn, kernel, flush, iters=30):
    """Mean device duration (ms) of the kernels named ``kernel`` over
    ``iters`` calls of ``fn``, L2 flushed before each, from torch.profiler:
    the kernel's own time, without the launch that CUDA events count."""
    for _ in range(3):  # a trace now and then comes back without the kernel's events
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.add_(1)
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in found)
        if count:
            return sum(e.device_time_total for e in found) / count / 1e3
    return float("nan")


def k3_phase(flush):
    """Hold K3 against its plain version at the shapes of its three uses and
    time it there, as the path calls it (``combine_hetero_partials`` for
    the two-source merge); returns ({shape: (ms, plain ms, bound ms, bound
    by, kernel ms)}, worst error), ms by CUDA events as every kernel's,
    kernel ms the profiler's duration of the combine kernel alone.  Rows
    with no live split must be exact zeros."""
    from repro_torch.kernels import mla_decode_combine as mc

    log("== K3 phase: the split-KV combine at the shapes of its three uses, vs its plain "
        "version ==")
    floor = time_cuda(lambda: torch.cuda._sleep(0), 50, flush)
    log(f"  event floor: a trivial kernel (torch.cuda._sleep(0)) timed the same way, "
        f"{floor:.4f} ms")
    rows, worst = {}, 0.0
    for shape, o_parts, lse_parts, dest, n_splits in k3_cases():
        if len(o_parts) > 1:
            merge = lambda: mc.combine_hetero_partials(o_parts, lse_parts, dest, n_splits)
        else:
            merge = lambda: mc.combine_split_partials(o_parts[0], lse_parts[0], dest, n_splits)
        plain = lambda: mc._combine_plain(torch.cat(o_parts), torch.cat(lse_parts), dest, n_splits)
        n0 = mc.combine_split_partials.launches
        got = merge()
        launches = mc.combine_split_partials.launches - n0
        want = plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        zero = (want == 0).all(-1)
        if launches != 1:
            raise SystemExit(f"K3 {shape}: {launches} combine launches, expected 1")
        if zero.any() and got[zero].abs().max().item() != 0.0:
            raise SystemExit(f"K3 {shape}: rows with no live split are not exact zeros")
        if not torch.isfinite(got).all() or not err <= K3_TOL:
            raise SystemExit(f"K3 {shape}: max |kernel - plain| {err:.3e} (tol {K3_TOL:g}) "
                             f"or non-finite output")
        worst = max(worst, err)
        t = time_cuda(merge, 50, flush)
        tk = kernel_device_ms(merge, "combine_kernel", flush)
        tp = time_cuda(plain, 20, flush)
        b, by = bound(charged(merge, COMBINE), torch.float32)
        g, d_v = o_parts[0].shape[1:]
        log(f"  time K3 {shape} (B={dest.shape[0]}, G={g}, Dv={d_v}, splits "
            f"{sorted(set(n_splits.tolist()))} of {dest.shape[1]}, sources "
            f"{[x.shape[0] for x in o_parts]}, {int(zero.sum())} zero rows): {t:.4f} ms, "
            f"kernel alone {tk:.4f} ms (bound {b:.5f} ms by {by}, plain {tp:.4f} ms); "
            f"max |kernel - plain| {err:.3e} (tol {K3_TOL:g})")
        rows[shape] = (t, tp, b, by, tk)
        if dest.shape[0] == 1 and int(n_splits[0]) == 2:  # the prefill chunk
            # the same bytes without the merge: one elementwise add of the two
            # partial arrays into an output of the same shape
            o0, o1 = (o_parts[0][int(i)] for i in dest[0, :2])
            sink = torch.empty_like(o0)
            ty = time_cuda(lambda: torch.add(o0, o1, out=sink), 50, flush)
            log(f"    yardstick: torch.add of its two partial arrays (the same bytes, no "
                f"merge) {ty:.4f} ms")
    return rows, worst


# --------------------------------------------------------------------------- #
# sixth-slice kernel phase: K4 and K5 on the tensor-core row body
# --------------------------------------------------------------------------- #


def fragmented_case(seed, kv_lens, g, page, extra=3):
    """K5's inputs on the card: bf16 queries and pool, a fragmented (B, W)
    table whose entries past each request's last page point anywhere in the
    pool, decode positions."""
    rng = np.random.default_rng(seed)
    w = max(1, max(-(-n // page) for n in kv_lens)) + extra
    num_pages = len(kv_lens) * w + 5
    bt = rng.permutation(num_pages)[: len(kv_lens) * w].reshape(len(kv_lens), w)
    for r, n in enumerate(kv_lens):
        used = -(-n // page)
        bt[r, used:] = rng.integers(0, num_pages, size=w - used)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")
    pos = np.stack([decode_positions(n, g) for n in kv_lens])
    return (randn((len(kv_lens), g, DK), seed, torch.bfloat16),
            randn((num_pages, page, DK), seed + 1, torch.bfloat16), dev(bt), dev(kv_lens), dev(pos))


def mma_rows_kernel_phase():
    """Hold K4 and K5 on the tensor-core body (bf16 q over bf16 rows)
    against their plain versions: ragged kv_len (0, either side of a
    16-key chunk, a 128-key strip and a 512-row block, 1116) at G of 1, 17
    and 128; K4 over a batch slice of a larger cache, K5 at pages of 16, 64,
    128 and 512 rows.  Every call must count one tensor-core launch."""
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import mla_decode_paged as mp

    log("== kernel phase: K4 and K5 on the tensor-core body (bf16 q over bf16 rows) vs "
        "their plain PyTorch versions ==")
    bf = torch.bfloat16
    ragged = [0, 1, 15, 16, 127, 129, 511, 513, 1116]
    kw = dict(d_v=DV, scale=1.0 / math.sqrt(192), softcap=None)
    worst = {}

    def hold(what, fn, run, variant, key):
        before = (fn.launches, fn.mma_launches)
        got = run(False)
        if (fn.launches - before[0], fn.mma_launches - before[1]) != (1, 1):
            raise SystemExit(f"{what}: not one launch of the tensor-core body")
        want = run(True)
        torch.cuda.synchronize()
        if got[0].abs().max().item() != 0.0 or not torch.isfinite(got).all():
            raise SystemExit(f"{what}: kv_len == 0 rows are not exact zeros, or non-finite")
        err, tol = (got - want).abs().max().item(), TOL[bf, variant]
        worst[key, bf, variant] = max(worst.get((key, bf, variant), 0.0), err)
        log(f"  {what} {variant}: max |kernel - plain| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise SystemExit(f"tensor-core kernel phase: {what} {variant} exceeds tol {tol}")

    kv = torch.as_tensor(ragged, dtype=torch.int32, device="cuda")
    for g in (1, 17, 128):
        q = randn((len(ragged), g, DK), 60 + g, bf)
        c = randn((len(ragged) + 1, 1116, DK), 61 + g, bf)[1:]
        pos = torch.as_tensor(np.stack([decode_positions(n, g) for n in ragged]),
                              dtype=torch.int32, device="cuda")
        blk = md.contiguous_block_k(512, c.shape[1])
        for variant in ("amla", "base"):
            run = lambda plain: (
                md._rows_plain(q, c, kv, pos, variant=variant, block_k=blk, **kw) if plain
                else md.mla_decode_rows(q, c, kv, pos, variant=variant, **kw))
            hold(f"K4 G={g} kv={ragged}, batch-sliced cache", md.mla_decode_rows, run, variant,
                 "K4")
        del q, c
    for page in (16, 64, 128, 512):
        for g in (1, 17, 128):
            args = fragmented_case(70 + page + g, ragged, g, page)
            for variant in ("amla", "base"):
                run = lambda plain: (mp._padded_rows_plain if plain else mp.mla_decode_paged_rows)(
                    *args, variant=variant, **kw)
                hold(f"K5 page {page} G={g} W={args[2].shape[1]} kv={ragged}",
                     mp.mla_decode_paged_rows, run, variant, "K5")
    torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------- #
# serve phase
# --------------------------------------------------------------------------- #


def small_reference_check():
    """The smoke-size model (fp32) through the kernels on the card and
    through the plain versions on the CPU, same weights and tokens (the
    CPU run's greedy picks are fed to both): logits must agree."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_schedule import DecodeScheduler
    from repro_torch.models import transformer as tf
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.step_graph import PagedDecodeStep

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
    # decode steps as PagedServingSession takes them: staged, and replayed
    # from a CUDA graph on the card (the same walk, uncaptured, on the CPU)
    steps = {dev: PagedDecodeStep(params, caches[dev], cfg=cfg, table_width=24, block_k=32,
                                  num_splits=2, compute_dtype=torch.float32,
                                  scheduler=DecodeScheduler(block_k=32, num_splits=2))
             for dev, params in (("cpu", p_cpu), ("cuda", p_gpu))}
    for _ in range(6):
        outs = {dev: step(np.asarray(last)[:, None], [0, 1, 2]).cpu()
                for dev, step in steps.items()}
        worst = max(worst, (outs["cuda"] - outs["cpu"]).abs().max().item())
        last = torch.argmax(outs["cpu"][:, 0], dim=-1).tolist()
    tol = 2e-3
    captures, shapes = steps["cuda"].graphs.captures, steps["cuda"].shapes
    log(f"small-input reference ({cfg.name}, fp32, 3 prompts + 6 steps, the steps replayed "
        f"from {captures} CUDA graph(s) on the card, keys (B, queue capacity) {shapes}): max "
        f"|logits on card - logits of the plain CPU path| = {worst:.3e} (tol {tol:g}: AMLA's "
        f"fp32 tolerance, see TOL)")
    if not worst <= tol or captures != len(shapes) or captures < 1:
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


def int8_prefix_logits(cfg, model, params, forced=None):
    """The smoke model (fp32) over an int8 paged cache with a forked
    family: a 69-token parent (2 complete 32-row blocks), two children
    admitted at its full prefix with suffixes of 7 and 11 tokens, then 6
    decode steps with prefix sharing (group-prefix kernel + int8 queue
    kernel in every layer).  Returns every call's logits (on the CPU) and
    the greedy picks; ``forced`` feeds given picks instead."""
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.kv_cache import CacheSpec

    rng = np.random.default_rng(2)
    parent = rng.integers(2, cfg.vocab_size, size=69).tolist()
    suffixes = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (7, 11)]
    cache = model.init_paged_cache(params, num_pages=48, page_size=16, spec=CacheSpec("int8"))
    kw = dict(cfg=cfg, cache=cache, block_k=32, compute_dtype=torch.float32, table_width=48)
    seen, picks = [], []
    cache.alloc(0)
    seen.append(tf.lm_prefill_paged(params, parent, rid=0, chunk=16, **kw).float().cpu())
    for rid, suf in enumerate(suffixes, start=1):
        cache.fork(0, rid, len(parent))
        seen.append(tf.lm_prefill_paged(params, suf, rid=rid, start_pos=len(parent), chunk=16,
                                        **kw).float().cpu())
    last = [int(torch.argmax(x[0])) for x in seen]
    for i in range(6):
        if forced is not None:
            last = forced[i]
        picks.append(last)
        out = tf.lm_decode_step_paged(params, np.asarray(last)[:, None], rids=[0, 1, 2],
                                      num_splits=2, prefix_sharing=True, **kw)
        seen.append(out[:, 0].float().cpu())
        last = torch.argmax(seen[-1], dim=-1).tolist()
    return seen, picks


def small_int8_prefix_check():
    """The smoke model through int8 pages and shared-prefix groups, on the
    card and on the CPU, same weights and tokens (the CPU's greedy picks
    fed to both): logits as close as the CPU path is to itself under
    fp32-sized weight noise.  Quantization rounds each latent to an int8
    step, so where the card's and the CPU's fp32 latents differ in the last
    bit a code can land one step apart; the tolerance is therefore the
    dense check's: 4x the CPU path's spread on weights perturbed by 2e-7
    relative (three seeds), never below 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("deepseek-v2-mla", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator("cpu").manual_seed(3), "cpu")
    diff = lambda a, b: max((x - y).abs().max().item() for x, y in zip(a, b))
    cpu, picks = int8_prefix_logits(cfg, model, p_cpu)
    card, _ = int8_prefix_logits(cfg, model, to_device(p_cpu, "cuda"), forced=picks)
    noise = max(diff(cpu, int8_prefix_logits(
        cfg, model, perturbed(p_cpu, torch.Generator("cpu").manual_seed(s)), forced=picks)[0])
        for s in (1, 2, 3))
    tol = max(2e-3, 4 * noise)
    worst = diff(card, cpu)
    same = all(torch.equal(torch.argmax(a, -1), torch.argmax(b, -1)) for a, b in zip(card, cpu))
    log(f"small int8 + shared-prefix reference ({cfg.name}, fp32, int8 pages, a forked family "
        f"of 3, 3 prefills + 6 steps): max |logits on card - logits of the plain CPU path| = "
        f"{worst:.3e} (tol {tol:.3e} = max(2e-3, 4 x {noise:.3e}, the CPU path against itself "
        f"on weights perturbed by 2e-7)); greedy picks {'equal' if same else 'DIFFER'}")
    if not worst <= tol:
        raise SystemExit("small int8 + shared-prefix reference check failed")


def smoke_stream(sess, prompts, steps):
    """Admit ``prompts`` in waves of two with overlapping lifetimes (the
    reference's trie test): each wave decodes 3 steps, every second wave
    finishes the oldest two; then ``steps`` more steps and finish all.
    Returns every request's tokens and the work counters."""
    outs, live = {}, []
    for wave in range(len(prompts) // 2):
        for p in prompts[2 * wave : 2 * wave + 2]:
            rid = sess.add_request(p)
            if rid is None:
                raise SystemExit("small trie / speculation check: admission failed")
            live.append(rid)
        for _ in range(3):
            sess.step()
        if wave % 2:
            for r in live[:2]:
                outs[r] = sess.finish(r)
            live = live[2:]
    for _ in range(steps):
        sess.step()
    for r in live:
        outs[r] = sess.finish(r)
    work = sess.work_stats()
    sess.close()
    return outs, work


class ScriptedDrafts:
    """A draft proposer that knows the speculate="off" streams: its first
    ``right`` drafts are the tokens that follow, the rest are wrong, so
    every verify step accepts exactly ``right`` drafts and rolls the rest
    back (the n-gram drafter accepts almost nothing on a random model)."""

    def __init__(self, streams, right, vocab):
        self.streams, self.right, self.vocab = streams, right, vocab

    def propose(self, history, k):
        hist = list(history)
        stream = next(s for s in self.streams if s[: len(hist)] == hist)
        cont = stream[len(hist) : len(hist) + k]
        cont += [0] * (k - len(cont))
        return cont[: self.right] + [(t + 1) % self.vocab for t in cont[self.right :]]


def small_trie_spec_check():
    """The smoke model (fp32) with the prefix trie and with speculation, on
    the card and on the CPU, same weights: the trie's greedy tokens equal
    the CPU path's and the card's trie-off run's; speculation's (draft_k 4,
    bf16 and int8 pages; n-gram drafts, and scripted drafts of which 2 of
    3 are right) equal the CPU path's and extend the card's
    speculate="off" stream."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import PagedServingSession

    cfg = get_config("deepseek-v2-mla", smoke=True)
    model = build_model(cfg)
    params = {"cpu": model.init(torch.Generator("cpu").manual_seed(3), "cpu")}
    params["cuda"] = to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(7)
    template = rng.integers(2, cfg.vocab_size, size=64).tolist()
    prompts = [template + rng.integers(2, cfg.vocab_size, size=5 + i).tolist() for i in range(8)]
    kw = dict(num_pages=96, page_size=16, block_k=32, prefill_chunk=16)

    def serve(dev, steps=4, **extra):
        return smoke_stream(PagedServingSession(model, params[dev], **kw, **extra), prompts, steps)

    on, work = serve("cuda", prefix_cache="trie")
    cpu, cpu_work = serve("cpu", prefix_cache="trie")
    off, _ = serve("cuda")
    keys = ("trie_hits", "trie_misses", "prefix_tokens_reused", "prefill_chunks", "page_dmas")
    same_work = all(work[k] == cpu_work[k] for k in keys)
    log(f"small trie reference ({cfg.name}, fp32, 8 template prompts in staggered waves): "
        f"greedy tokens {'equal' if on == cpu else 'DIFFER'} to the CPU path's, "
        f"{'equal' if on == off else 'DIFFER'} to the card's trie-off run; trie hits "
        f"{work['trie_hits']}, misses {work['trie_misses']}, reused tokens "
        f"{work['prefix_tokens_reused']} (CPU: {[cpu_work[k] for k in keys[:3]]})")
    if on != cpu or on != off or not same_work or work["trie_hits"] < 6:
        raise SystemExit("small trie reference check failed")
    spec_prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (8, 12, 30)]
    def decode(dev, kv_dtype, steps, **extra):
        sess = PagedServingSession(model, params[dev], kv_dtype=kv_dtype, **kw, **extra)
        rids = [sess.add_request(p) for p in spec_prompts]
        for _ in range(steps):
            sess.step()
        out = ({r: list(sess.outputs[r]) for r in rids}, sess.work_stats())
        sess.close()
        return out

    for kv_dtype in ("bf16", "int8"):
        off, _ = decode("cuda", kv_dtype, 32)
        streams = [p + off[r] for r, p in enumerate(spec_prompts)]
        for drafts in ("n-gram", "scripted, 2 of 3 right"):
            extra = dict(speculate="ngram", draft_k=4)
            if drafts != "n-gram":
                extra["draft_proposer"] = ScriptedDrafts(streams, 2, cfg.vocab_size)
            (spec, ws), (cpu, cpu_ws) = (decode(dev, kv_dtype, 8, **extra)
                                         for dev in ("cuda", "cpu"))
            extends = all(off[r][: len(out)] == out for r, out in spec.items())
            log(f"small speculation reference ({cfg.name}, fp32, {kv_dtype} pages, draft_k 4, "
                f"{drafts} drafts, 3 prompts x 8 steps): greedy tokens "
                f"{'equal' if spec == cpu else 'DIFFER'} to the CPU path's; "
                f"{'an extension' if extends else 'NOT an extension'} of speculate='off' on "
                f"the card; {ws['accepted_tokens_per_step']:.3f} accepted tokens per "
                f"request-step, query rows {ws['query_rows']} = 4 x {ws['request_steps']}")
            if (spec != cpu or not extends or ws != cpu_ws
                    or ws["query_rows"] != 4 * ws["request_steps"]
                    or (drafts != "n-gram" and ws["accepted_tokens_per_step"] != 3.0)):
                raise SystemExit(f"small speculation reference check failed ({kv_dtype} pages, "
                                 f"{drafts} drafts)")


def trie_serve_phase(cfg, model, params):
    """deepseek-v2-mla at published widths (the paged phase's bf16 weights)
    through PagedServingSession(prefix_cache="trie", num_splits=2, 64
    pages): a 1024-token system prompt S, templates T1 = S + 512 tokens and
    T2 = S + another 512; requests A = T1 + 37 (cold), B = T1 + 300, C = T2
    + 40, D = T2 + 7 and a 513-token loner, 16 greedy steps, finish all,
    then F = T1 + 100 from the retained pages.  Every decode step runs K2'
    over three nested groups ([0, 2) x 4, [2, 3) x 2 twice), K2 on the
    suffixes and K3 with chains of 2.  A trie-off session over the same
    weights then admits B cold: its first token and logits row must equal
    the trie session's bit for bit."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import PagedServingSession

    log(f"== trie serve phase: {cfg.name} ({cfg.n_layers} layers, the paged phase's bf16 "
        f"weights), PagedServingSession(prefix_cache='trie', num_splits=2), 64 pages of "
        f"{PAGE}, block_k {BLOCK_K}, prefill_chunk 32 ==")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(2)
    tok = lambda n: rng.integers(2, cfg.vocab_size, size=n).tolist()
    system = tok(1024)
    t1, t2 = system + tok(512), system + tok(512)
    prompts = [t1 + tok(37), t1 + tok(300), t2 + tok(40), t2 + tok(7), tok(513)]
    late = t1 + tok(100)
    # what the prompts imply: each admission reuses the longest run of whole
    # blocks, before its last token, that an earlier prompt's complete
    # blocks share with it
    want = dict(hits=0, misses=0, reused=0, chunks=0)
    seen = []
    for p in prompts + [late]:
        usable = (len(p) - 1) // BLOCK_K * BLOCK_K
        lcp = lambda a: next((i for i, (x, y) in enumerate(zip(a, p)) if x != y), min(len(a), len(p)))
        m = max([min(lcp(a), len(a) // BLOCK_K * BLOCK_K, usable) // BLOCK_K * BLOCK_K
                 for a in seen] + [0])
        want["hits" if m else "misses"] += 1
        want["reused"] += m
        want["chunks"] += -(-(len(p) - m) // 32)
        seen.append(p)

    recorded = []
    real_prefill = tf.lm_prefill_paged

    def rec_prefill(*a, **k):
        out = real_prefill(*a, **k)
        recorded.append(out.float().clone())
        return out

    sess = PagedServingSession(model, params, num_pages=64, page_size=PAGE, block_k=BLOCK_K,
                               num_splits=2, prefill_chunk=32, prefix_cache="trie")
    timing = timed_session(sess)
    grouped = []
    step = sess.step

    def recorded_step():
        step()
        cur = sess._scheduler.current
        grouped.append((cur.num_groups, cur.groups.gmax))

    sess.step = recorded_step
    counters = (mp.mla_decode_paged_queue_rows, mc.combine_split_partials,
                mp.mla_decode_paged_group_prefix)
    for fn in counters:
        fn.launches = 0
    mp.mla_decode_paged_queue_rows.int8_launches = 0
    mp.mla_decode_paged_queue_rows.mma_launches = 0
    mp.mla_decode_paged_group_prefix.mma_launches = 0
    tf.lm_prefill_paged = rec_prefill
    try:
        rids = [sess.add_request(p) for p in prompts]
        b_logits = recorded[1]
        for _ in range(16):
            sess.step()
        results = {r: sess.finish(r) for r in rids}
        retained = sess.work_stats()["retained_pages"]
        f = sess.add_request(late)
    finally:
        tf.lm_prefill_paged = real_prefill
    torch.cuda.synchronize()
    k2, k3, k2p = (fn.launches for fn in counters)
    mma = (mp.mla_decode_paged_queue_rows.mma_launches,
           mp.mla_decode_paged_group_prefix.mma_launches)
    work = sess.work_stats()
    results[f] = sess.finish(f)
    sweep = sess.close()
    chunks, steps, L = work["prefill_chunks"], work["decode_steps"], cfg.n_layers
    n_prompt = sum(map(len, prompts)) + len(late)
    tokens_out = 16 * len(prompts)
    log(f"served {len(prompts)} + 1 requests: prefill {n_prompt} prompt tokens, "
        f"{n_prompt - work['prefix_tokens_reused']} of them prefilled in {chunks} chunks, "
        f"{timing['prefill']:.3f} s ({n_prompt / timing['prefill']:.1f} prompt tok/s); decode "
        f"{tokens_out} tokens in {steps} steps, {timing['decode']:.3f} s "
        f"({tokens_out / timing['decode']:.2f} tok/s, {1e3 * timing['decode'] / steps:.1f} "
        f"ms/step); peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"trie: hits {work['trie_hits']}, misses {work['trie_misses']} (hit rate "
        f"{work['trie_hit_rate']:.3f}), prefix tokens reused {work['prefix_tokens_reused']}; "
        f"expected from the prompts: {want}; retained pages after finishing all "
        f"{retained}; teardown sweep {sweep['free_pages']} pages free")
    log(f"groups per decode step (groups, gmax): {sorted(set(grouped))} in {len(grouped)} "
        f"steps; launches: K2 {k2} (expected layers x (chunks + steps) = {L} x ({chunks} + "
        f"{steps}) = {L * (chunks + steps)}), K3 {k3} (same), K2' {k2p} (expected {L} x "
        f"{steps} = {L * steps}); tensor-core body: K2 {mma[0]}, K2' {mma[1]}")
    if (work["trie_hits"] != want["hits"] or work["trie_misses"] != want["misses"]
            or work["prefix_tokens_reused"] != want["reused"] or chunks != want["chunks"]):
        raise SystemExit("trie serve phase: trie counts differ from the prompts' own")
    if (set(grouped) != {(3, 4)} or steps != 16 or k2 != L * (chunks + steps) or k3 != k2
            or k2p != L * steps or mma != (k2, k2p)
            or mp.mla_decode_paged_queue_rows.int8_launches):
        raise SystemExit("trie serve phase: groups or launch counts do not match the path")
    for rid, out in results.items():
        if len(out) != (1 if rid == f else 17) or not all(0 <= t < cfg.vocab_size for t in out):
            raise SystemExit(f"trie serve phase: request {rid} returned {out}")
    log(f"tokens: { {r: results[r][:6] for r in sorted(results)} }")
    del sess
    release()
    cold = PagedServingSession(model, params, num_pages=64, page_size=PAGE, block_k=BLOCK_K,
                               num_splits=2, prefill_chunk=32)
    tf.lm_prefill_paged = rec_prefill
    try:
        rb = cold.add_request(prompts[1])
    finally:
        tf.lm_prefill_paged = real_prefill
    same = torch.equal(recorded[-1], b_logits) and cold.outputs[rb][0] == results[rids[1]][0]
    log(f"B admitted cold by a trie-off session ({-(-len(prompts[1]) // 32)} chunks): first "
        f"token and logits row {'equal bit for bit' if same else 'DIFFER'} to the trie "
        f"session's (max |difference| {(recorded[-1] - b_logits).abs().max().item():.3e})")
    cold.close()
    if not same:
        raise SystemExit("trie serve phase: a warm admission differs from a cold one")
    return k2, k2p, k3


def spec_serve_phase(cfg, model, params, prompt_lens, paged_results):
    """The paged phase's weights and prompts through
    PagedServingSession(speculate="ngram", draft_k=4, num_splits=2) over
    bf16 pages, 16 steps: every step verifies 4 rows per request through K2
    and K3 (eagerly), and rolls the rejected rows back exactly."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.runtime.serve_loop import PagedServingSession

    log(f"== speculation serve phase: {cfg.name} ({cfg.n_layers} layers, the paged phase's "
        f"bf16 weights and prompts {list(prompt_lens)}), PagedServingSession(speculate='ngram', "
        f"draft_k=4, num_splits=2), 48 pages of {PAGE} ==")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    sess = PagedServingSession(model, params, num_pages=48, page_size=PAGE, num_splits=2,
                               prefill_chunk=32, speculate="ngram", draft_k=4)
    timing = timed_session(sess)
    for fn in (mp.mla_decode_paged_queue_rows, mc.combine_split_partials):
        fn.launches = 0
    mp.mla_decode_paged_queue_rows.mma_launches = 0
    rids = [sess.add_request(p) for p in prompts]
    exact = True
    for _ in range(16):
        sess.step()
        exact &= all(sess.cache.seq_len(r) == len(p) + len(sess.outputs[r]) - 1
                     for r, p in zip(rids, prompts))
    torch.cuda.synchronize()
    k2, k3 = mp.mla_decode_paged_queue_rows.launches, mc.combine_split_partials.launches
    k2_mma = mp.mla_decode_paged_queue_rows.mma_launches
    work = sess.work_stats()
    results = {r: list(sess.outputs[r]) for r in rids}
    sweep = sess.close()
    chunks, steps, L = work["prefill_chunks"], work["decode_steps"], cfg.n_layers
    accepted = work["accepted_tokens"]  # emitted by the steps (not the prefill's first)
    agree = [next((i for i, (a, b) in enumerate(zip(results[r], paged_results[r])) if a != b),
                  min(len(results[r]), len(paged_results[r]))) for r in rids]
    log(f"served {len(rids)} requests: prefill {sum(prompt_lens)} tokens in {chunks} chunks, "
        f"{timing['prefill']:.3f} s; decode {steps} steps in {timing['decode']:.3f} s "
        f"({1e3 * timing['decode'] / steps:.1f} ms/step), {work['accepted_tokens']} tokens "
        f"accepted over {work['request_steps']} request-steps "
        f"({work['accepted_tokens_per_step']:.3f} a request-step, i.e. acceptance "
        f"{(work['accepted_tokens_per_step'] - 1) / 3:.3f} of the 3 drafts), "
        f"{1e3 * timing['decode'] / max(accepted, 1):.2f} ms per accepted token "
        f"({accepted / timing['decode']:.2f} tok/s); query rows {work['query_rows']}; "
        f"rows = prompt + outputs - 1 after every step: {exact}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; teardown sweep "
        f"{sweep['free_pages']} pages free")
    log(f"tokens equal to speculate='off' (the paged phase's 17 a request) for the first "
        f"{agree} of each request's {[len(results[r]) for r in rids]} (not a gate at bf16: "
        f"the dense products run at M = 4 x 4 rows, not 4)")
    log(f"launches: K2 {k2} (tensor-core body {k2_mma}), K3 {k3}; expected layers x (chunks "
        f"+ steps) = {L} x ({chunks} + {steps}) = {L * (chunks + steps)}; CUDA graph "
        f"captures {sess.graph_captures} (expected 0: verify steps run eagerly)")
    if (not exact or k2 != L * (chunks + steps) or k3 != k2 or k2_mma != k2 or steps != 16
            or work["query_rows"] != 4 * work["request_steps"] or sess.graph_captures):
        raise SystemExit("speculation serve phase: rollback, rows or launch counts do not "
                         "match the path")
    for rid, out in results.items():
        if len(out) < 17 or not all(0 <= t < cfg.vocab_size for t in out):
            raise SystemExit(f"speculation serve phase: request {rid} returned {out}")
    return k2, k3


def small_interleave_suspend_check():
    """The smoke model (fp32) on the card and on the CPU, same weights: the
    stream admitted under ``prefill_budget`` and the streams with requests
    suspended and resumed by replay (a decoding request twice, a prompt
    still pending under a budget once) give the phased, uninterrupted
    stream's tokens exactly, with ``replay_mismatches`` 0; every card
    stream equals the CPU path's."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import PagedServingSession

    cfg = get_config("deepseek-v2-mla", smoke=True)
    model = build_model(cfg)
    params = {"cpu": model.init(torch.Generator("cpu").manual_seed(3), "cpu")}
    params["cuda"] = to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (70, 9, 24, 40)]
    gen = 12
    # step -> ("suspend" | "resume", request index)
    plans = {"phased": (None, {}), "interleaved": (48, {}),
             "suspended": (None, {3: ("suspend", 1), 6: ("resume", 1), 8: ("suspend", 2),
                                  9: ("resume", 2)}),
             "pending suspended": (48, {0: ("suspend", 0), 2: ("resume", 0)})}

    def stream(dev, budget, events):
        sess = PagedServingSession(model, params[dev], num_pages=64, page_size=16, block_k=32,
                                   prefill_chunk=16, prefill_budget=budget)
        rids = [sess.add_request(p) for p in prompts]
        for i in range(80):
            if i in events:
                what, k = events[i]
                if what == "suspend":
                    sess.suspend(rids[k])
                elif not sess.resume(rids[k]):
                    raise SystemExit("small interleave/suspend check: a resume found no room")
            if all(len(sess.outputs.get(r, [])) > gen for r in rids):
                break
            sess.step()
        out = [list(sess.outputs[r][: gen + 1]) for r in rids]
        work = sess.work_stats()
        sess.close()
        return out, work

    want = None
    for name, (budget, events) in plans.items():
        (card, work), (cpu, cpu_work) = (stream(dev, budget, events) for dev in ("cuda", "cpu"))
        want = card if want is None else want
        log(f"small {name} stream ({cfg.name}, fp32, prompts 70/9/24/40, budget {budget}, "
            f"{gen} tokens each): tokens {'equal' if card == want else 'DIFFER'} to the "
            f"phased uninterrupted stream on the card, {'equal' if card == cpu else 'DIFFER'} "
            f"to the CPU path's; suspends {work['suspends']}, resumes {work['resumes']}, "
            f"replay_mismatches {work['replay_mismatches']} (CPU {cpu_work['replay_mismatches']}),"
            f" prefill_stall_steps {work['prefill_stall_steps']}")
        if (card != want or card != cpu or work["replay_mismatches"]
                or work["suspends"] != work["resumes"] or work["suspends"] != len(events) // 2
                or (budget is not None and work["prefill_stall_steps"])):
            raise SystemExit(f"small interleave/suspend check failed ({name})")


def sla_traffic(cfg, chunk=32, seed=7):
    """One burst of the reference's seeded multi-tenant SLA traffic
    (``benchmarks/model_serve.py``, ``_sla_traffic``): a batch-class prompt
    of 16-20 chunks (priority 0), five interactive prompts of chunk/4 to
    3/2 chunk (priority 2) and one standard prompt of 3/2 to 7/2 chunks
    (priority 1), arriving within units 0-17 of the work clock; as
    (arrival, prompt, priority)."""
    rng = np.random.default_rng(seed)
    tok = lambda n: rng.integers(2, cfg.vocab_size, size=n).tolist()
    subs = [(0, tok(int(rng.integers(16 * chunk, 20 * chunk + 1))), 0)]
    for _ in range(5):
        arr = int(rng.integers(0, 18))
        subs.append((arr, tok(int(rng.integers(max(chunk // 4, 2), 3 * chunk // 2))), 2))
    arr = int(rng.integers(0, 18))
    subs.append((arr, tok(int(rng.integers(3 * chunk // 2 + 1, 7 * chunk // 2))), 1))
    return subs


class ServeClock:
    """Host wall times of a supervised run: the work clock (plus the
    supervisor's idle skew) sampled around every ``add_request``, ``step``
    and ``resume``, so a work-clock unit maps to the wall time the clock
    reached it (linear inside a call); each request's emission times; the
    decode graphs' capture time; each resume's time; the top-2 logit gap
    of every graphed decode row."""

    def __init__(self, sup):
        sess = sup.sess
        self.points, self.emits, self.rid_of = [], {}, {}
        self.capture_s, self.resume_ms, self.top2 = 0.0, [], {}
        self.t0 = time.perf_counter()
        unit = lambda: sess.work_units + sup._clock_skew

        def wrap(fn, name):
            def call(*a):
                self.points.append((unit(), self.now()))
                out = fn(*a)
                t = self.now()
                self.points.append((unit(), t))
                if name == "add_request" and out is not None:
                    self.rid_of[tuple(a[0])] = out
                if name == "resume":
                    self.resume_ms.append(1e3 * (t - self.points[-2][1]))
                for r, toks in sess.outputs.items():
                    seen = self.emits.setdefault(r, [])
                    seen.extend([t] * (len(toks) - len(seen)))
                return out
            return call

        for name in ("add_request", "step", "resume"):
            setattr(sess, name, wrap(getattr(sess, name), name))
        graphs = sess.step_graph.graphs
        capture, run = graphs._capture, graphs.run

        def timed_capture(walk):
            t = self.now()
            out = capture(walk)
            self.capture_s += self.now() - t
            return out

        def gapped_run(key, walk, eager=False):
            out = run(key, walk, eager=eager)
            top = out[:, -1].float().topk(2, dim=-1).values.cpu()
            for r, (a, b) in zip(sess.active, top.tolist()):
                self.top2[r, len(sess.outputs[r])] = a - b
            return out

        graphs._capture, graphs.run = timed_capture, gapped_run

    def now(self):
        torch.cuda.synchronize()
        return time.perf_counter() - self.t0

    def wall_at(self, unit):
        """When the work clock first reached ``unit``."""
        for (u0, t0), (u1, t1) in zip(self.points, self.points[1:]):
            if u1 >= unit:
                return t0 if u0 >= unit else t0 + (unit - u0) / (u1 - u0) * (t1 - t0)
        return self.points[-1][1]


def supervised_run(model, params, subs, *, gen_len, plan=None, **session):
    """``subs`` = [(arrival, prompt, priority)] through a ServeSupervisor
    (``arrival_unit="work_units"``) over PagedServingSession(**session);
    K2/K3 counted over the run only.  Returns the run's record."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.runtime.serve_loop import PagedServingSession, ServeSupervisor

    sess = PagedServingSession(model, params, page_size=PAGE, block_k=BLOCK_K, num_splits=2,
                               prefill_chunk=32, **session)
    sup = ServeSupervisor(sess, gen_len=gen_len, plan=plan, arrival_unit="work_units")
    for arr, p, pri in subs:
        sup.submit(p, priority=pri, arrival=arr)
    clock = ServeClock(sup)
    for fn in (mp.mla_decode_paged_queue_rows, mc.combine_split_partials):
        fn.launches = 0
    mp.mla_decode_paged_queue_rows.mma_launches = 0
    t = clock.now()
    results = sup.run()
    wall = clock.now() - t
    counts = (mp.mla_decode_paged_queue_rows.launches, mc.combine_split_partials.launches,
              mp.mla_decode_paged_queue_rows.mma_launches)
    rec = dict(results=results, stats=sup.stats(), recs=sup.latency_records(),
               work=sess.work_stats(), wall=wall, counts=counts, clock=clock,
               captures=sess.graph_captures, shapes=list(sess.step_graph.shapes),
               abandoned=set(sup.abandoned_idx), events=list(sup.events))
    rec["sweep"] = sess.close()
    rec["pages"] = sess.cache.num_pages
    rec["rids"] = [clock.rid_of.get(tuple(p)) for _, p, _ in subs]
    del sess, sup
    release()
    return rec


def launches_match(rec, n_layers):
    """K2 = K3 = tensor-core K2 = layers x (prefill chunks + decode steps)."""
    k2, k3, mma = rec["counts"]
    want = n_layers * (rec["work"]["prefill_chunks"] + rec["work"]["decode_steps"])
    return k2 == k3 == mma == want, want


def agreement(a, b):
    """Leading tokens two streams share."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def sla_serve_phase(cfg, model, params):
    """deepseek-v2-mla at published widths (the paged phase's bf16 weights)
    under one burst of the reference's SLA traffic at chunk 32, seed 7,
    through ServeSupervisor(arrival_unit="work_units") over
    PagedServingSession(num_splits=2, 64 pages), 16 greedy tokens each:
    once phased (prefill_budget=None), once interleaved
    (prefill_budget=96).  Prints TTFT p50/p99 per class (work units and
    host ms), per-token p99, stall chunks, units per output token,
    tokens/s and graph captures; gates exact K2/K3 counts, interleaving
    without stalls, equal units per token, equal first tokens and a clean
    teardown."""
    from repro_torch.runtime.serve_loop import latency_percentile

    subs = sla_traffic(cfg)
    classes = {0: "batch", 1: "standard", 2: "interactive"}
    log(f"== SLA serve phase: {cfg.name} ({cfg.n_layers} layers, the paged phase's bf16 "
        f"weights), ServeSupervisor(arrival_unit='work_units') over PagedServingSession("
        f"num_splits=2), 64 pages of {PAGE}, block_k {BLOCK_K}, chunk 32; traffic (arrival "
        f"unit, prompt tokens, priority): {[(a, len(p), pri) for a, p, pri in subs]} ==")
    runs, L = {}, cfg.n_layers
    for name, budget in (("phased", None), ("interleaved", 96)):
        rec = runs[name] = supervised_run(model, params, subs, gen_len=16, num_pages=64,
                                          prefill_budget=budget)
        st, clock, work = rec["stats"], rec["clock"], rec["work"]
        tokens = sum(len(v) for v in rec["results"].values())
        rec["upt"] = (work["request_steps"] + work["prefill_chunks"]) / tokens
        units, ms = {c: [] for c in classes}, {c: [] for c in classes}
        for (arr, _, pri), r, lat in zip(subs, rec["rids"], rec["recs"]):
            units[pri].append(lat["first_vt"] - lat["submit_vt"])
            ms[pri].append(1e3 * (clock.emits[r][0] - clock.wall_at(arr)))
        gaps_ms = [1e3 * (b - a) for r in rec["rids"] for a, b in zip(clock.emits[r],
                                                                     clock.emits[r][1:])]
        ok, want = launches_match(rec, L)
        rec["ok"] = ok
        log(f"{name}: {len(rec['results'])} requests, {tokens} tokens in {rec['wall']:.3f} s "
            f"({tokens / rec['wall']:.2f} tok/s); {work['prefill_chunks']} prefill chunks, "
            f"{work['decode_steps']} decode steps, {work['work_units']} work units; "
            f"prefill_stall_steps {st['prefill_stall_steps']}; units per output token "
            f"{rec['upt']:.4f}; graph captures {rec['captures']} (keys {rec['shapes']}) in "
            f"{clock.capture_s:.3f} s; teardown sweep {rec['sweep']['free_pages']} of "
            f"{rec['pages']} pages free")
        for pri, cname in classes.items():
            log(f"  TTFT {cname} (priority {pri}, {len(units[pri])} requests): p50/p99 "
                f"{latency_percentile(units[pri], 50):.0f}/{latency_percentile(units[pri], 99):.0f}"
                f" units, {latency_percentile(ms[pri], 50):.1f}/"
                f"{latency_percentile(ms[pri], 99):.1f} ms")
        log(f"  per-token p50/p99: {st['tpot_units_p50']:.0f}/{st['tpot_units_p99']:.0f} units, "
            f"{latency_percentile(gaps_ms, 50):.1f}/{latency_percentile(gaps_ms, 99):.1f} ms; "
            f"launches K2 {rec['counts'][0]} (tensor-core {rec['counts'][2]}), K3 "
            f"{rec['counts'][1]}; expected layers x (chunks + steps) = {want}")
    ph, il = runs["phased"], runs["interleaved"]
    firsts = all(ph["results"][i][0] == il["results"][i][0] for i in range(len(subs)))
    agree = [agreement(ph["results"][i], il["results"][i]) for i in range(len(subs))]
    log(f"first tokens {'equal' if firsts else 'DIFFER'} between the runs; later tokens "
        f"agree for the first {agree} of each request's 17 (not a gate at bf16: the decode "
        f"products run at other batch sizes)")
    for i, n in enumerate(agree):
        if n < 17:
            gap = [rec["clock"].top2.get((rec["rids"][i], n)) for rec in (ph, il)]
            log(f"  request {i} diverges at token {n}: top-2 logit gap there "
                f"{['%.4f' % g if g is not None else 'n/a' for g in gap]} (phased, interleaved)")
    if not (ph["ok"] and il["ok"]):
        raise SystemExit("SLA serve phase: K2/K3 launch counts do not match the path")
    if il["stats"]["prefill_stall_steps"] or ph["upt"] != il["upt"] or not firsts:
        raise SystemExit("SLA serve phase: stalls when interleaved, unequal units per token "
                         "or unequal first tokens")
    for rec in (ph, il):
        if rec["sweep"]["free_pages"] != rec["pages"] or rec["abandoned"] or any(
                len(v) != 17 for v in rec["results"].values()):
            raise SystemExit("SLA serve phase: a request did not complete or pages leaked")
    return tuple(sum(r["counts"][k] for r in runs.values()) for k in (0, 1))


def pool_rows(sess, rid):
    """Every layer's rows of ``rid``, (L, seq_len, 576), copied."""
    return torch.stack([sess.cache.gather_contiguous(rid, l)
                        for l in range(sess.cache.num_layers)])


def row_diffs(before, after, lo, hi):
    """(rows [lo, hi) bit-equal, max |difference| there)."""
    d = (before[:, lo:hi].float() - after[:, lo:hi].float()).abs()
    return torch.equal(before[:, lo:hi], after[:, lo:hi]), d.max().item() if d.numel() else 0.0


def layer_rel_diffs(before, after):
    """Per layer, the max over the rows of |difference| / max |row|."""
    a, b = before.float(), after.float()
    rel = (a - b).abs().amax(-1) / a.abs().amax(-1).clamp_min(1e-30)
    return rel.amax(-1).cpu().numpy()


def chaos_serve_phase(cfg, model, params):
    """deepseek-v2-mla at published widths (the paged phase's bf16 weights):
    suspend / resume by replay, then the supervisor under faults.

    Direct sequence, PagedServingSession(prefill_budget=96, num_splits=2,
    64 pages): prompts of 37, 120, 250, 513 and 1020 tokens admitted under
    the budget, an admit_with_prefix child of the 1020-token prompt (40
    more tokens); a plain request suspended and resumed; the child
    suspended and resumed while its parent is live (re-aliased prefix);
    the child suspended again and resumed after its parent finished
    (standalone replay); a prompt suspended while its prefill is pending.
    Each resumed request's rows are held against a copy taken before it was
    suspended: rows prefilled on their original chunk boundaries bit-equal;
    a row a decode step wrote is recomputed by a prefill chunk (products at
    M = 32, not the batch), which changes its low bits in every layer it
    passes, so at layer l it is held within 1e-2 x sqrt(l + 1) of the
    row's max: the kernels' bf16 tolerance for one recomputed layer,
    growing as a random walk over the layers below it.

    Then ServeSupervisor over the five prompts in a 24-page pool, fault
    free and under a FaultPlan of pool pressure (6 pages at step 2 for 6
    steps, while three requests cross a 128-row page), a slow shard and an
    abandon: every request not abandoned completes, resumes = suspends >=
    1, the slow shard is flagged, the abandoned request keeps its partial
    output, no page leaks."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.runtime.fault_injection import FaultEvent, FaultPlan
    from repro_torch.runtime.serve_loop import PagedServingSession

    log(f"== suspend / replay and chaos phase: {cfg.name} ({cfg.n_layers} layers, the paged "
        f"phase's bf16 weights), page {PAGE}, block_k {BLOCK_K}, chunk 32, num_splits=2 ==")
    rng = np.random.default_rng(5)
    tok = lambda n: rng.integers(2, cfg.vocab_size, size=n).tolist()
    lens = (37, 120, 250, 513, 1020)
    prompts, suffix = [tok(n) for n in lens], tok(40)
    tol, L = 1e-2, cfg.n_layers
    bound = tol * np.sqrt(np.arange(1, L + 1))
    sess = PagedServingSession(model, params, num_pages=64, page_size=PAGE, block_k=BLOCK_K,
                               num_splits=2, prefill_chunk=32, prefill_budget=96)
    resume_ms = []

    def resume(rid):
        torch.cuda.synchronize()
        t = time.perf_counter()
        back = sess.resume(rid)
        torch.cuda.synchronize()
        resume_ms.append(1e3 * (time.perf_counter() - t))
        if not back:
            raise SystemExit(f"chaos phase: request {rid} found no room to resume")

    for fn in (mp.mla_decode_paged_queue_rows, mc.combine_split_partials):
        fn.launches = 0
    mp.mla_decode_paged_queue_rows.mma_launches = 0
    rids = [sess.add_request(p) for p in prompts]
    while rids[4] not in sess.active:
        sess.step()
    child = sess.admit_with_prefix(rids[4], suffix)
    if child is None or sess.prefill_pending:
        raise SystemExit("chaos phase: admission of the family failed")
    for _ in range(3):
        sess.step()
    checks = []

    def held(what, rid, before, exact_ranges, n_rows):
        after = pool_rows(sess, rid)
        exact = [row_diffs(before, after, lo, hi) for lo, hi in exact_ranges]
        same = all(e[0] for e in exact)
        rel = layer_rel_diffs(before, after) if after.shape == before.shape else bound + 1
        worst = int(np.argmax(rel))
        log(f"  {what}: rows {list(exact_ranges)} (prefilled on their original chunk "
            f"boundaries) {'bit-equal' if same else 'DIFFER'} (max |diff| "
            f"{max([e[1] for e in exact] + [0.0]):.3e}); all {n_rows} rows, max |diff| / "
            f"max |row|: layer 0 {rel[0]:.3e}, layer {L // 2} {rel[L // 2]:.3e}, layer "
            f"{L - 1} {rel[-1]:.3e}, largest {rel[worst]:.3e} at layer {worst}; largest "
            f"against {tol:g} x sqrt(layer + 1): {np.max(rel / bound):.3f}; replay_mismatches "
            f"{sess.replay_mismatches}; resume {resume_ms[-1]:.1f} ms")
        checks.append(same and bool(np.all(rel <= bound)))

    # (a) a plain request
    r = rids[1]
    before = pool_rows(sess, r)
    sess.suspend(r)
    sess.step()
    resume(r)
    held(f"plain request {r} ({lens[1]} prompt + {before.shape[1] - lens[1]} decoded rows)",
         r, before, [(0, lens[1])], before.shape[1])
    # (b) the child while its parent is live: the prefix is re-aliased
    prefix = sess._family[child][1]
    before = pool_rows(sess, child)
    sess.suspend(child)
    sess.step()
    resume(child)
    shared = sess.cache.seq_pages(child)[: prefix // PAGE] == sess.cache.seq_pages(rids[4])[
        : prefix // PAGE]
    held(f"child {child} re-aliased on live parent {rids[4]} (prefix {prefix} rows, pages "
         f"{'shared' if shared else 'NOT shared'})", child, before,
         [(0, prefix + len(suffix))], before.shape[1])
    checks.append(shared)
    # (c) the child again, replayed standalone after its parent finished
    before = pool_rows(sess, child)
    sess.suspend(child)
    sess.finish(rids[4])
    resume(child)
    held(f"child {child} replayed standalone ({before.shape[1]} rows from position 0)",
         child, before, [(0, lens[4])], before.shape[1])
    # (d) a prompt suspended while its prefill is pending under the budget
    late = sess.add_request(prompts[2])
    sess.step()
    pending = sess.prefill_pending
    rec = sess.suspend(late)
    n_out = len(rec.outputs)
    resume(late)
    while not sess.outputs[late]:
        sess.step()
    same_first = sess.outputs[late][0] == sess.outputs[rids[2]][0]
    d = row_diffs(pool_rows(sess, rids[2]), pool_rows(sess, late), 0, lens[2])
    log(f"  request {late} suspended mid-prefill ({pending} pending, {n_out} tokens out) and resumed: first token {'equal' if same_first else 'DIFFERS'} to "
        f"request {rids[2]}'s (the same prompt), its {lens[2]} prompt rows "
        f"{'bit-equal' if d[0] else 'DIFFER'} to that request's; resume {resume_ms[-1]:.1f} ms")
    checks.append(same_first and d[0] and not n_out)
    torch.cuda.synchronize()
    direct = (mp.mla_decode_paged_queue_rows.launches, mc.combine_split_partials.launches,
              mp.mla_decode_paged_queue_rows.mma_launches)
    work = sess.work_stats()
    sweep = sess.close()
    launches_ok, want = launches_match(dict(counts=direct, work=work), L)
    log(f"direct sequence: suspends {work['suspends']}, resumes {work['resumes']}, replay "
        f"prefill tokens {work['replay_prefill_tokens']}, replay_mismatches "
        f"{work['replay_mismatches']}, prefill_stall_steps {work['prefill_stall_steps']}; "
        f"launches K2 {direct[0]} (tensor-core {direct[2]}), K3 {direct[1]}, expected "
        f"layers x (chunks + steps) = {want}; teardown sweep {sweep['free_pages']} pages free")
    del sess
    release()
    if (not all(checks) or not launches_ok or work["suspends"] != work["resumes"]
            or work["suspends"] != 4 or sweep["free_pages"] != 64):
        raise SystemExit("chaos phase: a resumed request's rows or tokens do not hold")

    subs = [(0, p, 0) for p in prompts]
    plan = FaultPlan([FaultEvent(step=2, kind="pool_pressure", pages=6, duration=6),
                      FaultEvent(step=3, kind="slow_shard", duration=2, factor=9.0),
                      FaultEvent(step=10, kind="abandon")])
    calm = supervised_run(model, params, subs, gen_len=16, num_pages=24)
    chaos = supervised_run(model, params, subs, gen_len=16, num_pages=24, plan=plan)
    st, clock = chaos["stats"], chaos["clock"]
    agree = {i: (agreement(calm["results"][i], out), len(out))
             for i, out in chaos["results"].items()}
    replay_s = sum(clock.resume_ms) / 1e3
    log(f"supervisor, fault free: {calm['stats']['completed']} completed, suspends "
        f"{calm['stats']['suspends']}, {calm['stats']['steps']} steps, {calm['wall']:.3f} s")
    log(f"supervisor under '{plan.describe()}': completed {st['completed']}, abandoned "
        f"{st['abandoned']} (submissions {sorted(chaos['abandoned'])}), suspends "
        f"{st['suspends']}, resumes {st['resumes']}, evictions {st['evictions']}, admission "
        f"retries {st['admission_retries']}, straggler events {st['straggler_events']}, "
        f"faults applied {st['faults_applied']} (skipped {st['faults_skipped']}), steps "
        f"{st['steps']}, {chaos['wall']:.3f} s; replay_mismatches {st['replay_mismatches']}")
    log(f"  replay: {st['replay_prefill_tokens']} prefill tokens in {replay_s:.3f} s of "
        f"resumes ({st['replay_prefill_tokens'] / max(replay_s, 1e-9):.1f} tok/s); resume "
        f"wall ms {[round(t, 1) for t in clock.resume_ms]}; tokens agreeing with the fault-"
        f"free run (leading, of each): {agree}; events {chaos['events']}; teardown sweep "
        f"{chaos['sweep']['free_pages']} of {chaos['pages']} pages free")
    for rec in (calm, chaos):
        ok, want = launches_match(rec, L)
        if not ok:
            raise SystemExit(f"chaos phase: K2/K3 counts {rec['counts']} != {want}")
        if rec["sweep"]["free_pages"] != rec["pages"]:
            raise SystemExit("chaos phase: pages leaked")
        if any(len(out) != 17 for i, out in rec["results"].items() if i not in rec["abandoned"]):
            raise SystemExit("chaos phase: a request that was not abandoned did not complete")
    if (st["suspends"] < 1 or st["resumes"] != st["suspends"] or st["straggler_events"] < 1
            or len(chaos["abandoned"]) != 1 or calm["abandoned"]
            or not all(0 < len(chaos["results"][i]) < 17 for i in chaos["abandoned"])):
        raise SystemExit("chaos phase: suspends, stragglers or the abandoned request do not "
                         "hold")
    return tuple(direct[k] + sum(r["counts"][k] for r in (calm, chaos)) for k in (0, 1))


def shared_prefix_phase(cfg, model, params, kv_dtype):
    """deepseek-v2-mla at published widths (the paged phase's weights)
    through PagedServingSession(kv_dtype=..., prefix_sharing=True): an
    1100-token system prompt, three admit_with_prefix children (suffixes of
    7, 40 and 300 tokens), an unrelated 513-token loner, 16 greedy steps.
    The family shares 2 complete 512-row blocks, so every decode step runs
    K2' (one group of 4, G = 512 stacked rows), the queue kernel on the
    suffixes (K2-int8 over int8 pages, K2 over bf16 pages) and the hetero
    combine in every layer.  Over either pool every K2 and K2' launch takes
    the tensor-core body."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.runtime.serve_loop import PagedServingSession

    int8 = kv_dtype == "int8"
    log(f"== {kv_dtype} shared-prefix serve phase: {cfg.name} ({cfg.n_layers} layers, the "
        f"paged phase's bf16 weights), PagedServingSession(kv_dtype='{kv_dtype}', "
        f"prefix_sharing=True, num_splits=2), 48 pages of {PAGE} ==")
    torch.cuda.reset_peak_memory_stats()
    sess = PagedServingSession(model, params, num_pages=48, page_size=PAGE, num_splits=2,
                               prefill_chunk=32, kv_dtype=kv_dtype, prefix_sharing=True)
    rng = np.random.default_rng(1)
    system = rng.integers(2, cfg.vocab_size, size=1100).tolist()
    suffixes = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (7, 40, 300)]
    loner = rng.integers(2, cfg.vocab_size, size=513).tolist()
    timing = timed_session(sess)
    grouped = []
    step = sess.step

    def recorded_step():
        step()
        cur = sess._scheduler.current
        grouped.append((cur.num_groups, cur.groups.gmax))

    sess.step = recorded_step
    counters = (mp.mla_decode_paged_queue_rows, mc.combine_split_partials,
                mp.mla_decode_paged_group_prefix)
    for fn in counters:
        fn.launches = 0
    mp.mla_decode_paged_queue_rows.int8_launches = 0
    mp.mla_decode_paged_queue_rows.mma_launches = 0
    mp.mla_decode_paged_group_prefix.mma_launches = 0
    parent = sess.add_request(system)
    kids = [sess.admit_with_prefix(parent, suf) for suf in suffixes]
    other = sess.add_request(loner)
    rids = [parent, *kids, other]
    if None in rids:
        raise SystemExit(f"int8 shared-prefix phase: admission failed ({rids})")
    aliased = sess.work_stats()["aliased_pages"]
    for _ in range(16):
        sess.step()
    torch.cuda.synchronize()
    k2, k3, k2p = (fn.launches for fn in counters)
    k2i8 = mp.mla_decode_paged_queue_rows.int8_launches
    mma = (mp.mla_decode_paged_queue_rows.mma_launches,
           mp.mla_decode_paged_group_prefix.mma_launches)
    work = sess.work_stats()
    results = {r: list(sess.outputs[r]) for r in rids}
    sweep = sess.close()
    chunks, steps = work["prefill_chunks"], work["decode_steps"]
    n_grouped = sum(1 for n, gmax in grouped if n > 0)
    n_prompt = len(system) + sum(map(len, suffixes)) + len(loner)
    tokens_out = 16 * len(rids)
    L = cfg.n_layers
    log(f"served {len(rids)} requests: prefill {n_prompt} tokens in {chunks} chunks, "
        f"{timing['prefill']:.3f} s ({n_prompt / timing['prefill']:.1f} tok/s); decode "
        f"{tokens_out} tokens in {steps} steps, {timing['decode']:.3f} s "
        f"({tokens_out / timing['decode']:.2f} tok/s, {1e3 * timing['decode'] / steps:.1f} "
        f"ms/step); aliased pages after admission {aliased}; page DMAs {work['page_dmas']} "
        f"({work['page_dma_bytes'] / 1e6:.2f} MB at {kv_dtype}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; teardown sweep "
        f"{sweep['free_pages']} pages free")
    log(f"groups per decode step (groups, gmax): {sorted(set(grouped))} in {n_grouped} of "
        f"{steps} steps; CUDA graph captures {sess.graph_captures} (expected 0: the "
        f"shared-prefix step runs eagerly)")
    queue = k2i8 if int8 else k2
    log(f"launches: {'K2-int8' if int8 else 'K2'} {queue} (expected layers x (prefill chunks + "
        f"decode steps) = {L} x ({chunks} + {steps}) = {L * (chunks + steps)}), K2' {k2p} "
        f"(expected layers x grouped steps = {L} x {n_grouped} = {L * n_grouped}), K3 {k3} "
        f"(expected {L * (chunks + steps)}), {'K2 on bf16 pages' if int8 else 'K2-int8'} "
        f"{k2 if int8 else k2i8} (expected 0); tensor-core body: K2 {mma[0]}, K2' {mma[1]} "
        f"(expected {(queue, k2p)})")
    if (queue != L * (chunks + steps) or k2p != L * n_grouped or k3 != L * (chunks + steps)
            or (k2 if int8 else k2i8) != 0 or n_grouped != steps or k2p <= 0 or aliased <= 0
            or set(grouped) != {(1, 4)} or mma != (queue, k2p) or sess.graph_captures):
        raise SystemExit(f"{kv_dtype} shared-prefix phase: launch counts do not match the path")
    for rid, out in results.items():
        if len(out) != 17 or not all(0 <= t < cfg.vocab_size for t in out):
            raise SystemExit(f"{kv_dtype} shared-prefix phase: request {rid} returned {out}")
    log(f"tokens: { {r: results[r][:6] for r in rids} }")
    return queue, k2p, k3


def padded_decode_phase():
    """PagedDecodeSession at full MLA attention width (d_k 576, d_v 512,
    128 query rows, page 128, bf16) with synthetic latents from a seed:
    prompts of 37, 300, 513 and 1100 rows, then 16 steps, through
    scheduler="padded" (K5) and, on the same inputs, scheduler="queue"."""
    from repro_torch.kernels import mla_decode_paged as mp
    from repro_torch.runtime.serve_loop import PagedDecodeSession

    log("== padded decode phase: PagedDecodeSession(scheduler='padded') at MLA attention "
        "width (d_k 576, d_v 512, 128 query rows, page 128, bf16), 4 prompts + 16 steps ==")
    gen = torch.Generator("cuda").manual_seed(21)
    lat = lambda n: torch.randn((n, DK), generator=gen, device="cuda").to(torch.bfloat16)
    prompts = [lat(n) for n in (37, 300, 513, 1100)]
    steps = [({r: lat(128) for r in range(4)}, {r: lat(1)[0] for r in range(4)})
             for _ in range(16)]
    outs, times = {}, {}
    for scheduler in ("padded", "queue"):
        sess = PagedDecodeSession(num_pages=24, page_size=PAGE, d_k=DK, d_v=DV,
                                  scale=1.0 / math.sqrt(192), scheduler=scheduler,
                                  dtype=torch.bfloat16, device="cuda")
        for p in prompts:
            if sess.admit(p) is None:
                raise SystemExit("padded decode phase: admission failed")
        mp.mla_decode_paged_rows.launches = 0
        mp.mla_decode_paged_rows.mma_launches = 0
        outs[scheduler], per_step = [], []
        for q, new in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[scheduler].append(sess.step(q, new))
            torch.cuda.synchronize()
            per_step.append(time.perf_counter() - t0)
        times[scheduler] = (np.mean(per_step), np.median(per_step), np.max(per_step))
        if scheduler == "padded":
            k5 = mp.mla_decode_paged_rows.launches
            k5_mma = mp.mla_decode_paged_rows.mma_launches
    err = max((a[r] - b[r]).abs().max().item()
              for a, b in zip(outs["padded"], outs["queue"]) for r in range(4))
    finite = all(torch.isfinite(o[r]).all() for o in outs["padded"] for r in range(4))
    tol = TOL[torch.bfloat16, "amla"]
    ms = {k: "/".join(f"{1e3 * t:.3f}" for t in v) for k, v in times.items()}
    log(f"padded {ms['padded']} ms/step, queue {ms['queue']} ms/step (mean/median/max); "
        f"max |padded - queue| over 16 steps {err:.3e} (tol {tol:g}: bf16, the two update "
        f"the AMLA state per page and per 512-row block); K5 launches {k5}, on the tensor-core "
        f"body {k5_mma} (expected 16 and 16)")
    if k5 != len(steps) or k5_mma != k5 or not err <= tol or not finite:
        raise SystemExit("padded decode phase failed")
    return k5, times


def dense_session_logits(cfg, params, prompts, max_len=64):
    """Every prefill's and decode step's logits (on the CPU) and the greedy
    outputs of a small ServingSession run: 2 slots, 6 steps, a finish, a
    third prompt into the recycled slot, 3 more steps."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import ServingSession

    model = build_model(cfg)
    seen = []
    prefill = model.prefill

    def rec_prefill(*a, **k):
        out = prefill(*a, **k)
        seen.append(out[0].float().cpu())
        return out

    model.prefill = rec_prefill
    sess = ServingSession(model, params, batch_size=2, max_len=max_len)
    run = sess.step_graph.graphs.run

    def rec_decode(*a, **k):  # after the replay (or the eager walk on the CPU)
        out = run(*a, **k)
        seen.append(out.float().cpu())
        return out

    sess.step_graph.graphs.run = rec_decode
    sess.add_request(prompts[0])
    sess.add_request(prompts[1])
    for _ in range(6):
        sess.step()
    sess.finish(0)
    sess.add_request(prompts[2])
    for _ in range(3):
        sess.step()
    return seen, dict(sess.outputs)


SMALL_FAMILIES = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "mamba2-370m", "recurrentgemma-2b")


def small_dense_check():
    """Smoke gemma2-2b, deepseek-v2-mla and the MoE, Mamba-2 and RG-LRU
    hybrid families (``SMALL_FAMILIES``), fp32
    weights, through ServingSession on the card and on the CPU, same
    weights and prompts:
    the same greedy tokens, and every prefill's and decode step's logits as
    close as the CPU path is to itself under fp32-sized noise.

    The dense path feeds attention bf16 inputs whatever the model's dtype
    (``ops.gqa_attention`` and ``ops.mla_decode`` cast q, k, v and read the
    cache rounded to bf16, as the reference does), so where the card's
    fp32 products and the CPU's differ in the last bit, an attention input
    can land one bf16 step (2^-8 relative) apart.  The families' second
    prompt is 300 tokens (max_len 512), past Mamba-2's 256-step SSD chunk
    and one block of the RG-LRU's doubling scan, so the chunked prefill
    (the pad after softplus, the masked exp) is held card vs CPU too; the
    others keep 40 tokens (max_len 64).  The tolerance is
    therefore 4x the largest logit difference of the CPU path against
    itself on weights perturbed by 2e-7 relative (three seeds), and never
    below 2e-3.  The kernels themselves are held to their tolerances in the
    kernel phases."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    for arch in ("gemma2-2b", "deepseek-v2-mla", *SMALL_FAMILIES):
        cfg = get_config(arch, smoke=True)
        p_cpu = build_model(cfg).init(torch.Generator("cpu").manual_seed(5), "cpu")
        rng = np.random.default_rng(5)
        family = arch in SMALL_FAMILIES
        lens, max_len = ((5, 300, 12), 512) if family else ((5, 40, 12), 64)
        prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in lens]
        hold_card_vs_cpu(f"{cfg.name}, fp32, ServingSession, prompts {lens}, 9 steps",
                         lambda p: dense_session_logits(cfg, p, prompts, max_len), p_cpu)


def hold_card_vs_cpu(what, run, p_cpu):
    """``run(params) -> (logits list, greedy outputs)`` on the CPU, on the
    card over the same fp32 weights, and on the CPU over weights perturbed
    by 2e-7 relative (three seeds): fail unless the card's logits are
    within max(2e-3, 4 x the CPU path's spread against itself) of the
    CPU's and its greedy outputs are equal."""
    diff = lambda a, b: max((x - y).abs().max().item() for x, y in zip(a, b))
    cpu, cpu_out = run(p_cpu)
    card, card_out = run(to_device(p_cpu, "cuda"))
    noise = max(diff(cpu, run(perturbed(p_cpu, torch.Generator("cpu").manual_seed(s)))[0])
                for s in (1, 2, 3))
    tol = max(2e-3, 4 * noise)
    worst = diff(card, cpu)
    same = card_out == cpu_out if not isinstance(card_out, torch.Tensor) else torch.equal(
        card_out, cpu_out)
    log(f"small dense reference ({what}): max |logits on card - logits of the plain CPU path| "
        f"= {worst:.3e} (tol {tol:.3e} = max(2e-3, 4 x {noise:.3e}, the CPU path against "
        f"itself on weights perturbed by 2e-7)); greedy tokens {'equal' if same else 'DIFFER'}")
    if not worst <= tol or not same:
        raise SystemExit(f"small dense reference check failed: {what}")


def hold_against_eager(sess, steps=3):
    """Make the first ``steps`` graph-replayed decode steps of ``sess`` run
    the eager walk first, on the same staged inputs and state (the walk
    rewrites the same cache rows; recurrent and SSM state, which a step
    advances, is put back after it), and compare: returns the list it fills
    with (max |logits of the graph - of the eager walk|, greedy tokens
    equal) per step.  The eager runs' kernel launches are taken back from
    the counts: the counts read the replays only."""
    from repro_torch.runtime import step_graph as sg

    graphs = sess.step_graph.graphs
    run, held = graphs.run, []
    state = getattr(sess.step_graph, "state", [])  # advanced by a step: restored

    def checked(key, walk, eager=False):
        if eager or len(held) >= steps:
            return run(key, walk, eager=eager)
        counts = sg.launch_counts()
        saved = [t.clone() for t in state]
        want = run(key, walk, eager=True)
        for t, v in zip(state, saved):
            t.copy_(v)
        sg.set_launch_counts(counts)
        got = run(key, walk)
        held.append(((got - want).abs().max().item(),
                     torch.equal(got.argmax(-1), want.argmax(-1))))
        return got

    graphs.run = checked
    return held


def report_held(what, held, sess, timing):
    """Print the hold against the eager walk, the captures and the steady
    decode time (the steps after the held ones, the first of which also
    captured); fail unless the decode steps replayed graphs and their
    tokens equal the eager walk's."""
    worst = max((d for d, _ in held), default=float("nan"))
    same = bool(held) and all(eq for _, eq in held)
    steady = [s for s in timing["steps"] if s][len(held):]
    log(f"graphs: {sess.graph_captures} CUDA graph capture(s) of the decode step "
        f"(keys {getattr(sess.step_graph, 'shapes', ['decode'])}); first {len(held)} steps held "
        f"against the eager walk on the same state: greedy tokens "
        f"{'equal' if same else 'DIFFER'}, max |logits graph - eager| {worst:.3e}; steady "
        f"decode after them {1e3 * np.mean(steady):.2f} ms/step (median "
        f"{1e3 * np.median(steady):.2f}, {len(steady)} steps)")
    if not same or sess.graph_captures < 1:
        raise SystemExit(f"{what}: the decode steps did not replay graphs equal to the eager walk")


def timed_session(sess):
    """Wrap add_request (and admit_with_prefix, where the session has it)
    and step with device-synchronised host timers; ``timing["steps"]``
    keeps each decode step's seconds."""
    timing = {"prefill": 0.0, "decode": 0.0, "steps": []}

    def timed(name, fn):
        def call(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            timing[name] += time.perf_counter() - t
            if name == "decode":
                timing["steps"].append(time.perf_counter() - t)
            return out
        return call

    sess.add_request = timed("prefill", sess.add_request)
    if hasattr(sess, "admit_with_prefix"):
        sess.admit_with_prefix = timed("prefill", sess.admit_with_prefix)
    sess.step = timed("decode", sess.step)
    return timing


def zero_counts(counters) -> None:
    """Set the wrappers' ``launches`` (and ``mma_launches``) to 0."""
    for fn in counters:
        fn.launches = 0
        if hasattr(fn, "mma_launches"):
            fn.mma_launches = 0


def read_counts(counters) -> list:
    """``[(launches, mma_launches or None)]`` of the wrappers."""
    return [(fn.launches, getattr(fn, "mma_launches", None)) for fn in counters]


def dense_serve(cfg, model, params, prompt_lens, gen_len, max_len, counters):
    """Serve prompts of ``prompt_lens`` through ServingSession(batch 4,
    max_len) with the launch/serve stream loop; ``counters`` (wrapper
    functions; their ``launches`` and, where they have them,
    ``mma_launches``) are set to 0 just before and read just after."""
    from repro_torch.launch.serve import _serve_stream
    from repro_torch.runtime.serve_loop import ServingSession

    sess = ServingSession(model, params, batch_size=4, max_len=max_len)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    held = hold_against_eager(sess)
    timing = timed_session(sess)
    steps = 0
    step = sess.step

    def counted_step():
        nonlocal steps
        steps += int(sess.active_mask.any())
        step()

    sess.step = counted_step
    zero_counts(counters)
    results, tokens_out, dt = _serve_stream(sess, list(prompts), gen_len, len(prompts))
    torch.cuda.synchronize()
    launches = read_counts(counters)
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
    report_held(f"{cfg.name} dense serve", held, sess, timing)
    if sess.graph_captures != 1:
        raise SystemExit(f"{cfg.name} dense serve: {sess.graph_captures} captures, expected 1")
    return results, launches, buckets, steps, held, timing


def gemma_dense_phase():
    """gemma2-2b at published widths (26 layers, bf16, seed 0) through the
    dense ServingSession: prompts of 5 (bucket 8: prefilled through K6),
    300, 1100 and 4500 tokens (past the 4096-key window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as mc
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
    unembed_table_phase(model, params)
    max_len, batch = 8192, 4
    _, ((k6, k6_mma), (k7, k7_mma), (k3, _)), buckets, steps, _, _ = dense_serve(
        cfg, model, params, (5, 300, 1100, 4500), 16, max_len,
        (gd.gqa_decode_rows, fp.flash_prefill, mc.combine_split_partials))
    want7 = cfg.n_layers * sum(b > 8 for b in buckets)
    want6 = cfg.n_layers * (steps + sum(b <= 8 for b in buckets))
    # K6 reads the whole max_len cache: a decode step has batch x Hkv CTAs of
    # G = group rows, a bucket-8 prefill 1 x Hkv of G = 8 x group; each call
    # split over the cache's blocks launches K3 once
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_blocks = -(-max_len // 512)
    group = cfg.n_heads // cfg.n_kv_heads
    split = lambda b, g: gd.decode_splits(sms, b * cfg.n_kv_heads * -(-g // 16), n_blocks) > 1
    want3 = cfg.n_layers * (steps * split(batch, group)
                            + sum(b <= 8 for b in buckets) * split(1, 8 * group))
    log(f"launches: K6 gqa_decode_rows {k6}, {k6_mma} on the tensor-core body (expected "
        f"layers x (decode steps + prefills with bucket <= 8) = {want6}); K7 flash_prefill "
        f"{k7}, {k7_mma} on the tensor-core body (expected layers x prefills with bucket > 8 "
        f"= {want7}); K3 combine_split_partials {k3} from the split K6 calls (expected "
        f"{want3})")
    if (k6 <= 0 or k7 <= 0 or (k6, k6_mma) != (want6, want6) or (k7, k7_mma) != (want7, want7)
            or k3 != want3):
        raise SystemExit("gemma2-2b dense phase: kernel launch counts do not match the main path")
    return k6, k7, k3


def mla_dense_phase(cfg, model, params, prompt_lens, paged_results):
    """deepseek-v2-mla at published widths through the dense ServingSession,
    on the paged phase's weights and prompts: K4 at every prefill and
    decode step of every layer.  Token agreement with the paged phase is
    printed as information: the two paths round bf16 in different orders."""
    from repro_torch.kernels import mla_decode as md

    log(f"== dense serve phase: {cfg.name} ({cfg.n_layers} layers, the paged phase's "
        f"weights), ServingSession(batch 4, max_len 2048) ==")
    torch.cuda.reset_peak_memory_stats()
    results, ((k4, k4_mma),), buckets, steps, _, _ = dense_serve(
        cfg, model, params, prompt_lens, 16, 2048, (md.mla_decode_rows,))
    want4 = cfg.n_layers * (len(prompt_lens) + steps)
    log(f"launches: K4 mla_decode_rows {k4}, on the tensor-core body {k4_mma} (expected layers "
        f"x (prefills + decode steps) = {cfg.n_layers} x ({len(prompt_lens)} + {steps}) = "
        f"{want4}, all on the tensor-core body)")
    agree = [sum(a == b for a, b in zip(results[r], paged_results[r])) for r in sorted(results)]
    log(f"greedy tokens equal to the paged phase's, per request (of {len(results[0])}): {agree}")
    if k4 <= 0 or k4 != want4 or k4_mma != k4:
        raise SystemExit("deepseek-v2-mla dense phase: K4 launch count does not match the main path")
    return k4


# (arch, prompt lengths) of the families phase
FAMILY_RUNS = (
    ("qwen3-moe-30b-a3b", (5, 300, 1100, 4500)),
    ("mamba2-370m", (37, 300, 1100, 4500)),
    ("recurrentgemma-2b", (5, 300, 1100, 4500)),
)


def families_phase():
    """The MoE, Mamba-2 and RG-LRU hybrid families at published widths and
    full depth (random bf16 weights, seed 0) through ServingSession(batch
    4, max_len 8192) and the launch/serve stream loop, 16 greedy tokens a
    request (``FAMILY_RUNS``).  Returns the K6, K7 and K3 launches."""
    t0 = time.perf_counter()
    totals = np.zeros(3, np.int64)
    for arch, prompt_lens in FAMILY_RUNS:
        totals += family_serve(arch, prompt_lens)
        release()
    log(f"families phase: {time.perf_counter() - t0:.1f} s")
    return tuple(int(n) for n in totals)


def family_serve(arch, prompt_lens, gen_len=16, max_len=8192, batch=4, then=None):
    """One family at full width: its attention layers' K6/K7/K3 launch
    counts must equal layers x calls (0 for an attention-free stack), the
    decode steps replay one CUDA graph whose first 3 steps equal the eager
    walk bit for bit (greedy tokens and logits), and a MoE stack's decode
    time is printed beside the time to read every expert's weights (the
    reference's ``(E, C, d)`` product reads all E every step).  ``then(cfg,
    model, params)``, run after on the same weights, returns K6/K7/K3
    launches of its own, added to the session's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline import analysis

    cfg = get_config(arch)
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("global", "local") for k in kinds)
    mixers = {k: kinds.count(k) for k in dict.fromkeys(kinds)}
    extra = (f", {cfg.n_experts} experts top-{cfg.n_experts_active} x d_ff {cfg.d_ff_expert}"
             if cfg.n_experts else f", d_ff {cfg.d_ff}")
    if cfg.d_inner:
        extra += f", d_inner {cfg.d_inner}" + (f", state {cfg.ssm_state} x heads of "
                                               f"{cfg.ssm_head_dim}" if cfg.ssm_state else "")
    log(f"== families phase: {cfg.name} d_model {cfg.d_model}, layers {mixers}, attention "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, window {cfg.window}{extra}, "
        f"vocab {cfg.vocab_size}, bf16, {cfg.param_count() / 1e9:.2f} B params ==")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"random bf16 weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    unembed_table_phase(model, params)
    _, ((k6, k6_mma), (k7, k7_mma), (k3, _)), buckets, steps, held, timing = dense_serve(
        cfg, model, params, prompt_lens, gen_len, max_len,
        (gd.gqa_decode_rows, fp.flash_prefill, mc.combine_split_partials))
    # prefills of <= 8 tokens (bucket or exact length) attend through K6
    want7 = n_attn * sum(b > 8 for b in buckets)
    want6 = n_attn * (steps + sum(b <= 8 for b in buckets))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_blocks = -(-max_len // 512)
    group = cfg.n_heads // cfg.n_kv_heads
    split = lambda b, g: gd.decode_splits(sms, b * cfg.n_kv_heads * -(-g // 16), n_blocks) > 1
    want3 = n_attn * (steps * split(batch, group)
                      + sum(split(1, b * group) for b in buckets if b <= 8))
    log(f"launches: K6 gqa_decode_rows {k6}, {k6_mma} on the tensor-core body (expected "
        f"attention layers x (decode steps + prefills of <= 8 tokens) = {want6}); K7 "
        f"flash_prefill {k7}, {k7_mma} on the tensor-core body (expected attention layers x "
        f"longer prefills = {want7}); K3 combine_split_partials {k3} (expected {want3}); "
        f"{n_attn} attention layers of {cfg.n_layers}")
    worst = max(d for d, _ in held)
    if cfg.n_experts:
        weights = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert * 2
        steady = [t for t in timing["steps"] if t][len(held):]
        log(f"MoE decode: {1e3 * timing['decode'] / steps:.2f} ms/step over all {steps} steps, "
            f"{1e3 * np.mean(steady):.2f} ms/step steady, beside the time to read every "
            f"expert's weights once, {weights / 2**30:.1f} GiB = "
            f"{1e3 * weights / analysis.HBM_BW:.2f} ms at {analysis.HBM_BW / 1e12:.2f} TB/s")
    if ((k6, k6_mma), (k7, k7_mma), k3) != ((want6, want6), (want7, want7), want3):
        raise SystemExit(f"{cfg.name} families phase: kernel launch counts do not match the "
                         "main path")
    if n_attn and (k6 <= 0 or k7 <= 0):
        raise SystemExit(f"{cfg.name} families phase: an attention kernel never launched")
    if worst != 0.0:
        raise SystemExit(f"{cfg.name} families phase: graph and eager logits differ by "
                         f"{worst:.3e} (must be 0)")
    if then is not None:
        return tuple(a + b for a, b in zip((k6, k7, k3), then(cfg, model, params)))
    return k6, k7, k3


# --------------------------------------------------------------------------- #
# vision-language and encoder-decoder phase
# --------------------------------------------------------------------------- #


def vision_form(model, params, vis, tokens, steps, max_len, hold=False):
    """The reference's vision prefill (``dryrun.lower_prefill``): ``Nv``
    patch embeddings then text through ``lm_apply`` at
    ``mrope_positions(B, S, Nv)`` into a batch-B dense cache at cache_len
    0; then ``steps`` greedy decode steps through ``DenseDecodeStep`` (a
    CUDA graph on the card) at cache_len S + i.  Returns (each call's
    last-position logits on the CPU, the tokens (steps, B), the step,
    prefill seconds, each step's seconds, and with ``hold`` the first 3
    steps held against the eager walk, ``hold_against_eager``'s list)."""
    from types import SimpleNamespace

    from repro_torch.models import transformer as tf
    from repro_torch.models import vlm
    from repro_torch.runtime.step_graph import DenseDecodeStep

    b, s = tokens.shape
    dev = tokens.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cache = model.init_cache(params, b, max_len)
    sync()
    t0 = time.perf_counter()
    hidden, _, _ = tf.lm_apply(params, tokens, cfg=model.cfg,
                               positions=vlm.mrope_positions(b, s, vis.shape[1], device=dev),
                               cache=cache, cache_len=0, embeds_override=vis)
    logits = model.logits(params, hidden[:, -1:])
    sync()
    prefill_s = time.perf_counter() - t0
    seen = [logits[:, -1].float().cpu()]
    step = DenseDecodeStep(model, params, cache, b)
    held = hold_against_eager(SimpleNamespace(step_graph=step)) if hold else []
    toks, times = [], []
    for i in range(steps):
        toks.append(seen[-1].argmax(-1).to(torch.int32))
        sync()
        t0 = time.perf_counter()
        logits = step(toks[-1].numpy(), np.full((b,), s + i, np.int32))
        seen.append(logits[:, -1].float().cpu())
        times.append(time.perf_counter() - t0)
    return seen, torch.stack(toks), step, prefill_s, times, held


def encdec_form(model, params, src, prompt, steps, max_len):
    """The reference's encoder-decoder serving form (``dryrun``'s prefill
    and decode): ``init_cache`` (the encoder and every layer's cross K/V),
    ``decode_step`` over the target prompt at cache_len 0, then ``steps``
    greedy steps, eager.  Returns (each call's last-position logits on the
    CPU, the tokens (steps, B), encode seconds, prompt seconds, each
    step's seconds)."""
    b, st = prompt.shape
    dev = prompt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    cache = model.init_cache(params, src, max_len)
    sync()
    t1 = time.perf_counter()
    logits, _ = model.decode_step(params, cache, prompt,
                                  torch.zeros((b,), dtype=torch.int32, device=dev))
    sync()
    t2 = time.perf_counter()
    seen, toks, times = [logits[:, -1].float().cpu()], [], []
    for i in range(steps):
        toks.append(seen[-1].argmax(-1))
        t = time.perf_counter()
        logits, _ = model.decode_step(params, cache, toks[-1][:, None].to(dev),
                                      torch.full((b,), st + i, dtype=torch.int32, device=dev))
        seen.append(logits[:, -1].float().cpu())
        sync()
        times.append(time.perf_counter() - t)
    return seen, torch.stack(toks), t1 - t0, t2 - t1, times


def small_vlm_encdec_check():
    """Smoke qwen2-vl-7b and seamless-m4t-medium (fp32) on the card and on
    the CPU, held as the other small references (``hold_card_vs_cpu``):
    qwen2-vl through the text-only ``ServingSession`` (prompts 5, 40 and
    12) and through the vision prefill (16 patches + 24 text tokens,
    batch 2) + 6 graphed decode steps; seamless through ``init_cache`` over
    40 frames, ``decode_step`` over a 24-token prompt and 6 greedy steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen2-vl-7b", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator("cpu").manual_seed(5), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 12)]
    hold_card_vs_cpu(f"{cfg.name}, fp32, ServingSession text-only, prompts (5, 40, 12), 9 steps",
                     lambda p: dense_session_logits(cfg, p, prompts, 64), p_cpu)
    vis = torch.from_numpy(
        (rng.standard_normal((2, cfg.vision_stub_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, cfg.vision_stub_tokens + 24)))

    def vision(p):
        dev = p["embed"]["table"].device
        seen, out, *_ = vision_form(model, p, vis.to(dev), toks.to(dev), 6, 64)
        return seen, out

    hold_card_vs_cpu(f"{cfg.name}, fp32, vision prefill 16 + 24 into a batch-2 cache, 6 graphed "
                     "steps", vision, p_cpu)
    cfg = get_config("seamless-m4t-medium", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator("cpu").manual_seed(5), "cpu")
    src = torch.from_numpy((rng.standard_normal((2, 40, cfg.d_model)) * 0.02).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 24)))

    def serving_form(p):
        dev = p["embed"]["table"].device
        seen, out, *_ = encdec_form(model, p, src.to(dev), prompt.to(dev), 6, 32)
        return seen, out

    hold_card_vs_cpu(f"{cfg.name}, fp32, init_cache over 40 frames, a 24-token prompt, 6 steps",
                     serving_form, p_cpu)


def vision_serve(cfg, model, params, batch=4, n_text=768, steps=16):
    """qwen2-vl-7b with vision stubs, on the text-only phase's weights: 4
    requests of 256 patch embeddings (seeded normal x 0.02, a 16 x 16
    grid) and 768 text tokens, prefilled as one batch of 1024 positions
    into a batch-4 cache of ``VISION_MAX_LEN`` rows, then 16 greedy graphed
    steps; K7 = layers, K6 = layers x steps, K3 after the split K6 calls;
    the first 3 steps held against the eager walk (max |logits| 0)."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.models import vlm

    nv = cfg.vision_stub_tokens
    s = nv + n_text
    side = int(nv**0.5)
    log(f"== vlm phase: {cfg.name} with vision stubs: {batch} requests of {nv} patches "
        f"(grid {side} x {-(-nv // side)}) + {n_text} text tokens, one prefill of {s} "
        f"positions, {steps} graphed steps, cache of {VISION_MAX_LEN} rows ==")
    gen = torch.Generator("cuda").manual_seed(0)
    vis = (torch.randn((batch, nv, cfg.d_model), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (batch, s)))
    counters = (gd.gqa_decode_rows, fp.flash_prefill, mc.combine_split_partials)
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    seen, toks, step, prefill_s, times, held = vision_form(
        model, params, vis, tokens.cuda(), steps, VISION_MAX_LEN, hold=True)
    torch.cuda.synchronize()
    (k6, k6_mma), (k7, k7_mma), (k3, _) = read_counts(counters)
    steady = times[len(held):]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    group = cfg.n_heads // cfg.n_kv_heads
    split = gd.decode_splits(sms, batch * cfg.n_kv_heads * -(-group // 16),
                             -(-VISION_MAX_LEN // 512)) > 1
    want6, want7, want3 = cfg.n_layers * steps, cfg.n_layers, cfg.n_layers * steps * split
    pos = vlm.mrope_positions(1, s, nv, device="cpu")[:, 0]
    log(f"vision prefill {batch} x {s} positions in {prefill_s:.3f} s "
        f"({batch * s / prefill_s:.1f} tok/s); decode {steps} steps, "
        f"{1e3 * sum(times) / steps:.2f} ms/step (steady {1e3 * np.mean(steady):.2f}, median "
        f"{1e3 * np.median(steady):.2f}, {len(steady)} steps); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"M-RoPE positions: patches (t, h, w) from (0, 0, 0) to {tuple(pos[:, nv - 1].tolist())}, "
        f"text from {tuple(pos[:, nv].tolist())} to {tuple(pos[:, -1].tolist())}; the first "
        f"decode step sits at cache_len {s}, not at {int(pos[0, -1]) + 1}: "
        f"{s - int(pos[0, -1]) - 1} positions skipped (the reference's caveat, reproduced)")
    worst = max(d for d, _ in held)
    log(f"graphs: {step.graphs.captures} capture; first {len(held)} steps against the eager "
        f"walk: greedy tokens {'equal' if all(e for _, e in held) else 'DIFFER'}, max |logits "
        f"graph - eager| {worst:.3e}")
    log(f"launches: K6 {k6} ({k6_mma} tensor-core; expected layers x steps = {want6}), K7 {k7} "
        f"({k7_mma}; expected layers = {want7}), K3 {k3} (expected {want3}); tokens "
        f"{toks[:6].T.tolist()}")
    if not all(torch.isfinite(x).all() for x in seen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise SystemExit("vlm phase: non-finite logits or tokens out of range")
    if ((k6, k6_mma), (k7, k7_mma), k3) != ((want6, want6), (want7, want7), want3):
        raise SystemExit("vlm phase: kernel launch counts do not match the main path")
    if worst != 0.0 or not all(e for _, e in held) or step.graphs.captures != 1:
        raise SystemExit("vlm phase: the graphed steps are not the eager walk's")
    return k6, k7, k3


def encdec_src(cfg, batch, dev):
    """``batch`` requests of ``ENCDEC_FRAMES`` stub frame embeddings (a
    normal draw from seed 0 on ``dev``, x 0.02, bf16): the source the
    encdec phase and cell (m) serve."""
    gen = torch.Generator(dev).manual_seed(0)
    return (torch.randn((batch, ENCDEC_FRAMES, cfg.d_model), generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)


def encdec_serve(batch=4, steps=16):
    """seamless-m4t-medium at published widths (12 + 12 layers, random bf16
    weights, seed 0): 4 requests of ``ENCDEC_FRAMES`` seeded frames (x
    0.02) and a ``ENCDEC_PROMPT``-token target prompt through
    ``EncDecModel.init_cache`` (``ENCDEC_MAX_LEN`` rows) and
    ``decode_step`` (the prompt at cache_len 0, then 16 greedy steps,
    eager).  K7 = encoder layers + 2 x decoder layers (the prompt's self-
    and cross-attention), K6 = 2 x decoder layers x steps, K3 after the
    split K6 calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("seamless-m4t-medium")
    log(f"== encdec phase: {cfg.name} {cfg.encoder_layers} encoder + {cfg.n_layers} decoder "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
        f"d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab_size}, bf16, "
        f"{cfg.param_count() / 1e9:.3f} B params; {batch} requests of {ENCDEC_FRAMES} frames, "
        f"a {ENCDEC_PROMPT}-token prompt, {steps} eager steps, max_len {ENCDEC_MAX_LEN} ==")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"random bf16 weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    unembed_table_phase(model, params)
    src = encdec_src(cfg, batch, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (batch, ENCDEC_PROMPT))).cuda()
    counters = (gd.gqa_decode_rows, fp.flash_prefill, mc.combine_split_partials)
    zero_counts(counters)
    seen, toks, enc_s, prompt_s, times = encdec_form(model, params, src, prompt, steps,
                                                     ENCDEC_MAX_LEN)
    torch.cuda.synchronize()
    (k6, k6_mma), (k7, k7_mma), (k3, _) = read_counts(counters)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = lambda rows: gd.decode_splits(sms, batch * cfg.n_kv_heads, -(-rows // 512)) > 1
    want7 = cfg.encoder_layers + 2 * cfg.n_layers
    want6 = 2 * cfg.n_layers * steps
    want3 = cfg.n_layers * steps * (split(ENCDEC_MAX_LEN) + split(ENCDEC_FRAMES))
    n_src = batch * ENCDEC_FRAMES
    log(f"encoder + cross K/V of {n_src} frames in {enc_s:.3f} s ({n_src / enc_s:.1f} frames/s); "
        f"prompt of {batch} x {ENCDEC_PROMPT} tokens in {prompt_s:.3f} s "
        f"({batch * ENCDEC_PROMPT / prompt_s:.1f} tok/s); decode {steps} steps, "
        f"{1e3 * sum(times) / steps:.2f} ms/step (eager; median {1e3 * np.median(times):.2f}, "
        f"steady after the first {1e3 * np.mean(times[1:]):.2f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches: K6 {k6} ({k6_mma} tensor-core; expected 2 x decoder layers x steps = "
        f"{want6}), K7 {k7} ({k7_mma}; expected encoder layers + 2 x decoder layers = {want7}), "
        f"K3 {k3} (expected {want3}); tokens {toks[:6].T.tolist()}")
    if not all(torch.isfinite(x).all() for x in seen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise SystemExit("encdec phase: non-finite logits or tokens out of range")
    if ((k6, k6_mma), (k7, k7_mma), k3) != ((want6, want6), (want7, want7), want3):
        raise SystemExit("encdec phase: kernel launch counts do not match the main path")
    if k6 <= 0 or k7 <= 0:
        raise SystemExit("encdec phase: an attention kernel never launched")
    return k6, k7, k3


def vlm_encdec_phase():
    """The small references of both families, then qwen2-vl-7b text-only
    (``family_serve``: ServingSession(batch 4, max_len 8192), prompts of
    5, 300, 1100 and 4500 tokens) and with vision stubs on the same
    weights (``vision_serve``), then seamless-m4t-medium
    (``encdec_serve``).  Returns the K6, K7 and K3 launches."""
    t0 = time.perf_counter()
    small_vlm_encdec_check()
    release()
    totals = np.array(family_serve("qwen2-vl-7b", (5, 300, 1100, 4500), then=vision_serve))
    release()
    totals += encdec_serve()
    release()
    log(f"vlm / encdec phase: {time.perf_counter() - t0:.1f} s")
    return tuple(int(n) for n in totals)


def unembed_table_phase(model, params):
    """The fp32 copy of the embedding table that bf16 unembedding multiplies
    by, made with the parameters (``model.init``): fail unless it is there,
    on the card; print its device memory, what a logits call leaves
    allocated (its logits only: no copy of its own), and one call's time."""
    table = params.get("unembed", params["embed"])
    copy, rows = table.get("table_f32"), 4096  # compared in slices: no second full copy
    if copy is None or copy.device.type != "cuda" or not all(
            torch.equal(copy[i:i + rows], table["table"][i:i + rows].float())
            for i in range(0, copy.shape[0], rows)):
        raise SystemExit(f"{model.cfg.name}: no fp32 unembedding table made with the parameters")
    x = torch.zeros((4, 1, model.cfg.d_model), dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    logits = model.logits(params, x)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    ms = time_cuda(lambda: model.logits(params, x), 20, None)
    log(f"fp32 unembedding table ({model.cfg.name}, vocab {model.cfg.vocab_size} x "
        f"{model.cfg.d_model}): {copy.nbytes / 2**30:.3f} GiB on the card, made with the "
        f"parameters (the bf16 table is {table['table'].nbytes / 2**30:.3f} GiB); a logits call "
        f"of 4 rows leaves {grown} bytes allocated (its logits: {logits.nbytes}) and takes "
        f"{ms:.3f} ms")


def serve_phase():
    """deepseek-v2-mla at published widths through PagedServingSession.
    Returns the K2 and K3 launches, (cfg, model, params, prompt lengths,
    results) and the first decode step's logits per request."""
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
    unembed_table_phase(model, params)
    sess = PagedServingSession(model, params, num_pages=num_pages, page_size=PAGE,
                               num_splits=2, prefill_chunk=32, max_batch=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    held = hold_against_eager(sess)
    first = record_first_logits(sess)
    timing = timed_session(sess)
    mp.mla_decode_paged_queue_rows.launches = 0
    mp.mla_decode_paged_queue_rows.mma_launches = 0
    mc.combine_split_partials.launches = 0
    results, tokens_out, dt = _serve_stream(sess, list(prompts), gen_len, len(prompts))
    torch.cuda.synchronize()
    k2, k3 = mp.mla_decode_paged_queue_rows.launches, mc.combine_split_partials.launches
    k2_mma = mp.mla_decode_paged_queue_rows.mma_launches
    work = sess.work_stats()
    sweep = sess.close()
    chunks, steps = work["prefill_chunks"], work["decode_steps"]
    n_prompt = sum(prompt_lens)
    log(f"served {len(results)} requests: prefill {n_prompt} tokens in {chunks} chunks, "
        f"{timing['prefill']:.3f} s ({n_prompt / timing['prefill']:.1f} tok/s); decode "
        f"{tokens_out} tokens in {steps} steps, {timing['decode']:.3f} s "
        f"({tokens_out / timing['decode']:.2f} tok/s, "
        f"{1e3 * timing['decode'] / steps:.1f} ms/step); wall {dt:.3f} s")
    log(f"launches: K2 mla_decode_paged_queue_rows {k2} (tensor-core body {k2_mma}), K3 "
        f"combine_split_partials {k3}; expected layers x (prefill chunks + decode steps) = "
        f"{cfg.n_layers} x ({chunks} + {steps}) = {cfg.n_layers * (chunks + steps)}")
    log(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; teardown sweep "
        f"{sweep['free_pages']} pages free")
    if (k2 <= 0 or k3 <= 0 or k2 != cfg.n_layers * (chunks + steps) or k3 != k2
            or k2_mma != k2):
        raise SystemExit("serve phase: kernel launch counts do not match the main path")
    for rid, out in results.items():
        if len(out) != gen_len + 1 or not all(0 <= t < cfg.vocab_size for t in out):
            raise SystemExit(f"serve phase: request {rid} returned {out}")
    log(f"tokens: { {r: results[r][:6] for r in sorted(results)} }")
    report_held("serve phase", held, sess, timing)
    if sess.graph_captures != len(sess.step_graph.shapes):
        raise SystemExit("serve phase: expected one graph capture per (batch size, queue "
                         f"capacity) decoded, {sess.step_graph.shapes}")
    return k2, k3, (cfg, model, params, prompt_lens, results), first


# --------------------------------------------------------------------------- #
# sharded serving
# --------------------------------------------------------------------------- #


def head_chunk_kernel_check(flush):
    """K2 over each half of the 128 heads against the matching rows of the
    128-head call, bit for bit (a row's math does not depend on its
    neighbours), then K3 over each half's partials against the same rows
    of the full combine: at the serve phase's decode shape (4 requests, 2
    splits: 16-row tiles at both G) and at a prefill chunk's (32 tokens x
    128 heads = 4096 rows, where the 32-row tiles of G = 4096 become
    16-row tiles at 2048), bf16, amla and base.  Then K2 at the decode
    shape of one head chunk (G = 64) against its plain version, timed
    beside its bound, the plain version and one SDPA call.  Returns
    ({(kernel, dtype, variant): max |kernel - plain|}, the G = 64 timing
    row)."""
    log("== kernel phase: K2 and K3 over head chunks (head_shards = 2) vs the 128-head call, "
        "bit for bit ==")
    decode_lens = [37 + 16, 300 + 16, 513 + 16, 1100 + 16]
    at_end = lambda l, g: np.full((g,), l - 1)
    shapes = [("decode", decode_lens, 128, at_end, 2),
              ("prefill", [1100], 4096, prefill_positions, 1)]
    for name, lens, g, pos_fn, ns in shapes:
        for variant in ("amla", "base"):
            case = make_case(21, lens, g, torch.bfloat16, ns, pos_fn)
            o_full, lse_full = run_k2(case, variant, plain=False)
            out_full = run_k3(case, o_full, lse_full, plain=False)
            same = True
            for lo, hi in ((0, g // 2), (g // 2, g)):
                part = dict(case, q=case["q"][:, lo:hi].contiguous(),
                            q_pos=case["q_pos"][:, lo:hi].contiguous())
                o, lse = run_k2(part, variant, plain=False)
                out = run_k3(part, o, lse, plain=False)
                same &= (torch.equal(o, o_full[:, lo:hi]) and torch.equal(lse, lse_full[:, lo:hi])
                         and torch.equal(out, out_full[:, lo:hi]))
            torch.cuda.synchronize()
            log(f"  {name} {variant} G={g} -> 2 x {g // 2}: K2 partials and lse, K3 rows "
                f"{'bit-equal' if same else 'DIFFER'} to the full call's")
            if not same:
                raise SystemExit(f"head chunks: K2/K3 over {g // 2} heads differ from the "
                                 f"matching rows of the {g}-head call ({name}, {variant})")
    worst = {}
    case = make_case(11, decode_lens, 64, torch.bfloat16, 2, at_end)
    for variant in ("amla", "base"):
        hold_k2_k3(case, "chunk64", torch.bfloat16, variant, worst)
    t2 = time_cuda(lambda: run_k2(case, "amla", plain=False), 20, flush)
    t2p = time_cuda(lambda: run_k2(case, "amla", plain=True), 5, flush)
    tlib = time_cuda(sdpa_call(case), 20, flush)
    b2, by2 = k2_bound(case)
    log(f"  time decode head chunk (bf16, G=64, kv={decode_lens}): K2 {t2:.4f} ms (bound "
        f"{b2:.4f} ms by {by2}, plain {t2p:.4f} ms, SDPA on a contiguous copy {tlib:.4f} ms)")
    return worst, (t2, t2p, b2, by2, tlib)


def small_sharded_check():
    """Smoke deepseek-v2-mla (fp32, seed 3): 4 prompts and 8 greedy steps
    through one PagedServingSession on the card, ShardedPagedServingSession
    on the card (2 shards; 2 shards x 2 head chunks; 2 shards with shard 1
    failed after 3 steps, its requests replayed on shard 0, and a third
    shard attached after 5 that takes a new admission), and the 2-shard
    session on the CPU.  At fp32 compute a row's math does not depend on
    the batch it is decoded in, nor on whether a prefill chunk or a decode
    step wrote it, so the greedy tokens must be equal in all five; the
    cards' decode steps replay graphs (one set per shard)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import PagedServingSession, ShardedPagedServingSession

    cfg = get_config("deepseek-v2-mla", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator("cpu").manual_seed(3), "cpu")
    p_gpu = to_device(p_cpu, "cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 77, 23)]
    kw = dict(num_pages=48, page_size=16, block_k=32, prefill_chunk=16, num_splits=2)

    def run(sess, lose=False):
        rids = [sess.add_request(p) for p in prompts]
        for i in range(8):
            if lose and i == 3:
                moved = sess.fail_shard(1)["resumed"]
                if not moved or sess.work_stats()["replay_mismatches"]:
                    raise SystemExit("small sharded reference: the lost shard held nothing "
                                     "or a replay diverged")
            if lose and i == 5:
                sess.add_request(prompts[0])  # onto the attached shard
            sess.step()
            if lose and i == 4:
                sess.attach_shard()
        out = [list(sess.outputs[r]) for r in rids]
        pages = sum(x.cache.num_pages for x in getattr(sess, "shards", [sess]))
        return out, sess.close()["free_pages"] == pages, sess.graph_captures

    shard = lambda p, **k: ShardedPagedServingSession(model, p, shards=2, **kw, **k)
    runs = {
        "card, one session": run(PagedServingSession(model, p_gpu, **kw)),
        "card, 2 shards": run(shard(p_gpu)),
        "card, 2 shards x 2 head chunks": run(shard(p_gpu, head_shards=2)),
        "card, 2 shards, shard 1 lost after 3 steps, a shard attached after 5": run(
            shard(p_gpu), lose=True),
        "CPU, 2 shards": run(shard(p_cpu)),
    }
    want = runs["CPU, 2 shards"][0]
    log(f"small sharded reference ({cfg.name}, fp32, 4 prompts + 8 steps): greedy tokens "
        + "; ".join(f"{k}: {'equal' if v[0] == want else 'DIFFER'} ({v[2]} graph captures, "
                    f"{'every pool free' if v[1] else 'PAGES LEAKED'})"
                    for k, v in runs.items()))
    if any(v[0] != want or not v[1] for v in runs.values()) or any(
            v[2] < 1 for k, v in runs.items() if k.startswith("card")):
        raise SystemExit("small sharded reference check failed")


def record_first_logits(sess, where=None):
    """Keep the logits of ``sess``'s first graphed decode step, {rid: (vocab,)
    on the CPU}; ``where`` maps the session's local rid to a global one (a
    shard of a sharded session)."""
    graphs = sess.step_graph.graphs
    run, first = graphs.run, {}

    def rec(key, walk, eager=False):
        out = run(key, walk, eager=eager)
        if not first and not eager:
            name = where() if where is not None else {r: r for r in sess.active}
            first.update({name[r]: out[i, 0].float().cpu() for i, r in enumerate(sess.active)})
        return out

    graphs.run = rec
    return first


def shard_counts(sess, counters):
    """Per-shard launch counts of ``counters``: each shard session's
    add_request, step and adopt_suspended are wrapped to add the
    counters' growth over the call to their shard's row."""
    per = [[0] * len(counters) for _ in sess.shards]

    def wrap(i, fn):
        def call(*a, **k):
            before = [c.launches for c in counters]
            out = fn(*a, **k)
            for j, c in enumerate(counters):
                per[i][j] += c.launches - before[j]
            return out
        return call

    for i, s in enumerate(sess.shards):
        for name in ("add_request", "step", "adopt_suspended"):
            setattr(s, name, wrap(i, getattr(s, name)))
    return per


def sharded_serve(cfg, model, params, prompts, gen_len, num_pages, counters, **kw):
    """``prompts`` through ShardedPagedServingSession(shards=2, num_pages,
    **kw) and the launch/serve stream loop; ``counters`` set to 0 just
    before and counted per shard.  Returns the run's record."""
    from repro_torch.launch.serve import _serve_stream
    from repro_torch.runtime.serve_loop import ShardedPagedServingSession

    sess = ShardedPagedServingSession(model, params, shards=2, num_pages=num_pages,
                                      page_size=PAGE, num_splits=2, prefill_chunk=32,
                                      max_batch=4, **kw)
    firsts = [record_first_logits(s, lambda i=i: {v[1]: g for g, v in sess._where.items()
                                                   if v[0] == i})
              for i, s in enumerate(sess.shards)]
    per = shard_counts(sess, counters)
    t = {"prefill": 0.0, "steps": []}
    routes = [[] for _ in sess.shards]
    add, step = sess.add_request, sess.step

    def timed_add(p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = add(p)
        torch.cuda.synchronize()
        t["prefill"] += time.perf_counter() - t0
        if out is not None:
            routes[sess.shard_of(out)].append(out)
        return out

    def timed_step():
        caps = sess.graph_captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        t["steps"].append((time.perf_counter() - t0, sess.graph_captures > caps))

    sess.add_request, sess.step = timed_add, timed_step
    zero_counts(counters)
    results, tokens_out, dt = _serve_stream(sess, list(prompts), gen_len, len(prompts))
    torch.cuda.synchronize()
    work = sess.work_stats()
    if counters[0].mma_launches != sum(r[0] for r in per):
        raise SystemExit("sharded serve: a K2 launch missed the tensor-core body")
    rec = dict(results=results, work=work, per=per, wall=dt, timing=t, routes=routes,
               captures=[s.graph_captures for s in sess.shards],
               first={k: v for f in firsts for k, v in f.items()},
               head_shards=sess.head_shards)
    rec["sweep"] = sess.close()
    del sess
    release()
    return rec


def report_sharded(what, rec, cfg, single_results, single_first, first_like=None):
    """Log one sharded run: routing, tokens and first-step logits against
    the single session's, ms/step (all, and steady: the steps that
    captured no graph), balance, captures and K2/K3 per shard; fail unless
    every shard's K2 = K3 = layers x (chunks + steps) x head chunks."""
    steps = [s for s, _ in rec["timing"]["steps"]]
    steady = [s for s, cap in rec["timing"]["steps"] if not cap]
    work = rec["work"]
    res = rec["results"]
    agree = sum(agreement(single_results[r], res[r]) for r in res)
    total = sum(len(v) for v in res.values())
    base = single_first if first_like is None else first_like
    dlog = max((rec["first"][r] - base[r]).abs().max().item() for r in rec["first"])
    want = [cfg.n_layers * (st["prefill_chunks"] + st["decode_steps"]) * rec["head_shards"]
            for st in work["per_shard"]]
    log(f"{what}: requests per shard {rec['routes']}; tokens agreeing with the single session "
        f"(leading, summed) {agree} of {total}; first step max |logits - "
        f"{'single session' if first_like is None else 'data shards only'}| {dlog:.3e}; decode "
        f"{1e3 * np.mean(steps):.1f} ms/step over {len(steps)} steps, steady "
        f"{1e3 * np.mean(steady):.2f} ms/step (median {1e3 * np.median(steady):.2f}, "
        f"{len(steady)} steps); prefill {rec['timing']['prefill']:.3f} s; balance "
        f"{work['balance']['imbalance']:.3f} ({work['balance']['per_shard']} page DMAs); graph "
        f"captures per shard {rec['captures']}; K2, K3 per shard {rec['per']}, expected layers x "
        f"(chunks + steps) x {rec['head_shards']} = {want}; wall {rec['wall']:.3f} s; teardown "
        f"{rec['sweep']['free_pages']} pages free")
    for rid, out in res.items():
        if len(out) != 17 or not all(0 <= x < cfg.vocab_size for x in out):
            raise SystemExit(f"{what}: request {rid} returned {out}")
    if any(k2 != w or k3 != w for (k2, k3), w in zip(rec["per"], want)) or min(
            rec["captures"]) < 1:
        raise SystemExit(f"{what}: K2/K3 launches per shard or graph captures do not match")
    return dlog, agree, total


def partials_across_pools_check():
    """(c) One request's KV (1116 latent rows, Dk 576) split between two
    page pools at row 600: each half attended with
    ``ops.mla_decode_paged(return_partials=True)`` (fp32 q and pages, 128
    heads at the last position, 2 splits), merged with
    ``combine_shard_partials``, held against one pool holding all of it
    within 2e-3 (the split-vs-unsplit budget of AMLA's fp32 path)."""
    from repro_torch.core.distributed import combine_shard_partials
    from repro_torch.kernels import ops

    n, cut, g = 1116, 600, 128
    gen = torch.Generator("cuda").manual_seed(31)
    rows = torch.randn((n, DK), generator=gen, device="cuda")
    q = torch.randn((1, 1, g, DK), generator=gen, device="cuda")

    def pool_of(r):
        n_pages = -(-r.shape[0] // PAGE)
        pool = torch.zeros((n_pages + 1, PAGE, DK), device="cuda")
        pool.view(-1, DK)[: r.shape[0]] = r
        return pool, torch.arange(n_pages, dtype=torch.int32, device="cuda")[None]

    kw = dict(d_v=DV, scale=1.0 / math.sqrt(192), block_k=BLOCK_K, num_splits=2,
              compute_dtype=torch.float32)
    full = ops.mla_decode_paged(q, *pool_of(rows), [n], **kw)
    parts = [ops.mla_decode_paged(q, *pool_of(rows[lo:hi]), [hi - lo], return_partials=True,
                                  **kw) for lo, hi in ((0, cut), (cut, n))]
    merged = combine_shard_partials(torch.stack([o for o, _ in parts]),
                                    torch.stack([lse for _, lse in parts]))
    s = (q[0, 0] @ rows.T) / math.sqrt(192)
    lse_err = max((lse[0, 0] - torch.logsumexp(s[:, lo:hi], -1)).abs().max().item()
                  for (_, lse), (lo, hi) in zip(parts, ((0, cut), (cut, n))))
    err = (merged - full).abs().max().item()
    log(f"(c) return_partials across two pools (rows [0, {cut}) and [{cut}, {n}), fp32, G "
        f"{g}): max |merged - one pool| {err:.3e} (tol 2e-3); each half's lse against a "
        f"logsumexp of its scores {lse_err:.3e}")
    if not err <= 2e-3 or not torch.isfinite(merged).all():
        raise SystemExit("sharded phase (c): partials merged across two pools disagree")
    return err


def sharded_lifecycle(cfg, model, params, prompts, want, counters):
    """(d) fail_shard(1) after 4 decode steps re-routes its requests to
    shard 0, which replays their rows by chunked prefill and finishes all
    four; 2 steps later attach_shard() opens a third shard on the same
    parameter tensors (allocated memory grows by its pool slice only),
    which takes the next admission; the teardown leaves every pool free.

    The requests that stayed on shard 0 must give the fault-free run's
    tokens (``want``) exactly.  A moved request's rows are held as the
    chaos phase holds replayed rows: its prompt rows, prefilled on their
    original chunk boundaries, bit-equal to the copy taken before the
    loss; the rows its decode steps wrote are recomputed by a prefill
    chunk (bf16 products at M = 32, not the shard's batch), so at layer
    l they are held within 1e-2 x sqrt(l + 1) of the row's max, and its
    later tokens are printed against the fault-free run's, not gated (a
    near-tie may flip); ``replay_mismatches`` must be 0.  Token equality
    after a shard loss is gated at fp32 compute, in the small sharded
    reference."""
    from repro_torch.core.tree import leaves
    from repro_torch.runtime.serve_loop import ShardedPagedServingSession

    sess = ShardedPagedServingSession(model, params, shards=2, num_pages=64, page_size=PAGE,
                                      num_splits=2, prefill_chunk=32)
    zero_counts(counters)
    rids = [sess.add_request(p) for p in prompts]
    for _ in range(4):
        sess.step()
    moved = [r for r in rids if sess.shard_of(r) == 1]
    before = {r: pool_rows(sess.shards[1], sess._where[r][1]) for r in moved}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.fail_shard(1)
    torch.cuda.synchronize()
    t_fail = time.perf_counter() - t0
    L = cfg.n_layers
    bound = 1e-2 * np.sqrt(np.arange(1, L + 1))
    rows_ok, rows_log = True, []
    for r in moved:
        after = pool_rows(sess.shards[0], sess._where[r][1])
        n = len(prompts[r])
        exact, worst = row_diffs(before[r], after, 0, n)
        rel = layer_rel_diffs(before[r], after) if after.shape == before[r].shape else bound + 1
        rows_ok &= exact and bool(np.all(rel <= bound))
        rows_log.append(f"request {r}: prompt rows [0, {n}) {'bit-equal' if exact else 'DIFFER'}"
                        f" (max |diff| {worst:.3e}), all {after.shape[1]} rows' largest |diff| / "
                        f"max |row| {rel.max():.3e} at layer {int(np.argmax(rel))} "
                        f"({np.max(rel / bound):.3f} of 1e-2 x sqrt(layer + 1))")
    del before
    for _ in range(2):
        sess.step()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    idx = sess.attach_shard()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    new = sess.shards[idx]
    pool_bytes = new.cache.pages.nbytes
    shared = all(a is b for a, b in zip(leaves(new.params), leaves(params), strict=True))
    late = sess.add_request(prompts[0])
    home = sess.shard_of(late)
    while any(len(sess.outputs[r]) < 17 for r in rids):
        sess.step()
    peak_rise = torch.cuda.max_memory_allocated() - mem0
    outs = {r: sess.finish(r)[:17] for r in rids}
    sess.finish(late)
    kept = all(outs[r] == want[r] for r in rids if r not in moved)
    agree = {r: agreement(outs[r], want[r]) for r in rids}
    counts = [c.launches for c in counters]
    work = sess.work_stats()
    sweep = sess.close()
    log(f"(d) lifecycle: fail_shard(1) after 4 steps suspended {res['suspended']} and "
        f"re-routed {res['resumed']} onto shard 0 in {t_fail:.3f} s (replay prefill "
        f"{work['replay_prefill_tokens']} tokens, replay_mismatches {work['replay_mismatches']}); "
        f"{'; '.join(rows_log)}; tokens of the requests shard 0 kept equal to the fault-free "
        f"run: {kept}; leading agreement with the fault-free run (of 17) {agree}; "
        f"attach_shard() 2 steps later -> shard {idx} on the same parameter tensors: "
        f"{shared}, allocated +{grown / 2**20:.1f} MiB (its pool: {pool_bytes / 2**20:.1f} "
        f"MiB), peak +{peak_rise / 2**20:.1f} MiB over the next admission (which went to "
        f"shard {home}) and the steps to the end; health {sess.shard_health}; teardown "
        f"{sweep['free_pages']} of 64 + {new.cache.num_pages} pages free, per shard "
        f"{[r['free_pages'] for r in sweep['per_shard']]}")
    if (not kept or not rows_ok or res["suspended"] != moved or res["resumed"] != moved
            or not shared or home != idx or grown > pool_bytes + 2**20
            or work["replay_mismatches"] or sweep["free_pages"] != 64 + new.cache.num_pages):
        raise SystemExit("sharded phase (d): fail / attach lifecycle does not hold")
    return counts


def sharded_supervised(cfg, model, params, prompts, want, counters):
    """(e) ServeSupervisor over 2 shards with a FaultPlan that loses shard
    1 at step 3: every result complete (17 tokens), replay_mismatches 0,
    the loss applied, no page left; the tokens' agreement with the
    fault-free run printed."""
    from repro_torch.runtime.fault_injection import FaultEvent, FaultPlan
    from repro_torch.runtime.serve_loop import ServeSupervisor, ShardedPagedServingSession

    sess = ShardedPagedServingSession(model, params, shards=2, num_pages=64, page_size=PAGE,
                                      num_splits=2, prefill_chunk=32, max_batch=4)
    plan = FaultPlan([FaultEvent(step=3, kind="shard_loss", shard=1)])
    sup = ServeSupervisor(sess, gen_len=16, plan=plan)
    for p in prompts:
        sup.submit(p)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = sup.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [c.launches for c in counters]
    st = sup.stats()
    agree = {i: agreement(results[i], want[i]) for i in results}
    sweep = sess.close()
    log(f"(e) supervisor under '{plan.describe()}': completed {st['completed']}, faults "
        f"applied {st['faults_applied']} (skipped {st['faults_skipped']}), suspends "
        f"{st['suspends']}, resumes {st['resumes']}, replay prefill tokens "
        f"{st['replay_prefill_tokens']}, replay_mismatches {st['replay_mismatches']}, steps "
        f"{st['steps']}, {wall:.3f} s; health {sess.shard_health}; tokens agreeing with the "
        f"fault-free run (leading, of 17): {agree}; events {sup.events}; teardown "
        f"{sweep['free_pages']} of 64 pages free")
    if (sorted(results) != list(range(len(prompts))) or any(len(v) != 17 for v in results.values())
            or st["replay_mismatches"] or st["faults_applied"] != 1 or st["suspends"] < 1
            or st["resumes"] != st["suspends"] or sweep["free_pages"] != 64):
        raise SystemExit("sharded phase (e): the supervisor under a shard loss does not hold")
    return counts


def sharded_phase(cfg, model, params, prompt_lens, single_results, single_first):
    """deepseek-v2-mla at published widths (the paged phase's bf16 weights,
    one parameter set for every shard) through ShardedPagedServingSession:
    (a) 2 data shards over the serve phase's prompts and 32 pages (16 a
    shard), graphed; (b) the same with 2 head chunks a shard; (c)
    return_partials across two pools; (d) fail / attach lifecycle; (e) the
    supervisor under a shard loss.  Returns the K2 and K3 launches of (a),
    (b), (d) and (e)."""
    from repro_torch.kernels import mla_decode_combine as mc
    from repro_torch.kernels import mla_decode_paged as mp

    log(f"== sharded serve phase: {cfg.name} ({cfg.n_layers} layers, the paged phase's bf16 "
        f"weights shared by every shard), ShardedPagedServingSession(shards=2, num_splits=2), "
        f"page {PAGE}, chunk 32, prompts {list(prompt_lens)} ==")
    t_phase = time.perf_counter()
    counters = (mp.mla_decode_paged_queue_rows, mc.combine_split_partials)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    total = [0, 0]
    torch.cuda.reset_peak_memory_stats()
    a = sharded_serve(cfg, model, params, prompts, 16, 32, counters)
    report_sharded("(a) 2 data shards", a, cfg, single_results, single_first)
    b = sharded_serve(cfg, model, params, prompts, 16, 32, counters, head_shards=2)
    dlog, _, _ = report_sharded("(b) 2 data shards x 2 head chunks", b, cfg, single_results,
                                single_first, first_like=a["first"])
    same_b = all(b["results"][r] == a["results"][r] for r in a["results"])
    log(f"(b) tokens equal to (a): {same_b}; K2 = K3 = 2 x (a): "
        f"{[[2 * x for x in r] for r in a['per']] == b['per']}; peak memory of (a) and (b) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not same_b or [[2 * x for x in r] for r in a["per"]] != b["per"]:
        raise SystemExit("sharded phase (b): head chunks changed the tokens or the counts")
    for rec in (a, b):
        for j in range(2):
            total[j] += sum(r[j] for r in rec["per"])
    partials_across_pools_check()
    release()
    for counts in (sharded_lifecycle(cfg, model, params, prompts, a["results"], counters),
                   sharded_supervised(cfg, model, params, prompts, a["results"], counters)):
        total = [x + y for x, y in zip(total, counts)]
        release()
    log(f"sharded serve phase: {time.perf_counter() - t_phase:.1f} s; K2 {total[0]}, K3 "
        f"{total[1]} launches")
    return tuple(total)


def int8_compression_check():
    """(b') int8 gradient compression on the card: smoke deepseek-v2-mla
    and recurrentgemma-2b (scanned layer groups stacked, and a remainder
    layer), random gradient trees from seed 9 compressed for 2 steps of
    error feedback with the keys ``fold_in(PRNGKey(17), step)`` made on the
    card; the threefry noise must be drawn on the card, and the compressed
    gradients and residuals must equal the CPU's bit for bit.  Then one
    int8 ``make_train_step`` step of the smoke qwen1.5-0.5b on the card:
    a finite loss, and its residuals on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng, tree
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import compression
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

    log("== train phase (b'): int8 gradient compression on the card vs the CPU ==")
    drawn = []
    uniform = prng.uniform

    def spy(key, *a, **k):
        out = uniform(key, *a, **k)
        drawn.append(out.device.type)
        return out

    prng.uniform = spy
    try:
        for arch in ("deepseek-v2-mla", "recurrentgemma-2b"):
            cfg = get_config(arch, smoke=True)
            params, _, _ = init_train_state(build_model(cfg), torch.Generator().manual_seed(9),
                                            "cpu")
            gen = torch.Generator().manual_seed(9)
            grads = [tree.tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-2, params)
                     for _ in range(2)]
            states = {dev: compression.compression_init(to_device(params, dev), "int8")
                      for dev in ("cpu", "cuda")}
            equal, n = True, 0
            for step, g in enumerate(grads):
                outs = {}
                for dev in ("cpu", "cuda"):
                    key = prng.fold_in(prng.prng_key(17, dev), step)
                    drawn.clear()
                    outs[dev], states[dev] = compression.compress_grads(
                        to_device(g, dev), states[dev], mode="int8", rng=key, cfg=cfg)
                    if set(drawn) != {dev}:
                        raise SystemExit(f"train phase (b'): compression on {dev} drew its "
                                         f"noise on {sorted(set(drawn))}")
                for got, want in ((outs["cuda"], outs["cpu"]),
                                  (states["cuda"].residual, states["cpu"].residual)):
                    for a, b in zip(tree.leaves(got), tree.leaves(want), strict=True):
                        equal &= torch.equal(a.cpu(), b)
                        n += 1
            log(f"  {cfg.name}: {n} compressed leaves and residuals over 2 steps, card == CPU "
                f"bit for bit: {equal}; the card's noise drawn on the card")
            if not equal:
                raise SystemExit(f"train phase (b'): int8 compression on the card differs "
                                 f"from the CPU's ({cfg.name})")
        cfg = get_config("qwen1.5-0.5b", smoke=True)
        model = build_model(cfg)
        params, opt, _ = init_train_state(model, torch.Generator("cuda").manual_seed(5), "cuda")
        comp = compression.compression_init(params, "int8")
        drawn.clear()
        batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                                seed=0).batch_at(0)
        _, _, comp, m = make_train_step(model, TrainConfig(compression="int8", remat=True))(
            params, opt, comp, batch, 3)
        loss = float(m["loss"])
        res_dev = {t.device.type for t in tree.leaves(comp.residual)}
        log(f"  one int8 train step of smoke {cfg.name} on the card: loss {loss:.6f}, "
            f"grad_norm {float(m['grad_norm']):.6f}, noise drawn on {sorted(set(drawn))}, "
            f"residuals on {sorted(res_dev)}")
        if not math.isfinite(loss) or set(drawn) != {"cuda"} or res_dev != {"cuda"}:
            raise SystemExit("train phase (b'): the int8 step did not run on the card")
    finally:
        prng.uniform = uniform


# --------------------------------------------------------------------------- #
# train phase
# --------------------------------------------------------------------------- #
TRAIN_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-3}  # K7 forward vs the blockwise one


def rel_max(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def train_counters():
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as mc

    return [fp.flash_prefill, gd.gqa_decode_rows, mc.combine_split_partials]


GRAD_STEP = 2.0**-7  # one bf16 step of a tensor's largest magnitude


def train_attention_case(name, q, k, v, kw):
    """One attention Function call on the card: forward through the kernel
    (one K7 launch, tensor-core body), backward through the blockwise path;
    held against ``blockwise_attention`` and ``torch.autograd.grad``
    through it on the same inputs (bit for bit), and against that
    gradient taken on the CPU, which the CPU tests hold against JAX's
    gradient of ``impl="xla"``: within GRAD_STEP of each gradient's
    largest magnitude with fewer than 1% of elements differing, the rule
    of ``tests/test_torch_flash_core.py`` (attention's input gradients are
    rounded to bf16, and an fp32 sum in another order can round one
    element a bf16 step the other way).  Returns the forward error."""
    from repro_torch.core import attention
    from repro_torch.kernels import flash_prefill as fp

    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_ins = [t.detach().requires_grad_() for t in (q, k, v)]
    zero_counts(train_counters())
    out = attention.multi_head_attention(*ins, **kw)
    torch.cuda.synchronize()
    launches = fp.flash_prefill.launches, fp.flash_prefill.mma_launches
    ref = attention.blockwise_attention(*ref_ins, **kw)
    ct = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(9), device="cuda",
                     dtype=out.dtype)
    got = torch.autograd.grad(out, ins, ct)
    want = torch.autograd.grad(ref, ref_ins, ct)
    cpu_ins = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    cpu_want = torch.autograd.grad(attention.blockwise_attention(*cpu_ins, **kw), cpu_ins,
                                   ct.cpu())
    fwd = rel_max(out, ref)
    bwd = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    cpu_err = max(float((g.cpu().float() - w.float()).abs().max() / w.float().abs().max())
                  for g, w in zip(got, cpu_want))
    cpu_frac = max(float((g.cpu() != w).float().mean()) for g, w in zip(got, cpu_want))
    tol = TRAIN_TOL[q.dtype]
    log(f"  {name}: forward (K7) vs blockwise {fwd:.3e} (tol {tol:g}); backward vs autograd "
        f"through blockwise_attention: max |difference| {bwd:.3e} (must be 0); vs the CPU's "
        f"gradient {cpu_err:.3e} of the max (tol {GRAD_STEP:.3e}), {cpu_frac:.2e} of elements "
        f"differ (tol 1e-2); K7 launches {launches[0]} ({launches[1]} tensor-core)")
    if launches != (1, 1) or not fwd <= tol or bwd != 0.0 or not all(
            bool(torch.isfinite(g).all()) for g in got) or not (
            cpu_err < GRAD_STEP and cpu_frac < 1e-2):
        raise SystemExit(f"train phase (a): the attention Function failed at {name}")
    return fwd


def train_attention_check():
    """(a) The training attention on the card at qwen1.5-0.5b's geometry
    (16 x 64 heads, 2 x 2048 tokens, causal; amla and base; bf16 and fp32
    inputs) and at smoke deepseek-v2-mla's expanded MLA widths (Dk 48, Dv
    32, 4 heads, 2 x 256 tokens).  At the training shape (8 x 2048
    tokens, bf16 amla): K7 timed beside its bound, its plain version and
    SDPA; the blockwise backward beside SDPA's forward + backward (the
    library's fused attention with its own backward, timed only).
    Returns the worst forward error."""
    from repro_torch.core import attention

    log("== train phase (a): the attention Function vs the blockwise reference ==")
    worst = 0.0
    b, s, h, d = 2, 2048, 16, 64
    for dtype in (torch.bfloat16, torch.float32):
        for variant in ("amla", "base"):
            q, k, v = (randn((b, s, h, d), 40 + i, dtype) for i in range(3))
            kw = dict(variant=variant, causal=True, scale=d ** -0.5,
                      kv_len=np.full((b,), s, np.int32), q_offset=np.zeros((b,), np.int32))
            worst = max(worst, train_attention_case(
                f"qwen1.5-0.5b heads 16 x 64, {b} x {s} tokens, {dtype}, {variant}", q, k, v, kw))
    q, k = (randn((2, 256, 4, 48), 50 + i, torch.float32) for i in range(2))
    v = randn((2, 256, 4, 32), 52, torch.float32)
    kw = dict(variant="amla", causal=True, scale=48 ** -0.5, kv_len=np.full((2,), 256, np.int32),
              q_offset=np.zeros((2,), np.int32))
    worst = max(worst, train_attention_case(
        "smoke deepseek-v2-mla expanded (Dk 48, Dv 32: K7 at 64), fp32", q, k, v, kw))

    # timed at the training shape: one layer of qwen1.5-0.5b at batch 8 x 2048
    bt = 8
    time_dense_rows([("K7", f"qwen1.5-0.5b train {bt} x {s}", gqa_case(
        "K7", GQA_GEOMETRIES[2], bt, s, s, [s] * bt, torch.bfloat16, 60))], None)
    q, k, v = (randn((bt, s, h, d), 40 + i, torch.bfloat16).requires_grad_() for i in range(3))
    kw = dict(variant="amla", causal=True, scale=d ** -0.5, kv_len=np.full((bt,), s, np.int32),
              q_offset=np.zeros((bt,), np.int32))
    ct = randn((bt, s, h, d), 49, torch.bfloat16)
    out = attention.multi_head_attention(q, k, v, **kw)
    bwd_ms = time_cuda(lambda: torch.autograd.grad(out, (q, k, v), ct, retain_graph=True), 3,
                       None)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (q, k, v), ct.transpose(1, 2))

    sdpa_ms = time_cuda(sdpa, 10, None)
    log(f"  the attention backward of one training layer ({bt} x {s} tokens, 16 x 64 heads, "
        f"bf16 amla; blockwise recompute + autograd): {bwd_ms:.3f} ms; SDPA forward + "
        f"backward {sdpa_ms:.3f} ms (timed only)")
    return worst


def small_train_check():
    """(b) Smoke qwen1.5-0.5b and deepseek-v2-mla (the expanded MLA form),
    fp32 master weights and compute, 3 remat train steps (batch 4 x 64,
    peak lr 3e-3, warmup 1, schedule steps 1-3).  Each step is taken on
    the card and on the CPU from the CPU's state before it (parameters
    and AdamW moments), so each is held as one step, at the tolerances
    of ``tests/test_torch_train_loop.py``: the loss within 1e-5 and
    grad_norm within 1e-4 relative; the first moment within 2^-8 of each
    leaf's largest magnitude (attention's input gradients are rounded to
    bf16 on both sides, and a few roundings land a bf16 step apart); the
    parameters within the step's size, 2 lr, everywhere (Adam moves an
    element by about lr whatever its gradient, so one whose gradient is
    rounding noise, such as the K bias's, may move the other way), and
    after the first step, Adam's first, within 2e-3 of each leaf's
    largest magnitude where the CPU's first moment exceeds that 2^-8.
    Later steps are not held to that: a leaf whose whole gradient is
    noise (the K bias's, zero in exact arithmetic: softmax ignores a
    shift of a row's scores) has its largest first moment at the noise
    too, and the CPU against itself, on weights perturbed by 2e-7, moves
    such a leaf by 2.8e-2 of its largest magnitude at the second step.
    Free-running, those noise elements would make the next step's inputs
    differ; starting both from one state keeps each comparison to its
    step."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

    def opt_to(o, dev):
        return AdamWState(o.count.to(dev), to_device(o.mu, dev), to_device(o.nu, dev))

    log("== train phase (b): smoke models, 3 train steps, card vs CPU, each from the CPU's "
        "state ==")
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10, remat=True)
    mu_tol, p_tol = 2.0**-8, 2e-3
    for arch in ("qwen1.5-0.5b", "deepseek-v2-mla"):
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        step = make_train_step(model, tc)
        params, opt, _ = init_train_state(model, torch.Generator("cpu").manual_seed(5), "cpu")
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0)
        losses = ([], [])
        l_err = n_err = mu_err = p_err = step_err = 0.0
        for i in range(3):
            batch = data.batch_at(i)
            cp, co, _, cm = step(params, opt, None, batch, i + 1)
            gp, go, _, gm = step(to_device(params, "cuda"), opt_to(opt, "cuda"), None, batch,
                                 i + 1)
            gp, go = to_device(gp, "cpu"), opt_to(go, "cpu")
            lr = float(cm["lr"])
            losses[0].append(float(gm["loss"]))
            losses[1].append(float(cm["loss"]))
            l_err = max(l_err, abs(float(gm["loss"]) / float(cm["loss"]) - 1))
            n_err = max(n_err, abs(float(gm["grad_norm"]) / float(cm["grad_norm"]) - 1))
            for a, b, mg, mc in zip(tree.leaves(gp), tree.leaves(cp), tree.leaves(go.mu),
                                    tree.leaves(co.mu), strict=True):
                mu_err = max(mu_err, float((mg - mc).abs().max() / mc.abs().max()))
                d = (a - b).abs()
                resolved = mc.abs() > mu_tol * mc.abs().max()
                if i == 0 and bool(resolved.any()):
                    p_err = max(p_err, float(d[resolved].max() / b.abs().max()))
                step_err = max(step_err, float(d.max()) / (2 * lr))
            params, opt = cp, co
        log(f"  {cfg.name}: losses card {[round(x, 6) for x in losses[0]]}, CPU "
            f"{[round(x, 6) for x in losses[1]]}: max relative difference {l_err:.3e} (tol 1e-5); "
            f"grad_norm {n_err:.3e} (tol 1e-4); first moment {mu_err:.3e} of the leaf max "
            f"(tol {mu_tol:.3e}); first step's parameters where the gradient is resolved "
            f"{p_err:.3e} of the leaf max (tol {p_tol:g}); every step's parameters "
            f"{step_err:.3f} x 2 lr (tol 1)")
        if not (l_err <= 1e-5 and n_err <= 1e-4 and mu_err < mu_tol and p_err <= p_tol
                and step_err <= 1 + 1e-4):
            raise SystemExit(f"train phase (b): {cfg.name} on the card disagrees with the CPU")


MOE_LAYER_TOL = 2.0**-7  # expert weight gradients, one layer, same inputs (bf16-rounded)
MOE_STEP_TOL = (2e-3, 2e-2, 5e-2)  # a train step from one state: loss, grad_norm, expert moments


def moe_train_check():
    """(b'') Smoke qwen3-moe-30b-a3b at bf16 compute over fp32 master
    weights, whose expert products take bf16 inputs to fp32 outputs: on
    the card through ``moe._WideProducts`` (cuBLAS's ``out_dtype``
    product, with a hand-written gradient, since PyTorch has none), on the
    CPU through the widened product, whose gradient
    ``tests/test_torch_moe.py`` holds against ``jax.grad`` of the
    reference.  (1) One MoE layer, the same bf16 weights, fp32 input and
    cotangent on both: each expert weight's gradient within MOE_LAYER_TOL
    of its largest magnitude (both round it to bf16).  (2) One train step
    from one state on each: the loss and grad_norm within MOE_STEP_TOL
    relative, and the expert leaves' first moments (0.1 x the clipped
    gradient) within MOE_STEP_TOL in norm (attention differs by bf16
    roundings between the kernels and the CPU, which may move a token to
    another expert)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

    log("== train phase (b''): smoke qwen3-moe-30b-a3b at bf16 compute, expert gradients, "
        "card vs CPU ==")
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True), dtype="bfloat16")
    model = build_model(cfg)
    params, opt, _ = init_train_state(model, torch.Generator("cpu").manual_seed(5), "cpu")
    gen = torch.Generator("cpu").manual_seed(6)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    cot = torch.randn((4, 64, cfg.d_model), generator=gen)
    grads = []
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, torch.bfloat16).requires_grad_() for k, v in
             params["layers"][0]["mlp"].items()}
        out, aux = moe.moe_apply(p, x.to(dev), cfg=cfg, dtype=torch.bfloat16)
        (torch.sum(out * cot.to(dev)) + aux).backward()
        grads.append({k: v.grad.float().cpu() for k, v in p.items()})
    layer_err = {k: float((grads[1][k] - grads[0][k]).abs().max() / grads[0][k].abs().max())
                 for k in ("gate", "up", "down", "router")}

    tc = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10, remat=True)
    step = make_train_step(model, tc)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                            seed=0).batch_at(0)
    _, co, _, cm = step(params, opt, None, batch, 1)
    gopt = AdamWState(opt.count.cuda(), to_device(opt.mu, "cuda"), to_device(opt.nu, "cuda"))
    _, go, _, gm = step(to_device(params, "cuda"), gopt, None, batch, 1)
    l_err = abs(float(gm["loss"]) / float(cm["loss"]) - 1)
    n_err = abs(float(gm["grad_norm"]) / float(cm["grad_norm"]) - 1)
    experts = [(mc, mg.cpu()) for (path, mc), mg in
               zip(tree.leaves_with_paths(co.mu), tree.leaves(go.mu), strict=True)
               if "mlp" in str(path) and mc.dim() == 3]  # the experts' gate, up, down
    mu_err = max(float((mg - mc).norm() / mc.norm()) for mc, mg in experts)
    log("  one MoE layer: expert gradients card vs CPU, max |diff| / max |CPU| "
        + ", ".join(f"{k} {v:.3e}" for k, v in layer_err.items()) + f" (tol {MOE_LAYER_TOL:.3e})")
    log(f"  one train step: loss card {float(gm['loss']):.6f} CPU {float(cm['loss']):.6f} "
        f"(rel {l_err:.3e}, tol {MOE_STEP_TOL[0]:g}); grad_norm rel {n_err:.3e} (tol "
        f"{MOE_STEP_TOL[1]:g}); expert first moments |diff| / |CPU| {mu_err:.3e} (tol "
        f"{MOE_STEP_TOL[2]:g})")
    if not (max(layer_err.values()) <= MOE_LAYER_TOL and l_err <= MOE_STEP_TOL[0]
            and n_err <= MOE_STEP_TOL[1] and mu_err <= MOE_STEP_TOL[2]
            and len(experts) == 3 * cfg.n_layers):
        raise SystemExit("train phase (b''): MoE expert gradients on the card disagree with the "
                         "CPU")


def train_phase(card):
    """(c) qwen1.5-0.5b at full width: 10 train steps on the card (``card``:
    its name and power limit, printed beside the numbers).  Returns (cfg,
    model, params, opt, launches (K7, K6, K3), the step's TrainConfig, its
    data and its steady ms/step)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline import analysis
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

    cfg = get_config("qwen1.5-0.5b")
    b, s, steps = 8, 2048, 10
    n = cfg.param_count()
    log(f"== train phase (c): {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} x {cfg.head_dim} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n / 1e9:.3f} B parameters (fp32 master, bf16 compute), batch {b} x {s}, remat, "
        f"{cfg.attn_variant}, {steps} steps ==")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, opt, comp = init_train_state(model, torch.Generator("cuda").manual_seed(0), "cuda")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=0)
    step = make_train_step(model, TrainConfig(peak_lr=3e-4, warmup_steps=2, total_steps=steps,
                                              remat=True))
    counters = train_counters()
    losses, times = [], []
    torch.cuda.synchronize()
    zero_counts(counters)
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, comp, m = step(params, opt, comp, data.batch_at(i), i)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"  step {i}: loss {loss:.4f} grad_norm {float(m['grad_norm']):.4f} lr "
            f"{float(m['lr']):.3e} ({1e3 * times[-1]:.1f} ms)")
    launches = read_counts(counters)
    (k7, k7_mma), (k6, _), (k3, _) = launches
    ms = 1e3 * float(np.mean(times[1:]))
    tokens = b * s
    flops = analysis.model_flops(cfg, ShapeConfig("chip_train", s, b, "train"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    share = flops / (ms / 1e3) / analysis.PEAK_FLOPS
    log(f"steady {ms:.1f} ms/step (steps 2-{steps}; first {1e3 * times[0]:.1f} ms), "
        f"{tokens / (ms / 1e3):.1f} tokens/s, peak {peak:.2f} GiB; model FLOPs "
        f"(roofline.analysis.model_flops: 6 N T + causal attention) = "
        f"{flops / 1e12:.2f} TFLOP/step, "
        f"{100 * share:.2f} % of the bf16 dense peak (989 TFLOP/s); card {card}")
    want = cfg.n_layers * 2 * steps
    log(f"launches: K7 {k7} ({k7_mma} tensor-core; expected layers x 2 x steps = {want}: the "
        f"forward and the remat recompute), K6 {k6}, K3 {k3}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"train phase: losses {losses} not finite or not lower at the end")
    if (k7, k7_mma, k6, k3) != (want, want, 0, 0):
        raise SystemExit("train phase: kernel launch counts do not match the main path")
    return cfg, model, params, opt, (k7, k6, k3), (step, data, ms)


def train_serve_handoff(cfg, model, params, opt):
    """(d) The trained state saved through ``CheckpointManager(async_save=
    True)`` under ``build/train_ckpt`` (removed after) and restored (bit
    for bit); ``serving_params`` of it (bf16 weights, the fp32 table copy
    from the trained table) and of the in-memory parameters each serve 4
    prompts x 8 greedy tokens through ``ServingSession`` (batch 4,
    max_len 2048): equal tokens.  Returns the serve path's launches (K7,
    K6, K3) of the restored tree's run."""
    import shutil

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import tree
    from repro_torch.runtime.serve_loop import ServingSession
    from repro_torch.runtime.train_loop import serving_params

    log("== train phase (d): checkpoint, restore, serve ==")
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    state = {"params": params, "opt": opt}
    mgr = CheckpointManager(ckpt_dir, keep=1, async_save=True)
    t0 = time.perf_counter()
    mgr.save(10, state)
    t_copy = time.perf_counter() - t0
    mgr.wait()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, restored = mgr.restore_latest(state)
    t_read = time.perf_counter() - t0
    nbytes = sum(x.nbytes for x in tree.leaves(state))
    same = step == 10 and all(torch.equal(a, b) for a, b in zip(tree.leaves(restored),
                                                                 tree.leaves(state)))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"checkpoint of {nbytes / 2**30:.2f} GiB: host copy {t_copy:.1f} s, written by "
        f"{t_write:.1f} s, restored in {t_read:.1f} s; restored == saved: {same}")
    if not same:
        raise SystemExit("train phase (d): the restored state differs from the saved one")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 300, 700)]
    counters = train_counters()
    outs, launches = [], None
    for which in (restored["params"], params):
        sp = serving_params(which, cfg)
        sess = ServingSession(model, sp, batch_size=4, max_len=2048)
        zero_counts(counters)
        rids = [sess.add_request(p) for p in prompts]
        for _ in range(7):
            sess.step()
        outs.append([sess.finish(r) for r in rids])
        torch.cuda.synchronize()
        launches = launches or read_counts(counters)
        del sess, sp
        release()
    (k7, _), (k6, _), (k3, _) = launches
    log(f"served 4 prompts x 8 greedy tokens from the restored and from the in-memory trained "
        f"parameters: tokens equal: {outs[0] == outs[1]}; {[o[:8] for o in outs[0]]}; "
        f"launches K7 {k7}, K6 {k6}, K3 {k3}")
    if outs[0] != outs[1] or not all(len(o) == 8 for o in outs[0]) or min(k7, k6, k3) <= 0:
        raise SystemExit("train phase (d): the restored parameters do not serve the trained "
                         "model's tokens")
    return k7, k6, k3


def train_phases(card):
    """(a)-(d) on ``card`` (its name and power limit).  Returns (worst
    forward error of (a), main-path launches of K7, K6 and K3 in (c), (c')
    and (d))."""
    t0 = time.perf_counter()
    worst = train_attention_check()
    release()
    small_train_check()
    release()
    moe_train_check()
    release()
    int8_compression_check()
    release()
    cfg, model, params, opt, (k7, k6, k3), train_cell = train_phase(card)
    roofline_train_cell(cfg, model, params, opt, *train_cell, card)
    release()
    k7m, k6m, k3m = mesh_train_check(cfg, model, params, opt)
    release()
    k7d, k6d, k3d = train_serve_handoff(cfg, model, params, opt)
    del params, opt
    release()
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return worst, (k7 + k7m + k7d, k6 + k6m + k6d, k3 + k3m + k3d)


# --------------------------------------------------------------------------- #
# the roofline: one step counted on the card and on meta, bounds beside times
# --------------------------------------------------------------------------- #
ROOFLINE_REL = 1e-6  # card count against meta count, flops and bytes


def counted(fn):
    """``(fn(), the OpCounter it ran under)``."""
    from repro_torch.roofline.op_cost import OpCounter

    with OpCounter() as c:
        out = fn()
    return out, c


def hold_counts(what, card_c, meta_c, card):
    """Print the card's and the meta count (every kernel wrapper's charge
    beside them) and fail unless flops and bytes agree within
    ROOFLINE_REL and the same kernels were charged."""
    for where, c in (("card", card_c), ("meta", meta_c)):
        charges = "; ".join(f"{k} x{c.launches[k]}: {v.flops:.6e} flops, {v.bytes:.6e} bytes"
                            for k, v in sorted(c.charges.items()))
        log(f"  {what}, {where} count: {c.cost.flops:.6e} flops, {c.cost.bytes:.6e} bytes "
            f"(+ casts {c.cost.cast_bytes:.6e}), {c.n_ops} aten ops; kernel charges: {charges}")
    rel = max(abs(card_c.cost.flops - meta_c.cost.flops) / meta_c.cost.flops,
              abs(card_c.cost.bytes - meta_c.cost.bytes) / meta_c.cost.bytes)
    same = sorted(card_c.launches.items()) == sorted(meta_c.launches.items())
    log(f"  {what}: card count = meta count within {rel:.3e} (gate {ROOFLINE_REL:g}); the same "
        f"kernel launches charged: {same}; card {card}")
    if rel > ROOFLINE_REL or not same:
        raise SystemExit(f"roofline phase: {what}'s card count differs from its meta count")


def report_bound(what, cost, ms, mf, card):
    """The three roofline terms of one card's ``cost``, the dominant one,
    and ``ms`` over the bound; returns the terms."""
    from repro_torch.roofline import analysis

    t = analysis.roofline_from_cost(cost, model_flops_total=mf, n_chips=1)
    log(f"  {what} roofline (one card, datasheet peaks): compute {1e3 * t.compute_s:.3f} ms, "
        f"memory {1e3 * t.memory_s:.3f} ms, collective {1e3 * t.collective_s:.3f} ms; dominant "
        f"{t.dominant}, bound {1e3 * t.bound_time_s:.3f} ms; measured {ms:.3f} ms = "
        f"{ms / (1e3 * t.bound_time_s):.2f} x the bound; useful flops {t.useful_ratio:.3f}; "
        f"card {card}")
    return t


def roofline_train_cell(cfg, model, params, opt, step, data, ms, card):
    """(a), (b) for the train phase's cell: one more step from its state
    (untimed, its result dropped) counted on the card, the same step on
    meta parameters and batch, the roofline beside the steady ms/step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline import analysis

    log("== roofline phase (a, b): the train cell, qwen1.5-0.5b 8 x 2048, remat ==")
    batch = {k: torch.as_tensor(v).long().cuda() for k, v in data.batch_at(10).items()}
    torch.cuda.synchronize()
    _, card_c = counted(lambda: step(params, opt, None, batch, 10))
    torch.cuda.synchronize()
    pm = model.init(None, "meta", dtype=torch.float32)
    om = adamw_init(pm)
    mb = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    t0 = time.perf_counter()
    _, meta_c = counted(lambda: step(pm, om, None, mb, 10))
    log(f"  meta count in {time.perf_counter() - t0:.1f} s of host time")
    hold_counts("train step", card_c, meta_c, card)
    b, s = batch["tokens"].shape
    mf = analysis.model_flops(cfg, ShapeConfig("chip_train", s, b, "train"))
    report_bound("train step", meta_c.cost, ms, mf, card)
    log(f"  model FLOPs {mf / 1e12:.2f} TFLOP/step: "
        f"{100 * mf / (ms / 1e3) / analysis.PEAK_FLOPS:.2f} % of the bf16 dense peak at the "
        f"measured {ms:.1f} ms/step; card {card}")


def roofline_decode_cell(cfg, model, params, card):
    """(a), (b) for the dense deepseek-v2-mla decode step at batch 4 over
    a 2048-row cache filled to its length (every key live on both sides):
    counted on the card (the paged phase's weights) and on meta; the
    eager step timed (2 warm-ups, then 5 with a sync each)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import analysis

    b, s = 4, 2048
    log(f"== roofline phase (a, b): the dense {cfg.name} decode step, batch {b}, cache of "
        f"{s} rows filled ==")
    cache = model.init_cache(params, b, s)
    tokens = torch.randint(2, cfg.vocab_size, (b, 1), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
    decode = lambda p, c, t: model.decode_step(p, c, t, s - 1)
    torch.cuda.synchronize()
    _, card_c = counted(lambda: decode(params, cache, tokens))
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(params, cache, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times[2:]))
    del cache
    pm = model.init(None, "meta")
    cm = model.init_cache(pm, b, s)
    tm = torch.empty((b, 1), dtype=torch.int64, device="meta")
    _, meta_c = counted(lambda: decode(pm, cm, tm))
    hold_counts("decode step", card_c, meta_c, card)
    mf = analysis.model_flops(cfg, ShapeConfig("chip_decode", s, b, "decode"))
    t = report_bound("decode step (eager, median of 5)", meta_c.cost, ms, mf, card)
    floor = cfg.param_count() * 2 / analysis.HBM_BW
    log(f"  memory term {1e3 * t.memory_s:.3f} ms against the weights' read, "
        f"{cfg.param_count() / 1e9:.2f} B bf16 parameters at 3.35 TB/s = {1e3 * floor:.3f} ms")
    if t.memory_s < floor:
        raise SystemExit("roofline phase: the decode step's memory term is below its weights' read")


def dryrun_cli_check(card):
    """(c) The dry-run CLI on the card's host: one full-width cell counted
    on meta stand-ins."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--archs", "qwen1.5-0.5b",
           "--shapes", "decode_32k", "--meshes", "single",
           "--out", os.path.join(root, "build", "dryrun_torch")]
    log(f"== roofline phase (c): {' '.join(cmd[1:])} ==")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                       env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        if line.startswith(("[OK]", "[FAIL]", "dry-run complete")):
            log(f"  {line}")
    log(f"  exit {r.returncode}, {wall:.1f} s wall; card {card}")
    if r.returncode != 0 or "[OK]" not in r.stdout or " 0 failed" not in r.stdout:
        raise SystemExit(f"roofline phase (c): the dry run failed: {r.stderr[-1500:]}")


# --------------------------------------------------------------------------- #
# the mesh side: split-KV decode, seqkv serving, the 1 x 1 mesh factories
# --------------------------------------------------------------------------- #
SPLIT_KV_LENS = (4096, 8192, 16384, 32000)  # qwen2.5-3b, batch 4 over a 32768-row cache
SPLIT_KV_SHARDS = (1, 2, 4)
SPLIT_KV_REL = 5e-3  # tests/test_perf_paths.py's rel_err bound, here per request row
SEQKV_MIN_TOKENS = 60  # of the seqkv phase's 4 x 16 greedy tokens equal to plain's


def split_kv_inputs(dtype, b=4, s=32768):
    """qwen2.5-3b's decode step (16 / 2 heads of 128): q (B, 1, 16, 128)
    at the last position below each kv_len, a (B, 2, S, 128) cache."""
    _, hq, hkv, dh, _, _ = GQA_GEOMETRIES[1]
    q = randn((b, 1, hq, dh), 700, dtype)
    k = randn((b, hkv, s, dh), 701, dtype)
    v = randn((b, hkv, s, dh), 702, dtype)
    lens = torch.as_tensor(SPLIT_KV_LENS, device="cuda")
    return q, k, v, lens, dict(scale=1.0 / math.sqrt(dh), kv_len=lens, q_offset=lens - 1)


def k6_outputs(dtype=torch.bfloat16):
    """K6 without partials (and, over more than one split, K3) at the
    split-KV shapes, amla and base: {variant: (B, Hkv, G, Dh) fp32}.  Run
    under another tree's ``src`` first on ``sys.path``, it gives that tree's
    numbers for a bit-for-bit A/B."""
    from repro_torch.kernels import gqa_decode as gd

    q, k, v, lens, kw = split_kv_inputs(dtype)
    b, _, hq, dh = q.shape
    hkv = k.shape[1]
    rows = q.reshape(b, hkv, hq // hkv, dh)  # Sq = 1: row j of head h is query head h * G + j
    pos = (lens - 1)[:, None].expand(b, hq // hkv).to(torch.int32)
    return {var: gd.gqa_decode_rows(rows, k, v, lens, pos, variant=var, scale=kw["scale"])
            for var in ("amla", "base")}


class plain_k6:
    """Within it, the split-KV decode's K6 is its plain version walked in
    the kernel's own splits (``attend_plain`` on the card's tensors)."""

    def __enter__(self):
        from repro_torch.core import distributed as dist
        from repro_torch.kernels import gqa_decode as gd

        def plain(q, k, v, kv_len, q_pos, *, block_k, return_partials, **kw):
            blk = min(block_k, max(k.shape[2], 128))
            return gd.attend_plain(q, k, v, kv_len, q_pos, block_k=blk,
                                   num_splits=gd.split_count(q, k, blk),
                                   return_partials=return_partials, **kw)

        self.dist, self.kernel = dist, dist.gqa_decode_rows
        dist.gqa_decode_rows = plain

    def __exit__(self, *exc):
        self.dist.gqa_decode_rows = self.kernel


def k6_ab(other_src):
    """K6 without partials (:func:`k6_outputs`, bf16 and fp32, amla and
    base) from another tree's ``src`` and from this one's, in the order
    other, this, this, other, each in a process of its own with its tree's
    ``src`` first on ``sys.path`` (each tree builds its own library under
    its own ``build/``).  Prints the sha256 of every output; returns
    whether all four runs are equal bit for bit."""
    import hashlib

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "k6_ab")
    os.makedirs(out_dir, exist_ok=True)
    trees = {"other": os.path.abspath(other_src), "this": os.path.join(here, "src")}
    log(f"== K6 A/B: {trees['other']} against {trees['this']} (other, this, this, other) ==")
    runs = []
    for i, name in enumerate(("other", "this", "this", "other")):
        path = os.path.join(out_dir, f"{i}_{name}.pt")
        code = ("import sys, torch; sys.path[:0] = [%r, %r]; import chip_smoke as c; "
                "torch.save({f'{d} {v}': t.cpu() for d in (torch.bfloat16, torch.float32) "
                "for v, t in c.k6_outputs(d).items()}, %r)" % (trees[name], here, path))
        subprocess.run([sys.executable, "-c", code], check=True, cwd=here)
        got = torch.load(path)
        digest = {key: hashlib.sha256(t.numpy().tobytes()).hexdigest() for key, t in got.items()}
        log(f"  run {i} ({name}): " + ", ".join(f"{k} {h[:16]}" for k, h in digest.items()))
        runs.append(digest)
    same = all(r == runs[0] for r in runs)
    log(f"  K6 without partials bit-equal across the two trees and their repeats: {same}")
    return same


def split_kv_row_errors(got, ref):
    """Errors scaled by each request row's own output (a row's values
    shrink as 1 / sqrt(kv_len): ~0.01 at 32000 random keys): the worst over
    rows b of ||got_b - ref_b|| / ||ref_b|| and of max |got_b - ref_b| /
    max |ref_b|, and max |got - ref|."""
    d = (got - ref).double().reshape(got.shape[0], -1)
    r = ref.double().reshape(ref.shape[0], -1)
    rel = (d.norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)).max().item()
    top = (d.abs().amax(dim=1) / r.abs().amax(dim=1).clamp_min(1e-30)).max().item()
    return rel, top, d.abs().max().item()


def split_kv_kernel_check(flush):
    """(a) Split-KV decode (``core.distributed.gqa_split_kv_decode``: K6
    with ``return_partials`` per sequence shard + one LSE merge) at
    qwen2.5-3b's decode shape over 1, 2 and 4 logical shards of a 32768-row
    cache, bf16 and fp32, amla and base: against its plain version (K6's
    plain version in the kernel's splits, the same merge) and the
    monolithic K6 (+ K3) call rounded to the output's dtype; K6 without
    partials bit-equal to its partials merged by K3 (the parent's path).
    Gate: per request row, ||err|| within SPLIT_KV_REL of ||ref|| (the
    output's scale falls with kv_len, so an absolute bound alone would pass
    a wrong merge at 32000 keys), and max |err| within the absolute TOL.
    The gate must reject two wrong merges of the monolithic call's own
    split partials (lse weights ignored, one split left out), or the check
    fails: they show that it can.  bf16 amla timed behind the 2 ms sleep
    beside the monolithic call, the plain version and one SDPA call.
    Returns (worst absolute error per kind, {n: (ms, plain ms, bound ms,
    bound by, SDPA ms)}, monolithic ms)."""
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as comb
    from repro_torch.launch.mesh import logical_mesh

    log("== split-KV kernel check: qwen2.5-3b decode (B 4, 16 / 2 heads x 128, a "
        f"{split_kv_inputs.__defaults__[1]}-row cache, kv_len {SPLIT_KV_LENS}) over "
        f"{SPLIT_KV_SHARDS} logical sequence shards; gate per request row: rel "
        f"<= {SPLIT_KV_REL:g}, max |err| <= TOL ==")
    worst, timed = {}, {}
    mono_ms = None
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, lens, kw = split_kv_inputs(dtype)
        b, _, hq, dh = q.shape
        hkv, g = k.shape[1], hq // k.shape[1]
        rows = q.reshape(b, hkv, g, dh)
        pos = (lens - 1)[:, None].expand(b, g).to(torch.int32)
        mono = k6_outputs(dtype)
        as_out = lambda x: x.reshape(b, hkv, 1, g, dh).transpose(1, 2).reshape(
            b, 1, hq, dh).to(dtype).float()  # (B, Hkv, G, Dh) fp32 -> the output's rows
        for variant in ("amla", "base"):
            tol = TOL[(dtype, variant)]
            o, lse = gd.gqa_decode_rows(rows, k, v, lens, pos, variant=variant,
                                        scale=kw["scale"], return_partials=True)
            splits = o.shape[0]
            merged = (comb.combine_split_partials(
                o.reshape(splits * b * hkv, g, dh), lse.reshape(splits * b * hkv, g, 1),
                *gd.split_tables(b * hkv, splits, q.device)).view(b, hkv, g, dh)
                if splits > 1 else o[0])
            bits = torch.equal(merged, mono[variant])
            want = as_out(mono[variant])
            errs, fails = [], []
            for n in SPLIT_KV_SHARDS:
                mesh = logical_mesh({"data": 1, "model": n}, "cuda")
                call = lambda: dist.gqa_split_kv_decode(q, k, v, mesh=mesh, variant=variant,
                                                        kv_layout="bhsd", **kw)
                got = call().float()
                with plain_k6():
                    ref = call().float()
                e_plain, e_mono = split_kv_row_errors(got, ref), split_kv_row_errors(got, want)
                errs.append((n, e_plain, e_mono))
                for kind, e in (("plain", e_plain), ("monolithic", e_mono)):
                    worst[kind] = max(worst.get(kind, 0.0), e[2])
                    worst[kind, "rel"] = max(worst.get((kind, "rel"), 0.0), e[0])
                    worst[kind, "top"] = max(worst.get((kind, "top"), 0.0), e[1])
                if not (all(e[0] <= SPLIT_KV_REL and e[2] <= tol for e in (e_plain, e_mono))
                        and torch.isfinite(got).all()):
                    fails.append(n)
                if dtype == torch.bfloat16 and variant == "amla":
                    with plain_k6():
                        plain_ms = time_cuda(call, 3, flush)
                    ms = time_cuda(call, 20, flush)
                    timed[n] = (ms, plain_ms, *bound(charged(call, "gqa_decode_rows"), dtype),
                                split_kv_sdpa(q, k, v, kw, flush))
            log(f"  {str(dtype).split('.')[1]} {variant}: K6 at {splits} splits; without "
                f"partials == its partials merged by K3 bit for bit: {bits}; per shard count "
                "n: (rel, max |err| / max |ref|, max |err|) against plain; against the "
                "monolithic K6: "
                + "; ".join(f"{n}: ({a[0]:.2e}, {a[1]:.2e}, {a[2]:.3e}); ({m[0]:.2e}, "
                            f"{m[1]:.2e}, {m[2]:.3e})" for n, a, m in errs)
                + f" (rel {SPLIT_KV_REL:g}, tol {tol:g})")
            if splits > 1:  # wrong merges of the same partials must fail the gate
                live = lse > dist.EMPTY_LSE
                dropped = lse.clone()
                dropped[0] = -math.inf
                for what, l_bad in (("lse weights ignored", torch.where(live, 0.0, lse)),
                                    ("split 0 left out", dropped)):
                    bad = split_kv_row_errors(as_out(dist.combine_shard_partials(o, l_bad)),
                                              want)
                    log(f"    control, {what}: rel {bad[0]:.3e}, max |err| / max |ref| "
                        f"{bad[1]:.3e}, max |err| {bad[2]:.3e}: "
                        f"{'rejected' if bad[0] > SPLIT_KV_REL else 'PASSES the gate'}")
                    worst["control rel"] = min(worst.get("control rel", math.inf), bad[0])
                    if bad[0] <= SPLIT_KV_REL:
                        raise SystemExit(f"split-KV kernel check: a merge with {what} passes "
                                         "the gate; the check cannot fail a wrong merge")
            if fails:
                raise SystemExit(f"split-KV kernel check: {dtype} {variant} over {fails} "
                                 "shards outside the gate (readings above)")
            if not bits:
                raise SystemExit("split-KV kernel check: K6 without partials differs from its "
                                 "partials merged by K3")
            if dtype == torch.bfloat16 and variant == "amla":
                mono_ms = time_cuda(lambda: gd.gqa_decode_rows(
                    rows, k, v, lens, pos, variant=variant, scale=kw["scale"]), 20, flush)
        del q, k, v, mono
        release()
    for n, (ms, plain_ms, bms, by, sdpa) in timed.items():
        log(f"  bf16 amla over {n} shard(s): {ms:.4f} ms (K6 x {n} + merge; plain "
            f"{plain_ms:.3f} ms; bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f} % of it; one "
            f"SDPA call {sdpa:.4f} ms); the monolithic K6 + K3 call {mono_ms:.4f} ms")
    log("  worst over dtypes, variants and shard counts: "
        + ", ".join(f"{k if isinstance(k, str) else ' '.join(k)} {v:.3e}"
                    for k, v in worst.items()))
    return worst, timed, mono_ms


def split_kv_sdpa(q, k, v, kw, flush):
    """One scaled_dot_product_attention call on the same rows (GQA by
    enable_gqa, kv_len as a boolean mask), timed as a yardstick."""
    f = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)  # (B, Hq, 1, Dh)
    mask = torch.arange(k.shape[2], device="cuda")[None, None, None, :] < kw["kv_len"][
        :, None, None, None]
    return time_cuda(lambda: f(qt, k, v, attn_mask=mask, scale=kw["scale"], enable_gqa=True),
                     20, flush)


def seqkv_decode(model, params, cache, tokens, cache_len, steps, decode, mesh):
    """``steps`` greedy decode steps from ``tokens`` / ``cache_len`` (host
    arrays) through ``decode`` (``model.decode_step`` or a compiled decode),
    under ``mesh_ctx(mesh, "seqkv")`` when ``mesh`` is given.  Returns
    (tokens per step (B, steps) list, first step's logits on the CPU, ms per
    step)."""
    import contextlib

    from repro_torch.runtime.mesh_ctx import mesh_ctx

    ctx = mesh_ctx(mesh, "seqkv") if mesh is not None else contextlib.nullcontext()
    out, first, times = [], None, []
    tok, lens = np.array(tokens), np.array(cache_len)
    with ctx:
        for _ in range(steps):
            t = torch.as_tensor(tok[:, None], dtype=torch.int64, device=cache[0]["k"].device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = decode(params, cache, t, lens)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            times.append(1e3 * (time.perf_counter() - t0))
            if first is None:
                first = logits[:, -1].float().cpu()
            out.append(nxt.tolist())
            tok, lens = nxt, lens + 1
    return out, first, times


def small_seqkv_check():
    """Smoke qwen2.5-3b (fp32 weights, seed 6): 4 ragged prompts into a
    ServingSession (max_len 64), then 8 greedy steps under
    ``mesh_ctx(seqkv)`` over 4 logical shards, on the card and on the CPU:
    equal tokens (attention takes bf16 inputs on both, as in the plain
    path)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve_loop import ServingSession

    cfg = get_config("qwen2.5-3b", smoke=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator("cpu").manual_seed(6), "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 40, 17, 60)]
    outs = {}
    for where, dev in (("card", "cuda"), ("CPU", "cpu")):
        params = p_cpu if dev == "cpu" else to_device(p_cpu, "cuda")
        sess = ServingSession(model, params, batch_size=4, max_len=64)
        for p in prompts:
            sess.add_request(p)
        outs[where] = seqkv_decode(model, params, sess.cache, sess.last_token, sess.cache_len, 3,
                                 model.decode_step, logical_mesh({"data": 1, "model": 4}, dev))[0]
    log(f"small seqkv reference ({cfg.name}, fp32, prompts 5/40/17/60, 3 steps over 4 logical "
        f"sequence shards): tokens card {outs['card']}, CPU {outs['CPU']}: "
        f"{'equal' if outs['card'] == outs['CPU'] else 'DIFFER'}")
    if outs["card"] != outs["CPU"]:
        raise SystemExit("small seqkv reference: the card's tokens differ from the CPU's")


def seqkv_phase(card):
    """(b) qwen2.5-3b at full width (36 layers, 16 / 2 heads x 128, bf16
    weights from seed 0): 4 prompts of 4096, 8192, 16384 and 32000 tokens
    prefilled into a ServingSession (batch 4, max_len 32768), the cache
    kept; then 16 greedy steps from that cache plain (``decode_step``: K6 +
    K3) and through ``jit_serve_fns``' decode (on the parameters and cache
    placed once on the 1 x 1 nccl mesh, as the reference's caller puts
    them on their shardings before the jitted calls) under
    ``mesh_ctx(seqkv)`` over the debug mesh and logical 1 x 2,
    1 x 4 meshes, and over the debug mesh through ``decode_step`` itself
    (no placement: what the split-KV path costs without it).  Gates: the
    first step's logits within 2e-2 of plain relative to the largest plain
    logit (``tests/test_perf_paths.py``'s bound, read as the port's model
    tests read theirs: the bf16 model's logits reach ~570, and a one-ulp
    bf16 flip of an attention output moves them by its noise, not by a
    share of each logit), at least SEQKV_MIN_TOKENS of the 4 x 16 greedy
    tokens equal to plain's (every step of the run), K6 = layers x steps x
    shards and no K3 on the seqkv runs.  Returns (K6, K3) of the seqkv
    runs, the main path, and what the ranks phase starts from: the
    parameters, the prefilled cache, the next tokens and lengths, and the
    logical 1 x 2 run's tokens and first logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as comb
    from repro_torch.launch.mesh import init_local_process_group, logical_mesh, make_debug_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.core import tree
    from repro_torch.runtime.serve_loop import ServingSession, jit_serve_fns
    from repro_torch.runtime.sharding import local_run, place

    cfg = get_config("qwen2.5-3b")
    steps = 16
    log(f"== seqkv phase: {cfg.name} {cfg.n_layers} layers, {cfg.n_heads} / {cfg.n_kv_heads} "
        f"heads x {cfg.head_dim}, d_model {cfg.d_model}, {cfg.param_count() / 1e9:.2f} B "
        f"parameters (bf16, seed 0); ServingSession(batch 4, max_len 32768), prompts "
        f"{SPLIT_KV_LENS}, {steps} decode steps per run; card {card} ==")
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    sess = ServingSession(model, params, batch_size=4, max_len=32768)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in SPLIT_KV_LENS:
        sess.add_request(rng.integers(2, cfg.vocab_size, size=n).tolist())
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache = sess.cache
    kept = [{k: t.clone() for k, t in c.items()} for c in cache]
    gib = sum(t.nbytes for c in kept for t in c.values()) / 2**30
    log(f"prefill of {sum(SPLIT_KV_LENS)} tokens: {t_prefill:.2f} s; the cache {gib:.2f} GiB a "
        f"copy; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    init_local_process_group("cuda")
    debug = make_debug_mesh("cuda")
    _, compile_decode, sh = jit_serve_fns(model, debug, params, cache, policy="seqkv")
    decode = compile_decode(torch.zeros((4, 1), dtype=torch.int64))
    local_run(debug, (params, cache), (sh["params"], sh["cache"]))  # makes the DeviceMesh
    t0 = time.perf_counter()
    placed = place((params, cache), (sh["params"], sh["cache"]))
    t_place = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    local_run(debug, placed, (sh["params"], sh["cache"]))
    log(f"placing the {len(tree.leaves(params))} parameter and {len(tree.leaves(cache))} cache "
        f"tensors on the 1 x 1 mesh (DTensor views of them, no copy): {t_place:.1f} ms of host "
        f"time; a call on the placed trees reads their local shards in "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    counters = (gd.gqa_decode_rows, comb.combine_split_partials)
    runs = {"plain": (model.decode_step, None),
            "seqkv 1 x 1, decode_step (not placed)": (model.decode_step, debug),
            "seqkv 1 x 1 (debug mesh)": (decode, debug),
            "seqkv 1 x 2 (logical)": (decode, logical_mesh({"data": 1, "model": 2}, "cuda")),
            "seqkv 1 x 4 (logical)": (decode, logical_mesh({"data": 1, "model": 4}, "cuda"))}
    res = {}
    for name, (fn, mesh) in runs.items():
        for c, k in zip(cache, kept):  # the placed cache's shards are views of these
            for key in c:
                c[key].copy_(k[key])
        zero_counts(counters)
        p_run, c_run = placed if fn is decode else (params, cache)
        toks, first, times = seqkv_decode(model, p_run, c_run, sess.last_token, sess.cache_len,
                                          steps, fn, mesh)
        torch.cuda.synchronize()
        res[name] = (toks, first, times, read_counts(counters),
                     1 if mesh is None else mesh.shape["model"])
    plain_toks, plain_first = res["plain"][0], res["plain"][1]
    k6_main = k3_main = 0
    for name, (toks, first, times, ((k6, _), (k3, _)), n) in res.items():
        d = (first - plain_first).abs().max().item()
        top = plain_first.abs().max().item()
        agree = sum(a == b for x, y in zip(toks, plain_toks) for a, b in zip(x, y))
        ok = d <= 2e-2 * max(1.0, top) and agree >= SEQKV_MIN_TOKENS
        log(f"{name}: {np.mean(times[2:]):.2f} ms/step steady (steps 3-{steps}; first "
            f"{times[0]:.1f} ms); K6 {k6}, K3 {k3}; first step max |logits - plain| "
            f"{d:.3e} = {d / max(1.0, top):.2e} of max |plain| {top:.2f} (tol 2e-2); "
            f"tokens agreeing with plain {agree} of {4 * steps} (at least "
            f"{SEQKV_MIN_TOKENS}): {ok}")
        if name == "plain":
            continue
        k6_main, k3_main = k6_main + k6, k3_main + k3
        if not ok or (k6, k3) != (cfg.n_layers * steps * n, 0):
            raise SystemExit(f"seqkv phase: {name} disagrees with plain decode (logits or "
                             f"tokens) or its K6 / K3 launches ({k6}, {k3}) are not layers x "
                             "steps x shards and 0")
    logical = res["seqkv 1 x 2 (logical)"]
    handoff = dict(params=params, cache=kept, tokens=np.array(sess.last_token),
                   cache_len=np.array(sess.cache_len), tokens_out=logical[0], first=logical[1])
    del sess, cache, placed
    release()
    return k6_main, k3_main, handoff


def mesh_train_check(cfg, model, params, opt):
    """(c') qwen1.5-0.5b at full width from the train phase's state: 3
    steps through ``jit_train_step`` on the 1 x 1 nccl mesh (the inputs
    placed by the tp_fsdp shardings, the step on the local shards), each
    bit-equal to ``make_train_step``'s from the same state; then
    ``reshard_train_state`` 1 x 1 -> 1 x 1 (each leaf whole already: placed as
    it is) bit-equal, timed.
    Returns the jit steps' (K7, K6, K3) launches."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import init_local_process_group, make_debug_mesh
    from repro_torch.runtime.elastic import reshard_train_state
    from repro_torch.runtime.train_loop import TrainConfig, jit_train_step, make_train_step

    log("== train phase (c'): jit_train_step on the 1 x 1 nccl mesh, 3 steps, and "
        "reshard_train_state ==")
    init_local_process_group("cuda")
    mesh = make_debug_mesh("cuda")
    tc = TrainConfig(peak_lr=3e-4, warmup_steps=2, total_steps=20, remat=True)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=2048, global_batch=8, seed=1)
    compile_for, _ = jit_train_step(model, tc, mesh, params)
    step = compile_for(data.batch_at(0))
    plain = make_train_step(model, tc)
    counters = train_counters()
    launches = [0, 0, 0]
    state = (params, opt, None)
    for i in range(3):
        batch = data.batch_at(i)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = step(*state, batch, 10 + i)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = [a + c for a, (c, _) in zip(launches, read_counts(counters))]
        want = plain(*state, batch, 10 + i)
        same = all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(want)))
        log(f"  step {10 + i}: loss {float(got[3]['loss']):.4f}, {ms:.1f} ms through the "
            f"placed step; == make_train_step's bit for bit: {same}")
        if not same:
            raise SystemExit("train phase (c'): jit_train_step differs from make_train_step")
        state = got[:3]
        del want
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, o2 = reshard_train_state(state[0], state[1], mesh, mesh)
    torch.cuda.synchronize()
    t_reshard = time.perf_counter() - t0
    same = all(torch.equal(b.to_local(), a)
               for a, b in zip(tree.leaves(state[:2]), tree.leaves((p2, o2))))
    nbytes = sum(x.nbytes for x in tree.leaves(state[:2]))
    log(f"  reshard_train_state 1 x 1 -> 1 x 1 of {nbytes / 2**30:.2f} GiB (no copy): "
        f"{t_reshard:.2f} s; bit-equal: {same}; launches of the placed steps K7 {launches[0]}, "
        f"K6 {launches[1]}, K3 {launches[2]}")
    if not same or launches[0] != cfg.n_layers * 2 * 3:
        raise SystemExit("train phase (c'): the resharded state differs or K7 did not run "
                         "layers x 2 x steps times")
    return tuple(launches)


# --------------------------------------------------------------------------- #
# ranks: the sharded steps over a process group, two ranks on the one card
# --------------------------------------------------------------------------- #
RANKS_TIMEOUT = 600.0  # s for the ranks phase's two processes; then they are killed
RANK_TRAIN_REL = 1e-5  # loss and grad_norm of a rank step against the one-rank step
RANK_PARAM_TOL = 2e-3  # tests/test_torch_train_loop.py's PARAM_TOL
# (b)'s steps: 2, so that the whole script stays inside its 1200 s on slow
# hosts; its gloo phases vary by host (on H100 hosts, with (b) at 3 and
# (g) at 16: 1142 s; with (g) at 4: 1255 s on a slower one)
RANK_TRAIN_STEPS = 2


class GatherSpy:
    """Inside the ``with``: every call of ``mesh_ctx.working`` in a
    rank-local step, the layers' counted (``layers``), and the bytes of
    what each call gathered (a leaf that came back as another tensor): the
    most for one layer and for one leaf outside the layers (a table), whose
    sum is the bound on the gathered bytes alive at once (:meth:`summary`),
    all the MoE expert stacks' (``layers/<l>/mlp/gate|up|down``), all the
    Mamba-2 and RG-LRU blocks' leaves (``layers/<l>/ssm|rec/...``) and all
    the attention, dense MLP and embedding table leaves (``module_bytes``);
    ``core/distributed.GATHERED``'s peak from the start and the bytes
    still alive after."""

    def __enter__(self):
        from repro_torch.core import distributed, tree
        from repro_torch.runtime import mesh_ctx
        from repro_torch.runtime.sharding import EXPERT_LEAVES

        self.layers = self.layer_bytes = self.table_bytes = self.expert_bytes = 0
        self.block_bytes = self.module_bytes = 0
        self._orig = orig = mesh_ctx.working

        def spy(sub, prefix):
            out = orig(sub, prefix)
            if mesh_ctx._CURRENT["gather"] is not None:
                pairs = [(tuple(prefix) + p, t) for (p, t), t_in in zip(
                    tree.leaves_with_paths(out), tree.leaves(sub)) if t is not t_in]
                got = [t.nbytes for _, t in pairs]
                self.expert_bytes += sum(t.nbytes for p, t in pairs if len(p) == 4
                                         and p[2] == "mlp" and p[3] in EXPERT_LEAVES)
                self.block_bytes += sum(t.nbytes for p, t in pairs if len(p) > 2
                                        and p[2] in ("ssm", "rec"))
                self.module_bytes += sum(t.nbytes for p, t in pairs if p[0] in ("embed", "unembed")
                                         or (len(p) > 2 and p[2] in ("attn", "self_attn",
                                                                     "cross_attn"))
                                         or (len(p) == 5 and p[2] == "mlp"))
                if str(prefix[0]).endswith("layers"):
                    self.layers += 1
                    self.layer_bytes = max(self.layer_bytes, sum(got))
                else:
                    self.table_bytes = max(self.table_bytes, *got, 0)
            return out

        mesh_ctx.working = spy
        distributed.reset_gathered_peak()
        return self

    def __exit__(self, *exc):
        from repro_torch.core import distributed
        from repro_torch.runtime import mesh_ctx

        mesh_ctx.working = self._orig
        self.peak = distributed.GATHERED["peak"]
        gc.collect()
        self.live = distributed.GATHERED["live"]
        return False

    def summary(self) -> dict:
        return dict(gathered_peak=self.peak, gathered_live=self.live, layer_gathers=self.layers,
                    gather_bound=self.layer_bytes + self.table_bytes,
                    expert_gathered=self.expert_bytes, block_gathered=self.block_bytes,
                    module_gathered=self.module_bytes)


def _rank_main(rank, world, store_path, seqkv, train, out):
    """One rank of the ranks phase (a spawned process on ``cuda:0`` in a
    gloo group): (a) the seqkv decode from this rank's half of the cache,
    (b) the train steps under each policy.  Puts ``(rank, results)`` or
    ``(rank, traceback)`` on ``out``."""
    import traceback

    try:
        res = _rank_phases(rank, world, store_path, seqkv, train)
        del seqkv, train
        _release_spawn_args()
        out.put((rank, res))
    except Exception:  # the parent fails the phase with this traceback
        out.put((rank, traceback.format_exc()))


def _release_spawn_args() -> None:
    """In a spawned rank: drop what still holds the arguments it was
    started with (its ``Process`` object, a module global until the
    interpreter exits), and collect, so that the CUDA tensors the parent
    shared with it are released now.  The parent's copies stay allocated
    until every process it shared them with has released them (CUDA IPC);
    released only at exit, they stayed allocated in the parent for the rest
    of the script (the ranks phase's 32k cache, parameters and train state,
    which left too little of the card for cell (h))."""
    import multiprocessing

    multiprocessing.current_process()._args = ()
    gc.collect()


def _rank_phases(rank, world, store_path, seqkv, train):
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as comb
    from repro_torch.launch.mesh import init_process_group, rank_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import sharding
    from repro_torch.runtime.serve_loop import jit_serve_fns
    from repro_torch.runtime.train_loop import jit_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_process_group("gloo", rank=rank, world_size=world,
                             store=dist.FileStore(store_path, world))
    res = {"device": str(dev)}
    counters = (gd.gqa_decode_rows, comb.combine_split_partials, fp.flash_prefill)

    # (a) seqkv decode: this rank's half of every layer's cache sequence
    cfg = get_config("qwen2.5-3b")
    model = build_model(cfg)
    mesh = rank_mesh("1x2", "cuda")
    params, full = seqkv["params"], seqkv["cache"]
    _, compile_decode, sh = jit_serve_fns(model, mesh, params, full, policy="seqkv")
    flat_sh = dict(tree.leaves_with_paths(sh["cache"]))
    cache = tree.map_with_paths(
        lambda path, t: sharding.from_local(sharding.shard_one(t, flat_sh[path]).clone(),
                                            flat_sh[path], t.shape), full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    decode = compile_decode(torch.zeros((4, 1), dtype=torch.int64, device=dev))
    with GatherSpy() as gathers:  # the parameters come whole: nothing is gathered
        toks, first, times = seqkv_decode(model, params, cache, seqkv["tokens"],
                                          seqkv["cache_len"], 16, decode, mesh)
        torch.cuda.synchronize()
    local = sum(c[k].to_local().nbytes for c in cache for k in c)
    res["a"] = dict(tokens=toks, first=first, times=times, launches=read_counts(counters),
                    peak=torch.cuda.max_memory_allocated() / 2**30, cache_gib=local / 2**30,
                    rows=tuple(cache[0]["k"].to_local().shape), **gathers.summary())
    del cache, decode, params, full
    gc.collect()
    torch.cuda.empty_cache()

    # (b) training on 2 x 1 ranks; rank 0 holds each step against the
    # one-rank step from the same (gathered) state and batch
    from repro_torch.core import distributed
    from repro_torch.runtime.train_loop import make_train_step

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    mesh = rank_mesh("2x1", "cuda")
    one_rank = make_train_step(model, train["tc"])
    res["b"] = {}
    for policy in ("fsdp", "tp_fsdp"):
        compile_for, sh = jit_train_step(model, train["tc"], mesh, train["params"],
                                         policy=policy)
        step = compile_for(train["batches"][0])
        state = (train["params"], train["opt"], None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times, held, launches, coll = [], [], [], [0, 0, 0], []
        with GatherSpy() as gathers:
            for i, batch in enumerate(train["batches"]):
                if policy == "tp_fsdp" and i == 1:  # the second step from the restored state
                    state, res["ckpt"] = rank_ckpt_round_trip(
                        rank, state, train, os.path.join(os.path.dirname(store_path), "ckpt"))
                before = [tree.tree_map(sharding.full_value, t) for t in state[:2]]  # gathered
                zero_counts(counters)
                n0 = dict(distributed.COLLECTIVES), dict(distributed.COLLECTIVE_BYTES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                *state, m = step(*state, batch, 10 + i)
                metrics.append({k: float(v) for k, v in m.items()})
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                coll.append((sum(distributed.COLLECTIVES.values()) - sum(n0[0].values()),
                             sum(distributed.COLLECTIVE_BYTES.values()) - sum(n0[1].values())))
                launches = [x + c for x, (c, _) in zip(launches, read_counts(counters))]
                after = tree.tree_map(sharding.full_value, state[0])
                if rank == 0:  # the peer waits in the next collective meanwhile
                    held.append(_hold_rank_step(one_rank, before, after, metrics[-1], batch,
                                                10 + i))
                del before, after
        local = sum(x.to_local().nbytes for x in tree.leaves(state[:2]))
        res["b"][policy] = dict(metrics=metrics, times=times, launches=launches, held=held,
                                peak=torch.cuda.max_memory_allocated() / 2**30,
                                state_gib=local / 2**30, coll=coll, **gathers.summary())
        del state, step, compile_for
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return res


def rank_ckpt_round_trip(rank, state, train, directory):
    """On every rank: the train state ``(params, opt, comp)`` (this rank's
    ``DTensor`` shards) saved as step 1 by a ``CheckpointManager(directory,
    async_save=True)`` and waited for (each rank its shard file, rank 0
    commits), then restored by a fresh manager against the whole initial
    state (the supervisor's first call, before any step), and the
    directory removed.  Returns the restored state and this rank's save
    and restore seconds, its shard file's bytes, and whether every
    restored local shard, placement and mesh equals the saved one."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import tree

    saved = {"params": state[0], "opt": state[1], "comp": state[2]}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    mgr = CheckpointManager(directory, async_save=True)
    mgr.save(1, saved)
    mgr.wait()
    save_s = time.perf_counter() - t0
    shard = os.path.getsize(os.path.join(directory, "step_00000001", f"shard_{rank:05d}.npz"))
    dist.barrier()
    t0 = time.perf_counter()
    step, got = CheckpointManager(directory).restore_latest(
        {"params": train["params"], "opt": train["opt"], "comp": None})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    pairs = list(zip(tree.leaves(got), tree.leaves(saved), strict=True))
    equal = step == 1 and all(
        a.placements == b.placements and a.device_mesh is b.device_mesh and a.shape == b.shape
        and torch.equal(a.to_local(), b.to_local()) for a, b in pairs)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(directory)
    return (got["params"], got["opt"], got["comp"]), dict(
        save_s=save_s, restore_s=restore_s, shard_bytes=shard, equal=equal,
        state_bytes=sum(b.to_local().nbytes for _, b in pairs))


def _spawn_ranks(world, args, timeout, target=None):
    """``world`` processes of ``target`` (default :func:`_rank_main`;
    spawn start mode) on a
    ``FileStore`` under ``build/``; returns each rank's results, or exits
    nonzero with a rank's traceback, or after ``timeout`` seconds (every
    rank killed)."""
    import queue
    import shutil
    import tempfile

    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store_dir = tempfile.mkdtemp(dir=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "build"))
    path = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=target or _rank_main, args=(r, world, path, *args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, value = out.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise SystemExit(f"ranks phase: the ranks did not finish in {timeout} s "
                                 "(killed)") from None
            if isinstance(value, str):
                raise SystemExit(f"ranks phase: rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise SystemExit(f"ranks phase: {p.name} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(store_dir, ignore_errors=True)
    return [results[r] for r in range(world)]


def _hold_rank_step(one_rank, before, after, m, batch, step):
    """A rank step (the whole state ``before``, its new parameters
    ``after``, gathered; metrics ``m``) against ``make_train_step`` on one
    rank from the same state and batch: the relative errors of the loss
    and ``grad_norm``, and the parameters' differences by
    ``tests/test_torch_train_loop.py``'s rule: where the one-rank first
    moment exceeds 2^-8 of its leaf's largest, against 2e-3 of the
    leaf's largest parameter (``resolved``); everywhere, against 2 lr
    (Adam moves a noise-level element by about lr either way).
    ``resolved_model`` reads the first rule where the first moment exceeds
    2^-8 of the model's largest instead (a leaf whose gradients are all
    far below the model's, such as a zero-initialized bias or norm scale,
    whose largest parameter after one step is lr, is then held by the 2 lr
    rule).  The worst leaf of each rule is named."""
    from repro_torch.core import tree
    from repro_torch.runtime.sharding import path_str

    p1, o1, _, m1 = one_rank(*before, None, batch, step)
    top = max(float(g.abs().max()) for g in tree.leaves(o1.mu))
    out = {"resolved": 0.0, "resolved_model": 0.0, "anywhere": 0.0}
    worst = {}
    for (path, a), b, g in zip(tree.leaves_with_paths(after), tree.leaves(p1), tree.leaves(o1.mu),
                               strict=True):
        d = (a - b).abs()
        errs = {"anywhere": float(d.max()) / (2 * float(m1["lr"]))}
        for key, floor in (("resolved", g.abs().max()), ("resolved_model", top)):
            big = g.abs() > 2.0**-8 * floor
            if big.any():
                errs[key] = float(d[big].max() / b.abs().max())
        for key, err in errs.items():
            if err > out[key]:
                out[key], worst[key] = err, path_str(path)
    rel = {k: abs(m[k] - float(m1[k])) / abs(float(m1[k])) for k in ("loss", "grad_norm")}
    return dict(rel, **out, worst=worst, one_rank={k: float(v) for k, v in m1.items()})


def rank_train_state(steps=RANK_TRAIN_STEPS, dev="cuda", smoke=False, arch="qwen1.5-0.5b"):
    """``arch`` (default qwen1.5-0.5b) at full width: the ranks' initial
    state (fp32 master from seed 0, as ``init_train_state`` makes it), the
    step's TrainConfig (remat) and ``steps`` global batches of 8 x 2048
    from seed 1 (``smoke``: the smoke config, 8 x 32; an encoder-decoder's
    with source frames and ``src_len``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state

    cfg = get_config(arch, smoke=smoke)
    params, opt, _ = init_train_state(build_model(cfg), torch.Generator(dev).manual_seed(0), dev)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32 if smoke else 2048,
                           global_batch=8, seed=1)
    batches = [data.batch_at(i) for i in range(steps)]
    if cfg.family == "encdec":  # 16 source frames a row (seed 1, x 0.02), some rows shorter
        rng = np.random.default_rng(1)
        for batch in batches:
            batch["src_embeds"] = (rng.standard_normal((8, 16, cfg.d_model))
                                   * 0.02).astype(np.float32)
            batch["src_len"] = rng.integers(9, 17, size=8).astype(np.int32)
    return dict(tc=TrainConfig(peak_lr=3e-4, warmup_steps=2, total_steps=20, remat=True),
                params=params, opt=opt, batches=batches, n_layers=cfg.n_layers)


def ranks_phase(card, seqkv):
    """Two ranks on ``cuda:0`` in a gloo group (NCCL refuses two ranks on
    one device), spawned, running the sharded steps rank-locally; the
    card's name and power limit ``card`` printed beside every number.

    (a) qwen2.5-3b at full width under ``seqkv`` on a 1 x 2 mesh of ranks:
    each rank holds its half of the seqkv phase's 32k cache (every layer's
    K/V rows ``[r x 16384, (r + 1) x 16384)``, copied from the parent's
    cache through CUDA IPC) and runs 16 greedy decode steps through
    ``jit_serve_fns`` (the parameters the parent's whole tensors, through
    CUDA IPC, which the step uses as they are): K6 once per layer over its
    slice, the partials all-gathered.  Gates: the first step's logits
    bit-equal to the one-process logical 1 x 2 run's from the same cache
    bits, 64 of 64 tokens equal to its, K6 = layers x steps on each rank
    and no K3, no parameter bytes gathered.

    (b) qwen1.5-0.5b at full width on 2 x 1 ranks under ``fsdp`` and
    ``tp_fsdp``, the global batch 8 x 2048, ``RANK_TRAIN_STEPS`` steps
    through ``jit_train_step`` (the first from full tensors, the next from
    the ranks' own shards, gathered); the model gathers each layer at its use
    (and again in its remat recompute).  Between the ``tp_fsdp`` steps
    every rank saves its shards of the state, restores them against the
    whole initial state and runs the second step from what it restored
    (:func:`rank_ckpt_round_trip`: every shard, placement and mesh
    bit-equal; each rank's save and restore seconds and shard bytes
    printed).  Rank 0 holds every step against
    ``make_train_step`` on one rank from the same state and batch
    (:func:`_hold_rank_step`).  Gates: loss and ``grad_norm`` within
    ``RANK_TRAIN_REL``, the parameters by ``RANK_PARAM_TOL`` where the
    gradient is resolved and within 2 lr everywhere, the same metrics on
    both ranks, K7 = layers x 2 x steps on each rank; the gathered
    parameter bytes alive at once at most what the step gathers of its
    largest layer plus its largest gathered table (:class:`GatherSpy`:
    under ``fsdp`` the table is replicated, so one layer), none alive
    after, and layers x 2 x steps layer gathers.  Each rank's peak and its gloo calls
    and bytes a step are printed.

    Every line is printed before a failed gate stops the run.  The step
    times are gloo on one card: the collectives move through host memory
    and the two ranks share the card's SMs; they are not a multi-card
    number.  Returns the ranks' (K6, K7, K3) launches."""
    n_layers = len(seqkv["params"]["layers"])
    log(f"== ranks phase: 2 ranks on cuda:0 (spawned, gloo), card {card} ==")
    t0 = time.perf_counter()
    train = rank_train_state()
    ranks = _spawn_ranks(2, (seqkv, train), RANKS_TIMEOUT)
    log(f"two ranks spawned, ran (a) and (b) and exited in {time.perf_counter() - t0:.1f} s")
    k6 = k7 = k3 = 0
    steps = len(seqkv["tokens_out"])
    failed = []
    for r, res in enumerate(ranks):
        c = res["ckpt"]
        log(f"(b) rank {r} tp_fsdp checkpoint between its steps: saved "
            f"{c['state_bytes'] / 1e9:.3f} GB of shards in {c['save_s']:.2f} s (host copy, shard "
            f"file of {c['shard_bytes'] / 1e9:.3f} GB, commit), restored in "
            f"{c['restore_s']:.2f} s; every shard, placement and mesh bit-equal: {c['equal']}; "
            f"card {card}")
        if not c["equal"]:
            failed.append(f"(b) rank {r}: the restored checkpoint differs from the saved state")
        a = res["a"]
        (k6a, _), (k3a, _), (k7a, _) = a["launches"]
        same_first = torch.equal(a["first"], seqkv["first"])
        agree = sum(x == y for s, t in zip(a["tokens"], seqkv["tokens_out"])
                    for x, y in zip(s, t))
        log(f"(a) rank {r} ({res['device']}): cache rows {a['rows']} ({a['cache_gib']:.2f} GiB "
            f"held), {np.mean(a['times'][2:]):.2f} ms/step steady (steps 3-{steps}; first "
            f"{a['times'][0]:.1f} ms), peak {a['peak']:.2f} GiB; first-step logits bit-equal "
            f"to the logical 1 x 2 run: {same_first} (max |diff| "
            f"{(a['first'] - seqkv['first']).abs().max().item():.3e}); tokens equal "
            f"{agree} of {4 * steps}; K6 {k6a}, K3 {k3a}; parameter bytes gathered "
            f"{a['gathered_peak']} (handed whole); card {card}")
        if not same_first or agree != 4 * steps or (k6a, k3a, k7a) != (n_layers * steps, 0, 0):
            failed.append(f"(a) rank {r}: not the logical 1 x 2 run's logits / tokens, or "
                          f"launches K6 {k6a}, K3 {k3a}, K7 {k7a} not layers x steps, 0, 0")
        if a["gathered_peak"] or a["layer_gathers"] != n_layers * steps:
            failed.append(f"(a) rank {r}: parameters handed whole were gathered, or the layers "
                          f"were not read through working once a step")
        k6, k3 = k6 + k6a, k3 + k3a
        for policy, b in res["b"].items():
            k7b, k6b, k3b = b["launches"][2], b["launches"][0], b["launches"][1]
            log(f"(b) rank {r} {policy}: " + "; ".join(
                f"loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f}" for m in b["metrics"])
                + f"; {', '.join(f'{t:.1f}' for t in b['times'])} ms/step, peak "
                f"{b['peak']:.2f} GiB, params + moments held {b['state_gib']:.2f} GiB; gloo "
                f"calls / GiB a step {[(c, round(x / 2**30, 3)) for c, x in b['coll']]}; "
                f"gathered parameter bytes alive at once at most "
                f"{b['gathered_peak'] / 2**20:.1f} MiB (bound {b['gather_bound'] / 2**20:.1f} "
                f"MiB: the largest gathered layer plus the largest gathered table), "
                f"{b['gathered_live']} B alive after; layer gathers {b['layer_gathers']}; K7 "
                f"{k7b}, K6 {k6b}, K3 {k3b}; card {card}")
            if (b["gathered_peak"] > b["gather_bound"] or b["gathered_live"]
                    or b["layer_gathers"] != train["n_layers"] * 2 * RANK_TRAIN_STEPS):
                failed.append(f"(b) rank {r} {policy}: gathered bytes alive past the bound or "
                              "after the step, or layer gathers not layers x 2 x steps")
            for i, h in enumerate(b["held"]):
                log(f"    step {i}: one rank from the same state: loss "
                    f"{h['one_rank']['loss']:.6f} grad_norm {h['one_rank']['grad_norm']:.6f}; "
                    f"relative: loss {h['loss']:.2e}, grad_norm {h['grad_norm']:.2e} (tol "
                    f"{RANK_TRAIN_REL}); params where the gradient is resolved "
                    f"{h['resolved']:.2e} of the leaf max (tol {RANK_PARAM_TOL}), everywhere "
                    f"{h['anywhere']:.3f} x 2 lr (tol 1)")
                if (max(h["loss"], h["grad_norm"]) > RANK_TRAIN_REL
                        or h["resolved"] > RANK_PARAM_TOL or h["anywhere"] > 1 + 1e-4):
                    failed.append(f"(b) {policy} step {i}: outside the one-rank step's bounds")
            if (k7b != train["n_layers"] * 2 * RANK_TRAIN_STEPS or (k6b, k3b) != (0, 0)
                    or b["metrics"] != ranks[0]["b"][policy]["metrics"]
                    or (r == 0) != (len(b["held"]) == RANK_TRAIN_STEPS)):
                failed.append(f"(b) rank {r} {policy}: metrics differ from rank 0's or K7 "
                              f"{k7b} is not layers x 2 x steps (K6 {k6b}, K3 {k3b})")
            k6, k7, k3 = k6 + k6b, k7 + k7b, k3 + k3b
    if failed:
        raise SystemExit("ranks phase: " + "; ".join(failed))
    del train
    return k6, k7, k3


# --------------------------------------------------------------------------- #
# tensor-parallel serve steps on ranks: heads, d_ff and vocabulary by model
# --------------------------------------------------------------------------- #
TP_TIMEOUT = 600.0  # s for the tensor-parallel phase's two processes; then they are killed
TP_MIN_TOKENS = 60  # of the 4 x 16 decode steps' greedy tokens equal to one process's
TP_LOGIT_TOL = 2e-2  # of the largest one-process logit of the call
# Or: the split's logits at most this many times as far from the fp32
# function of the same weights (the one-process model at fp32 compute) as
# the one-process bf16 run's are.  Two bf16 runs whose products round apart
# part by a share that grows with depth (3.3e-2 of the largest logit at
# deepseek-v2-mla's 60 layers, while the one-process run is itself 2.9e-2
# from the fp32 function; PERF.md, PR 30), so there the bound is the bf16
# run's own error, not a fixed share.
TP_F32_FACTOR = 1.5
TP_RESIDENT_SHARE = 0.55  # a rank's parameter bytes over the whole model's
# A MoE model at fp32 compute: the split's products round apart from one
# process's at the ulp (cuBLAS picks its kernels by shape), AMLA's
# rescale can make that a larger difference in a layer's output, and the
# router sends a token whose k-th and next probabilities lie closer than
# that to another expert, which moves its hidden state and its row's
# later tokens far more (PERF.md, PR 33).  So where one process routes a token
# and a rank does not, the first such tokens must be near-ties: their
# one-process top-k margin at most this share of the call's median (a
# wrong split moves the outputs by O(1) and reroutes at any margin), and
# the greedy tokens are held by TP_MIN_TOKENS in proportion, as at bf16.
MOE_NEAR_TIE = 1.0 / 16
TP_BATCH, TP_PROMPT, TP_STEPS = 4, 64, 16
# label -> (arch, policy, max_len, decode steps): deepseek-v2-mla's latent
# cache needs no more rows; qwen2.5-3b's and qwen3-moe-30b-a3b's 2048 give
# K6 four 512-key splits, so K3 runs.  (h): qwen3-moe's 128 experts split
# by expert over the 2 ranks ("ep"), 8 steps (its one-process references
# take ~58 GiB of weights a run, and the script must stay inside 1200 s).
# (j): mamba2-370m's 32 SSM heads, 16 a rank, its state's ds over model
# (one all-to-all each way a call); (k): recurrentgemma-2b's 2560 RG-LRU
# channels, 1280 a rank, and its local attention's 5 of 10 query heads on
# the one kv head, over the 2048-row window (K6 splits, K3 runs).  (j)
# and (k) run 4 steps, their token gate TP_MIN_TOKENS in proportion: on a
# slow host the whole script took 1115.8 s with them at 8 (PERF.md).  (m):
# seamless-m4t-medium in the reference's serving form: the caller's
# init_cache over 4 x ENCDEC_FRAMES frames (the encoder, whole, in each
# rank), the 64-token target prompt through the decode step at cache_len 0,
# then 2 steps (4 took the script to 1097.1 s on a slow host, PERF.md); each
# rank its 8 of 16 heads of every self- and cross-attention (the cross K/V's
# width over model: one all-to-all a call).  (d) runs 8 steps, its token gate
# in proportion: the time it gives up pays for the ranks phase's checkpoint
# round trip (about 13 s on an H100), with the script near its limit on a slow host
TP_CELLS = {"c": ("deepseek-v2-mla", "tp", 128, TP_STEPS),
            "d": ("qwen2.5-3b", "tp_fsdp", 2048, 8),
            "h": ("qwen3-moe-30b-a3b", "tp", 2048, 8),
            "j": ("mamba2-370m", "tp_fsdp", 128, 4),
            "k": ("recurrentgemma-2b", "tp", 2048, 4),
            "m": ("seamless-m4t-medium", "tp_fsdp", 128, 2)}
# label -> (the cell whose one-process references it reuses, mesh, policy,
# decode steps): FSDP serving on 2 x 1 ranks, each rank its batch rows and
# its data shards of the weights, every layer gathered at its use.  Its
# first 2 of (d)'s steps: every call gathers each layer through gloo
# (5.2 GiB, 7-9.5 s on an H100 host), and at 16 the whole script took
# 1142 s of its 1200
FSDP_CELLS = {"g": ("d", "2x1", "fsdp", 2)}
# a rank's peak allocated over the bytes of every parameter leaf of the
# one-process model (the fp32 table copy included): the shards, one layer
# and the table, not a whole copy (the all-at-once gather needs ~1.4x)
FSDP_PEAK_SHARE = 0.85
TP_GEOM = ("qwen2.5-3b rank", 8, 1, 128, None, None)  # one rank of 1 x 2: 8 / 1 heads
TP_MOE_GEOM = ("qwen3-moe-30b-a3b rank", 16, 2, 128, None, None)  # (h)'s rank: 16 / 2 heads
# (k)'s rank: 5 of recurrentgemma-2b's 10 query heads on its one kv head,
# Dh 256, the 2048-key window: 5 rows a kv head in K6, 5 heads in K7
TP_REC_GEOM = ("recurrentgemma-2b rank", 5, 1, 256, 2048, None)
# one rank of the split train step: 8 of qwen1.5-0.5b's 16 heads (MHA, Dh 64)
TP_TRAIN_GEOM = ("qwen1.5-0.5b rank", 8, 8, 64, None, None)
# (m)'s rank: 8 of seamless-m4t-medium's 16 heads (MHA, Dh 64), self and cross
TP_ENCDEC_GEOM = ("seamless-m4t-medium rank", 8, 8, 64, None, None)
TP_ENCDEC_MAX_LEN = TP_CELLS["m"][2]
TP_TRAIN_B, TP_TRAIN_S = 8, 2048


def tp_kernel_cases(dtype):
    """K4, K6 and K7 at the shapes one rank of the tensor-parallel phase
    gives them: K4 over 64 of deepseek-v2-mla's 128 heads (decode after
    16 steps, and the 64-token prompt, G = 64 x 64), K6 at 8 query heads
    over 1 kv head (qwen2.5-3b on 1 x 2, the 2048-row cache: 4 splits +
    K3), K7 at 8 heads over the 64-token prompt; the same at (h)'s 16 query
    heads over 2 kv heads (qwen3-moe-30b-a3b on 1 x 2) and at (k)'s 5
    query heads over 1 kv head, Dh 256, window 2048 (recurrentgemma-2b on
    1 x 2: 5 rows a kv head, which no other phase gives the tensor-core
    body); K7 at 8 of qwen1.5-0.5b's 16 heads over the split train step's
    8 x 2048 (causal, Dh 64); at (m)'s 8 of seamless-m4t-medium's 16 heads
    (MHA, Dh 64): K6 over the 128-row self cache after its steps and
    over the 1024 frames of the cross K/V (2 splits + K3), K7 non-causal
    over the frames at the 64-token prompt and causal over its own rows."""
    kv = np.full(TP_BATCH, TP_PROMPT + TP_STEPS)
    prompt_pos = np.tile(np.repeat(np.arange(TP_PROMPT), 64), (TP_BATCH, 1))
    f, m, steps = ENCDEC_FRAMES, TP_ENCDEC_MAX_LEN, TP_CELLS["m"][3]
    return [
        ("K4 rank decode G 64", mla_case(TP_BATCH, 64, 128, kv,
                                        np.repeat((kv - 1)[:, None], 64, 1), dtype, 70)),
        ("K4 rank prefill 64 x 64", mla_case(TP_BATCH, 64 * TP_PROMPT, 128,
                                            np.full(TP_BATCH, TP_PROMPT), prompt_pos, dtype, 71)),
        ("K6 rank 8/1 decode", gqa_case("K6", TP_GEOM, TP_BATCH, 1, 2048, kv, dtype, 72)),
        ("K7 rank 8 heads prefill 64", gqa_case("K7", TP_GEOM, TP_BATCH, TP_PROMPT, 2048,
                                               np.full(TP_BATCH, TP_PROMPT), dtype, 73)),
        ("K6 rank 16/2 decode", gqa_case("K6", TP_MOE_GEOM, TP_BATCH, 1, 2048, kv, dtype, 75)),
        ("K7 rank 16 heads prefill 64", gqa_case("K7", TP_MOE_GEOM, TP_BATCH, TP_PROMPT, 2048,
                                                np.full(TP_BATCH, TP_PROMPT), dtype, 76)),
        ("K6 rank 5/1 decode", gqa_case("K6", TP_REC_GEOM, TP_BATCH, 1, 2048, kv, dtype, 77)),
        ("K7 rank 5 heads prefill 64", gqa_case("K7", TP_REC_GEOM, TP_BATCH, TP_PROMPT, 2048,
                                               np.full(TP_BATCH, TP_PROMPT), dtype, 78)),
        ("K7 rank 8 heads train 8 x 2048", gqa_case(
            "K7", TP_TRAIN_GEOM, TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_S,
            np.full(TP_TRAIN_B, TP_TRAIN_S), dtype, 74)),
        ("K6 rank 8/8 encdec self decode", gqa_case(
            "K6", TP_ENCDEC_GEOM, TP_BATCH, 1, m, np.full(TP_BATCH, TP_PROMPT + steps), dtype, 79)),
        ("K6 rank 8/8 encdec cross decode", gqa_case(
            "K6", TP_ENCDEC_GEOM, TP_BATCH, 1, f, np.full(TP_BATCH, f), dtype, 80)),
        ("K7 rank 8 heads encdec cross prompt 64", gqa_case(
            "K7", TP_ENCDEC_GEOM, TP_BATCH, TP_PROMPT, f, np.full(TP_BATCH, f), dtype, 81,
            causal=False)),
        ("K7 rank 8 heads encdec self prompt 64", gqa_case(
            "K7", TP_ENCDEC_GEOM, TP_BATCH, TP_PROMPT, m, np.full(TP_BATCH, TP_PROMPT), dtype, 82)),
    ]


def tp_kernel_phase(flush):
    """Hold K4, K6 (+ K3) and K7 at one rank's shapes against their plain
    versions, then time them (bf16, amla) beside their bounds, the plain
    versions and SDPA."""
    log("== kernel phase: K4 at G 64, K6 at 8 / 1, 16 / 2, 5 / 1 and 8 / 8 heads (+ K3), K7 at 8, "
        "16 and 5 heads and 8 non-causal: one rank's shapes in the tensor-parallel serve and "
        "train phases ==")
    worst = hold_dense_cases(tp_kernel_cases)
    bf = torch.bfloat16
    cases = dict(tp_kernel_cases(bf))
    timed = [("K4", "rank decode G 64", cases["K4 rank decode G 64"]),
             ("K4", "rank prefill 64 x 64", cases["K4 rank prefill 64 x 64"]),
             ("K6", "rank 8/1 decode", cases["K6 rank 8/1 decode"]),
             ("K7", "rank 8 heads prefill 64", cases["K7 rank 8 heads prefill 64"]),
             ("K6", "rank 5/1 decode", cases["K6 rank 5/1 decode"]),
             ("K7", "rank 5 heads prefill 64", cases["K7 rank 5 heads prefill 64"]),
             ("K7", "rank 8 heads train 8 x 2048", cases["K7 rank 8 heads train 8 x 2048"]),
             ("K6", "rank 8/8 encdec self decode", cases["K6 rank 8/8 encdec self decode"]),
             ("K6", "rank 8/8 encdec cross decode", cases["K6 rank 8/8 encdec cross decode"]),
             ("K7", "rank 8 heads encdec cross prompt 64",
              cases["K7 rank 8 heads encdec cross prompt 64"]),
             ("K7", "rank 8 heads encdec self prompt 64",
              cases["K7 rank 8 heads encdec self prompt 64"])]
    del cases
    return worst, time_dense_rows(timed, flush)


def tp_split_counts(arch, calls, smoke=False, layer_calls=None, encoder=False):
    """``mesh_ctx.TP_COUNTS`` of a tensor-parallel run of ``arch`` that
    splits every module: each attention layer, dense MLP or MoE layer's
    experts, Mamba-2 and RG-LRU block ``layer_calls`` times (default
    ``calls``), the lookup and the logits (or loss) ``calls`` times.  An
    encoder-decoder's: every decoder layer's self-attention,
    cross-attention and MLP a call (``encoder`` also every encoder layer's
    attention and MLP: a train step, whose encoder runs split)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=smoke)
    kinds = cfg.layer_kinds()
    per = calls if layer_calls is None else layer_calls
    if cfg.family == "encdec":
        n = per * (cfg.n_layers + (cfg.encoder_layers if encoder else 0))
        return {"attn": n, "cross": per * cfg.n_layers, "mlp": n, "embed": calls,
                "logits": calls}
    out = {"attn": per * sum(k in ("global", "local") for k in kinds),
           "moe" if cfg.n_experts else "mlp": per * sum(k != "ssm" for k in kinds),
           "ssm": per * kinds.count("ssm"), "rec": per * kinds.count("recurrent"),
           "embed": calls, "logits": calls}
    return {k: v for k, v in out.items() if v}


def attention_layers(arch, smoke=False) -> int:
    from repro_torch.configs import get_config

    return sum(k in ("global", "local") for k in get_config(arch, smoke=smoke).layer_kinds())


def tp_serve(prefill, decode, params, cache, prompts, forced=None, dev="cuda", steps=TP_STEPS):
    """The 64-token prompts prefilled in one call, then ``steps`` decode
    steps of one token: greedy, or fed ``forced[:, i]`` at step ``i`` (the
    one-process run's tokens, so every call's logits are comparable).
    Returns each call's last-position logits on the host, the greedy
    tokens ``(B, 1 + steps)``, the prefill's ms and each step's ms (host
    clock ending in a device sync)."""
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    p = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    sync()
    t0 = time.perf_counter()
    logits, _ = prefill(params, cache, p)
    out = [logits[:, -1].float().cpu()]
    sync()
    t_prefill = 1e3 * (time.perf_counter() - t0)
    greedy = [out[-1].argmax(-1).numpy()]
    times = []
    for i in range(steps):
        tok = greedy[-1] if forced is None else forced[:, i]
        t = torch.as_tensor(np.asarray(tok)[:, None], dtype=torch.int64, device=dev)
        lens = np.full((len(tok),), TP_PROMPT + i, np.int32)
        sync()
        t0 = time.perf_counter()
        logits, _ = decode(params, cache, t, lens)
        out.append(logits[:, -1].float().cpu())
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        greedy.append(out[-1].argmax(-1).numpy())
    return out, np.stack(greedy, 1), t_prefill, times


def tp_counters():
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import mla_decode_combine as mc

    return (md.mla_decode_rows, gd.gqa_decode_rows, fp.flash_prefill, mc.combine_split_partials)


class RouteSpy:
    """Inside the ``with``: every MoE layer's routing (``moe.route``), in
    call order: each token's sorted expert ids and the margin of its
    top-k (the k-th largest probability less the next)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.top, self.margin = [], []
        self._orig = orig = moe.route

        def spy(router, xf, *, cfg, dtype):
            r = orig(router, xf, cfg=cfg, dtype=dtype)
            k = cfg.n_experts_active
            probs = torch.topk(r.probs, k + 1, dim=-1).values
            self.top.append(torch.sort(r.top_i, dim=-1).values.to(torch.int16).cpu().numpy())
            self.margin.append((probs[:, k - 1] - probs[:, k]).float().cpu().numpy())
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._orig
        return False


def rerouted(one: RouteSpy, top: list, layers: int) -> dict:
    """The tokens whose experts differ between one process's routing
    (``one``) and a rank's (``top``, the same calls on the same input
    tokens): in all, and at the first MoE layer call where any does
    (call, layer), with one process's top-k margins there against the
    median margin of that call."""
    diff = [np.flatnonzero((a != b).any(-1)) for a, b in zip(one.top, top, strict=True)]
    first = next((i for i, d in enumerate(diff) if len(d)), None)
    out = dict(rerouted=int(sum(map(len, diff))), decisions=int(sum(len(a) for a in one.top)),
               first=None)
    if first is not None:
        out.update(first=(first // layers, first % layers), first_tokens=len(diff[first]),
                   first_margins=[float(m) for m in one.margin[first][diff[first]]],
                   median_margin=float(np.median(one.margin[first])))
    return out


def serve_cache(model, params, src, max_len):
    """A serve cell's cache: zeroed rows for ``TP_BATCH`` (a decoder-only
    model), or an encoder-decoder's ``init_cache`` over the source frames
    ``src`` (the encoder and every layer's cross K/V)."""
    return model.init_cache(params, TP_BATCH if src is None else src, max_len)


def prompt_call(model, decode=None):
    """``(params, cache, prompts) -> (logits, cache)``: ``model.prefill``,
    or for an encoder-decoder (no prefill: the reference's serving form)
    the decode step over the target prompt at ``cache_len`` 0 (``decode``,
    a compiled one, or ``model.decode_step``)."""
    if model.cfg.family != "encdec":
        return model.prefill
    decode = decode or model.decode_step
    return lambda params, cache, p: decode(params, cache, p, np.zeros((len(p),), np.int32))


def tp_reference(label, dev="cuda", smoke=False):
    """One process, no mesh: the cell's model at full width (bf16 weights
    from seed 0), 4 prompts of 64 tokens (seed 0) and ``TP_STEPS`` greedy decode
    steps through ``prefill`` / ``decode_step`` (an encoder-decoder: its
    ``init_cache`` over :func:`encdec_src`'s frames, the prompt through
    ``decode_step`` at ``cache_len`` 0); what the ranks are held
    against; then the same weights at fp32 compute fed those tokens (the
    yardstick of the logits gate), and at fp32 compute greedy (its own
    tokens: what the ranks' fp32-compute run is held to, token for token).
    Frees its weights before it returns."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models.model_zoo import build_model

    arch, policy, max_len, steps = TP_CELLS[label]
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    whole = sum(t.nbytes for t in tree.leaves(params))
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(TP_BATCH, TP_PROMPT))
    src = encdec_src(cfg, TP_BATCH, dev) if cfg.family == "encdec" else None
    cache = serve_cache(model, params, src, max_len)
    t_build = time.perf_counter() - t0
    zero_counts(tp_counters())
    logits, tokens, t_prefill, times = tp_serve(prompt_call(model), model.decode_step, params,
                                                cache, prompts, dev=dev, steps=steps)
    launches = [c for c, _ in read_counts(tp_counters())]
    # the fp32 function of the same weights: fp32 compute (each weight cast
    # at its product), an fp32 cache, fed the bf16 run's tokens
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    cache = serve_cache(model32, params, src, max_len)
    f32 = tp_serve(prompt_call(model32), model32.decode_step, params, cache, prompts,
                   forced=tokens, dev=dev, steps=steps)[0]
    cache = serve_cache(model32, params, src, max_len)
    with RouteSpy() as routes32:
        logits32, tokens32 = tp_serve(prompt_call(model32), model32.decode_step, params, cache,
                                      prompts, dev=dev, steps=steps)[:2]
    err = logit_share(logits, f32)
    log(f"({label}) one process: {cfg.name} {cfg.n_layers} layers, {cfg.n_heads} heads, "
        f"{whole / 2**30:.2f} GiB of bf16 weights (the fp32 unembedding copy included) built "
        f"in {t_build:.1f} s; prefill {TP_BATCH} x {TP_PROMPT} in {t_prefill:.1f} ms, "
        f"{np.mean(times[2:] or times):.2f} ms/step steady (steps {3 if steps > 2 else 1}-"
        f"{steps}; first {times[0]:.1f} ms); K4, K6, K7, K3 launches {launches}; its logits within "
        f"{err:.3e} of the largest logit of the fp32-compute run")
    del params, cache, src
    release()
    return dict(label=label, arch=arch, policy=policy, max_len=max_len, prompts=prompts,
                tokens=tokens, logits=logits, f32=f32, f32_err=err, whole=whole,
                layers=cfg.n_layers, tokens32=tokens32, logits32=logits32, routes32=routes32,
                moe=cfg.n_experts > 0)


def logit_share(got, want) -> float:
    """The largest ``|got - want|`` over the calls, each call's over its
    largest ``|want|`` (at least 1)."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) / max(1.0, float(np.abs(
        np.asarray(b)).max())) for a, b in zip(got, want, strict=True))


def _tp_rank_main(rank, world, store_path, jobs, out):
    """One rank of the tensor-parallel phase (a spawned process on
    ``cuda:0`` in a gloo group): each job of ``jobs`` in turn.  Puts
    ``(rank, results)`` or ``(rank, traceback)`` on ``out``."""
    import traceback

    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_process_group

        dev = jobs[0].get("dev", "cuda")
        if dev != "cpu":
            torch.backends.cuda.matmul.allow_tf32 = False
        init_process_group("gloo", rank=rank, world_size=world,
                           store=dist.FileStore(store_path, world), device=dev)
        res = {job["label"]: _tp_rank_cell(**job) for job in jobs}
        dist.destroy_process_group()
        out.put((rank, res))
    except Exception:  # the parent fails the phase with this traceback
        out.put((rank, traceback.format_exc()))


def _tp_rank_cell(label, arch, policy, max_len, prompts, forced, forced32, dev="cuda",
                  smoke=False, spec="1x2", steps=TP_STEPS):
    """One rank's run of a cell on the ``spec`` mesh: this rank's shards
    of the parameters drawn from seed 0 (each leaf drawn whole and sliced
    at once, so the whole model is never resident here; an
    encoder-decoder's drawn whole, its ``init_cache`` run over the source
    frames at bf16 and at fp32 compute, as the caller runs it, and then
    only the shards kept), the cache placed
    as the specs lay it out, the prompts prefilled and the one-process
    run's first ``steps`` tokens fed through ``jit_serve_fns``' prefill
    and decode (each layer gathered at its use).  Records the shapes K4, K6 and K7 launch at
    (their CUDA launch paths wrapped), the gathered parameter bytes alive
    at once and the layer gathers.  Then the same shards at fp32 compute
    (weights unchanged, an fp32 cache), fed the one-process fp32-compute
    run's tokens ``forced32``: its greedy tokens, logits, launches and MoE
    routing (:class:`RouteSpy`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import distributed, tree
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode as md
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.models import transformer
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import mesh_ctx, sharding
    from repro_torch.runtime.serve_loop import jit_serve_fns

    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    encdec = cfg.family == "encdec"
    mesh = rank_mesh(spec, dev)
    src = encdec_src(cfg, TP_BATCH, dev) if encdec else None
    like = model.init(None, "meta")
    like_c = serve_cache(model, like, None if src is None else src.to("meta"), max_len)
    compile_prefill, compile_decode, sh = jit_serve_fns(model, mesh, like, like_c, policy=policy)
    flat = dict(tree.leaves_with_paths(sh["params"]))
    shapes = {p: t.shape for p, t in tree.leaves_with_paths(like)}
    gpu = dev != "cpu"
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if encdec:  # the caller's init_cache (the encoder, whole) from whole weights, then the shards
        whole_p = model.init(torch.Generator(dev).manual_seed(0), dev)
        full, full32 = (serve_cache(m, whole_p, src, max_len) for m in (model, model32))
        local = tree.map_with_paths(lambda p, t: sharding.shard_one(t, flat[p]).clone(), whole_p)
        del whole_p
        gc.collect()
    else:
        local = transformer.lm_init(torch.Generator(dev).manual_seed(0), cfg,
                                    device=torch.device(dev), dtype=model.dtype,
                                    keep=lambda p, t: sharding.shard_one(t, flat[p]).clone())
        full = model.init_cache(local, TP_BATCH, max_len)
    resident = sum(t.nbytes for t in tree.leaves(local))
    params = tree.map_with_paths(lambda p, t: sharding.from_local(t, flat[p], shapes[p]), local)
    cflat = dict(tree.leaves_with_paths(sh["cache"]))
    cache = tree.map_with_paths(lambda p, t: sharding.from_local(
        sharding.shard_one(t, cflat[p]).clone(), cflat[p], t.shape), full)
    del full
    t_build = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() if gpu else resident
    seen = {"K4": set(), "K6": set(), "K7": set()}
    spied = [(md, "_rows_cuda", "K4", lambda q: q.shape[1]),
             (gd, "_decode_cuda", "K6", lambda q: tuple(q.shape[1:3])),
             (fp, "_prefill_cuda", "K7", lambda q: q.shape[1])]

    def spy(fn, key, shape):
        def call(q, *a, **k):
            seen[key].add(shape(q))
            return fn(q, *a, **k)

        return call

    originals = [(mod, name, getattr(mod, name)) for mod, name, _, _ in spied]
    for (mod, name, key, shape), (_, _, fn) in zip(spied, originals):
        setattr(mod, name, spy(fn, key, shape))
    calls, moved = {}, {}

    def counted(name, fn):
        def call(*a, **k):
            n0, b0 = dict(distributed.COLLECTIVES), sum(distributed.COLLECTIVE_BYTES.values())
            out = fn(*a, **k)
            calls.setdefault(name, []).append(
                {c: distributed.COLLECTIVES[c] - n0[c] for c in n0})
            moved.setdefault(name, []).append(sum(distributed.COLLECTIVE_BYTES.values()) - b0)
            return out

        return call

    try:
        zero_counts(tp_counters())
        mesh_ctx.TP_COUNTS.clear()
        p_like = torch.zeros((TP_BATCH, TP_PROMPT), dtype=torch.int64, device=dev)
        t_like = torch.zeros((TP_BATCH, 1), dtype=torch.int64, device=dev)
        with GatherSpy() as gathers:
            logits, tokens, t_prefill, times = tp_serve(
                counted("prefill", prompt_call(model, compile_decode(p_like)) if encdec
                        else compile_prefill(p_like)),
                counted("decode", compile_decode(t_like)), params, cache, prompts, forced=forced,
                dev=dev, steps=steps)
        launches = [c for c, _ in read_counts(tp_counters())]
        counts = dict(mesh_ctx.TP_COUNTS)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    peak = torch.cuda.max_memory_allocated() if gpu else 0
    # fp32 compute on the same shards from an fp32 cache, fed the one-process fp32 tokens
    compile_prefill, compile_decode, sh32 = jit_serve_fns(
        model32, mesh, like, serve_cache(model32, like, None if src is None else src.to("meta"),
                                         max_len), policy=policy)
    cflat = dict(tree.leaves_with_paths(sh32["cache"]))
    cache = tree.map_with_paths(lambda p, t: sharding.from_local(
        sharding.shard_one(t, cflat[p]).clone(), cflat[p], t.shape),
        full32 if encdec else model32.init_cache(local, TP_BATCH, max_len))
    full32 = None
    zero_counts(tp_counters())
    with RouteSpy() as routes32:
        logits32, tokens32 = tp_serve(
            prompt_call(model32, compile_decode(p_like)) if encdec else compile_prefill(p_like),
            compile_decode(t_like), params, cache, prompts, forced=forced32, dev=dev,
            steps=steps)[:2]
    launches32 = [c for c, _ in read_counts(tp_counters())]
    gc.collect()
    res = dict(logits=[x.numpy() for x in logits], tokens=tokens, t_prefill=t_prefill,
               times=times,
               t_build=t_build, resident=resident, allocated=allocated, peak=peak,
               whole=sum(t.nbytes for t in tree.leaves(like)), launches=launches,
               counts=counts, seen={k: sorted(v) for k, v in seen.items()},
               coll_prefill=calls["prefill"][0], coll_step=calls["decode"][-1],
               device=str(torch.cuda.current_device()) if gpu else "cpu", tokens32=tokens32,
               logits32=[x.numpy() for x in logits32], top32=routes32.top,
               launches32=launches32, **dict(gathers.summary(),
                                             gathered_live=distributed.GATHERED["live"]),
               bytes_prefill=moved["prefill"][0], bytes_step=moved["decode"][-1])
    del params, cache, local, src
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    return res


def tp_phase(card, dev="cuda", smoke=False):
    """Two ranks on ``cuda:0`` in a gloo group (NCCL refuses two ranks on
    one device), spawned, running ``jit_serve_fns`` split by ``model`` on
    a 1 x 2 mesh; the card's name and power limit ``card`` printed beside
    every number.

    (c) deepseek-v2-mla at full width (60 layers, bf16, amla) under
    ``tp``; (d) qwen2.5-3b at full width (36 layers) under ``tp_fsdp``;
    (h) qwen3-moe-30b-a3b at full width (48 layers, 128 experts) under
    ``tp``, each rank multiplying its 64 experts' slots (``"ep"``); (j)
    mamba2-370m at full width (48 layers, 32 heads x 64, state 128) under
    ``tp_fsdp``, each rank its 16 heads (its state's ds over ``model``:
    one all-to-all each way a call); (k) recurrentgemma-2b at full width
    (26 layers, 2560 RG-LRU channels, local attention 10 / 1 heads x 256
    over a 2048-key window) under ``tp``, each rank its 1280 channels and
    5 query heads; (m) seamless-m4t-medium at full width (12 + 12 layers,
    16 / 16 heads x 64, d_ff 4096, vocabulary 256 206, tied) under
    ``tp_fsdp`` in the reference's serving form: the caller's
    ``init_cache`` over 4 x 1024 frames, the prompts through the decode
    step at ``cache_len`` 0, each rank its 8 heads of every self- and
    cross-attention, its d_ff columns and vocabulary rows.  For each,
    first the one-process run in this process (4 prompts of 64 tokens, the cell's greedy decode steps: 16, (h) 8,
    (j) and (k) 4, (m) 2;
    :func:`tp_reference`), its weights freed; then each rank draws the
    same weights from seed 0 keeping only its shards, prefills the prompts
    and decodes the one-process run's tokens (:func:`_tp_rank_cell`), then
    runs the same shards at fp32
    compute, fed the one-process fp32-compute run's tokens.  Gates per
    rank: at fp32 compute all the decode steps' greedy tokens (and the
    prefill's) equal to the one-process fp32-compute run's (for (h), whose
    routing turns rounding into rerouted near-ties, ``TP_MIN_TOKENS`` in
    proportion and the first rerouted tokens near-ties: ``MOE_NEAR_TIE``),
    with the bf16 run's launches; at bf16 at least
    ``TP_MIN_TOKENS`` of the decode steps' greedy tokens equal to the
    one-process run's, every call's logits within ``TP_LOGIT_TOL`` of its
    largest one-process logit or, where the one-process bf16 run is
    itself farther than that from the fp32-compute run, at most
    ``TP_F32_FACTOR`` times as far from it, the rank's parameter bytes at most
    ``TP_RESIDENT_SHARE`` of the whole model's, every attention layer,
    MLP (or MoE layer's experts), lookup and logits split
    (``mesh_ctx.TP_COUNTS``: Mamba-2 and RG-LRU blocks too), no expert
    stack and no Mamba-2 or RG-LRU leaf gathered (:class:`GatherSpy`), K4
    at G 64 (c), K7 at 8 heads and K6 at 8 / 1 heads with K3 (d), K7 at 16
    heads and K6 at 16 / 2 heads with K3 (h), none (j), K7 at 5 heads and
    K6 at 5 / 1 heads with K3 (k), (attention) layers x calls launches;
    (m) K7 at 8 heads twice a layer at the prompt, K6 at 8 / 8 heads twice
    a layer a step, K3 after the split ones, and no attention, MLP or
    table leaf gathered; both ranks the same logits.  The step times are gloo on one
    card: collectives through host memory, the two ranks sharing the
    card's SMs; not a multi-card number.

    (g) qwen2.5-3b at full width under ``fsdp`` on 2 x 1 ranks
    (``FSDP_CELLS``): each rank draws its data shards of (d)'s weights and
    serves its 2 of the 4 rows, every layer's leaves gathered at their use,
    for the first 2 of (d)'s decode steps; held against those steps of
    (d)'s one-process runs (none runs again) by (d)'s token and logit gates
    (``TP_MIN_TOKENS`` in proportion), with K7 at 16 heads and K6 at 8 / 2 heads with K3,
    layers x calls launches, layers x calls layer gathers, the gathered
    bytes alive at once at most what the step gathers of its largest layer
    plus its largest gathered table (:class:`GatherSpy`: the tables are
    replicated under ``fsdp``, so one layer) and each rank's peak allocated below
    ``FSDP_PEAK_SHARE`` of the whole model's parameter bytes (a whole copy
    gathered at once could not meet it).  Returns the ranks' (K4, K6, K7,
    K3) launches."""
    held = f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB" if dev != "cpu" else "(CPU)"
    log(f"== tensor-parallel phase: jit_serve_fns split by model on 1 x 2 ranks (attention, "
        f"cross-attention, MLP, MoE experts, Mamba-2 and RG-LRU blocks, vocabulary), and FSDP "
        f"on 2 x 1 ranks (2 ranks on {dev}, spawned, gloo; {held} allocated in this process), card "
        f"{card} ==")
    t0 = time.perf_counter()
    refs = {label: tp_reference(label, dev, smoke) for label in TP_CELLS}
    cells = {**{label: (label, "1x2", TP_CELLS[label][1], TP_CELLS[label][3])
                for label in TP_CELLS}, **FSDP_CELLS}
    jobs = [dict(label=label, arch=refs[src]["arch"], policy=policy,
                 max_len=refs[src]["max_len"], prompts=refs[src]["prompts"],
                 forced=refs[src]["tokens"], forced32=refs[src]["tokens32"], dev=dev, smoke=smoke,
                 spec=spec, steps=steps)
            for label, (src, spec, policy, steps) in cells.items()]
    ranks = _spawn_ranks(2, (jobs,), TP_TIMEOUT, _tp_rank_main)
    log(f"two ranks spawned, ran {', '.join(f'({c})' for c in cells)} and exited; the phase "
        f"{time.perf_counter() - t0:.1f} s")
    total = [0, 0, 0, 0]
    failed, k3_encdec = [], 0
    if dev != "cpu":  # (m)'s K6 calls merged by K3: the self cache's 128 rows, the 1024 frames
        from repro_torch.kernels import gqa_decode as gd

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = lambda rows: gd.decode_splits(sms, TP_BATCH * TP_ENCDEC_GEOM[2],
                                               -(-rows // 512)) > 1
        k3_encdec = int(splits(TP_ENCDEC_MAX_LEN)) + int(splits(ENCDEC_FRAMES))
    for label, (src, spec, policy, steps) in cells.items():
        ref = refs[src]
        n, calls = ref["layers"], 1 + steps
        # the one-process run's first ``steps`` steps
        ref = dict(ref, logits=ref["logits"][:calls], f32=ref["f32"][:calls],
                   tokens=ref["tokens"][:, :calls], tokens32=ref["tokens32"][:, :calls],
                   logits32=ref["logits32"][:calls],
                   f32_err=logit_share(ref["logits"][:calls], ref["f32"][:calls]))
        min_tokens = TP_MIN_TOKENS * steps // TP_STEPS
        for r, res in enumerate(ranks):
            x = res[label]
            err = logit_share(x["logits"], ref["logits"])
            f32_err = logit_share(x["logits"], ref["f32"])
            agree = int((x["tokens"][:, 1:] == ref["tokens"][:, 1:]).sum())
            share = x["resident"] / ref["whole"]
            k4, k6, k7, k3 = x["launches"]
            split = tp_split_counts(ref["arch"], calls, smoke)
            na = attention_layers(ref["arch"], smoke)
            if label == "c":
                kernels_ok = (k4, k6, k7, k3) == (n * calls, 0, 0, 0) and 64 in x["seen"]["K4"]
            elif label == "d":
                kernels_ok = ((k4, k6, k7, k3) == (0, n * steps, n, n * steps)
                              and x["seen"]["K6"] == [(1, 8)] and x["seen"]["K7"] == [8])
            elif label == "h":  # 16 of 32 heads, 2 of 4 kv heads a rank
                kernels_ok = ((k4, k6, k7, k3) == (0, n * steps, n, n * steps)
                              and x["seen"]["K6"] == [(2, 8)] and x["seen"]["K7"] == [16])
            elif label == "j":  # no attention layer
                kernels_ok = (k4, k6, k7, k3) == (0, 0, 0, 0)
            elif label == "k":  # 5 of 10 query heads on the one kv head, in the local layers
                kernels_ok = ((k4, k6, k7, k3) == (0, na * steps, na, na * steps)
                              and x["seen"]["K6"] == [(1, 5)] and x["seen"]["K7"] == [5])
            elif label == "m":  # 8 of 16 heads: the prompt's self- and cross-attention (K7), each
                # step's (K6); no attention, MLP or table leaf gathered
                kernels_ok = ((k4, k6, k7, k3) == (0, 2 * n * steps, 2 * n, n * steps * k3_encdec)
                              and x["seen"]["K6"] == [(8, 1)] and x["seen"]["K7"] == [8]
                              and x["module_gathered"] == 0)
            else:  # all heads, each rank its rows
                kernels_ok = ((k4, k6, k7, k3) == (0, n * steps, n, n * steps)
                              and x["seen"]["K6"] == [(2, 8)] and x["seen"]["K7"] == [16])
            same = all(np.array_equal(a, b)
                       for a, b in zip(x["logits"], ranks[0][label]["logits"]))
            agree32 = int((x["tokens32"][:, 1:] == ref["tokens32"][:, 1:]).sum())
            same32 = np.array_equal(x["tokens32"], ref["tokens32"])
            err32 = logit_share(x["logits32"], ref["logits32"])
            if ref["moe"]:  # a rerouted token first appears at a near-tie (MOE_NEAR_TIE)
                flips = rerouted(ref["routes32"], x["top32"], n)
                ok32 = agree32 >= min_tokens and (flips["first"] is None or max(
                    flips["first_margins"]) <= MOE_NEAR_TIE * flips["median_margin"])
                must = (f"at least {min_tokens}; tokens rerouted {flips['rerouted']} of "
                        f"{flips['decisions']} routed, first at (call, layer) {flips['first']}"
                        + ("" if flips["first"] is None else
                           f": {flips['first_tokens']} tokens, one process's top-k margins "
                           f"{[f'{m:.2e}' for m in flips['first_margins'][:8]]} against that "
                           f"call's median {flips['median_margin']:.2e} (each at most "
                           f"{MOE_NEAR_TIE} x)"))
            else:
                ok32, must = same32, "must be all"
            log(f"({label}) rank {r} at fp32 compute (same shards, fp32 cache, fed the "
                f"one-process fp32-compute run's tokens): greedy tokens equal to its "
                f"{agree32} of {TP_BATCH * steps} (all, the prefill's included: {same32}; "
                f"{must}); logits within {err32:.3e} of its largest; launches K4, K6, K7, K3 "
                f"{x['launches32']}; card {card}")
            peak_share = x["peak"] / ref["whole"]
            gathers_ok = (x["gathered_peak"] <= x["gather_bound"] and not x["gathered_live"]
                          and x["layer_gathers"] == n * calls and x["expert_gathered"] == 0
                          and x["block_gathered"] == 0)
            log(f"({label}) rank {r} ({ref['arch']}, {policy} {spec}): gathered parameter bytes "
                f"alive at once at most {x['gathered_peak'] / 2**20:.1f} MiB (bound "
                f"{x['gather_bound'] / 2**20:.1f} MiB: the largest gathered layer plus the "
                f"largest gathered table), expert stacks gathered {x['expert_gathered']} B, "
                f"Mamba-2 / RG-LRU leaves gathered {x['block_gathered']} B (both must be 0), "
                f"attention, dense MLP and table leaves {x['module_gathered']} B ((m): must be 0), "
                f"{x['gathered_live']} B alive after; layer gathers "
                f"{x['layer_gathers']} (layers x calls {n * calls}); peak "
                f"{peak_share:.4f} of the whole model's parameter bytes; gloo GiB per decode "
                f"step {x['bytes_step'] / 2**30:.3f}, at the prefill "
                f"{x['bytes_prefill'] / 2**30:.3f}; card {card}")
            log(f"({label}) rank {r} ({ref['arch']}, {policy} {spec}): parameters held "
                f"{x['resident'] / 2**30:.2f} GiB = {share:.4f} of the whole "
                f"{ref['whole'] / 2**30:.2f} GiB (allocated after the build {x['allocated'] / 2**30:.2f} GiB, drawn in "
                f"{x['t_build']:.1f} s), peak {x['peak'] / 2**30:.2f} GiB; prefill "
                f"{x['t_prefill']:.1f} ms, {np.mean(x['times'][2:] or x['times']):.2f} ms/step "
                f"steady (steps {3 if steps > 2 else 1}-{steps}; first {x['times'][0]:.1f} ms); "
                f"gloo calls per decode step "
                f"{x['coll_step']}, at the prefill {x['coll_prefill']}; launches K4 {k4}, K6 "
                f"{k6}, K7 {k7}, K3 {k3} at K4 G {x['seen']['K4']}, K6 (kv heads, rows) "
                f"{x['seen']['K6']}, K7 heads {x['seen']['K7']}; split counts {x['counts']}; "
                f"logits within {err:.3e} of the largest one-process logit ({TP_LOGIT_TOL}: "
                f"{err <= TP_LOGIT_TOL}), within {f32_err:.3e} of the largest fp32-compute logit "
                f"against the one-process run's {ref['f32_err']:.3e} (at most {TP_F32_FACTOR} x); "
                f"greedy tokens equal {agree} of {TP_BATCH * steps} (at least "
                f"{min_tokens}); rank 0's logits: {same}; card {card}")
            close = err <= TP_LOGIT_TOL or f32_err <= TP_F32_FACTOR * ref["f32_err"]
            if label in FSDP_CELLS:  # no split; memory by the peak
                layout_ok = x["counts"] == {} and peak_share < FSDP_PEAK_SHARE
            else:
                layout_ok = share <= TP_RESIDENT_SHARE and x["counts"] == split
            if (not close or agree < min_tokens or not layout_ok or not gathers_ok
                    or not kernels_ok or not same):
                failed.append(f"({label}) rank {r}")
            if not ok32 or x["launches32"] != x["launches"]:
                failed.append(f"({label}) rank {r} at fp32 compute: tokens (or routing) not the "
                              "one-process fp32-compute run's, or its launches not the bf16 run's")
            total = [a + b + c for a, b, c in zip(total, x["launches"], x["launches32"])]
    if failed:
        raise SystemExit("tensor-parallel phase: outside its gates: " + ", ".join(failed))
    return tuple(total)


# --------------------------------------------------------------------------- #
# tensor-parallel train steps on ranks: heads, d_ff and vocabulary by model
# --------------------------------------------------------------------------- #
TP_TRAIN_TIMEOUT = 540.0  # s for the phase's two processes; then they are killed
# one step a cell: the cells move 16.6-24.5 GiB a step through gloo
# (28-52 s), and the whole script must stay inside 1200 s
TP_TRAIN_STEPS = 1
# label -> (arch, smoke widths, policy, compute dtype): (e) at fp32
# compute (the fp32 master state unchanged), (f) at the config's bf16;
# (i) smoke qwen3-moe at bf16, its experts split by expert: the expert
# products' fp32-output gradient (moe._WideProducts) on each rank's experts;
# (l1) / (l2) smoke mamba2 (4 of 8 heads a rank) and smoke recurrentgemma
# (64 of 128 RG-LRU channels, 2 of 4 query heads) at bf16: the split
# blocks' gradients (their gathered projections' cotangents summed over
# model, the partial leaves' gradients summed after); (n) smoke
# seamless-m4t-medium at bf16: the encoder's, the decoder's and the
# cross-attention's heads (2 of 4 a rank), MLPs and the tied table split
# (the full-width encoder-decoder train step would not fit the script's time)
TP_TRAIN_CELLS = {"e": ("qwen1.5-0.5b", False, "tp", "float32"),
                  "f": ("qwen1.5-0.5b", False, "tp_fsdp", "bfloat16"),
                  "i": ("qwen3-moe-30b-a3b", True, "tp", "bfloat16"),
                  "l1": ("mamba2-370m", True, "tp", "bfloat16"),
                  "l2": ("recurrentgemma-2b", True, "tp", "bfloat16"),
                  "n": ("seamless-m4t-medium", True, "tp", "bfloat16")}


def _tp_train_rank_main(rank, world, store_path, train, dev, smoke, out):
    """One rank of the tensor-parallel train phase (a spawned process on
    ``cuda:0`` in a gloo group).  Puts ``(rank, results)`` or ``(rank,
    traceback)`` on ``out``."""
    import traceback

    try:
        res = _tp_train_rank(rank, world, store_path, train, dev, smoke)
        del train
        _release_spawn_args()
        out.put((rank, res))
    except Exception:  # the parent fails the phase with this traceback
        out.put((rank, traceback.format_exc()))


def _tp_train_rank(rank, world, store_path, train, dev="cuda", smoke=False):
    """Each cell of ``TP_TRAIN_CELLS``: ``TP_TRAIN_STEPS`` steps of its
    model (``train[arch]``'s state) through ``jit_train_step`` on the 1 x 2 mesh (the first
    from the parent's full state, the next from this rank's shards).  Both
    ranks gather the state before each step and the new parameters after
    it; rank 0 holds the step against ``make_train_step`` on one rank from
    that state (:func:`_hold_rank_step`), at the cell's compute dtype and,
    for a bf16 cell, at fp32 compute too (the yardstick of its gate).
    Records the step times, the gloo calls and bytes of each step, the
    peak, the bytes of parameters + moments held, the split counts, what
    the loss computed on (the leaves ``mesh_ctx.working`` returned: each
    kept leaf's share of its whole) and K7's launches and head counts."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import distributed, tree
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import mla_decode_combine as comb
    from repro_torch.launch.mesh import init_process_group, rank_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import mesh_ctx, sharding
    from repro_torch.runtime.train_loop import jit_train_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("gloo", rank=rank, world_size=world,
                       store=dist.FileStore(store_path, world), device=dev)
    gpu = dev != "cpu"
    sync = torch.cuda.synchronize if gpu else (lambda: None)
    counters = (gd.gqa_decode_rows, comb.combine_split_partials, fp.flash_prefill)
    mesh = rank_mesh("1x2", dev)
    heads = set()
    prefill_cuda = fp._prefill_cuda

    def spy(q, *a, **k):
        heads.add(q.shape[1])
        return prefill_cuda(q, *a, **k)

    fp._prefill_cuda = spy
    working = mesh_ctx.working
    res = {}
    try:
        for label, (arch, cell_smoke, policy, dtype) in TP_TRAIN_CELLS.items():
            state0 = train[arch]
            base = get_config(arch, smoke=smoke or cell_smoke)
            cfg = dataclasses.replace(base, dtype=dtype)
            cfg32 = dataclasses.replace(base, dtype="float32")
            whole = {sharding.path_str(p): t.numel()
                     for p, t in tree.leaves_with_paths(state0["params"])}
            model = build_model(cfg)
            held = {}  # each leaf's elements in what the loss computed on

            def computed_on(sub, prefix):
                out = working(sub, prefix)
                for p, t in tree.leaves_with_paths(out):
                    held.setdefault(sharding.path_str(tuple(prefix) + p), t.numel())
                return out

            mesh_ctx.working = computed_on
            compile_for, sh = jit_train_step(model, state0["tc"], mesh, state0["params"],
                                             policy=policy)
            plan = sharding.tp_plan(cfg, mesh, policy, sh["params"])
            specs = {sharding.path_str(p): s.spec for p, s in tree.leaves_with_paths(sh["params"])}
            one_rank = make_train_step(build_model(cfg), state0["tc"])
            one32 = (None if dtype == "float32"
                     else make_train_step(build_model(cfg32), state0["tc"]))
            state = (state0["params"], state0["opt"], None)
            heads.clear()
            zero_counts(counters)
            mesh_ctx.TP_COUNTS.clear()
            sync()
            if gpu:
                torch.cuda.reset_peak_memory_stats()
            metrics, times, holds, coll = [], [], [], []
            for i, batch in enumerate(state0["batches"][:TP_TRAIN_STEPS]):
                before = [tree.tree_map(sharding.full_value, t) for t in state[:2]]  # gathered
                step = compile_for(batch)
                n0 = dict(distributed.COLLECTIVES), dict(distributed.COLLECTIVE_BYTES)
                sync()
                t0 = time.perf_counter()
                *state, m = step(*state, batch, 10 + i)
                metrics.append({k: float(v) for k, v in m.items()})
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
                coll.append((sum(distributed.COLLECTIVES.values()) - sum(n0[0].values()),
                             sum(distributed.COLLECTIVE_BYTES.values()) - sum(n0[1].values())))
                after = tree.tree_map(sharding.full_value, state[0])
                if rank == 0:  # the peer waits in the next collective meanwhile
                    counted, seen = read_counts(counters), set(heads)
                    h = _hold_rank_step(one_rank, before, after, metrics[-1], batch, 10 + i)
                    if one32 is not None:
                        h["f32"] = {k: float(v) for k, v in one32(*before, None, batch,
                                                                  10 + i)[3].items()}
                    holds.append(h)
                    for fn, (c, mma) in zip(counters, counted):  # the holds' launches not counted
                        fn.launches = c
                        if mma is not None:
                            fn.mma_launches = mma
                    heads.clear()
                    heads.update(seen)
                del before, after
            local = sum(x.to_local().nbytes for x in tree.leaves(state[:2]))
            kept = [n for n in whole if plan.keeps(n, specs[n])]
            res[label] = dict(
                metrics=metrics, times=times, holds=holds, coll=coll,
                launches=[c for c, _ in read_counts(counters)], heads=sorted(heads),
                peak=torch.cuda.max_memory_allocated() / 2**30 if gpu else 0.0, held_bytes=local,
                whole_bytes=3 * 4 * sum(whole.values()), counts=dict(mesh_ctx.TP_COUNTS),
                kept=len(kept), kept_halves=all(held[n] * 2 == whole[n] for n in kept),
                rest_whole=held.keys() == whole.keys() and all(
                    held[n] == whole[n] for n in whole if n not in kept),
                replicated=sorted(n for n in whole if not any(specs[n])), moe=plan.moe,
                n_layers=cfg.n_layers, rank_heads=cfg.n_heads // 2)
            del state, compile_for
            gc.collect()
            if gpu:
                torch.cuda.empty_cache()
    finally:
        fp._prefill_cuda = prefill_cuda
        mesh_ctx.working = working
    dist.destroy_process_group()
    return res


def tp_train_phase(card, dev="cuda", smoke=False):
    """Two ranks on ``cuda:0`` in a gloo group, spawned, running
    ``jit_train_step`` split by ``model`` on a 1 x 2 mesh: qwen1.5-0.5b at
    full width (24 layers, 16 heads x 64, d_ff 2816, vocabulary 151 936,
    tied), the global batch 8 x 2048 (seed 1), remat, ``TP_TRAIN_STEPS``
    steps of (e) ``tp`` at fp32 compute and (f) ``tp_fsdp`` at bf16, from
    the fp32 master state of seed 0, and of (i) smoke qwen3-moe-30b-a3b
    (2 layers, 8 experts over the 2 ranks by expert, 8 x 32), (l1) smoke
    mamba2-370m (2 Mamba-2 blocks, 4 of 8 heads a rank) and (l2) smoke
    recurrentgemma-2b (5 RG-LRU blocks, 64 of 128 channels a rank, and 2
    local attention layers) and (n) smoke seamless-m4t-medium (2 + 2
    layers, 2 of 4 heads of every encoder, decoder and cross-attention a
    rank, source frames bounded by ``src_len``) under ``tp`` at bf16
    (:func:`_tp_train_rank`).
    Rank 0
    holds each step against ``make_train_step`` on one rank from the same
    gathered state and batch.  Gates: (e) loss and ``grad_norm`` within
    ``RANK_TRAIN_REL``, the parameters by ``RANK_PARAM_TOL`` where the
    gradient exceeds 2^-8 of the model's largest (``resolved_model``: the
    zero-initialized biases and norm scales of this random model get
    gradients near 1e-4 of the model's largest, which the split's sums
    move by a fraction of the lr they step by) and within 2 lr
    everywhere; (f), (i), (l1) and (l2) loss and
    ``grad_norm`` within ``RANK_TRAIN_REL`` or no farther from the
    one-rank fp32-compute step than ``TP_F32_FACTOR`` times the one-rank
    bf16 step is; both ranks the same metrics; each kept leaf half its
    whole in what the loss computed on, every other leaf whole; a rank's
    parameters + moments at most ``TP_RESIDENT_SHARE`` of the whole; every
    attention layer, MLP (or MoE layer's experts), Mamba-2 and RG-LRU
    block, lookup and loss split
    (``mesh_ctx.TP_COUNTS``, the layers twice a step: remat; (n) once:
    the encoder-decoder ignores remat, as the reference does); K7 =
    attention layers x 2 x steps a rank at half the heads (8; (i), (l2) 2;
    none in (l1); (n) encoder layers + 2 x decoder layers a step, 2
    heads), no K6 or K3.  The
    step times are gloo through host memory on one card (the two ranks
    share its SMs), not a multi-card number.
    Returns the ranks' K7 launches.  ``tp_train_phase("x", dev="cpu",
    smoke=True)`` runs the phase on the CPU at smoke widths (its K7 gate
    fails there: the plain version counts no launches)."""
    log(f"== tensor-parallel train phase: jit_train_step split by model on 1 x 2 ranks (2 ranks "
        f"on {dev}, spawned, gloo), card {card} ==")
    t0 = time.perf_counter()
    train = {}  # each model's initial state, once
    for arch, cell_smoke, _, _ in TP_TRAIN_CELLS.values():
        if arch not in train:
            train[arch] = rank_train_state(TP_TRAIN_STEPS, dev, smoke or cell_smoke, arch=arch)
    ranks = _spawn_ranks(2, (train, dev, smoke), TP_TRAIN_TIMEOUT, _tp_train_rank_main)
    log(f"two ranks spawned, ran {', '.join(f'({c})' for c in TP_TRAIN_CELLS)} and exited; the "
        f"phase {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import get_config

    steps, k7, failed = TP_TRAIN_STEPS, 0, []
    rel = lambda a, b: abs(a - b) / abs(b)
    for label, (arch, cell_smoke, policy, dtype) in TP_TRAIN_CELLS.items():
        cfg = get_config(arch, smoke=smoke or cell_smoke)
        n = attention_layers(arch, smoke or cell_smoke)
        if cfg.family == "encdec":  # remat ignored; K7 once an encoder layer, twice a decoder layer
            split = tp_split_counts(arch, steps, smoke or cell_smoke, encoder=True)
            want7 = (cfg.encoder_layers + 2 * cfg.n_layers) * steps
        else:
            split = tp_split_counts(arch, steps, smoke or cell_smoke, layer_calls=2 * steps)
            want7 = n * 2 * steps
        for r, res in enumerate(ranks):
            x = res[label]
            k6, k3, k7x = x["launches"]
            share = x["held_bytes"] / x["whole_bytes"]
            log(f"({label}) rank {r} {arch} {policy} at {dtype} compute: " + "; ".join(
                f"loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f}" for m in x["metrics"])
                + f"; {', '.join(f'{t:.1f}' for t in x['times'])} ms/step (gloo through host "
                f"memory on one card, not a multi-card number); gloo calls / GiB a step "
                f"{[(c, round(b / 2**30, 3)) for c, b in x['coll']]}; peak {x['peak']:.2f} GiB; "
                f"parameters + moments held {x['held_bytes'] / 2**30:.3f} GiB = {share:.4f} of "
                f"the whole {x['whole_bytes'] / 2**30:.3f} GiB (replicated leaves: "
                f"{len(x['replicated'])}); kept leaves {x['kept']}, each half its whole in what "
                f"the loss computed on: {x['kept_halves']}, the rest whole: {x['rest_whole']}; "
                f"split counts {x['counts']} (experts {x['moe']}); K7 {k7x} at heads "
                f"{x['heads']}, K6 {k6}, K3 {k3}; card {card}")
            for i, h in enumerate(x["holds"]):
                one = h["one_rank"]
                line = (f"    step {i}: one rank from the same state: loss {one['loss']:.6f} "
                        f"grad_norm {one['grad_norm']:.6f}; relative: loss {h['loss']:.2e}, "
                        f"grad_norm {h['grad_norm']:.2e} (tol {RANK_TRAIN_REL}); params where the "
                        f"gradient exceeds 2^-8 of the model's largest {h['resolved_model']:.2e} of "
                        f"the leaf max (tol {RANK_PARAM_TOL}; {h['worst']['resolved_model']}), of "
                        f"the leaf's largest {h['resolved']:.2e} ({h['worst']['resolved']}), "
                        f"everywhere {h['anywhere']:.3f} x 2 lr (tol 1; {h['worst']['anywhere']})")
                ok = max(h["loss"], h["grad_norm"]) <= RANK_TRAIN_REL
                if "f32" in h:
                    m, f32 = x["metrics"][i], h["f32"]
                    far = {k: (rel(m[k], f32[k]), rel(one[k], f32[k])) for k in ("loss", "grad_norm")}
                    line += "; from the one-rank fp32-compute step: " + ", ".join(
                        f"{k} split {a:.2e} vs one-rank bf16 {b:.2e}" for k, (a, b) in far.items())
                    ok = ok or all(a <= TP_F32_FACTOR * b for a, b in far.values())
                else:
                    ok = ok and h["resolved_model"] <= RANK_PARAM_TOL and h["anywhere"] <= 1 + 1e-4
                log(line)
                if not ok:
                    failed.append(f"({label}) step {i}: outside the one-rank step's bounds")
            if (x["metrics"] != ranks[0][label]["metrics"] or share > TP_RESIDENT_SHARE
                    or not (x["kept_halves"] and x["rest_whole"] and x["kept"] > 0)
                    or x["counts"] != split or (k6, k3, k7x) != (0, 0, want7)
                    or x["heads"] != ([x["rank_heads"]] if n else [])
                    or (r == 0) != (len(x["holds"]) == steps)):
                failed.append(f"({label}) rank {r}: metrics differ from rank 0's, or the split's "
                              "leaves, counts, share or K7 launches are not as gated")
            k7 += k7x
    if failed:
        raise SystemExit("tensor-parallel train phase: " + "; ".join(failed))
    del train
    return k7


def mma_ptxas(log_text):
    """ptxas's spill and register lines for each instantiation of the
    tensor-core kernels: [((kernel, pool, kM, amla), spill line, register
    line)], read from the mangled name (``I<pool>Li<kM>ELb<amla>E``)."""
    pools = {"13__nv_bfloat16": "bf16", "a": "int8", "": "bf16"}  # K6/K7: bf16 only
    out = []
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        kernel = next((k for k in MMA_KERNELS if k in line), None)
        if "Compiling entry function" in line and kernel is not None:
            mangled = line.split(kernel, 1)[1]
            pool, rest = mangled[1:].split("Li", 1)
            args = (kernel, pools.get(pool, pool), int(rest[0]),
                    rest.split("Lb", 1)[1][0] == "1")
            after = lines[i + 1:i + 5]
            spill = next((x.strip() for x in after if "spill" in x), "")
            regs = next((x.strip() for x in after if "registers" in x), "")
            out.append((args, spill, regs))
    return out


def build_phase() -> None:
    """Build the kernels; print ptxas's lines and fail on a spill or a
    missing tensor-core instantiation."""
    from repro_torch.kernels import _build

    log("== build ==")
    t0 = time.perf_counter()
    _build.load()
    res = _build.last_build()
    log(f"built {res.path} in {res.seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  " + line.strip())
    if not res.log:
        log(f"  (library already built: no ptxas lines for {list(MMA_KERNELS)})")
        return
    found = mma_ptxas(res.log)
    lib = _build.load()
    for (kernel, pool, k_m, amla), spill, regs in sorted(found):
        block_k = MMA_KERNELS[kernel][1]
        if kernel in GQA_MMA_KERNELS:
            smem, at = lib.amla_gqa_rows_mma_smem(k_m, 256, block_k), "Dh 256"
        else:
            smem = lib.amla_mla_rows_mma_smem(k_m, 2 if pool == "int8" else 1, 128, DK, DV,
                                              block_k)
            at = f"Dk {DK}"
        log(f"  {kernel}<{pool}, kM={k_m}, amla={amla}>: {regs}; {spill}; "
            f"smem_bytes at {at}, block_k {block_k}: {smem}")
    spilled = [a for a, spill, _ in found if "0 bytes spill stores, 0 bytes spill loads" not in spill]
    counts = {k: sum(a[0] == k for a, _, _ in found) for k in MMA_KERNELS}
    want = {k: n for k, (n, _) in MMA_KERNELS.items()}
    if counts != want or spilled:
        raise SystemExit(f"build: the tensor-core kernels' ptxas lines show spills or are "
                         f"missing (found {counts} of {want}; spilled: {spilled})")


def release() -> None:
    """Free what the last phase left: its sessions (in reference cycles
    through the timing and hold wrappers, so only a collection frees them,
    and with them their CUDA graphs' memory pools), the tensors it shared
    with spawned ranks that have released them (``ipc_collect``) and the
    cached blocks."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if not (argv in ([], ["--k3-only"]) or (len(argv) == 2 and argv[0] == "--k6-ab")):
        print("usage: chip_smoke.py [--k3-only | --k6-ab OTHER_TREE/src]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

    if argv[:1] == ["--k6-ab"]:  # K6 without partials against another tree's, bit for bit
        return 0 if k6_ab(argv[1]) else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_phase()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    if argv == ["--k3-only"]:  # K3 alone at the shapes of its uses
        k3rows, _ = k3_phase(flush)
        print(json.dumps({"k3": k3rows, "card": smi}), flush=True)
        return 0
    worst, rows = kernel_phase(flush)
    dworst, drows = dense_kernel_phase(flush)
    fworst, _ = family_kernel_phase(flush)
    vworst, _ = vlm_encdec_kernel_phase(flush)
    tworst, trows = slice3_kernel_phase(flush)
    nworst, nrows = trie_kernel_phase(flush)
    k3rows, k3err = k3_phase(flush)
    hworst, _ = head_chunk_kernel_check(flush)
    sworst, _, _ = split_kv_kernel_check(flush)
    pworst, _ = tp_kernel_phase(flush)
    mworst = mma_rows_kernel_phase()
    del flush
    release()
    small_reference_check()
    small_dense_check()
    small_int8_prefix_check()
    small_trie_spec_check()
    small_interleave_suspend_check()
    small_sharded_check()
    small_seqkv_check()
    release()
    k6, k7, k3g = gemma_dense_phase()
    release()
    torch.cuda.reset_peak_memory_stats()
    k2, k3, paged, first = serve_phase()
    release()
    k2h, k3h = sharded_phase(*paged, first)
    del first
    release()
    k2b, k2pb, k3b = shared_prefix_phase(*paged[:3], "bf16")
    release()
    k2i8, k2p, k3i8 = shared_prefix_phase(*paged[:3], "int8")
    release()
    k2t, k2pt, k3t = trie_serve_phase(*paged[:3])
    release()
    k2s, k3s = spec_serve_phase(*paged[:4], paged[4])
    release()
    k2l, k3l = sla_serve_phase(*paged[:3])
    release()
    k2c, k3c = chaos_serve_phase(*paged[:3])
    release()
    k4 = mla_dense_phase(*paged)
    roofline_decode_cell(*paged[:3], smi)
    del paged
    release()
    k5, _ = padded_decode_phase()
    release()
    k6f, k7f, k3f = families_phase()
    release()
    k6v, k7v, k3v = vlm_encdec_phase()
    release()
    k6q, k3q, handoff = seqkv_phase(smi)
    release()
    k6r, k7r, k3r = ranks_phase(smi, handoff)
    del handoff
    release()
    k4p, k6p, k7p, k3p = tp_phase(smi)
    release()
    k7tt = tp_train_phase(smi)
    release()
    _, (k7tr, k6tr, k3tr) = train_phases(smi)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    dryrun_cli_check(smi)

    err = lambda name: max(v for k, v in worst.items() if k[0] == name)
    derr = lambda name: max(v for d in (dworst, fworst, vworst, pworst) for k, v in d.items()
                            if k[0] == name)
    terr = lambda name: max(v for k, v in tworst.items() if k[0] == name)
    merr = lambda name: max(v for k, v in mworst.items() if k[0] == name)
    nerr = lambda name: max(v for k, v in nworst.items() if k[0] == name)
    herr = lambda name: max(v for k, v in hworst.items() if k[0] == name)
    d2, d3 = rows["decode"], k3rows["(a) paged decode"]
    t8, tp, tpi, t5 = trows["K2-int8"], trows["K2'"], trows["K2' int8"], trows["K5"]
    t4, t6, t7 = drows["K4", "deepseek decode"], drows["K6", "gemma2-2b decode"], drows[
        "K7", "gemma2-2b prefill 2048"]
    mma_src = "src/repro_torch/csrc/mla_rows_mma.cuh"
    kernels = [
        dict(name="mla_decode_paged_queue_rows", route="cuda", source=mma_src,
             replaces="src/repro/kernels/mla_decode_paged.py:490",
             launches=k2 + k2b + k2t + k2s + k2l + k2c + k2h,
             max_abs_err=max(err("mla_decode_paged_queue_rows"),
                             nerr("mla_decode_paged_queue_rows"), nerr("verify-vs-single"),
                             herr("mla_decode_paged_queue_rows")),
             ms=d2[0], plain_ms=d2[1],
             bound_ms=d2[2], bound_by=d2[3], library_ms=d2[4]),
        dict(name="mla_decode_paged_queue_rows[int8]", route="cuda", source=mma_src,
             replaces="src/repro/kernels/mla_decode_paged.py:490", launches=k2i8,
             max_abs_err=terr("K2-int8"), ms=t8[0], plain_ms=t8[1], bound_ms=t8[2],
             bound_by=t8[3], library_ms=t8[4]),
        dict(name="mla_decode_paged_group_prefix", route="cuda", source=mma_src,
             replaces="src/repro/kernels/mla_decode_paged.py:618", launches=k2pb + k2pt,
             max_abs_err=max(terr("K2'"), nerr("K2' nested")), ms=tp[0], plain_ms=tp[1],
             bound_ms=tp[2],
             bound_by=tp[3], library_ms=tp[4]),
        dict(name="mla_decode_paged_group_prefix[int8]", route="cuda", source=mma_src,
             replaces="src/repro/kernels/mla_decode_paged.py:618", launches=k2p,
             max_abs_err=terr("K2' int8"), ms=tpi[0], plain_ms=tpi[1], bound_ms=tpi[2],
             bound_by=tpi[3], library_ms=tpi[4]),
        dict(name="combine_split_partials", route="cuda",
             source="src/repro_torch/csrc/mla_decode_combine.cu",
             replaces="src/repro/kernels/mla_decode_combine.py:83",
             launches=k3 + k3b + k3i8 + k3g + k3t + k3s + k3l + k3c + k3f + k3v + k3tr + k3h
             + k3q + k3r + k3p,
             max_abs_err=max(err("combine_split_partials"), k3err, nerr("combine_split_partials"),
                             nerr("K3 chain 2"), herr("combine_split_partials")), ms=d3[0], plain_ms=d3[1],
             bound_ms=d3[2], bound_by=d3[3], library_ms=None),
        dict(name="mla_decode_rows", route="cuda", source="src/repro_torch/csrc/mla_decode.cu",
             replaces="src/repro/kernels/mla_decode.py:401", launches=k4 + k4p,
             max_abs_err=max(derr("K4"), merr("K4")), ms=t4[0], plain_ms=t4[1], bound_ms=t4[2],
             bound_by=t4[3], library_ms=t4[4]),
        dict(name="mla_decode_paged_rows", route="cuda",
             source="src/repro_torch/csrc/mla_decode_paged_padded.cu",
             replaces="src/repro/kernels/mla_decode_paged.py:261", launches=k5,
             max_abs_err=max(terr("K5"), merr("K5")), ms=t5[0], plain_ms=t5[1], bound_ms=t5[2],
             bound_by=t5[3], library_ms=t5[4]),
        dict(name="gqa_decode_rows", route="cuda", source=mma_src,
             replaces="src/repro/kernels/gqa_decode.py:147",
             launches=k6 + k6f + k6v + k6tr + k6q + k6r + k6p,
             max_abs_err=max(derr("K6"), sworst["plain"]), ms=t6[0], plain_ms=t6[1],
             bound_ms=t6[2],
             bound_by=t6[3], library_ms=t6[4]),
        dict(name="flash_prefill", route="cuda", source=mma_src,
             replaces="src/repro/kernels/flash_prefill.py:149",
             launches=k7 + k7f + k7v + k7tr + k7r + k7p + k7tt,
             max_abs_err=derr("K7"), ms=t7[0], plain_ms=t7[1], bound_ms=t7[2],
             bound_by=t7[3], library_ms=t7[4]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
