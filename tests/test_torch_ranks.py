"""The sharded steps run rank-locally on a ``torch.distributed`` group of
several ranks, on the CPU: ``jit_serve_fns`` (prefill and decode, split-KV
decode across ranks through K6's plain version), ``jit_train_step``,
``reshard_train_state``, ``launch/train``'s data split, and the gathers
and slices of ``runtime.sharding`` and the differentiable collectives
over ``model`` underneath.  Checkpoints of the sharded train state: each
rank saves and restores its own shards into one step directory, committed
once (``CKPT_CASES``; a missing shard, another mesh, one process), through
``TrainingSupervisor`` and ``launch/train --ckpt-dir``, and the
reference's manager reads each rank's file.

The ranks are spawned processes in a gloo group on a ``FileStore`` under
the test's temporary directory (no port, so xdist workers cannot collide),
one thread each; they import no JAX (``torch_ranks_worker``).  All cases
of one world size run in one spawn (2 ranks: the 1 x 2 and 2 x 1 meshes;
4 ranks: 2 x 2), each spawn bounded by ``JOIN_TIMEOUT`` after which its
ranks are killed and the tests fail.  The JAX references run here, in
this process, as a single-device ``jax.jit``, which has the semantics of
the reference's sharded step.

Every rank step hands the model this rank's shards of the parameters,
and the model gathers each layer's leaves, and each table, at its use
(``mesh_ctx.working``; inside the remat'd layer, again in its
recompute): each serve and train case also checks that the handed tree
is the rank's shards, that every leaf the model computed on went through
that gather, the layers' gather order, and, where no layer is kept for
the backward, that the gathered bytes alive at once stay within the
largest layer plus the largest table; the gather's adjoint (the
cotangent summed over the gathered rows' axes, then this rank's slice) is
exact over ``SPECS``.  A serve step handed the parameters as whole tensors
uses them as they are and gathers nothing.

Under ``tp`` and ``tp_fsdp`` with several ``model`` ranks the serve step
splits its compute (heads, d_ff and d_model columns, vocabulary, Mamba-2
heads, RG-LRU channels): each case also checks that every leaf the split
keeps local is ``1 / m`` of its whole in what the model computed on, and
that every attention layer, MLP, Mamba-2 or RG-LRU block, lookup and
logits ran split (``mesh_ctx.TP_COUNTS``); 6 query heads over 4 ranks run
whole, counted so, and so do 6 Mamba-2 heads over 4 (``ssm_whole``).  A
split Mamba-2 or RG-LRU block computes its heads or channels and keeps
its state there (``TPPlan.state_caches``); one block on 2 ranks is held
against one process's and the reference's at a prefill of SSD chunks
and at one decode row.  A MoE
layer's experts split by ``model`` as the specs lay them out: by expert
(``"ep"``, qwen3-moe's 8 over 2; under ``tp_fsdp`` each rank also takes
its share of the capacity over ``data``) or within each expert by d_ff
(``"ff"``, granite-moe with 6 experts over 4): every rank routes the
gathered batch exactly as one process does, computes on ``1 / m`` of each
expert stack, gathers none of them, and its layer output at fp32 is held
against one process's on the same tokens by ``STEP_TOL``; the expert
outputs' gather has an exact adjoint.

Bounds: ``seqkv`` decode across ranks is bit-equal to the one-process run
on the logical mesh over the same rows (the same K6 slices, the partials
gathered in coordinate order, the same merge), and within
``tests/test_perf_paths.py``'s rtol/atol 2e-2 of the reference.  Other
policies against the one-process run and the reference by
``tests/test_torch_model.py``'s 2e-3 (fewer matmul rows or columns per
rank round differently on the CPU), greedy tokens at fp32 equal to the
one-process run's.  Training against ``make_train_step`` on one
rank: the first step's loss, ``grad_norm`` and first moment (0.1 x the
clipped gradient) within 1e-6 relative, the parameters by
``tests/test_torch_train_loop.py``'s rule (Adam's first step turns a
rounding-level gradient into +-lr); loss and ``grad_norm`` against the
reference's step by that file's bounds.  The train step splits under
``tp`` / ``tp_fsdp`` with several ``model`` ranks too (the same checks of
what it computed on and of ``TP_COUNTS``); where it splits, attention's
bf16-rounded input cotangents move the first moment by up to a bf16 step
(``SPLIT_MU_TOL``), and controls with fp32 products there hold it within
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_train_loop
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.runtime.sharding import path_str
from torch_ranks_worker import SPECS, run_ranks

MODEL_TOL = 2e-3  # tests/test_torch_model.py
SEQKV_TOL = 2e-2  # tests/test_perf_paths.py
STEP_TOL = 1e-6  # rank step against the one-rank step
LOSS_TOL, NORM_TOL = 1e-5, 1e-4  # tests/test_torch_train_loop.py, against the reference
PARAM_TOL = 2e-3
FLIP_SHARE = 1e-3  # int8 elements whose stochastic rounding lands the other way
B, PROMPT, DECODE, MAX_LEN = 2, 12, 2, 16
TRAIN = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20, remat=False)


def max_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def ref_pair(arch, changes=None):
    """(reference model, its params, the port's converted params) of the
    smoke ``arch`` with the config ``changes``."""
    import dataclasses

    changes = changes or {}
    ref_model = ref_build_model(dataclasses.replace(ref_get_config(arch, smoke=True), **changes))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, ref_params, convert_params(
        ref_params, dataclasses.replace(get_config(arch, smoke=True), **changes), device="cpu")


def tokens_for(arch, seed=3):
    vocab = get_config(arch, smoke=True).vocab_size
    rng = np.random.default_rng(seed)
    return rng.integers(2, vocab, size=(B, PROMPT)), rng.integers(2, vocab, size=(B, DECODE))


def ref_serve(ref_model, ref_params, prompt, tokens):
    """The reference's prefill and teacher-forced decode logits, each call a
    single-device ``jax.jit``."""
    prefill = jax.jit(lambda p, c, t: ref_model.prefill(p, c, t))
    decode = jax.jit(lambda p, c, t, n: ref_model.decode_step(p, c, t, n))
    cache = ref_model.init_cache(ref_params, B, MAX_LEN)
    logits, cache = prefill(ref_params, cache, jnp.asarray(prompt))
    out = [np.asarray(logits)]
    for i in range(tokens.shape[1]):
        logits, cache = decode(ref_params, cache, jnp.asarray(tokens[:, i:i + 1]),
                               jnp.int32(PROMPT + i))
        out.append(np.asarray(logits))
    return out


def train_batches(arch="qwen1.5-0.5b"):
    """Two global batches of 8 x 32 (seed 0); an encoder-decoder's also
    carry 16 source frames a row (numpy seed 4, x 0.02) and ``src_len``
    (some rows shorter: the cross-attention's bound)."""
    cfg = get_config(arch, smoke=True)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    batches = [data.batch_at(0), data.batch_at(1)]
    if cfg.family == "encdec":
        rng = np.random.default_rng(4)
        for batch in batches:
            batch["src_embeds"] = (rng.standard_normal((8, 16, cfg.d_model))
                                   * 0.02).astype(np.float32)
            batch["src_len"] = rng.integers(9, 17, size=8).astype(np.int32)
    return batches


# reference key -> (arch, config changes), for a serve case whose model is
# the smoke config changed (the JAX reference is given the same change)
VARIANTS = {
    # capacity factor 0.6: the prefill's 48 routed choices take 4 slots an
    # expert (half the mean: tokens dropped; 4 splits over data 2, where
    # 0.5's 3 would not) and a decode step's 1
    "qwen3-moe drops": ("qwen3-moe-30b-a3b", dict(capacity_factor=0.6)),
    # 6 experts do not split over model 4; their d_ff of 32 does
    "granite-moe 6 experts": ("granite-moe-3b-a800m", dict(n_experts=6)),
}


def arch_of(key):
    return VARIANTS[key][0] if key in VARIANTS else key


SERVE = {  # name -> (arch or VARIANTS key, mesh, policy, world)
    "seqkv 1x2": ("qwen2.5-3b", "1x2", "seqkv", 2),
    # FSDP: each layer's leaves gathered over data at their use
    "fsdp 2x1": ("qwen2.5-3b", "2x1", "fsdp", 2),
    "mla fsdp 2x1": ("deepseek-v2-mla", "2x1", "fsdp", 2),
    "tp 1x2": ("qwen2.5-3b", "1x2", "tp", 2),
    "tp_fsdp 2x1": ("qwen2.5-3b", "2x1", "tp_fsdp", 2),
    "mla tp_fsdp 2x1": ("deepseek-v2-mla", "2x1", "tp_fsdp", 2),
    "mla tp 1x2": ("deepseek-v2-mla", "1x2", "tp", 2),
    "gemma tp 1x2": ("gemma2-2b", "1x2", "tp", 2),
    # MoE: each rank multiplies its experts (8 over model 2: "ep")
    "moe tp 1x2": ("qwen3-moe-30b-a3b", "1x2", "tp", 2),
    # Mamba-2: each rank its 4 of 8 heads (the state a replica: each rank
    # writes its heads', the others' gathered after the call)
    "mamba2 tp 1x2": ("mamba2-370m", "1x2", "tp", 2),
    # the state's ds over model: one all-to-all to the rank's heads and back
    "mamba2 tp_fsdp 1x2": ("mamba2-370m", "1x2", "tp_fsdp", 2),
    # RG-LRU: each rank its 64 of 128 channels; the local attention's 2 of 4
    # query heads on the whole kv head
    "recurrentgemma tp 1x2": ("recurrentgemma-2b", "1x2", "tp", 2),
    "seqkv 2x2": ("qwen2.5-3b", "2x2", "seqkv", 4),
    "tp_fsdp 2x2": ("qwen2.5-3b", "2x2", "tp_fsdp", 4),
    "tp 2x2": ("qwen2.5-3b", "2x2", "tp", 4),
    "mla tp_fsdp 2x2": ("deepseek-v2-mla", "2x2", "tp_fsdp", 4),
    # kv 2 over model 4: wk / wv stay whole (the Megatron rule), each rank
    # slices the kv head its query head reads
    "tp 1x4": ("qwen2.5-3b", "1x4", "tp", 4),
    # "ep" with the capacity split over data too, and tokens dropped
    "moe tp_fsdp 2x2 drops": ("qwen3-moe drops", "2x2", "tp_fsdp", 4),
    # "ff": each rank multiplies its 8 of every expert's 32 d_ff columns
    "granite ff tp 1x4": ("granite-moe 6 experts", "1x4", "tp", 4),
    # the state's channels over model (the rank's part in place), rows over data
    "recurrentgemma tp_fsdp 2x2": ("recurrentgemma-2b", "2x2", "tp_fsdp", 4),
}
# the MoE serve cases: name -> the split of the experts
MOE_SERVE = {"moe tp 1x2": "ep", "moe tp_fsdp 2x2 drops": "ep", "granite ff tp 1x4": "ff"}
# the encoder-decoder's serve cases: name -> (mesh, policy, world); smoke
# seamless-m4t-medium (MHA 4 / 4 heads): each rank its 2 heads of every
# self- and cross-attention (tp_fsdp: the cross K/V's width over model, one
# all-to-all a call to the rank's heads)
ENCDEC = "seamless-m4t-medium"
ENCDEC_SERVE = {"seamless tp 1x2": ("1x2", "tp", 2), "seamless tp_fsdp 1x2": ("1x2", "tp_fsdp", 2),
                "seamless tp_fsdp 2x2": ("2x2", "tp_fsdp", 4)}
SRC_LEN = 20  # source frames of the encoder-decoder's serve cases
# 6 heads do not split over model 4: every encoder and decoder attention
# and every cross-attention runs whole, counted so; MLPs and vocabulary split
WHOLE_ENCDEC = dict(spec="1x4", policy="tp", cfg_changes=dict(n_heads=6, n_kv_heads=6),
                    whole=("attn", "cross"))
# the same cases with the parameters handed as whole tensors, which a serve
# step uses as they are (nothing gathered): name -> the placed case
SERVE_WHOLE = {"seqkv 1x2 whole": "seqkv 1x2", "fsdp 2x1 whole": "fsdp 2x1",
               "tp_fsdp 2x2 whole": "tp_fsdp 2x2"}
# 6 query heads do not split over model 4 (wq's 96 columns do, off head
# boundaries): the attention runs whole after the gather, counted as such
WHOLE_HEADS = dict(arch="qwen2.5-3b", spec="1x4", policy="tp", cfg_changes=dict(n_heads=6),
                   whole=("attn",))
# 6 Mamba-2 heads (d_inner 96) do not split over model 4: every block runs
# whole after the gather, counted ssm_whole; the vocabulary splits
WHOLE_SSM = dict(arch="mamba2-370m", spec="1x4", policy="tp", cfg_changes=dict(d_inner=96),
                 whole=("ssm",))
# the block-level cases: name -> (arch, block, sequence length): a prefill
# past the SSD chunk (300: padded to 512) and one decode row, from a
# nonzero state
BLOCKS = {f"block {kind} {s}": (arch, kind, s) for arch, kind in (("mamba2-370m", "ssm"),
                                                                 ("recurrentgemma-2b", "rec"))
          for s in (300, 1)}
TRAIN_CASES = {  # name -> (arch, mesh, policy, compression, grad_accum, world[, options])
    "2x1 tp_fsdp none": ("qwen1.5-0.5b", "2x1", "tp_fsdp", "none", 1, 2),
    "2x1 tp_fsdp int8": ("qwen1.5-0.5b", "2x1", "tp_fsdp", "int8", 1, 2),
    "2x1 fsdp none accum2": ("qwen1.5-0.5b", "2x1", "fsdp", "none", 2, 2),
    "2x2 tp_fsdp none": ("qwen1.5-0.5b", "2x2", "tp_fsdp", "none", 1, 4),
    "2x2 fsdp int8 accum2": ("qwen1.5-0.5b", "2x2", "fsdp", "int8", 2, 4),
    # remat: each layer gathered inside its checkpoint, again in the
    # recompute; the gathered bytes alive at once within a layer and a table
    "2x1 fsdp none remat": ("qwen1.5-0.5b", "2x1", "fsdp", "none", 1, 2, dict(remat=True)),
    "2x2 tp_fsdp none remat": ("qwen1.5-0.5b", "2x2", "tp_fsdp", "none", 1, 4,
                               dict(remat=True)),
    # MoE: the routing sees the gathered batch; its gradient flows back
    # through the gather's adjoint (the cotangent summed over the ranks)
    "moe 2x1 tp_fsdp none": ("qwen3-moe-30b-a3b", "2x1", "tp_fsdp", "none", 1, 2),
    # the experts split by model ("ep"): each rank's experts' gradients
    # whole for its slots, summed over the rows' axes only; under tp_fsdp
    # each rank multiplies its share of the capacity too
    "moe tp 1x2 none": ("qwen3-moe-30b-a3b", "1x2", "tp", "none", 1, 2),
    "moe tp_fsdp 2x2 none remat": ("qwen3-moe-30b-a3b", "2x2", "tp_fsdp", "none", 1, 4,
                                   dict(remat=True)),
    # split by model: heads, d_ff columns, vocabulary rows (a
    # vocabulary-parallel loss); accum2 under remat (the collectives
    # called again in the recompute)
    "tp 1x2 none": ("qwen1.5-0.5b", "1x2", "tp", "none", 1, 2),
    "tp 1x2 none accum2": ("qwen1.5-0.5b", "1x2", "tp", "none", 2, 2, dict(remat=True)),
    "tp_fsdp 1x2 int8": ("qwen1.5-0.5b", "1x2", "tp_fsdp", "int8", 1, 2),
    "mla tp 1x2 none": ("deepseek-v2-mla", "1x2", "tp", "none", 1, 2),
    # 3 query heads do not split over model 2 (wq's 48 columns do, off
    # head boundaries): attention runs whole, counted so; MLP and
    # vocabulary split
    "whole heads tp 1x2 none": ("qwen1.5-0.5b", "1x2", "tp", "none", 1, 2, dict(
        cfg_changes=dict(n_heads=3, n_kv_heads=3), whole=("attn",))),
    # the controls: the same splits with the blockwise attention's
    # products at fp32 (no bf16 rounding of its inputs' cotangents)
    "tp 1x2 none, fp32 products": ("qwen1.5-0.5b", "1x2", "tp", "none", 1, 2, dict(
        f32_products=True)),
    "mla tp 1x2 none, fp32 products": ("deepseek-v2-mla", "1x2", "tp", "none", 1, 2, dict(
        f32_products=True)),
    # the Mamba-2 blocks split by heads, the RG-LRU blocks by channels (the
    # gathered projections' uses are the rank's own: tp.copy sums their
    # cotangents); conv_b, a_log, dt_bias, d_skip, lam partial
    "mamba2 1x2 tp none": ("mamba2-370m", "1x2", "tp", "none", 1, 2),
    "recurrentgemma 1x2 tp_fsdp none remat": ("recurrentgemma-2b", "1x2", "tp_fsdp", "none", 1,
                                              2, dict(remat=True)),
    # the encoder-decoder: encoder and decoder self-attention, cross-attention
    # (its K/V from the encoder output, replicated: tp.products), MLPs and the
    # tied table split; source frames bounded by src_len; fp32 products in the
    # attention backward (F32_SPLIT)
    "seamless 1x2 tp none": (ENCDEC, "1x2", "tp", "none", 1, 2, dict(f32_products=True)),
    "seamless 2x2 tp_fsdp none": (ENCDEC, "2x2", "tp_fsdp", "none", 1, 4, dict(
        f32_products=True)),
}
# The MoE layer's input cotangent is a sum over the ranks, added in another
# order than one rank's backward adds it; upstream, attention rounds its
# input gradients to bf16 (tests/test_torch_train_loop.py), and a rounding
# that lands one step apart moves a first moment by up to one bf16 step of
# its leaf's largest: that file's GRAD_TOL (measured 1.9e-4 of a leaf's
# largest, 2.6e-5 of the whole moment's norm).  Loss and grad_norm stay 1e-6;
# the gather's adjoint itself is exact (test_gather_rows_adjoint_is_exact).
MU_TOL = {"qwen1.5-0.5b": STEP_TOL, "qwen3-moe-30b-a3b": 2.0**-8}
# Split cases (several model ranks): the ranks' partial input cotangents
# are summed over model in another order than one rank's product adds
# them, and the blockwise attention rounds its inputs' cotangents to bf16
# (core/flash.matmul), so a few land one bf16 step apart.  The first
# moment (int8: the error-feedback input) is held by the MoE case's 2^-8
# of its leaf's largest: measured <= 8.3e-4 (7.9e-5 of the moment's norm;
# int8's input 4.2e-5 of its norm).  The controls run the same splits
# with fp32 products there: grad_norm bit-equal to one rank's, the moment
# within STEP_TOL (measured <= 8.2e-7).
SPLIT_MU_TOL = 2.0**-8
# The same roundings move a split step's grad_norm: measured <= 8.1e-7 at
# the first step (held by STEP_TOL), 1.1e-6 at the second from the rank's
# own state, and 2.1e-6 / 1.5e-6 under int8 (2.8e-4 of the elements'
# stochastic rounding lands one int8 step the other way, the flips
# FLIP_SHARE bounds): those are held by chip_smoke.py's RANK_TRAIN_REL;
# the controls by STEP_TOL.
SPLIT_NORM_TOL = 1e-5
# The encoder-decoder chains six attention backwards (each decoder
# layer's self- and cross-attention, the cross-attention's K / V into the
# encoder's), and on its smoke model (loss ~31) the bf16 roundings of
# their products (core/flash.matmul) move grad_norm by 7.6e-6 at the first
# step, 3.2e-5 at the second from the rank's own state and 8.9e-4 after
# two steps: that is those roundings, not the split.  So its train cases
# run the blockwise backward's products at fp32 in both runs (the
# controls' form), where what is left is the split's fp32 summation order,
# and are held by the split cases' bounds: grad_norm measured 0 from one
# rank's at the first step and from the rank's own state; the first moment
# 1.3e-6 of a leaf's largest.  After two steps 6.9e-7 on 1 x 2; on 2 x 2
# the gradient's sum over the data ranks moves the first step's parameters
# by 2.3e-7 of a leaf's largest (no element flips sign: 0.0045 x 2 lr), and
# this model's grad_norm moves 1.6e-5 for it (from the rank's own state: 0),
# so that trajectory is held as the DIVERGE ones are.
F32_SPLIT = {"seamless 1x2 tp none", "seamless 2x2 tp_fsdp none"}
# Adam's first step moves an element whose gradient is noise (<= 1e-7 of
# its leaf's largest, e.g. layers/0/attn/w_uv of the mla case) by +-lr
# either way: measured 0.81 (mla), 0.82 (whole heads), 0.50 (int8) and
# 0.92 / 0.91 (the moe splits) x 2 lr, so these trajectories' second steps
# part by up to 2.5e-5 (the moe splits: 1.6e-5 / 1.5e-5 in the loss) and
# are held by NORM_TOL; every case's second step from the rank's own state
# is held too (held1).
DIVERGE = {"mla tp 1x2 none", "whole heads tp 1x2 none", "tp_fsdp 1x2 int8", "moe tp 1x2 none",
           "moe tp_fsdp 2x2 none remat", "seamless 2x2 tp_fsdp none"}


@pytest.fixture(scope="module")
def refs():
    """Weights and inputs of every case, and the JAX references."""
    out = {}
    for key in ("qwen2.5-3b", "deepseek-v2-mla", "qwen3-moe-30b-a3b", "gemma2-2b",
                "mamba2-370m", "recurrentgemma-2b", *VARIANTS):
        arch, changes = VARIANTS.get(key, (key, {}))
        ref_model, ref_params, params = ref_pair(arch, changes)
        prompt, tokens = tokens_for(arch)
        out[key] = dict(params=params, prompt=prompt, tokens=tokens,
                        want=ref_serve(ref_model, ref_params, prompt, tokens),
                        changes=changes)
    ref_model, ref_params, params = ref_pair("qwen1.5-0.5b")
    batch = train_batches()[0]
    step = jax.jit(ref_train_loop.make_train_step(ref_model, ref_train_loop.TrainConfig(**TRAIN)))
    *_, m = step(ref_params, ref_adamw.adamw_init(ref_params), None,
                 {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(3))
    out["train"] = dict(params=params, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    out["blocks"] = {name: ref_block(*case) for name, case in BLOCKS.items()}
    out[ENCDEC] = ref_encdec()
    return out


def ref_encdec():
    """Smoke seamless-m4t-medium: the reference's weights (converted),
    numpy-seeded source frames (x 0.02), a target prompt and teacher-forced
    tokens, and the reference's serving form (``init_cache`` over the
    frames, ``decode_step`` over the prompt at ``cache_len`` 0, then one
    column a step), its attention in ``pallas_interpret`` as
    ``tests/test_torch_encdec.py`` runs it, each call a single-device
    ``jax.jit``: the logits of each call and the self cache after."""
    import dataclasses

    ref_cfg = dataclasses.replace(ref_get_config(ENCDEC, smoke=True), attn_impl="pallas_interpret")
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = get_config(ENCDEC, smoke=True)
    rng = np.random.default_rng(5)
    src = (rng.standard_normal((B, SRC_LEN, cfg.d_model)) * 0.02).astype(np.float32)
    prompt, tokens = tokens_for(ENCDEC)
    init = jax.jit(lambda p, x: ref_model.init_cache(p, x, MAX_LEN))
    decode = jax.jit(lambda p, c, t, n: ref_model.decode_step(p, c, t, n))
    cache = init(ref_params, jnp.asarray(src))
    want = []
    for lo, hi in ((0, PROMPT),) + tuple((PROMPT + i, PROMPT + i + 1) for i in range(DECODE)):
        toks = prompt if lo == 0 else tokens[:, lo - PROMPT:hi - PROMPT]
        logits, cache = decode(ref_params, cache, jnp.asarray(toks),
                               jnp.full((B,), lo, jnp.int32))
        want.append(np.asarray(logits))
    return dict(params=convert_params(ref_params, cfg, device="cpu"), src=src, prompt=prompt,
                tokens=tokens, want=want, self_cache={k: np.asarray(v)
                                                      for k, v in cache["self"].items()})


def ref_block(arch, kind, s):
    """One smoke block's weights (the reference's init, converted), its
    input and nonzero state (numpy, seed 7), and the reference block's
    output and new state at fp32."""
    from repro.models import recurrent as ref_recurrent
    from repro.models import ssm as ref_ssm
    from repro_torch.convert import _tree_map

    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    mod = ref_ssm if kind == "ssm" else ref_recurrent
    init, apply = ((mod.mamba2_block_init, mod.mamba2_block_apply) if kind == "ssm"
                   else (mod.rglru_block_init, mod.rglru_block_apply))
    ref_params = init(jax.random.PRNGKey(6), ref_cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)
    nh = cfg.d_inner // cfg.ssm_head_dim
    h_shape = (B, nh, cfg.ssm_head_dim, cfg.ssm_state) if kind == "ssm" else (B, cfg.d_inner)
    width = cfg.d_inner + (2 * cfg.ssm_state if kind == "ssm" else 0)
    h0 = rng.normal(0, 1, h_shape).astype(np.float32)
    conv = rng.normal(0, 1, (B, cfg.conv_width - 1, width)).astype(np.float32)
    y, new = apply(ref_params, jnp.asarray(x), cfg=ref_cfg,
                   cache={"h": jnp.asarray(h0), "conv": jnp.asarray(conv)}, dtype=jnp.float32)
    params = _tree_map(lambda a: torch.from_numpy(np.array(np.asarray(a))), ref_params)
    return dict(params=params, x=x, h0=h0, conv=conv, want_y=np.asarray(y),
                want={k: np.asarray(v) for k, v in new.items()})


def own_params(arch, cfg_changes):
    """The port's own fp32 weights (seed 0) of the smoke ``arch`` with
    ``cfg_changes``."""
    import dataclasses

    from repro_torch.models.model_zoo import build_model

    cfg = dataclasses.replace(get_config(arch, smoke=True), **cfg_changes)
    return build_model(cfg).init(torch.Generator("cpu").manual_seed(0), "cpu",
                                 dtype=torch.float32)


def split_counts(arch, calls=1 + DECODE):
    """The split counts a tensor-parallel serve run of ``calls`` calls
    gives: every attention layer, every dense MLP or MoE layer's experts,
    every Mamba-2 and RG-LRU block, the embedding lookup and the logits,
    once a call each (an encoder-decoder's decode step: every decoder
    layer's self-attention, cross-attention and MLP)."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "encdec":
        n = calls * cfg.n_layers
        return {"attn": n, "cross": n, "mlp": n, "embed": calls, "logits": calls}
    kinds = cfg.layer_kinds()
    out = {"attn": calls * sum(k in ("global", "local") for k in kinds),
           "moe" if cfg.n_experts else "mlp": calls * sum(k != "ssm" for k in kinds),
           "ssm": calls * sum(k == "ssm" for k in kinds),
           "rec": calls * sum(k == "recurrent" for k in kinds),
           "embed": calls, "logits": calls}
    return {k: v for k, v in out.items() if v}


# name -> (mesh, policy, compression, world): a checkpoint of the state
# after one sharded step, saved and restored by rank (smoke qwen1.5-0.5b)
CKPT_CASES = {
    "fsdp 2x1 int8": ("2x1", "fsdp", "int8", 2),
    "tp 1x2": ("1x2", "tp", "none", 2),
    "tp_fsdp 2x2": ("2x2", "tp_fsdp", "none", 4),
}


def ckpt_cases(world, refs, root):
    """The checkpoint cases of a spawn of ``world`` ranks, each in its own
    directory under ``root``."""
    import os

    params, batches = refs["train"]["params"], train_batches()
    cases = [(f"ckpt {name}", dict(case="ckpt", params=params, batches=batches, spec=spec,
                                   policy=policy, compression=comp,
                                   directory=os.path.join(root, name.replace(" ", "_"))))
             for name, (spec, policy, comp, w) in CKPT_CASES.items() if w == world]
    if world == 2:
        cases += [
            ("ckpt faults", dict(case="ckpt_faults", params=params, batches=batches,
                                 directory=os.path.join(root, "faults"), other="1x2")),
            ("supervisor", dict(case="supervisor", params=params, batches=batches,
                                directory=os.path.join(root, "supervisor"))),
            ("launch ckpt", dict(case="launch_ckpt", directory=os.path.join(root, "launch")))]
    return cases


def cases_for(world, refs, root):
    cases = ckpt_cases(world, refs, root)
    for name, (key, spec, policy, w) in SERVE.items():
        if w == world:
            r = refs[key]
            cases.append((name, dict(case="serve", arch=arch_of(key), params=r["params"],
                                     spec=spec, policy=policy, prompt=r["prompt"],
                                     tokens=r["tokens"], max_len=MAX_LEN,
                                     cfg_changes=r["changes"])))
    for name, placed in SERVE_WHOLE.items():
        if SERVE[placed][3] == world:
            cases.append((name, dict(cases[[n for n, _ in cases].index(placed)][1],
                                     placed=False)))
    for name, (arch, spec, policy, comp, accum, w, *opts) in TRAIN_CASES.items():
        if w == world:
            opts = opts[0] if opts else {}
            if "cfg_changes" in opts:
                params = own_params(arch, opts["cfg_changes"])
            else:
                params = refs["train" if arch == "qwen1.5-0.5b" else arch]["params"]
            cases.append((name, dict(case="train", arch=arch, params=params,
                                     batches=train_batches(arch), spec=spec, policy=policy,
                                     compression=comp, grad_accum=accum, **opts)))
    r = refs[ENCDEC]
    for name, (spec, policy, w) in ENCDEC_SERVE.items():
        if w == world:
            cases.append((name, dict(case="encdec_serve", params=r["params"], spec=spec,
                                     policy=policy, src=r["src"], prompt=r["prompt"],
                                     tokens=r["tokens"], max_len=MAX_LEN)))
    if world == 4:
        cases.append(("whole encdec", dict(
            WHOLE_ENCDEC, case="encdec_serve", params=own_params(ENCDEC,
                                                                 WHOLE_ENCDEC["cfg_changes"]),
            src=r["src"], prompt=r["prompt"], tokens=r["tokens"], max_len=MAX_LEN)))
    for spec in (["1x2", "2x1"] if world == 2 else ["2x2"]):
        cases.append((f"round_trip {spec}", dict(case="round_trip", spec=spec)))
    if world == 4:
        r = refs["qwen2.5-3b"]
        cases.append(("whole heads", dict(
            WHOLE_HEADS, case="serve", params=own_params("qwen2.5-3b", WHOLE_HEADS["cfg_changes"]),
            prompt=r["prompt"],
            tokens=r["tokens"], max_len=MAX_LEN)))
        r = refs["mamba2-370m"]
        cases.append(("whole ssm", dict(
            WHOLE_SSM, case="serve", params=own_params("mamba2-370m", WHOLE_SSM["cfg_changes"]),
            prompt=r["prompt"], tokens=r["tokens"], max_len=MAX_LEN)))
    if world == 2:
        for name, (arch, kind, _) in BLOCKS.items():
            blk = refs["blocks"][name]
            cases.append((name, dict(case="block", arch=arch, kind=kind, params=blk["params"],
                                     x=blk["x"], h0=blk["h0"], conv=blk["conv"])))
        for arch in COUNT_ARCHS:
            cases.append((f"count {arch}", dict(case="count", arch=arch,
                                                params=refs[arch]["params"], spec="1x2",
                                                policy="tp", max_len=MAX_LEN)))
        cases.append(("train count", dict(case="train_count", arch="qwen1.5-0.5b",
                                          params=refs["train"]["params"],
                                          batch=train_batches()[0], spec="1x2", policy="tp")))
        r = refs["qwen3-moe-30b-a3b"]
        cases += [("moe 2x1", dict(case="moe", params=r["params"], spec="2x1",
                                   prompt=r["prompt"], tokens=r["tokens"], max_len=MAX_LEN)),
                  ("reshard", dict(case="reshard", params=refs["train"]["params"], old="2x1",
                                   new="1x2")),
                  ("launch_train", dict(case="launch_train"))]
    return cases


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    """Every case's results, ``{name: [per rank]}``, from one spawn of 2
    ranks and one of 4."""
    out = {}
    for world in (2, 4):
        root = str(tmp_path_factory.mktemp(f"store{world}"))
        out.update(run_ranks(world, cases_for(world, refs, root), root))
    return out


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_on_ranks(ranks, refs, name):
    """Prefill (12 tokens: K7; under seqkv each rank attends over the
    prompt's own K/V and keeps its slice of the rows) and two decode steps
    at per-row lengths through ``jit_serve_fns`` on ranks: every rank
    returns the whole batch's logits, the same on every rank; held against
    the one-process run (seqkv: bit for bit, logits and each rank's cache
    shard) and the reference."""
    key, spec, policy, _ = SERVE[name]
    arch = arch_of(key)
    res = ranks[name]
    want = refs[key]["want"]
    split = policy in ("tp", "tp_fsdp") and spec.split("x")[1] != "1"
    for r in res:
        assert r["returned_cache"]
        for g, g0 in zip(r["logits"], res[0]["logits"]):
            assert g.shape == g0.shape and np.array_equal(g, g0)
        if policy == "seqkv":
            assert r["logits_equal"] and r["cache_equal"]
        else:
            assert r["logits_err"] <= MODEL_TOL and r["cache_err"] <= MODEL_TOL
            assert r["tokens_equal"]
        # tensor-parallel: each local leaf 1 / m of its whole, every layer split
        assert r["held_ok"] and (r["local_leaves"] > 0) == split
        counts = {k: v for k, v in r["counts"].items() if k != "collectives"}
        assert counts == (split_counts(arch) if split else {})
    for g, w in zip(res[0]["logits"], want, strict=True):
        assert g.shape == w.shape
        if policy == "seqkv":
            np.testing.assert_allclose(g, w, rtol=SEQKV_TOL, atol=SEQKV_TOL)
        else:
            assert max_err(g, w) <= MODEL_TOL


@pytest.mark.parametrize("name", list(BLOCKS))
def test_split_blocks_on_ranks(ranks, refs, name):
    """One smoke Mamba-2 (4 of 8 heads a rank) or RG-LRU block (64 of 128
    channels) split over ``model`` on 1 x 2 ranks at fp32, at a prefill of
    300 (two SSD chunks, padded) and at one decode row from a nonzero
    state: every 2-D leaf at ``1 / m`` of its last dim, the output (whole on
    every rank) and the rank's part of the new state within ``STEP_TOL``
    of one process's (measured 0), the output and the ranks' parts put
    together within ``MODEL_TOL`` of the reference's block."""
    arch, kind, s = BLOCKS[name]
    blk = refs["blocks"][name]
    res = ranks[name]
    whole = {path_str(p): tuple(t.shape) for p, t in leaves_with_paths(blk["params"])}
    for r in res:
        assert r["y_err"] <= STEP_TOL and r["state_err"] <= STEP_TOL, (r["y_err"], r["state_err"])
        assert np.array_equal(r["y"], res[0]["y"])
        for path, shape in r["own_shapes"]:
            want = whole[path]
            assert shape == (want[:-1] + (want[-1] // 2,) if len(want) == 2 else want), path
        assert r["y"].shape == (B, s, get_config(arch, smoke=True).d_model)
    assert max_err(res[0]["y"], blk["want_y"]) <= MODEL_TOL
    for k, want in blk["want"].items():
        dim = 1 if (kind, k) == ("ssm", "h") else want.ndim - 1
        got = np.concatenate([r["state"][k] for r in res], axis=dim)
        assert max_err(got, want) <= MODEL_TOL, k


def test_ssm_heads_that_do_not_divide_run_whole(ranks):
    """6 Mamba-2 heads (d_inner 96) over ``model`` 4: every block runs
    whole after the gather (its leaves whole, counted ``ssm_whole``), the
    vocabulary splits; logits and cache within the model bound of the
    one-process run, greedy tokens equal."""
    want = split_counts("mamba2-370m")
    want["ssm_whole"] = want.pop("ssm")
    for r in ranks["whole ssm"]:
        assert r["logits_err"] <= MODEL_TOL and r["cache_err"] <= MODEL_TOL and r["tokens_equal"]
        assert r["held_ok"] and r["local_leaves"] > 0
        assert {k: v for k, v in r["counts"].items() if k != "collectives"} == want


def test_heads_that_do_not_divide_run_whole(ranks):
    """6 query heads over ``model`` 4: every attention layer runs whole
    after the gather (its leaves whole, counted ``attn_whole``), the MLPs
    and the vocabulary split; logits and cache within the model bound of
    the one-process run, greedy tokens equal."""
    want = split_counts("qwen2.5-3b")
    want["attn_whole"] = want.pop("attn")
    for r in ranks["whole heads"]:
        assert r["logits_err"] <= MODEL_TOL and r["cache_err"] <= MODEL_TOL and r["tokens_equal"]
        assert r["held_ok"] and r["local_leaves"] > 0
        assert {k: v for k, v in r["counts"].items() if k != "collectives"} == want


@pytest.mark.parametrize("name", list(ENCDEC_SERVE))
def test_encdec_serve_on_ranks(ranks, refs, name):
    """Smoke seamless-m4t-medium in the reference's serving form on ranks:
    the caller's ``init_cache`` (the encoder and every layer's cross K/V,
    whole), then ``jit_serve_fns``' decode of the 12-token target prompt
    at ``cache_len`` 0 (K7) and two teacher-forced steps (K6).  Every rank
    returns the whole batch's logits, the same on every rank, within the
    model bound of the one-process run and of the reference (greedy tokens
    equal), its shard of the self cache within that bound of the
    one-process run's, the gathered self cache within it of the
    reference's, and its shard of the cross K/V bit-equal to the caller's
    (never written); every kept leaf ``1 / m`` of its whole in what the
    decode computed on (each decoder layer gathered in order at its use,
    no encoder leaf used), and every self- and cross-attention, MLP,
    lookup and logits split."""
    r_ref = refs[ENCDEC]
    res = ranks[name]
    for r in res:
        assert r["returned_cache"]
        for g, g0 in zip(r["logits"], res[0]["logits"]):
            assert g.shape == g0.shape and np.array_equal(g, g0)
        assert r["logits_err"] <= MODEL_TOL and r["cache_err"] <= MODEL_TOL
        assert r["tokens_equal"] and r["cross_equal"]
        assert r["held_ok"] and r["local_leaves"] > 0
        assert r["layer_gathers"] == layer_gathers(ENCDEC, name)
        assert r["gathered_peak"] <= r["gather_bound"] and r["gathered_live"] == 0
        assert {k: v for k, v in r["counts"].items() if k != "collectives"} == split_counts(
            ENCDEC)
    for g, w in zip(res[0]["logits"], r_ref["want"], strict=True):
        assert g.shape == w.shape and max_err(g, w) <= MODEL_TOL
    rows = PROMPT + DECODE
    for l, c in enumerate(res[0]["self_cache"]):  # port (B, H, S, Dh), reference (L, B, S, H, Dh)
        for k in ("k", "v"):
            assert max_err(c[k].transpose(0, 2, 1, 3)[:, :rows],
                           r_ref["self_cache"][k][l][:, :rows]) <= MODEL_TOL


def test_encdec_heads_that_do_not_divide_run_whole(ranks):
    """Smoke seamless-m4t-medium with 6 heads over ``model`` 4: every
    decoder self- and cross-attention runs whole after the gather (its
    leaves whole, counted ``attn_whole`` / ``cross_whole``), the MLPs and
    the vocabulary split; logits and self cache within the model bound of
    the one-process run, greedy tokens equal, the cross K/V untouched."""
    want = split_counts(ENCDEC)
    want["attn_whole"], want["cross_whole"] = want.pop("attn"), want.pop("cross")
    for r in ranks["whole encdec"]:
        assert r["logits_err"] <= MODEL_TOL and r["cache_err"] <= MODEL_TOL and r["tokens_equal"]
        assert r["cross_equal"] and r["held_ok"] and r["local_leaves"] > 0
        assert {k: v for k, v in r["counts"].items() if k != "collectives"} == want


# the dry-run check's models: arch -> the split decode step's all-gathers
COUNT_ARCHS = {
    # o, wo, the MLP's h and down in each of 2 layers, the logits, the new K/V rows
    "qwen2.5-3b": 10,
    # the projection, the conv output, the gated output and out_proj's in each
    # of 2 blocks, the logits, the state's heads and channels (a replica)
    "mamba2-370m": 10,
    # conv output, h * gate and w_out's in each of 5 RG-LRU blocks, o and wo in
    # each of 2 attention layers, the MLP's 2 in each of 7, the logits, the
    # new K/V rows, the states
    "recurrentgemma-2b": 36,
    # o, wo, the cross-attention's o and wo, the MLP's 2 in each of 2 decoder
    # layers, the logits, the new self-attention K/V rows (the cross K/V: views)
    "seamless-m4t-medium": 14,
}


@pytest.mark.parametrize("arch", list(COUNT_ARCHS))
def test_dry_run_counts_a_split_decode_step(ranks, arch):
    """One rank's ``OpCounter`` count of the ``tp`` decode step at 1 x 2
    (smoke qwen2.5-3b, mamba2, recurrentgemma, seamless-m4t-medium) against the dry run's count
    of that step at ``local_config(cfg, 2)``, its Mamba-2 and RG-LRU blocks
    on the card's share (``dryrun.card_share``: the blocks' split code,
    each gather a stand-in that costs nothing): the products (projections,
    MLP, the SSM recurrence, logits and the kernels' charges) are the same
    flops; the split step adds the gathers' concatenations, the
    embedding's mask and the collectives (``COUNT_ARCHS`` all-gathers; 1
    all-reduce: the embedding), which the dry run's collective model
    charges apart."""
    for r in ranks[f"count {arch}"]:
        assert r["ranks"]["products"] == r["dry"]["products"] > 0
        assert r["ranks"]["coll_counts"] == {"all-gather": COUNT_ARCHS[arch], "all-reduce": 1}
        assert r["dry"]["coll_counts"] == {}
        assert r["ranks"]["flops"] >= r["dry"]["flops"]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-mla", "qwen3-moe-30b-a3b"])
def test_lm_init_keep_draws_the_same_weights(arch):
    """``lm_init(keep=...)`` (how one rank draws only its shards of a
    model it cannot hold whole) keeps what ``keep`` returns of the very
    tensors a plain ``lm_init`` from the same seed draws, the fp32
    unembedding copy made from the kept table (qwen3-moe: the ``(E, d,
    ff)`` / ``(E, ff, d)`` expert stacks too)."""
    from repro_torch.core import tree
    from repro_torch.models import transformer

    cfg = get_config(arch, smoke=True)
    kw = dict(device=torch.device("cpu"), dtype=torch.bfloat16)
    whole = transformer.lm_init(torch.Generator().manual_seed(5), cfg, **kw)
    half = lambda t: torch.chunk(t, 2, dim=-1)[1].clone() if t.ndim > 1 else t
    kept = transformer.lm_init(torch.Generator().manual_seed(5), cfg, **kw,
                               keep=lambda path, t: half(t))
    got = dict(tree.leaves_with_paths(kept))
    for path, t in tree.leaves_with_paths(whole):
        assert torch.equal(got[path], half(t)), path


def test_moe_dispatch_on_ranks_equals_one_rank(ranks, refs):
    """Smoke qwen3-moe on 2 x 1 ranks: each MoE layer routes the whole
    batch (gathered over ``data``), so every expert product sees the
    one-rank run's capacity and filled slots; logits within the model
    bound of the one-rank run and the reference."""
    for r in ranks["moe 2x1"]:
        assert r["calls"] > 0 and r["same_capacity"] and r["same_slots"]
        assert r["dispatch_err"] <= 1e-5 and r["logits_err"] <= MODEL_TOL
    for g, w in zip(ranks["moe 2x1"][0]["logits"], refs["qwen3-moe-30b-a3b"]["want"][:2],
                    strict=True):
        assert max_err(g, w) <= MODEL_TOL


def train_split_counts(arch, accum, remat=False, whole=(), steps=2):
    """The split counts of ``steps`` tensor-parallel train steps: every
    attention layer and dense MLP or MoE layer's experts once a
    microbatch (twice under remat: the backward runs the layer again),
    the lookup and the loss once (an encoder-decoder's attention in every
    encoder and decoder layer, its cross-attention in every decoder layer,
    remat ignored, as in the reference)."""
    cfg = get_config(arch, smoke=True)
    kinds = cfg.layer_kinds()
    calls = steps * accum
    if cfg.family == "encdec":
        n = calls * (cfg.encoder_layers + cfg.n_layers)
        return {"attn": n, "cross": calls * cfg.n_layers, "mlp": n, "embed": calls,
                "logits": calls}
    layer = calls * (2 if remat else 1)
    out = {"attn": layer * sum(k in ("global", "local") for k in kinds),
           "moe" if cfg.n_experts else "mlp": layer * sum(k != "ssm" for k in kinds),
           "ssm": layer * sum(k == "ssm" for k in kinds),
           "rec": layer * sum(k == "recurrent" for k in kinds),
           "embed": calls, "logits": calls}
    for module in whole:
        out[module + "_whole"] = out.pop(module)
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_on_ranks(ranks, refs, name):
    """Two steps through ``jit_train_step`` on ranks against
    ``make_train_step`` on one rank.  Under ``tp`` / ``tp_fsdp`` with
    several model ranks the step computes only the rank's heads, d_ff
    columns and vocabulary rows: every leaf the split keeps is ``1 / m``
    of its whole in what the loss computed on, every attention layer,
    MLP, lookup and loss counted split (or whole, where the heads do not
    divide)."""
    arch, spec, policy, comp, accum, _, *opts = TRAIN_CASES[name]
    opts = opts[0] if opts else {}
    split = policy in ("tp", "tp_fsdp") and spec.split("x")[1] != "1"
    control = opts.get("f32_products", False) and name not in F32_SPLIT
    for r in ranks[name]:
        m0 = r["metrics0"]
        # grad_norm of a split step: STEP_TOL at the first step but under
        # int8, SPLIT_NORM_TOL at the second from the rank's own state
        norm_tol = [STEP_TOL, STEP_TOL]
        if split and not control:
            norm_tol = [SPLIT_NORM_TOL if comp == "int8" else STEP_TOL, SPLIT_NORM_TOL]
        for k in ("loss", "grad_norm"):
            got, want = m0[k]
            tol = norm_tol[0] if k == "grad_norm" else STEP_TOL
            assert abs(got - want) <= tol * abs(want), (k, got, want)
        assert m0["lr"][0] == m0["lr"][1]
        if "e_err" in r:  # int8: the gradient tight, a rounding flip moves one step
            assert r["e_err"] <= (SPLIT_MU_TOL if split else STEP_TOL)
            assert r["flip_steps"] <= 1 + 1e-3 and r["flip_share"] <= FLIP_SHARE
        else:
            tol = STEP_TOL if control else SPLIT_MU_TOL if split else MU_TOL[arch]
            assert r["mu_err"] <= tol and r["mu_norm_err"] <= tol
        assert r["param_resolved_err"] <= PARAM_TOL and r["param_step_err"] <= 1 + 1e-4
        assert r["shards_are_slices"] and r["is_dtensor"]
        for k in ("loss", "grad_norm"):  # the second step, from states a step apart
            got, want = r["metrics1"][k]
            assert abs(got - want) <= (NORM_TOL if name in DIVERGE else LOSS_TOL) * abs(want)
            got, want = r["held1"][k]  # and from the rank's own state
            tol = norm_tol[1] if k == "grad_norm" else STEP_TOL
            assert abs(got - want) <= tol * abs(want), (k, got, want)
        # every rank reports the same metrics
        assert (m0, r["metrics1"]) == (ranks[name][0]["metrics0"], ranks[name][0]["metrics1"])
        assert r["held_ok"] and (r["local_leaves"] > 0) == split
        assert r["counts"] == (train_split_counts(arch, accum, opts.get("remat", False),
                                                  opts.get("whole", ())) if split else {})
    if name in ("2x1 tp_fsdp none", "tp 1x2 none"):  # the reference's step, same weights, batch
        got = ranks[name][0]["metrics0"]
        assert got["loss"][0] == pytest.approx(refs["train"]["loss"], rel=LOSS_TOL)
        assert got["grad_norm"][0] == pytest.approx(refs["train"]["grad_norm"], rel=NORM_TOL)


def test_dry_run_counts_a_split_train_step(ranks):
    """One rank's ``OpCounter`` count of the ``tp`` train step at 1 x 2
    (smoke qwen1.5-0.5b, 8 x 32, no remat) against the dry run's count of
    ``make_train_step`` at ``local_config(cfg, 2)``: the products (the
    projections, MLP and loss forward and backward, K7's charges and the
    blockwise backward) are the same flops; the split step adds the
    collectives: 8 all-gathers (o, wo's output, the MLP's h and down's
    output in each of 2 layers; the loss gathers no logits) and 51
    all-reduces (the lookup; the loss's max and exp-sum / label logit in
    each of 8 chunks, again in their recompute, and each chunk's input
    cotangent; the input cotangents of q / k / v, wo, gate / up and down
    in each layer; the partial leaves' gradients; the norm)."""
    for r in ranks["train count"]:
        assert r["ranks"]["products"] == r["dry"]["products"] > 0
        assert r["calls"] == {"all_gather": 8, "all_reduce": 51, "all_to_all": 0}
        assert r["ranks"]["coll_counts"] == {"all-gather": 8, "all-reduce": 51}
        assert r["dry"]["coll_counts"] == {}
        assert r["ranks"]["flops"] >= r["dry"]["flops"]


def test_reshard_train_state_across_ranks(ranks):
    """2 x 1 -> 1 x 2: the gathered values bit-equal, each rank's shard the
    new spec's slice, the leaves on the new mesh."""
    for r in ranks["reshard"]:
        assert r["equal"] and r["slices"] and r["sharded_leaves"] > 0
        assert r["mesh"] == (1, 2)


def test_launch_train_splits_data_by_rank(ranks):
    """``launch/train`` under a group of 2: each rank builds its shard
    (``num_shards=2``, ``shard_id=rank``: the reference's
    ``jax.process_count()`` / ``process_index()``), whose batches are the
    reference's shards bit for bit; the ranks train on their
    concatenation (the global batch) as one rank does."""
    res = ranks["launch_train"]
    for rank, r in enumerate(res):
        assert r["data_split"] == [(2, rank)]
        ref = RefData(vocab_size=get_config("qwen1.5-0.5b", smoke=True).vocab_size, seq_len=32,
                      global_batch=4, seed=0, num_shards=2, shard_id=rank).batch_at(0)
        np.testing.assert_array_equal(r["own"], ref["tokens"])
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_allclose(r["losses"], r["want"], rtol=LOSS_TOL)
    assert not np.array_equal(res[0]["own"], res[1]["own"])


def test_shards_of_a_global_batch_concatenate():
    """A global batch of ``num_shards`` shards is their batches in shard
    order: each shard's rows are ``global_batch / num_shards`` of the
    reference's stream for that shard, so the launcher's gather over ranks
    is the batch the reference's ``num_shards`` processes train on."""
    kw = dict(vocab_size=100, seq_len=32, global_batch=8, seed=0)
    shards = [SyntheticLMData(**kw, num_shards=2, shard_id=i) for i in range(2)]
    for step in (0, 5):
        glob = {k: np.concatenate([s.batch_at(step)[k] for s in shards]) for k in ("tokens",
                                                                                   "labels")}
        assert glob["tokens"].shape == (8, 32)
        for i in range(2):
            want = RefData(**kw, num_shards=2, shard_id=i).batch_at(step)
            for k in glob:
                np.testing.assert_array_equal(glob[k][4 * i:4 * (i + 1)], want[k])


@pytest.mark.parametrize("spec", ["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("shape", [repr(s) for s in SPECS])
def test_gather_and_shard_round_trip(ranks, spec, shape):
    """``place_one``'s local shard == ``shard_one`` of the value; its
    ``gather_tree`` / ``full_value`` / ``whole_tree`` == the value (a plain
    value passes ``whole_tree`` as it is); gathering all but the ``data``
    dims and slicing them again gives the shard back; on every rank, bit
    for bit."""
    for r in ranks[f"round_trip {spec}"]:
        assert r["round_trips"][shape]


@pytest.mark.parametrize("spec", ["1x2", "2x1", "2x2"])
def test_model_collectives_adjoints_are_exact(ranks, spec):
    """``copy_to_model`` (backward: the cotangent summed over model),
    ``gather_from_model`` (backward: this rank's slice, no sum) and
    ``reduce_from_model`` (backward: the cotangent as it is) on every rank
    against autograd of the same function in one process, exactly; the
    vocabulary-parallel ``chunked_cross_entropy`` (softcap, ignored
    labels, fp32) against the whole-vocabulary loss in value and in its
    gradients for ``hidden`` and this rank's table rows, within 1e-6."""
    for r in ranks[f"round_trip {spec}"]:
        assert r["model_adjoints"] == {"copy": True, "gather": True, "reduce": True}
        assert max(r["vocab_loss"].values()) <= STEP_TOL, r["vocab_loss"]


def layer_gathers(arch, name):
    """The layers a serve or train case gathers, in call order: every
    layer once a call (serve), or once a microbatch's forward and again,
    last layer first, in its remat recompute (train; an encoder-decoder:
    the encoder's layers, then the decoder's, no recompute)."""
    cfg = get_config(arch, smoke=True)
    n = cfg.n_layers
    if name not in TRAIN_CASES:
        return list(range(n)) * (1 + DECODE)
    accum = TRAIN_CASES[name][4]
    if cfg.family == "encdec":
        return (list(range(cfg.encoder_layers)) + list(range(n))) * accum * len(
            train_batches(arch))
    back = list(reversed(range(n))) if train_remat(name) else []
    return (list(range(n)) + back) * accum * len(train_batches(arch))


def train_remat(name) -> bool:
    _, _, _, _, _, _, *opts = TRAIN_CASES[name]
    return bool(opts) and opts[0].get("remat", False)


@pytest.mark.parametrize("name", list(SERVE) + ["whole heads", "whole ssm"] + list(TRAIN_CASES))
def test_layer_gathers_on_ranks(ranks, name):
    """Each rank step hands the model this rank's shards (never a whole
    parameter tree; ``held_ok``) and the model gathers each layer's
    leaves just before the layer runs (``mesh_ctx.working``): the layers
    in order once a call, again in reverse in the remat recompute of each
    microbatch, every leaf of the model through it; the gathered bytes
    alive at once at most the largest layer's leaves plus the largest
    table where nothing keeps a layer for the backward (serving, remat),
    and none alive after the call."""
    whole = {"whole heads": WHOLE_HEADS, "whole ssm": WHOLE_SSM}
    arch = arch_of(SERVE[name][0]) if name in SERVE else (
        whole[name]["arch"] if name in whole else TRAIN_CASES[name][0])
    for r in ranks[name]:
        assert r["held_ok"]
        assert r["layer_gathers"] == layer_gathers(arch, name)
        if name not in TRAIN_CASES or train_remat(name):
            assert r["gathered_peak"] <= r["gather_bound"], (r["gathered_peak"],
                                                             r["gather_bound"])
        assert r["gathered_live"] == 0


@pytest.mark.parametrize("name", list(SERVE_WHOLE))
def test_serve_uses_whole_tensors_as_they_are(ranks, name):
    """A serve step whose caller hands the parameters as whole tensors
    computes on them as they are (a leaf a split keeps local on its
    ``model`` slice, a view): every call of ``mesh_ctx.working`` still in
    layer order, nothing gathered, fewer collectives than from the placed
    shards, and the logits bit-equal to the placed run's (the gathered
    weights are the same bits)."""
    placed = ranks[SERVE_WHOLE[name]]
    arch = arch_of(SERVE[SERVE_WHOLE[name]][0])
    for r, p in zip(ranks[name], placed, strict=True):
        assert r["held_ok"]
        assert r["layer_gathers"] == layer_gathers(arch, name)
        assert r["gathered_peak"] == 0 and r["gather_bound"] == 0
        assert r["counts"]["collectives"] < p["counts"]["collectives"]
        assert all(np.array_equal(a, b) for a, b in zip(r["logits"], p["logits"], strict=True))


@pytest.mark.parametrize("spec", ["1x2", "2x1", "2x2"])
def test_gather_leaf_adjoint_is_exact(ranks, spec):
    """``core/distributed.gather_leaf`` as ``sharding.ParamGather`` calls
    it, for every spec shape, rows over ``data`` or ``data`` and
    ``model``, a plan keeping ``model`` or not: the gathered value is the
    leaf (whole but for the kept dims), and the gradient of this rank's
    shard is its slice of the integer weights summed over the ranks of
    the gathered rows' axes, exactly."""
    for r in ranks[f"round_trip {spec}"]:
        assert r["leaf_adjoints"] and all(r["leaf_adjoints"].values()), [
            k for k, v in r["leaf_adjoints"].items() if not v]


@pytest.mark.parametrize("spec", ["1x2", "2x1", "2x2"])
def test_gather_rows_adjoint_is_exact(ranks, spec):
    """``gather_rows``' backward on every rank: each rank's loss weighs
    the gathered rows by its own integer weights, and the gradient of its
    local rows is the sum over the ranks of their weights on those rows,
    exactly."""
    for r in ranks[f"round_trip {spec}"]:
        assert r["adjoint"]


def expert_shapes(arch, changes, mode, m):
    """The shapes of the expert stacks one rank computes on under the
    split ``mode``: ``E / m`` experts (``"ep"``) or ``d_ff / m`` columns of
    each (``"ff"``)."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    e, ff = (e // m, ff) if mode == "ep" else (e, ff // m)
    return [(("down", (e, ff, d)), ("gate", (e, d, ff)), ("router", (d, cfg.n_experts)),
             ("up", (e, d, ff)))]


@pytest.mark.parametrize("name", list(MOE_SERVE))
def test_moe_experts_split_on_ranks(ranks, refs, name):
    """Smoke qwen3-moe on 1 x 2 (``tp``) and on 2 x 2 (``tp_fsdp``,
    capacity factor 0.6: tokens dropped, the prefill's capacity split over
    ``data``), granite-moe with 6 experts on 1 x 4 (``tp``, split
    by d_ff): in every MoE call of prefill and decode on every rank, the
    routing (probabilities, top-k weights and indices, capacity, sort,
    drops, slot tables) equal to one process's on the same gathered
    tokens; the expert stacks computed on ``1 / m`` of their whole (by E,
    or by d_ff), the router whole; no expert stack gathered (nor over
    ``model``); the layer output at fp32 within ``STEP_TOL`` of one
    process's on the same tokens (measured 0: bit-equal).  The logits,
    tokens and split counts (``moe`` split, no ``moe_whole``) are
    :func:`test_serve_on_ranks`'."""
    key, spec, _, _ = SERVE[name]
    m = int(spec.split("x")[1])
    n_layers = get_config(arch_of(key), smoke=True).n_layers
    for r in ranks[name]:
        assert r["moe_calls"] == n_layers * (1 + DECODE)
        assert r["routing_equal"], name
        assert r["moe_out_err"] <= STEP_TOL, r["moe_out_err"]
        assert r["moe_modes"] == [MOE_SERVE[name]]
        assert r["expert_shapes"] == expert_shapes(arch_of(key), refs[key]["changes"],
                                                   MOE_SERVE[name], m)
        assert r["expert_gathered"] == 0
        assert r["counts"]["moe"] == n_layers * (1 + DECODE) and "moe_whole" not in r["counts"]
    caps = ranks[name][0]["moe_cap_axes"]
    if name == "moe tp_fsdp 2x2 drops":  # drops, and the prefill's capacity split over data
        assert sum(ranks[name][0]["moe_drops"]) > 0
        assert caps == [("data",)] * n_layers + [()] * n_layers * DECODE
    else:
        assert not any(caps)


@pytest.mark.parametrize("spec", ["1x2", "2x1", "2x2"])
def test_gather_slots_adjoint_is_exact(ranks, spec):
    """``moe.gather_slots``, the gather of an ``"ep"`` rank's expert
    outputs over ``model`` (and over ``data`` where the capacity is split
    over it), on every rank: the value the whole outputs, the gradient of
    the rank's piece the sum of the ``data`` ranks' integer weights on it
    where the capacity is split (each rank's cotangent holds its own rows'
    terms), the rank's own where it is not, with no sum over ``model``
    (the ranks there hold the same rows), exactly."""
    for r in ranks[f"round_trip {spec}"]:
        assert r["slots_adjoint"] == {"cap": True, "whole": True}


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_checkpoint_round_trip_on_ranks(ranks, name):
    """The state after one sharded step (an int8 residual under ``fsdp``),
    saved by every rank into one step directory (``async_save``; each rank
    its ``shard_{rank:05d}.npz``, one ``COMMIT``) and restored by a fresh
    manager: each rank's shards, placements, global shapes and mesh
    bit-equal to what it saved, from a ``DTensor`` like-tree and from the
    whole initial state (the supervisor's first call); the step from the
    restored state bit-equal to the step from the state in memory (loss,
    ``grad_norm``, parameters, moments, residuals)."""
    world = CKPT_CASES[name][3]
    for r in ranks[f"ckpt {name}"]:
        assert r["step"] == 1
        assert r["saved_by_dtensors"] and r["saved_by_whole"]
        assert r["metrics_equal"] and r["resumed_equal"]
        assert r["files"] == ["COMMIT", "manifest.json"] + [f"shard_{i:05d}.npz"
                                                             for i in range(world)]


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_checkpoint_on_ranks_reads_through_reference(ranks, name):
    """The reference's ``CheckpointManager.restore(step, like,
    process_index=r)`` reads rank ``r``'s file of the port's checkpoint,
    given a like-tree of that rank's local shapes: its shards bit for bit;
    the port's manager refuses the checkpoint in one process (a world of 1,
    not the 2 or 4 ranks that saved it)."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager

    res = ranks[f"ckpt {name}"]
    mgr = RefCheckpointManager(res[0]["directory"])
    assert mgr.committed_steps() == [1]
    for rank, r in enumerate(res):
        like = [jnp.zeros(a.shape, a.dtype) for a in r["local"]]
        got = mgr.restore(1, like, process_index=rank)
        assert len(got) == len(r["local"])
        for a, b in zip(got, r["local"]):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="saved by"):
        CheckpointManager(res[0]["directory"]).restore_latest(
            [torch.zeros(a.shape) for a in res[0]["local"]])


def test_uncommitted_step_is_skipped_on_ranks(ranks):
    """Rank 1 cannot write step 3: its ``wait()`` raises its error, rank 0's
    raises ``TimeoutError`` (it waited for rank 1's shard), step 3 is never
    committed (its ``.tmp`` stays), both ranks see steps [1, 2] and restore
    step 2; after step 4, ``keep=2`` leaves [2, 4] on both.  A restore onto
    the 1 x 2 mesh of what 2 x 1 saved raises ``ValueError``."""
    res = ranks["ckpt faults"]
    assert [r["raised"] for r in res] == ["TimeoutError", "OSError"]
    for r in res:
        assert r["after3"] == [1, 2] and r["latest"] == 2 and r["after4"] == [2, 4]
        assert r["stale"] == ["step_00000003.tmp"]
        assert "no resharding" in r["other_mesh"]


def test_supervisor_recovers_on_ranks(ranks):
    """``TrainingSupervisor`` over the 2 x 1 ``fsdp`` step, a checkpoint
    every 2 steps, a job-wide failure at step 3 (both ranks raise): it
    restores step 2 and replays; the history is steps 0-5 once each, its
    metrics and the final shards bit-equal to 6 uninterrupted steps."""
    for r in ranks["supervisor"]:
        assert r["steps"] == list(range(6)) and r["last"] == 6 and r["restarts"] == 1
        assert r["metrics_equal"] and r["state_equal"]


def test_launch_train_ckpt_resumes_on_ranks(ranks):
    """``launch/train --ckpt-dir --ckpt-every 2`` on 2 ranks, 4 steps, then
    ``--steps 2``: the second run resumes at step 4 and runs 4 and 5;
    ``keep=3`` leaves steps 2, 4 and 6, each with one shard a rank; only
    rank 0 prints."""
    res = ranks["launch ckpt"]
    for rank, r in enumerate(res):
        assert r["runs"] == [[0, 1, 2, 3], [4, 5]]
        assert r["files"] == {f"step_{s:08d}": ["COMMIT", "manifest.json", "shard_00000.npz",
                                                "shard_00001.npz"] for s in (2, 4, 6)}
        if rank:
            assert r["printed"] == ["", ""]
    assert "finished at step 4 (0 restarts)" in res[0]["printed"][0]
    assert "finished at step 6 (0 restarts)" in res[0]["printed"][1]
