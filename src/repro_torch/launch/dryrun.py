"""Dry run: count every (arch x shape x mesh) cell on meta-device stand-ins
(counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
them).

For each cell the port's own step (``make_train_step``, the model's
``prefill`` / ``decode_step``) runs on meta parameters, caches and inputs
(``input_specs``) under :class:`~repro_torch.roofline.op_cost.OpCounter`,
and the cell records:
    * memory: one card's argument, output and aliased bytes (the
      weights' and optimizer state's shards that the partition specs
      give; the batch and the cache as the card holds them) and its
      temporaries (the counted peak of live bytes less what the counted
      step held as arguments);
    * the counted FLOPs and bytes of one card;
    * collective bytes from the partition specs (the model below);
    * the three roofline terms (:mod:`repro_torch.roofline.analysis`).

The dry run is the one entry point that runs no arithmetic: it builds meta
stand-ins on every machine, so it needs no card and has no CPU fallback
to forbid.  The production meshes stay shape-only :class:`Mesh` values,
and nothing is placed.

**One card's count.** The step is counted at the local batch that
``batch_spec_fn`` gives (a cache at that batch and its full length, even
where the specs split its sequence).  Under a policy with tensor
parallelism (``tp_fsdp``, ``tp``, ``seqkv``) it is counted at the widths
one card of ``m = mesh.shape["model"]`` runs, as Megatron-style tensor
parallelism splits them (:func:`local_config`): query heads, the d_ff
columns (an expert's too) and the vocabulary (the embedding table,
unembedding and loss) each become ``ceil(width / m)``, the busiest card's
share; KV heads become ``ceil(n_kv / m)``, one replicated head where
there are fewer than ``m``.  So every per-head op (projections, attention
and its backward, the kernels' work) and every op over d_ff falls with
``m``, and the d_model-wide work (norms, residuals, the embedding
lookup's output) is counted whole, as every card of the group runs it.
The Mamba-2 and RG-LRU blocks are counted as a card computes them under
the split step's plan (:class:`CardShare`: the blocks' own split code on
the card's shares of their leaves and state, the gathers free stand-ins,
the blocks' collectives charged by the collective model like every
other sublayer's): their products read whole widths (Mamba-2's
in-projection row ``[z, x, B, C, dt]``, Griffin's ``d_inner x d_inner``
gates) that no smaller config reproduces, so ``local_config`` keeps
``d_inner`` whole.  A train
step's microbatches dispatch the same ops, so one is counted and taken
``accum`` times (the accumulation's own sums, under 1 % of the bytes,
are left out); the AdamW update is counted once, on each leaf's local
shard of the full-width parameters.

**Collectives** are a model of a partitioner, not XLA's SPMD output; a
machine with several cards is what would check it.  From the specs:
    * a parameter sharded over axes that are not tensor-parallel (FSDP)
      is all-gathered (to its tensor-parallel shard) before every
      microbatch's forward, and again under remat; serving steps gather
      once;
    * training gradients are reduce-scattered over those axes, and
      all-reduced over the data-parallel axes the leaf is replicated
      over (every one of them for a leaf without FSDP);
    * under a tensor-parallel policy every sublayer's output (attention
      or recurrent mixer, MLP; self-attention, cross-attention and MLP in
      an encoder-decoder's decoder) is all-reduced at the local tokens'
      bf16 width: once a pass, passes = forward, backward and (remat) the
      forward again.
Wire bytes follow the reference's ring conventions (op_cost).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --archs assigned \\
        --shapes all --meshes both --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from contextlib import nullcontext
from typing import NamedTuple

import torch

from repro_torch.configs import ASSIGNED, BONUS, LM_SHAPES, get_config, runnable_shapes
from repro_torch.core import tree as _tree
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    cosine_schedule,
    reference_decay_mask,
)
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import Cost, OpCounter
from repro_torch.runtime import mesh_ctx, sharding
from repro_torch.runtime.train_loop import TrainConfig, make_train_step

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32
TP_POLICIES = ("tp_fsdp", "tp", "seqkv")


def meta(shape, dtype):
    """A meta-device stand-in (the reference's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, *, smoke: bool = False) -> dict:
    """Meta stand-ins for every model input of this cell, at the global
    batch, with the reference's shapes and dtypes (``smoke``: at the smoke
    config's widths)."""
    cfg = get_config(arch, smoke=smoke)
    shape = LM_SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}
    if shape.kind == "train":
        if cfg.family == "encdec":
            specs["src_embeds"] = meta((b, s // 2, cfg.d_model), BF16)
            specs["src_len"] = meta((b,), I32)
            specs["tokens"] = meta((b, s // 2), I32)
            specs["labels"] = meta((b, s // 2), I32)
        else:
            specs["tokens"] = meta((b, s), I32)
            specs["labels"] = meta((b, s), I32)
            if cfg.family == "vlm":
                specs["vision_embeds"] = meta((b, cfg.vision_stub_tokens, cfg.d_model), BF16)
    elif shape.kind == "prefill":
        if cfg.family == "encdec":
            specs["src_embeds"] = meta((b, s // 2, cfg.d_model), BF16)
            specs["tokens"] = meta((b, s // 2), I32)
        else:
            specs["tokens"] = meta((b, s), I32)
            if cfg.family == "vlm":
                specs["vision_embeds"] = meta((b, cfg.vision_stub_tokens, cfg.d_model), BF16)
    else:  # decode
        specs["tokens"] = meta((b, shape.s_q), I32)
        # scalar position: uniform-batch decode, every key below it live
        specs["cache_len"] = meta((), I32)
    return specs


# --------------------------------------------------------------------------- #
# specs -> one card's shards
# --------------------------------------------------------------------------- #
def _axes(spec) -> set:
    out = set()
    for e in spec:
        out.update(e if isinstance(e, tuple) else () if e is None else (e,))
    return out


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def local_shape(shape, spec, mesh) -> tuple:
    """``shape`` with each dim divided by the mesh axes its spec names."""
    out = list(shape)
    for i, e in enumerate(spec):
        if e is not None:
            out[i] //= _size(mesh, e if isinstance(e, tuple) else (e,))
    return tuple(out)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree, spec_fn, mesh) -> int:
    """Bytes of one card's shards of every leaf of ``tree``."""
    return sum(
        math.prod(local_shape(t.shape, spec_fn(p, t), mesh)) * t.element_size()
        for p, t in _tree.leaves_with_paths(tree))


def _local_tensor(t, spec_fn, mesh):
    return meta(local_shape(t.shape, spec_fn((), t), mesh), t.dtype)


# --------------------------------------------------------------------------- #
# the collective model
# --------------------------------------------------------------------------- #
def _sublayers(cfg, kind: str) -> int:
    """Sublayers whose outputs a tensor-parallel step all-reduces."""
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + (2 * cfg.encoder_layers if kind != "decode" else 0)
    return sum(1 if k == "ssm" else 2 for k in cfg.layer_kinds())


def collective_cost(cfg, params, mesh, *, multi_pod, policy, kind, tokens, microbatches=1,
                    remat=False) -> Cost:
    """Wire bytes (and counts) one card moves in one step, from the
    partition specs of ``params`` (the module docstring's model):
    ``tokens`` is one card's tokens a microbatch (a step when serving)."""
    c = Cost()

    def add(k, nbytes, n=1):
        if nbytes > 0 and n > 0:
            c.coll[k] = c.coll.get(k, 0) + nbytes * n
            c.coll_counts[k] = c.coll_counts.get(k, 0) + n

    pfn = sharding.param_spec_fn(mesh, multi_pod=multi_pod, policy=policy, cfg=cfg)
    tp_axes = {"model"} if policy in TP_POLICIES else set()
    dp_axes = set(sharding.data_axes(multi_pod))
    if policy in ("fsdp", "fsdp2d", "dp"):
        dp_axes.add("model")
    train = kind == "train"
    forwards = microbatches * (2 if remat else 1) if train else 1
    for path, t in _tree.leaves_with_paths(params):
        ax = _axes(pfn(path, t))
        gather = ax - tp_axes
        compute = _nbytes(t) // _size(mesh, ax & tp_axes)  # the tensor-parallel shard
        if _size(mesh, gather) > 1:
            add("all-gather", compute, forwards)
            if train:
                add("reduce-scatter", compute)
        if train and _size(mesh, dp_axes - ax) > 1:
            add("all-reduce", 2 * compute // _size(mesh, gather))
    if policy in TP_POLICIES and mesh.shape["model"] > 1:
        passes = microbatches * (3 if remat else 2) if train else 1
        act = tokens * cfg.d_model * BF16.itemsize
        add("all-reduce", 2 * act, passes * _sublayers(cfg, kind))
    return c


# --------------------------------------------------------------------------- #
# counting the cells
# --------------------------------------------------------------------------- #
class Count(NamedTuple):
    """One card's counted step."""

    cost: Cost
    memory: dict
    local_batch: int
    accum: int
    n_ops: int
    charges: dict


def model_shards(mesh, policy) -> int:
    """How many cards split one layer's width: the ``model`` axis under a
    tensor-parallel policy, else 1."""
    return mesh.shape["model"] if policy in TP_POLICIES else 1


def local_config(cfg, m: int):
    """``cfg`` at the widths one of ``m`` tensor-parallel cards runs (the
    module docstring's rule: ``d_inner`` stays whole, the Mamba-2 and
    RG-LRU blocks take their share through :func:`card_share`); ``cfg``
    itself where ``m`` is 1."""
    if m == 1:
        return cfg
    per = lambda n: -(-n // m)
    kv = per(cfg.n_kv_heads)
    heads = (kv * (cfg.n_heads // cfg.n_kv_heads) if cfg.n_kv_heads >= m
             else per(cfg.n_heads))
    return dataclasses.replace(
        cfg, n_heads=heads, n_kv_heads=kv, d_ff=per(cfg.d_ff),
        d_ff_expert=per(cfg.d_ff_expert), vocab_size=per(cfg.vocab_size))


class _StandIn(torch.autograd.Function):
    """A gather's stand-in: an uninitialized tensor of the gathered shape
    (no bytes counted); its backward keeps the card's piece (a view)."""

    @staticmethod
    def forward(ctx, t, m, dim):
        ctx.n, ctx.dim = t.shape[dim], dim
        return t.new_empty(t.shape[:dim] + (m * t.shape[dim],) + t.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        return g.split(ctx.n, ctx.dim)[0], None, None


class CardShare(sharding.TPPlan):
    """The first of ``m`` cards computing its share of the Mamba-2 and
    RG-LRU blocks on meta stand-ins: the blocks' split code
    (:class:`~repro_torch.runtime.sharding.TPPlan` with ``ssm`` / ``rec``
    set, every other module at :func:`local_config`'s widths).  Its
    collectives cost the card nothing here, as no other layer's does: a
    gather is a tensor of the gathered shape that nothing writes,
    ``copy`` and the products' cotangent sum are nothing.  The collective
    model charges each split block as it charges any tensor-parallel
    sublayer (:func:`collective_cost`)."""

    def gather(self, t, dim):
        return _StandIn.apply(t, self.m, dim % t.ndim)

    def copy(self, t):
        return t

    def products(self, x, ws, product=torch.matmul):
        return [product(x, w) for w in ws]


def card_share(cfg, params, mesh, policy, multi_pod=False) -> CardShare | None:
    """The split of the Mamba-2 and RG-LRU blocks one card of ``mesh``
    computes under ``policy``, by ``sharding.block_splits`` (the rule the
    steps on ranks split by) from ``params``' specs; ``None`` where neither
    splits (a block that does not runs whole on every card)."""
    m = model_shards(mesh, policy)
    if m == 1:
        return None
    pfn = sharding.param_spec_fn(mesh, multi_pod=multi_pod, policy=policy, cfg=cfg)
    specs = {sharding.path_str(p): pfn(p, t) for p, t in _tree.leaves_with_paths(params)}
    ssm, rec = sharding.block_splits(cfg, m, specs)
    if not (ssm or rec):
        return None
    return CardShare(mesh=None, m=m, idx=0, kinds=tuple(cfg.layer_kinds()), n_heads=cfg.n_heads,
                     n_kv_heads=cfg.n_kv_heads, mla=False, attn=False, mlp=False, vocab=False,
                     kv_local=False, ssm=ssm, rec=rec)


def card_leaves(tree, plan: CardShare | None, state: bool = False):
    """``tree`` (meta parameters, or with ``state`` a cache) with the
    card's share of each split block's leaves: of a parameter its first
    ``1 / m`` of a 2-D leaf's last dim (the rest whole); of a state leaf
    the part the block computes (``TPPlan.state_dim``)."""
    if plan is None:
        return tree

    def one(path, t):
        if state:
            if not plan.splits_state(path):
                return t
            dim = plan.state_dim(path, t.ndim)
        else:
            parts = sharding.path_str(path).split("/")
            if not (parts[0] == "layers" and len(parts) > 3 and t.ndim == 2
                    and parts[2] in sharding.BLOCK_KINDS and plan.splits(parts[2])):
                return t
            dim = 1
        return t.narrow(dim, 0, t.shape[dim] // plan.m)

    return _tree.map_with_paths(one, tree)


def card_context(plan: CardShare | None):
    """The context a card's count runs in: its :class:`CardShare` set as
    the plan (``mesh_ctx.tp_local``), or nothing."""
    return nullcontext() if plan is None else mesh_ctx.mesh_ctx(None, tp_local=plan)


def _memory(args_local, out_local, alias, peak, args_full) -> dict:
    return {
        "argument_size_in_bytes": int(args_local),
        "output_size_in_bytes": int(out_local),
        "temp_size_in_bytes": int(max(peak - args_full, 0)),
        "alias_size_in_bytes": int(alias),
        "generated_code_size_in_bytes": 0,
    }


def _local_batch(specs, bfn, mesh) -> int:
    t = specs["tokens"]
    return local_shape(t.shape, bfn((), t), mesh)[0]


def count_train(arch, shape_name, mesh, multi_pod, *, policy="tp_fsdp", accum=None,
                remat=True, loss_chunks=16, smoke=False) -> Count:
    """Count one card's train step: ``make_train_step`` at the card's
    widths (:func:`local_config`) on fp32 meta parameters and AdamW state
    over one of the local batch's ``accum`` microbatches (fewer where the
    local batch does not split so), its loss and gradients taken ``accum``
    times (every microbatch dispatches the same ops), and the AdamW update
    once, on each leaf's shard of the full-width parameters."""
    cfg = get_config(arch, smoke=smoke)
    params = build_model(cfg).init(None, "meta", dtype=F32)
    lcfg = local_config(cfg, model_shards(mesh, policy))
    model = build_model(lcfg)
    plan = card_share(cfg, params, mesh, policy, multi_pod)
    lparams = card_leaves(model.init(None, "meta", dtype=F32), plan)
    specs = input_specs(arch, shape_name, smoke=smoke)
    bfn = sharding.batch_spec_fn(mesh, multi_pod=multi_pod, policy=policy)
    pfn = sharding.param_spec_fn(mesh, multi_pod=multi_pod, policy=policy, cfg=cfg)
    batch = {k: _local_tensor(v, bfn, mesh) for k, v in specs.items()}
    b = batch["tokens"].shape[0]
    if accum is None:
        dp = 32 if multi_pod else 16
        accum = max(1, min(8, specs["tokens"].shape[0] // dp))
    accum = max(a for a in range(1, min(accum, b) + 1) if b % a == 0)
    tc = TrainConfig(grad_accum=1, remat=remat, n_loss_chunks=loss_chunks)
    micro = {k: v[: b // accum] for k, v in batch.items()}
    with card_context(plan), OpCounter() as counter:
        make_train_step(model, tc)(lparams, adamw_init(lparams), None, micro, 0)
    cost = Cost()
    cost += counter.cost
    cost += _adamw_cost(lparams, lcfg, tc, lambda p, t: meta(t.shape, t.dtype)).scaled(-1.0)
    cost = cost.scaled(accum)
    cost += _adamw_cost(params, cfg, tc, lambda p, t: meta(local_shape(t.shape, pfn(p, t), mesh),
                                                           t.dtype))
    seq = batch["src_embeds" if cfg.family == "encdec" else "tokens"].shape[1]
    cost += collective_cost(cfg, params, mesh, multi_pod=multi_pod, policy=policy, kind="train",
                            tokens=(b // accum) * seq, microbatches=accum, remat=remat)
    # parameters, the two moments (fp32 as the parameters) and the count
    state_local = 3 * local_bytes(params, pfn, mesh) + 4
    batch_local = sum(_nbytes(t) for t in batch.values())
    held = 3 * sum(_nbytes(t) for t in _tree.leaves(lparams)) + 4 + batch_local
    memory = _memory(state_local + batch_local, state_local + 3 * 4, 0, counter.peak_bytes, held)
    return Count(cost, memory, b, accum, counter.n_ops, counter.charges)


def _adamw_cost(params, cfg, tc, like) -> Cost:
    """The AdamW update as ``make_train_step`` calls it, on stand-ins
    ``like(path, leaf)`` of every parameter, gradient and moment."""
    p = _tree.map_with_paths(like, params)
    g = _tree.map_with_paths(like, params)
    state = adamw_init(p)
    lr = cosine_schedule(0, peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps,
                         total_steps=tc.total_steps)
    with OpCounter() as c:
        adamw_update(g, state, p, lr=lr, weight_decay=tc.weight_decay, clip_norm=tc.clip_norm,
                     decay=reference_decay_mask(p, cfg))
    return c.cost


def _serve_setup(arch, shape_name, mesh, multi_pod, policy, smoke):
    """The full-width config and weights (what the specs shard), the
    model and weights at one card's widths (what it runs), its
    :class:`CardShare` (or ``None``), the inputs' stand-ins and the local
    batch."""
    cfg = get_config(arch, smoke=smoke)
    params = build_model(cfg).init(None, "meta")  # weights at the config's dtype
    model = build_model(local_config(cfg, model_shards(mesh, policy)))
    plan = card_share(cfg, params, mesh, policy, multi_pod)
    specs = input_specs(arch, shape_name, smoke=smoke)
    bfn = sharding.batch_spec_fn(mesh, multi_pod=multi_pod, policy=policy)
    b = _local_batch(specs, bfn, mesh)
    return cfg, params, model, card_leaves(model.init(None, "meta"), plan), plan, specs, b


def _serve_count(counter, cfg, params, lparams, cache, logits, mesh, multi_pod, policy, kind,
                 tokens, inputs) -> tuple[Cost, dict]:
    """The counted step's cost with its collectives, and its memory: the
    weights' shards, and the cache as the card built it (local batch and
    widths)."""
    pfn = sharding.param_spec_fn(mesh, multi_pod=multi_pod, policy=policy, cfg=cfg)
    cost = Cost()
    cost += counter.cost
    cost += collective_cost(cfg, params, mesh, multi_pod=multi_pod, policy=policy, kind=kind,
                            tokens=tokens)
    cache_b = sum(_nbytes(t) for t in _tree.leaves(cache))
    in_bytes = sum(_nbytes(t) for t in inputs)
    args = local_bytes(params, pfn, mesh) + cache_b + in_bytes
    held = sum(_nbytes(t) for t in _tree.leaves(lparams)) + cache_b + in_bytes
    out = _nbytes(logits) + cache_b
    return cost, _memory(args, out, cache_b, counter.peak_bytes, held)


def count_decode(arch, shape_name, mesh, multi_pod, *, policy="tp_fsdp", smoke=False) -> Count:
    """Count one card's decode step: ``decode_step`` of ``s_q`` tokens on a
    meta cache of the shape's length, at the last position (every key
    below the cache length live)."""
    cfg, params, model, lparams, plan, specs, b = _serve_setup(arch, shape_name, mesh,
                                                               multi_pod, policy, smoke)
    shape = LM_SHAPES[shape_name]
    s = shape.seq_len
    if cfg.family == "encdec":
        cache = model.init_cache(lparams, meta((b, 1024, cfg.d_model), BF16), s)
    else:
        cache = card_leaves(model.init_cache(lparams, b, s), plan, state=True)
    tokens = meta((b, shape.s_q), torch.int64)
    with card_context(plan), OpCounter() as counter:
        logits, cache = model.decode_step(lparams, cache, tokens, s - shape.s_q)
    cost, memory = _serve_count(counter, cfg, params, lparams, cache, logits, mesh, multi_pod,
                                policy, "decode", b * shape.s_q, [tokens])
    return Count(cost, memory, b, 1, counter.n_ops, counter.charges)


def count_prefill(arch, shape_name, mesh, multi_pod, *, policy="tp_fsdp", smoke=False) -> Count:
    """Count one card's prefill: the prompt into a meta cache of its
    length (an encoder-decoder: the encoder and cross K/V over the
    source, then the target prompt; a vlm: its vision stubs first)."""
    from repro_torch.models import vlm
    from repro_torch.models.transformer import lm_apply, lm_logits

    cfg, params, model, lparams, plan, specs, b = _serve_setup(arch, shape_name, mesh,
                                                               multi_pod, policy, smoke)
    lcfg = model.cfg
    tokens = meta((b, specs["tokens"].shape[1]), torch.int64)
    s = tokens.shape[1]
    inputs = [tokens]
    if cfg.family == "encdec":
        src = meta((b, *specs["src_embeds"].shape[1:]), BF16)
        inputs.append(src)
        with OpCounter() as counter:
            cache = model.init_cache(lparams, src, s)
            logits, cache = model.decode_step(lparams, cache, tokens, 0)
    else:
        cache = card_leaves(model.init_cache(lparams, b, s), plan, state=True)
        with card_context(plan), OpCounter() as counter:
            if cfg.family == "vlm":
                vis = meta((b, *specs["vision_embeds"].shape[1:]), BF16)
                inputs.append(vis)
                pos = vlm.mrope_positions(b, s, vis.shape[1], device="meta")
                hidden, cache, _ = lm_apply(lparams, tokens, cfg=lcfg, positions=pos, cache=cache,
                                            cache_len=0, embeds_override=vis)
                logits = lm_logits(lparams, hidden[:, -1:], cfg=lcfg)
            else:
                logits, cache = model.prefill(lparams, cache, tokens)
    cost, memory = _serve_count(counter, cfg, params, lparams, cache, logits, mesh, multi_pod,
                                policy, "prefill", b * s, inputs)
    return Count(cost, memory, b, 1, counter.n_ops, counter.charges)


COUNTERS = {"train": count_train, "prefill": count_prefill, "decode": count_decode}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None, *,
             smoke: bool = False) -> dict:
    cfg = get_config(arch, smoke=smoke)
    shape = LM_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")  # shapes only
    n_chips = mesh.size
    t0 = time.time()
    count = COUNTERS[shape.kind](arch, shape_name, mesh, multi_pod, smoke=smoke)
    count_s = time.time() - t0
    mf = analysis.model_flops(cfg, shape)
    terms = analysis.roofline_from_cost(count.cost, model_flops_total=mf, n_chips=n_chips)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "count_s": round(count_s, 2),
        "memory": count.memory,
        "model_flops_total": mf,
        "roofline": terms.to_dict(),
        "collectives": {"bytes": count.cost.coll, "counts": count.cost.coll_counts},
        "local_batch": count.local_batch,
        "grad_accum": count.accum,
        "n_ops": count.n_ops,
        "kernel_charges": {k: {"flops": v.flops, "bytes": v.bytes}
                           for k, v in count.charges.items()},
    }
    print(
        f"[OK] {arch:22s} {shape_name:12s} {rec['mesh']:8s} "
        f"count {rec['count_s']:6.1f}s "
        f"flops/dev {terms.flops_per_device:.3e} "
        f"dominant {terms.dominant:10s} bound {terms.bound_time_s*1e3:.2f} ms "
        f"useful {terms.useful_ratio:.2f}",
        flush=True,
    )
    print("  memory:", count.memory, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{shape_name}__{rec['mesh']}.json".replace("/", "_")
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="assigned", help="assigned|all|csv names")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--meshes", default="both", choices=["both", "single", "multi"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--stop-on-error", action="store_true")
    args = ap.parse_args(argv)

    if args.archs == "assigned":
        archs = list(ASSIGNED)
    elif args.archs == "all":
        archs = list(ASSIGNED) + list(BONUS)
    else:
        archs = args.archs.split(",")

    meshes = {"both": [False, True], "single": [False], "multi": [True]}[args.meshes]
    ok = fail = skip = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = runnable_shapes(cfg) if args.shapes == "all" else args.shapes.split(",")
        for shape_name in shapes:
            if shape_name not in runnable_shapes(cfg):
                print(f"[SKIP] {arch} {shape_name} (documented inapplicability)")
                skip += 1
                continue
            for multi_pod in meshes:
                try:
                    run_cell(arch, shape_name, multi_pod, args.out)
                    ok += 1
                except Exception:  # noqa: BLE001 - the sweep reports every cell
                    fail += 1
                    print(f"[FAIL] {arch} {shape_name} multi_pod={multi_pod}")
                    traceback.print_exc()
                    if args.stop_on_error:
                        raise
    print(f"\ndry-run complete: {ok} ok, {fail} failed, {skip} skipped")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
