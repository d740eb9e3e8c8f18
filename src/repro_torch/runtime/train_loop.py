"""The training step (counterpart of ``repro/runtime/train_loop.py``'s
``TrainConfig``, ``init_train_state`` and ``make_train_step``): the
model's chunked cross-entropy loss, per-layer remat, gradient
accumulation over strided microbatches, gradient compression with error
feedback, the cosine schedule, global-norm clipping and AdamW.

Parameters train as an fp32 tree (the reference's ``init``): the layers
compute at the config's dtype, casting each weight where it is used, so
the gradient reaches the fp32 leaves.  A serving tree (bf16 weights and
the fp32 copy of the unembedding table, ``table_f32``) is not a training
tree: :func:`init_train_state` builds fp32 parameters without that copy,
the step refuses a tree that holds one, and :func:`serving_params` makes
the serving tree from trained parameters.

Attention's forward is the card's flash prefill kernel (K7; K6 + K3 for
sequences of 8 or fewer) and its backward autograd through the
reference's blockwise path (:mod:`repro_torch.core.attention`).

:func:`jit_train_step` is the reference's sharded step factory: the
shardings of every parameter, moment, residual and batch leaf over a mesh
(:mod:`repro_torch.runtime.sharding`), and a step that places its inputs
by them and runs :func:`make_train_step`'s step on the local shards (a
mesh of one rank), or runs rank-locally on a mesh of processes
(:func:`_train_on_ranks`: this rank's batch rows, each layer's
parameters gathered at its use and their gradients reduced to this
rank's shards, the update on this rank's shards; under ``tp`` /
``tp_fsdp`` with several ``model`` ranks, this rank's heads, d_ff
columns and vocabulary rows only, with a vocabulary-parallel loss).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core import tree as _tree
from repro_torch.core.distributed import all_reduce_sum, axis_index
from repro_torch.core.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import cfg_dtype
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    reference_decay_mask,
)
from repro_torch.optim.compression import CompressionState, compress_grads, compression_init
from repro_torch.runtime import mesh_ctx, sharding


class TrainConfig(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    grad_accum: int = 1
    remat: bool = True
    compression: str = "none"  # none | bf16 | int8
    n_loss_chunks: int = 8


def _tables(params) -> list:
    return [params[k] for k in ("embed", "unembed") if k in params]


def check_trainable(params) -> None:
    """Raise unless ``params`` is a training tree: no ``table_f32`` copy
    (it would take the unembedding's gradient away from the table)."""
    if any("table_f32" in t for t in _tables(params)):
        raise ValueError(
            "parameters hold a serving table_f32 copy; train an fp32 tree "
            "(init_train_state, or convert_params of fp32 weights)")


def init_train_state(model, generator: torch.Generator, device="cuda"):
    """fp32 parameters drawn from ``generator`` on ``device``, zero AdamW
    state, and no compression state (the reference's)."""
    params = model.init(generator, resolve_device(device), dtype=torch.float32)
    check_trainable(params)
    return params, adamw_init(params), compression_init(params, "none")


def serving_params(params, cfg) -> dict:
    """The serving tree of trained fp32 ``params``: every leaf the serving
    init makes at the compute dtype cast to it (norm scales, biases and
    the recurrent/SSM blocks' fp32 leaves keep fp32, as ``model.init``
    makes them), and the unembedding table's fp32 copy made from the
    trained table."""
    dtype = cfg_dtype(cfg)
    like = _serving_dtypes(cfg, dtype)
    out = _tree.tree_map(lambda p, d: p.detach().to(d), params, like)
    for t in _tables(out):
        layers.keep_fp32_table(t)
    return out


def _serving_dtypes(cfg, dtype):
    """A tree of the dtypes ``model.init(dtype=dtype)`` gives each leaf,
    read off a meta-device build (no memory, no random draws)."""
    from repro_torch.models.model_zoo import build_model

    meta = build_model(cfg).init(None, "meta", dtype=dtype)
    for t in _tables(meta):
        t.pop("table_f32", None)
    return _tree.tree_map(lambda p: p.dtype, meta)


def _to_batch(batch, device) -> dict:
    """Host (numpy) or tensor batch fields as tensors on ``device``:
    integer fields as int64 (indices), float fields as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def make_train_step(model, tc: TrainConfig):
    """Returns ``train_step(params, opt_state, comp_state, batch, step) ->
    (params, opt_state, comp_state, metrics)``, ``metrics`` the device
    scalars ``loss``, ``grad_norm`` and ``lr``."""
    if tc.grad_accum < 1:
        raise ValueError(f"grad_accum={tc.grad_accum} must be positive")

    def train_step(params, opt_state, comp_state, batch, step):
        check_trainable(params)
        first = _tree.leaves(params)[0]
        batch = _to_batch(batch, first.device)
        losses, grads = _accumulated_grads(model, tc, params, batch)
        grads, comp_state = _compressed(model, tc, grads, comp_state, step, first.device)
        lr = cosine_schedule(step, peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps,
                             total_steps=tc.total_steps)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=tc.weight_decay,
            clip_norm=tc.clip_norm, decay=reference_decay_mask(params, model.cfg))
        metrics["loss"] = _mean(losses)
        return params, opt_state, comp_state, metrics

    return train_step


def _loss_and_grads(model, tc, params, batch, weight=None):
    """The loss (``model.loss``, the mean over ``batch``'s valid labels)
    and the gradient of ``weight x`` that loss (of the loss itself when
    ``weight`` is None) for every leaf of ``params``."""
    flat = [p.detach().requires_grad_() for p in _tree.leaves(params)]
    loss = model.loss(_tree.unflatten_like(params, flat), batch, remat=tc.remat,
                      n_loss_chunks=tc.n_loss_chunks)
    grads = torch.autograd.grad(loss if weight is None else loss * weight, flat,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), grads


def _microbatches(batch, a):
    """STRIDED microbatching: microbatch m takes rows [m::a], so every
    data shard contributes rows to every microbatch (the reference's split;
    a contiguous one changes which rows meet)."""
    if next(iter(batch.values())).shape[0] % a:
        raise ValueError(f"batch does not split into grad_accum={a} microbatches")
    return [{k: v[m::a] for k, v in batch.items()} for m in range(a)]


def _accumulated_grads(model, tc, params, batch, weights=None):
    """(each microbatch's loss, the gradient tree) of one step's batch:
    the mean over the ``grad_accum`` microbatches of their gradients,
    ``weights[m]`` scaling microbatch m's (:func:`_loss_and_grads`)."""
    a = tc.grad_accum
    weights = [None] * a if weights is None else weights
    if a == 1:
        loss, grads = _loss_and_grads(model, tc, params, batch, weights[0])
        return [loss], _tree.unflatten_like(params, grads)
    losses, grads = [], None
    for mb, w in zip(_microbatches(batch, a), weights):
        l, g = _loss_and_grads(model, tc, params, mb, w)
        losses.append(l)
        grads = [x.float() for x in g] if grads is None else [
            x + y.float() for x, y in zip(grads, g)]
    return losses, _tree.unflatten_like(params, [g / a for g in grads])


def _mean(losses):
    """The step's loss: the microbatches' mean (one microbatch's as it is)."""
    if len(losses) == 1:
        return losses[0]
    loss = 0.0
    for l in losses:
        loss = loss + l
    return loss / len(losses)


def _compressed(model, tc, grads, comp_state, step, device):
    """The gradients through the step's compression (none, bf16 or int8
    with error feedback), the key drawn from ``step`` as the reference's."""
    if tc.compression == "none":
        return grads, comp_state
    return compress_grads(grads, comp_state, mode=tc.compression, cfg=model.cfg,
                          rng=prng.fold_in(prng.prng_key(17, device), step))


def jit_train_step(model, tc: TrainConfig, mesh, params_like, *, multi_pod: bool = False,
                   donate: bool = True, policy: str = "tp_fsdp"):
    """The train step sharded over ``mesh`` against ``params_like`` (only
    its shapes are read: meta tensors do).  Returns ``(compile_for,
    shardings)``, ``shardings`` with keys ``params``, ``opt``, ``comp`` and
    ``batch_fn``; ``compile_for(batch_like)`` gives a step with
    :func:`make_train_step`'s signature that places ``params``,
    ``opt_state``, ``comp_state`` and ``batch`` by them and returns plain
    tensors (the local shards of the result).

    ``donate`` is the reference's buffer donation; the port's step is
    functional (it writes none of its inputs and returns new tensors), so
    there is nothing to donate and the flag changes nothing.  Microbatches
    are strided over the batch as :func:`make_train_step` takes them.

    On a mesh of several ranks every rank calls the step with the same
    arguments (the global batch; each state leaf a full value or a placed
    ``DTensor``) and it runs rank-locally (:func:`_train_on_ranks`): the
    metrics are the one-process step's, equal on every rank, and the new
    parameters, moments and residuals come back as ``DTensor``s of this
    rank's shards."""
    del donate
    pfn = sharding.param_spec_fn(mesh, multi_pod=multi_pod, policy=policy, cfg=model.cfg)
    bfn = sharding.batch_spec_fn(mesh, multi_pod=multi_pod, policy=policy)
    param_sh = sharding.make_shardings(mesh, params_like, pfn)
    opt_sh = AdamWState(count=sharding.NamedSharding(mesh, sharding.P()), mu=param_sh,
                        nu=param_sh)
    comp_sh = None if tc.compression == "none" else CompressionState(residual=param_sh)
    step_fn = make_train_step(model, tc)

    def batch_shardings(batch_like):
        return sharding.make_shardings(mesh, batch_like, bfn)

    def compile_for(batch_like):
        shs = (param_sh, opt_sh, comp_sh, batch_shardings(batch_like))

        def step(params, opt_state, comp_state, batch, step):
            dm = mesh.device_mesh()  # raises unless the process group fits the mesh
            dev = mesh.devices.flat[torch.distributed.get_rank()]
            args = (params, opt_state, comp_state, _to_batch(batch, dev))
            if dm.size() > 1:
                return _train_on_ranks(model, tc, mesh, shs, args, step,
                                       policy=policy, multi_pod=multi_pod)
            return step_fn(*sharding.local_run(mesh, args, shs), step)

        return step

    return compile_for, {"params": param_sh, "opt": opt_sh, "comp": comp_sh,
                         "batch_fn": batch_shardings}


def _train_on_ranks(model, tc, mesh, shardings, args, step, *, policy, multi_pod):
    """One rank's share of a sharded train step.

    * The batch rows are this rank's, by the batch spec (its axes
      ``rows``, the data-parallel ranks: the data axes, and ``model`` too
      under ``fsdp``, ``fsdp2d`` and ``dp``); the strided microbatches of
      those rows make up the global ones only if each rank's row count
      divides by ``grad_accum``, so another count raises.
    * The model receives this rank's shards of the parameters and
      gathers each layer's leaves, and each table, at its use
      (:class:`~repro_torch.runtime.sharding.ParamGather` in ``mesh_ctx``;
      inside the checkpoint of a remat'd layer, so the recompute gathers
      again); the gradient is taken with respect to the shards, and each
      comes back as this rank's shard, summed over the rows' axes the
      leaf was gathered over (the gather's adjoint).  Under a
      tensor-parallel plan (:func:`~repro_torch.runtime.sharding.tp_plan`:
      ``tp`` / ``tp_fsdp`` with several ``model`` ranks) the attention
      layers, dense MLPs and embedding tables keep this rank's ``model``
      shard (gathered over the data axes only) and the model computes
      only its heads, columns and vocabulary (``mesh_ctx.tp_local``).  A
      whole leaf of a split attention layer that the rank reads in part
      has a gradient that is this rank's term of a sum over ``model``,
      summed over it with the rows' sums below.
    * The loss is the global mean: each microbatch's gradient is weighted
      by ``n_dp x`` (this rank's valid labels / the global count), the
      gradients summed over the ``rows`` axes the gathers did not sum
      them over, and over ``model`` where they are partial (one
      all-reduce for the leaves alike in those axes), and divided by
      ``n_dp``; the reported loss is the sum of the ranks'
      label-weighted losses over the count.
    * Compression, the clipping norm and the norm reported are of the full
      gradient, as on one rank.  Compression runs on it whole (the
      gradient and the residual gathered, the threefry draw the same).
      Without compression the norm sums each leaf's squares over every
      axis that shards it (one all-reduce an axis) and counts a
      replicated leaf once.  AdamW updates this rank's shards of the
      parameters and moments, which come back as ``DTensor``s with the
      residual's shard.
    """
    param_sh, opt_sh, comp_sh, b_sh = shardings
    params, opt_state, comp_state, batch = args
    check_trainable(params)
    rows = sharding.spec_axes(next(iter(b_sh.values())).spec[0])
    n_dp = axis_index(rows, mesh)[1]
    local = sharding.local_shards(sharding.place(batch, b_sh))
    a = tc.grad_accum
    n_rows = next(iter(local.values())).shape[0]
    if n_rows % a:
        raise ValueError(
            f"a rank's {n_rows} batch rows do not split into grad_accum={a} strided "
            "microbatches, so its microbatches would not make up the global ones")
    plan = sharding.tp_plan(model.cfg, mesh, policy, param_sh)
    gather = sharding.param_gather(param_sh, plan, rows)
    p_local, opt_local = sharding.local_shards(sharding.place((params, opt_state),
                                                              (param_sh, opt_sh)))
    counts = torch.stack([(mb["labels"] >= 0).sum() for mb in _microbatches(local, a)])
    total = torch.clamp_min(all_reduce_sum(counts, rows, mesh=mesh), 1)
    weights = (n_dp * counts.double() / total.double()).float()
    with mesh_ctx.mesh_ctx(mesh, policy, multi_pod, rank_rows=rows, tp_local=plan,
                           gather=gather):
        losses, grads = _accumulated_grads(model, tc, p_local, local, weights=list(weights))
    sums = all_reduce_sum(torch.stack(losses) * counts, rows, mesh=mesh)
    loss = _mean(list(sums / total))
    grads = _sum_rest(gather, plan, grads, param_sh, n_dp)

    if comp_sh is not None:  # compression takes the whole gradient
        residual = sharding.whole_tree(comp_state.residual, param_sh)
        whole, comp = _compressed(model, tc, sharding.gather_tree(grads, param_sh),
                                  CompressionState(residual=residual), step,
                                  _tree.leaves(p_local)[0].device)
        comp_state = CompressionState(residual=_placed(comp.residual, param_sh, params, full=True))
        gnorm = global_norm(whole)
        grads = sharding.shard_tree(whole, param_sh)
    else:
        gnorm = _split_norm(grads, param_sh)
    if tc.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm, norm=gnorm)
    lr = cosine_schedule(step, peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps,
                         total_steps=tc.total_steps)
    new_p, new_opt, metrics = adamw_update(
        grads, opt_local, p_local, lr=lr, weight_decay=tc.weight_decay, clip_norm=None,
        decay=reference_decay_mask(p_local, model.cfg))
    new_opt = AdamWState(
        count=sharding.from_local(new_opt.count, opt_sh.count, ()),
        mu=_placed(new_opt.mu, param_sh, params), nu=_placed(new_opt.nu, param_sh, params))
    metrics.update(grad_norm=gnorm, loss=loss)
    return _placed(new_p, param_sh, params), new_opt, comp_state, metrics


def _sum_rest(gather, plan, grads, shardings, n_dp):
    """``grads`` (each this rank's shard, summed by its gather's adjoint
    over the rows' axes it was gathered over) summed over what is left and
    divided by ``n_dp``: for each leaf the rows' axes its gather did not
    sum over (:meth:`~repro_torch.runtime.sharding.ParamGather.rest`: a
    replicated leaf's every one, a leaf gathered over ``data`` only
    ``model`` under ``fsdp``), and ``model`` too where its gradient is
    this rank's term of a sum over ``model``
    (:meth:`~repro_torch.runtime.sharding.TPPlan.partial`): one all-reduce
    for all the leaves left the same axes."""
    flat = dict(_tree.leaves_with_paths(grads))
    specs = {p: sh.spec for p, sh in _tree.leaves_with_paths(shardings)}
    groups: dict = {}
    for p in flat:
        axes = gather.rest(p)
        if (plan is not None and "model" not in axes
                and plan.partial(sharding.path_str(p), specs[p])):
            axes += ("model",)
        if axes:
            groups.setdefault(axes, []).append(p)
    parts = {}
    for axes, paths in groups.items():
        summed = all_reduce_sum(torch.cat([flat[p].reshape(-1) for p in paths]), axes,
                                mesh=gather.mesh)
        parts.update(zip(paths, torch.split(summed, [flat[p].numel() for p in paths])))
    return _tree.map_with_paths(
        lambda p, g: (parts[p].view_as(g) if p in parts else g) / n_dp, grads)


def _split_norm(grads, shardings) -> torch.Tensor:
    """The full gradient's L2 norm (fp32) from ``grads``, each leaf this
    rank's shard by its spec: each leaf's sum of squares summed over every
    mesh axis that shards it (one all-reduce an axis, groups of one rank
    left out), a replicated leaf's counted once, added in leaf order as
    :func:`global_norm` adds them."""
    flat = _tree.leaves_with_paths(grads)
    shs = dict(_tree.leaves_with_paths(shardings))
    mesh = next(iter(shs.values())).mesh
    sq = torch.stack([torch.sum(g.float() * g.float()) for _, g in flat])
    for ax in mesh.axis_names:
        on = [ax in {a for e in shs[p].spec for a in sharding.spec_axes(e)} for p, _ in flat]
        if mesh.shape[ax] > 1 and any(on):
            mask = torch.tensor(on, device=sq.device)
            sq = torch.where(mask, all_reduce_sum(torch.where(mask, sq, 0.0), (ax,), mesh=mesh),
                             sq)
    return torch.sqrt(sum(sq.unbind()))


def _placed(tree, shardings, like, *, full=False):
    """``DTensor``s of this rank's shards in ``tree`` (or of its slices of
    the full values, with ``full``), shaped as the leaves of ``like`` (the
    step's arguments: full values or placed ``DTensor``s)."""
    flat = dict(_tree.leaves_with_paths(shardings))
    shapes = {path: t.shape for path, t in _tree.leaves_with_paths(like)}

    def one(path, t):
        sh = flat[path]
        return sharding.from_local(sharding.shard_one(t, sh) if full else t, sh, shapes[path])

    return _tree.map_with_paths(one, tree)
