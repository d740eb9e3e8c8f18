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
by them and runs :func:`make_train_step`'s step on the local shards.  A
mesh of one rank (``make_debug_mesh``) runs here; a step over several
ranks (sharded leaves, the gradient reduction) waits for a machine with
several cards and raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core import tree as _tree
from repro_torch.core.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import cfg_dtype
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    reference_decay_mask,
)
from repro_torch.optim.compression import CompressionState, compress_grads, compression_init
from repro_torch.runtime import sharding


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

    def loss_and_grads(params, batch):
        flat = [p.detach().requires_grad_() for p in _tree.leaves(params)]
        loss = model.loss(_tree.unflatten_like(params, flat), batch, remat=tc.remat,
                          n_loss_chunks=tc.n_loss_chunks)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return loss.detach(), grads

    def train_step(params, opt_state, comp_state, batch, step):
        check_trainable(params)
        first = _tree.leaves(params)[0]
        batch = _to_batch(batch, first.device)
        a = tc.grad_accum
        if a == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            # STRIDED microbatching: microbatch m takes rows [m::a], so every
            # data shard contributes rows to every microbatch (the reference's
            # split; a contiguous one changes which rows meet).
            if next(iter(batch.values())).shape[0] % a:
                raise ValueError(f"batch does not split into grad_accum={a} microbatches")
            loss, grads = 0.0, None
            for m in range(a):
                l, g = loss_and_grads(params, {k: v[m::a] for k, v in batch.items()})
                loss = loss + l
                grads = [x.float() for x in g] if grads is None else [
                    x + y.float() for x, y in zip(grads, g)]
            loss = loss / a
            grads = [g / a for g in grads]
        grads = _tree.unflatten_like(params, grads)

        if tc.compression != "none":
            grads, comp_state = compress_grads(
                grads, comp_state, mode=tc.compression, cfg=model.cfg,
                rng=prng.fold_in(prng.prng_key(17, first.device), step))
        lr = cosine_schedule(step, peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps,
                             total_steps=tc.total_steps)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=tc.weight_decay,
            clip_norm=tc.clip_norm, decay=reference_decay_mask(params, model.cfg))
        metrics["loss"] = loss
        return params, opt_state, comp_state, metrics

    return train_step


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
    are strided over the batch as :func:`make_train_step` takes them."""
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
        b_sh = batch_shardings(batch_like)

        def step(params, opt_state, comp_state, batch, step):
            mesh.device_mesh()  # raises unless the process group fits the mesh
            dev = mesh.devices.flat[torch.distributed.get_rank()]
            args = (params, opt_state, comp_state, _to_batch(batch, dev))
            placed = sharding.local_run(mesh, args, (param_sh, opt_sh, comp_sh, b_sh))
            return step_fn(*placed, step)

        return step

    return compile_for, {"params": param_sh, "opt": opt_sh, "comp": comp_sh,
                         "batch_fn": batch_shardings}
