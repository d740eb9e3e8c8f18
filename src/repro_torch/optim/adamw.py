"""AdamW, global-norm clipping and the cosine schedule (counterpart of
``repro/optim/adamw.py``).

Trees are the port's parameter trees (:mod:`repro_torch.core.tree`);
the update is functional, as the reference's: it returns new parameter,
moment and count tensors and changes none it was given.

Weight decay follows the reference's rank rule, ``ndim >= 2``, applied to
the reference's tree.  The reference stacks the layers of each scanned
layer group along a leading axis (and the encoder-decoder's layers with
``vmap``), so there every leaf of a stacked layer — norm scales and biases
included — has ``ndim >= 2`` and is decayed; only unstacked leaves
(``final_norm``, the unscanned remainder layers) escape it.  The port
keeps layers unstacked, so :func:`reference_leaves` maps its leaves onto
the reference's, :func:`reference_decay_mask` marks the leaves the
reference decays, and :func:`adamw_update` decays by that mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import tree as _tree


class AdamWState(NamedTuple):
    count: torch.Tensor  # scalar int32
    mu: dict
    nu: dict


def adamw_init(params) -> AdamWState:
    """Zero fp32 moments shaped as ``params``, count 0 (on their device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = _tree.leaves(params)
    dev = first[0].device if first else None
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=_tree.tree_map(zeros, params),
        nu=_tree.tree_map(zeros, params),
    )


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every leaf."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in _tree.leaves(tree)))


def clip_by_global_norm(grads, max_norm, norm=None):
    """(grads scaled to global norm at most ``max_norm``, the norm);
    ``norm``, where given, is the global norm already taken (of a
    gradient some of whose leaves are shards held elsewhere too)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return _tree.tree_map(lambda g: g * scale, grads), norm


class RefLeaf:
    """One leaf of the reference's stacked tree: the paths of the port
    leaves it holds, in stacking order (one path if it is not stacked)."""

    __slots__ = ("paths", "stacked")

    def __init__(self, paths, stacked):
        self.paths, self.stacked = paths, stacked


def reference_leaves(params, cfg) -> list[RefLeaf]:
    """The leaves of the reference's tree for ``params``, in its
    flattening order (dict keys sorted).  A decoder-only model's first
    ``n_layers // period * period`` layers are scanned groups there:
    ``groups/pos{j}`` stacks the leaf of layers ``j, j + period, ...``;
    the remainder layers (``rem``) and the top-level leaves are not
    stacked.  An encoder-decoder's ``enc_layers`` / ``dec_layers`` are
    stacked whole."""
    leaf = _tree.map_with_paths(lambda p, _: RefLeaf([p], False), params)

    def stack(layers):
        return _tree.tree_map(
            lambda *xs: RefLeaf([x.paths[0] for x in xs], True), layers[0], *layers[1:])

    if cfg.family == "encdec":
        ref = dict(leaf, **{k: stack(leaf[k]) for k in ("enc_layers", "dec_layers")})
    else:
        period = len(cfg.layer_pattern)
        n = cfg.n_layers // period * period
        ref = {k: v for k, v in leaf.items() if k != "layers"}
        if n:
            ref["groups"] = {f"pos{j}": stack(leaf["layers"][j:n:period]) for j in range(period)}
        ref["rem"] = leaf["layers"][n:]
    return _tree.leaves(ref)


def reference_decay_mask(params, cfg):
    """A tree of bools shaped as ``params``: True where the reference's
    ``ndim >= 2`` rule decays the leaf in its stacked tree
    (:func:`reference_leaves`): every stacked leaf, and an unstacked one
    by its own rank."""
    flat = dict(_tree.leaves_with_paths(params))
    decay = {p: ref.stacked or flat[p].ndim >= 2
             for ref in reference_leaves(params, cfg) for p in ref.paths}
    return _tree.map_with_paths(lambda p, _: decay[p], params)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
    decay=None,
):
    """Returns (new_params, new_state, metrics ``{"grad_norm", "lr"}``).
    ``decay`` is a bool tree shaped as ``params`` (default: ``ndim >= 2``
    per leaf, the reference's rule on its own tree); ``clip_norm=None``
    clips nothing."""
    if clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
    else:
        gnorm = global_norm(grads)
    if decay is None:
        decay = _tree.tree_map(lambda p: p.ndim >= 2, params)
    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def upd(g, m, v, p, dec):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        if dec:
            step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    out = [upd(*x) for x in zip(_tree.leaves(grads), _tree.leaves(state.mu),
                                _tree.leaves(state.nu), _tree.leaves(params),
                                _tree.leaves(decay), strict=True)]
    new_p = _tree.unflatten_like(params, [o[0] for o in out])
    new_m = _tree.unflatten_like(params, [o[1] for o in out])
    new_v = _tree.unflatten_like(params, [o[2] for o in out])
    return new_p, AdamWState(count=count, mu=new_m, nu=new_v), {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps, min_ratio=0.1) -> torch.Tensor:
    """fp32 learning rate: linear warmup to ``peak_lr`` over
    ``warmup_steps``, then a cosine down to ``min_ratio * peak_lr`` at
    ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
