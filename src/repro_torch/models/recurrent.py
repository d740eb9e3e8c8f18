"""RG-LRU recurrent block (RecurrentGemma / Griffin), counterpart of
``repro/models/recurrent.py``.

Two parallel branches from the residual stream:

    gate  = GeLU(x W_gate)                       (B, S, d_inner)
    main  = Conv1D_4(x W_main)  ->  RG-LRU       (B, S, d_inner)
    y     = (gate * main) W_out                  (B, S, d)

RG-LRU recurrence (per channel, fp32):

    r_t = sigmoid(x_t W_r),  i_t = sigmoid(x_t W_i)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference scans with ``jax.lax.associative_scan``; here a doubling
(Hillis-Steele) scan over the sequence takes ``ceil(log2 S)`` elementwise
steps on the ``(a, b)`` pairs, then folds in the initial state.  A decode
step (S = 1) takes none.  The cache (``h`` and the conv's last
``conv_width - 1`` inputs, both fp32 as the reference keeps them) is
updated in place with ``copy_``: a serving slot's batch-1 view and a
captured decode graph both write through it.

Under ``tp`` (a :class:`~repro_torch.runtime.sharding.TPPlan` splitting
the block over the ``model`` ranks, as the reference's specs lay out its
weights) a rank computes its ``d_inner / m`` channels: ``w_gate`` and
``w_main`` give its columns, the depthwise conv, the gates, ``lam``, the
scan and the state are per channel; ``w_r`` and ``w_i`` (d_inner x
d_inner) give its columns of the gathered conv output; ``w_out``'s output
``d`` is on ``model``, so ``h * gate`` is gathered, multiplied by the
rank's columns and the outputs gathered (:func:`layers.dense_across`).
Three gathers a block; its cache is the rank's channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


def rglru_block_init(gen, cfg, *, device, dtype):
    d, dl = cfg.d_model, cfg.d_inner
    kw = dict(device=device, dtype=dtype)
    # Lambda so that a = exp(-c * softplus(Lambda) * r) starts near 0.9..0.999
    lam = torch.empty((dl,), dtype=torch.float32, device=device).uniform_(
        0.001, 0.1, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(lam) / _C))  # inverse softplus
    return {
        "w_gate": layers.dense_init(gen, d, dl, **kw),
        "w_main": layers.dense_init(gen, d, dl, **kw),
        "conv_w": layers.truncnorm(gen, (cfg.conv_width, dl),
                                   1.0 / math.sqrt(cfg.conv_width), **kw),
        "conv_b": torch.zeros((dl,), dtype=torch.float32, device=device),
        "w_r": layers.dense_init(gen, dl, dl, std=1.0 / math.sqrt(dl), **kw),
        "w_i": layers.dense_init(gen, dl, dl, std=1.0 / math.sqrt(dl), **kw),
        "lam": lam,
        "w_out": layers.dense_init(gen, dl, d, std=1.0 / math.sqrt(dl), **kw),
    }


def init_rglru_cache(cfg, batch, *, device):
    dl = cfg.d_inner
    return {
        "h": torch.zeros((batch, dl), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dl), dtype=torch.float32,
                            device=device),
    }


def causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv of width W.  x: (B, S, D), w: (W, D).  Returns
    (out, the new conv state: the last W - 1 inputs, ``conv_state`` first)."""
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S + W - 1, D)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, width):
        out = out + xp[:, i : i + s] * w[i].to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return out + b.to(x.dtype), new_state


def rglru_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t from h0, over axis 1 of ``a, b (B, S, D)``:
    the prefix products of the affine maps by doubling, then h0 folded in."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a * h0[:, None] + b


def rglru_block_apply(params, x, *, cfg, cache=None, dtype=torch.bfloat16, tp=None):
    """Returns (y, cache); the cache (when given) is updated in place.
    ``tp``: this rank's channels only (the module docstring); ``cache``
    then holds its channels."""
    own = slice(None) if tp is None else slice(*tp.part(cfg.d_inner))
    gate, main = layers.dense_many([params["w_gate"], params["w_main"]], x, dtype=dtype, tp=tp)
    gate = F.gelu(gate.float(), approximate="tanh").to(dtype)

    conv_state = cache["conv"] if cache is not None else None
    main, new_conv = causal_conv(main, params["conv_w"], params["conv_b"][own], conv_state)

    # RG-LRU gates (fp32 for the recurrence)
    mf = main.float()
    r, i = layers.dense_many([params["w_r"], params["w_i"]],
                             main if tp is None else tp.gather(main, -1), dtype=dtype, tp=tp)
    r, i = torch.sigmoid(r.float()), torch.sigmoid(i.float())
    a = torch.exp(-_C * F.softplus(params["lam"][own]) * r)  # (B, S, dl)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * mf)

    h0 = cache["h"] if cache is not None else torch.zeros_like(a[:, 0])
    h = rglru_scan(a, b, h0)  # (B, S, dl)

    y = layers.dense_across(params["w_out"], h.to(dtype) * gate, dtype=dtype, tp=tp)
    if cache is not None:
        cache["h"].copy_(h[:, -1])
        cache["conv"].copy_(new_conv)
    return y, cache
