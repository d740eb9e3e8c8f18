"""Mamba-2 block via the SSD (state-space duality) chunked algorithm,
counterpart of ``repro/models/ssm.py``.

The sequence is split into chunks of ``CHUNK`` steps; within a chunk the
SSD matmul form runs as batched products, and a loop over the chunks
carries the ``(heads, head_dim, state)`` SSM state across them:

    intra:  Y_intra = ((C B^T) o L) X            (chunk-local, causal-masked)
    carry:  h_next  = decay(Q) h + (B~)^T X      (per chunk)
    inter:  Y_inter = C h_in  (decayed)

A prompt longer than ``CHUNK`` is padded to a multiple of it after the
``softplus`` of ``dt``, with ``dt = 0``, so the pad adds nothing to the
state; the conv state is taken before the padding.  Decode (S = 1 with a
cache) is the exact single-step recurrence.  The cache (``h`` and the
conv's last ``conv_width - 1`` inputs, fp32 as the reference keeps them)
is updated in place with ``copy_``.

Under ``tp`` (a :class:`~repro_torch.runtime.sharding.TPPlan` splitting
the block over the ``model`` ranks, as the reference's specs lay out its
weights) a rank computes its ``nh / m`` whole heads.  ``in_proj``'s and
``conv_w``'s columns are on ``model`` by their last dim, whose halves or
quarters do not fall on the ``[z, x, B, C, dt]`` boundaries: the rank
multiplies its columns and the projection is gathered, the depthwise conv
runs on the rank's conv channels (its cache's ``conv`` holds those) and
its output is gathered.  The SSD and the decode recurrence run on the
rank's heads with ``B`` and ``C`` whole (its cache's ``h`` holds its
heads), ``d_skip`` and the gate at its heads; the gated output is gathered
and normalized over the whole ``d_inner`` on every rank, and
``out_proj``'s output ``d`` is on ``model``: the rank multiplies its
columns and those are gathered.  Four gathers a block.  Under autograd
each gathered tensor whose uses are the rank's own passes ``tp.copy`` (the
ranks' cotangents summed over ``model``), so the gather's adjoint keeps
this rank's slice of the whole cotangent.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.recurrent import causal_conv

CHUNK = 256


def mamba2_block_init(gen, cfg, *, device, dtype):
    d, dl, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = dl // cfg.ssm_head_dim
    kw = dict(device=device, dtype=dtype)
    d_in_proj = 2 * dl + 2 * ds + nh  # [z, x, B, C, dt]
    conv_dim = dl + 2 * ds
    uniform = lambda lo, hi: torch.empty((nh,), dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=gen)
    return {
        "in_proj": layers.dense_init(gen, d, d_in_proj, **kw),
        "conv_w": layers.truncnorm(gen, (cfg.conv_width, conv_dim),
                                   1.0 / math.sqrt(cfg.conv_width), **kw),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=device),
        "a_log": torch.log(uniform(1.0, 16.0)),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 1e-1))),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm": layers.rmsnorm_init(dl, device=device),
        "out_proj": layers.dense_init(gen, dl, d, std=1.0 / math.sqrt(dl), **kw),
    }


def init_ssm_cache(cfg, batch, *, device):
    dl, ds = cfg.d_inner, cfg.ssm_state
    nh, hd = dl // cfg.ssm_head_dim, cfg.ssm_head_dim
    return {
        "h": torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dl + 2 * ds), dtype=torch.float32,
                            device=device),
    }


def split_proj(cfg, proj):
    """The in-projection's ``z, x, B, C, dt`` (dt: (..., heads))."""
    dl, ds = cfg.d_inner, cfg.ssm_state
    nh = dl // cfg.ssm_head_dim
    return torch.split(proj, [dl, dl, ds, ds, nh], dim=-1)


def ssd_chunked(x, dt, a, b, c, h0):
    """SSD chunked scan.

    x: (B, S, nh, hd)   dt: (B, S, nh)   a: (nh,) (positive decay rates)
    b, c: (B, S, ds)    h0: (B, nh, hd, ds)
    Returns y: (B, S, nh, hd), h_final.
    """
    bs, s, nh, hd = x.shape
    ds = b.shape[-1]
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nchunk = s // q

    la = -(a[None, None, :] * dt)  # per-step log-decay (B, S, nh), <= 0
    xr = x.reshape(bs, nchunk, q, nh, hd)
    br = b.reshape(bs, nchunk, q, ds)
    cr = c.reshape(bs, nchunk, q, ds)
    dtr = dt.reshape(bs, nchunk, q, nh)
    cum = torch.cumsum(la.reshape(bs, nchunk, q, nh), dim=2)  # inclusive
    total = cum[:, :, -1]  # (B, C, nh)

    # intra-chunk: L[t, u] = exp(cum_t - cum_u) for u <= t; above the
    # diagonal the exponent is positive and may overflow, so it is masked
    # to -inf before the exp (exp(-inf) = 0, no inf ever formed)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, C, Q, Q, nh)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    l_mat = torch.exp(torch.where(causal[None, None, :, :, None], diff, -torch.inf))
    cb = torch.einsum("bcqd,bcud->bcqu", cr, br)
    scores = cb[..., None] * l_mat  # (B, C, Q, Q, nh)
    xdt = xr * dtr[..., None]  # discretised input
    y_intra = torch.einsum("bcquh,bcuhd->bcqhd", scores, xdt)

    # chunk states: sum_u exp(total - cum_u) * dt_u x_u b_u^T
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B, C, Q, nh)
    h_chunk = torch.einsum("bcqhd,bcqs->bchds", decay_to_end[..., None] * xdt, br)

    h, h_ins = h0, []
    for i in range(nchunk):
        h_ins.append(h)  # the state entering chunk i
        h = h * torch.exp(total[:, i])[:, :, None, None] + h_chunk[:, i]
    h_ins = torch.stack(h_ins, dim=1)  # (B, C, nh, hd, ds)

    # inter-chunk output: y_t += C_t . (decay(0..t) h_in)
    y_inter = torch.einsum("bcqs,bchds->bcqhd", cr, h_ins) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(bs, s, nh, hd), h


def mamba2_block_apply(params, x, *, cfg, cache=None, dtype=torch.bfloat16, tp=None):
    """Returns (y, cache); the cache (when given) is updated in place.
    ``tp``: this rank's heads only (the module docstring); ``cache`` then
    holds its heads' ``h`` and its conv channels' ``conv``."""
    bsz, s, _ = x.shape
    dl, ds = cfg.d_inner, cfg.ssm_state
    nh, hd = dl // cfg.ssm_head_dim, cfg.ssm_head_dim
    heads = slice(0, nh) if tp is None else slice(*tp.part(nh))
    cols = slice(heads.start * hd, heads.stop * hd)

    proj = layers.dense_many([params["in_proj"]], x, dtype=dtype, tp=tp)[0]
    if tp is not None:
        proj = tp.copy(tp.gather(proj, -1))
    z, xin, b, c, dt = split_proj(cfg, proj)

    conv_in = torch.cat([xin, b, c], dim=-1)
    channels = slice(None) if tp is None else slice(*tp.part(conv_in.shape[-1]))
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = causal_conv(conv_in[..., channels], params["conv_w"],
                                     params["conv_b"][channels], conv_state)
    conv_out = F.silu(conv_out.float())
    if tp is not None:
        conv_out = tp.copy(tp.gather(conv_out, -1))
    xin, b, c = torch.split(conv_out, [dl, ds, ds], dim=-1)

    dt = F.softplus(dt[..., heads].float() + params["dt_bias"][heads])  # (B, S, heads)
    a = torch.exp(params["a_log"][heads])  # (heads,) positive
    xh = xin[..., cols].reshape(bsz, s, -1, hd)
    nl = xh.shape[2]

    h0 = cache["h"] if cache is not None else torch.zeros(
        (bsz, nl, hd, ds), dtype=torch.float32, device=x.device)

    if s == 1 and cache is not None:
        # exact single-step recurrence (decode)
        la = -(a[None, :] * dt[:, 0])  # (B, heads)
        xdt = xh[:, 0] * dt[:, 0, :, None]  # (B, heads, hd)
        h_final = h0 * torch.exp(la)[:, :, None, None] + torch.einsum(
            "bhd,bs->bhds", xdt, b[:, 0])
        y = torch.einsum("bs,bhds->bhd", c[:, 0], h_final)[:, None]  # (B, 1, heads, hd)
    else:
        pad = (-s) % CHUNK if s > CHUNK else 0
        xp, dtp, bp, cp = xh, dt, b, c
        if pad:
            xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            bp = F.pad(b, (0, 0, 0, pad))
            cp = F.pad(c, (0, 0, 0, pad))
        y, h_final = ssd_chunked(xp, dtp, a, bp, cp, h0)
        y = y[:, :s]

    y = y + xh * params["d_skip"][heads][None, None, :, None]  # skip path
    y = y.reshape(bsz, s, nl * hd).to(dtype)
    y = y * F.silu(z[..., cols].float()).to(dtype)  # gated
    if tp is None:
        y = layers.rmsnorm(params["norm"], y, eps=cfg.norm_eps)
        y = layers.dense(params["out_proj"], y, dtype=dtype)
    else:  # normalized over the whole d_inner: gathered first
        y = layers.rmsnorm(params["norm"], tp.gather(y, -1), eps=cfg.norm_eps)
        y = tp.gather(layers.dense_many([params["out_proj"]], y, dtype=dtype, tp=tp)[0], -1)
    if cache is not None:
        cache["h"].copy_(h_final)
        cache["conv"].copy_(new_conv)
    return y, cache
