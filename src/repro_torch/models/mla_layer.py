"""Multi-head Latent Attention (counterpart of ``repro/models/mla_layer.py``:
the absorbed decode pieces the paged backend composes, ``mla_apply`` over
a dense latent cache, and the expanded form it takes without one).

The KV cache stores only the shared latent ``[c (d_latent) ; k_rope
(d_rope)]`` per token (576 numbers at DeepSeek-V2 geometry).  Queries are
absorbed: the per-head no-rope query is premultiplied by ``W_uk`` so
scores are taken directly against the latent (paper §2.2).  Weights keep
the JAX package's layouts: ``wq_nope (d, h, n)``, ``wq_rope (d, h, r)``,
``w_uk (h, n, c)``, ``w_uv (h, c, v)``, ``wkv_down``/``wk_rope``/``wo``
as dense ``(d_in, d_out)``.

Under a tensor-parallel plan (``tp``; the rank-local serve step under
``tp`` / ``tp_fsdp``) ``wq_nope``, ``wq_rope``, ``w_uk`` and ``w_uv`` hold
this rank's heads, ``wkv_down`` / ``wk_rope`` its latent columns and
``wo`` its d_model columns: the latent row is all-gathered before it is
written and attended (every head reads the whole latent), K4 runs over
the local heads, and ``o`` is all-gathered into ``wo``.  Training takes
the expanded form the same way (:func:`_mla_apply_expanded`), under
autograd.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.attention import mla_attention, multi_head_attention
from repro_torch.models import layers
from repro_torch.models.attention_layer import as_batch_vec, update_rows


def mla_init(gen, cfg, *, device, dtype):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = 1.0 / math.sqrt(d)
    kw = dict(device=device, dtype=dtype)
    return {
        "wq_nope": layers.truncnorm(gen, (d, h, m.d_nope), s, **kw),
        "wq_rope": layers.truncnorm(gen, (d, h, m.d_rope), s, **kw),
        "w_uk": layers.truncnorm(gen, (h, m.d_nope, m.d_latent), 1.0 / math.sqrt(m.d_nope), **kw),
        "wkv_down": layers.dense_init(gen, d, m.d_latent, **kw),
        "wk_rope": layers.dense_init(gen, d, m.d_rope, **kw),
        "w_uv": layers.truncnorm(gen, (h, m.d_latent, m.d_vhead), 1.0 / math.sqrt(m.d_latent), **kw),
        "wo": layers.dense_init(gen, h * m.d_vhead, d, std=1.0 / math.sqrt(h * m.d_vhead), **kw),
    }


def mla_scale(cfg) -> float:
    """Attention scale: pre-absorption per-head width (d_nope + d_rope)."""
    return 1.0 / math.sqrt(cfg.mla.d_nope + cfg.mla.d_rope)


def _heads_matmul(x, w, dtype):
    """``einsum('bsd,dhn->bshn')`` as one matmul over the flattened heads."""
    d, h, n = w.shape
    y = torch.matmul(x.to(dtype), w.to(dtype).reshape(d, h * n))
    return y.reshape(*x.shape[:-1], h, n)


def _per_head_matmul(x, w, dtype):
    """``einsum('bshc,hcv->bshv')``: a batched matmul over heads."""
    b, s, h, c = x.shape
    y = torch.bmm(x.to(dtype).reshape(b * s, h, c).transpose(0, 1), w.to(dtype))
    return y.transpose(0, 1).reshape(b, s, h, w.shape[-1])


def mla_latents(params, x, *, cfg, positions, dtype=torch.bfloat16, tp=None):
    """Latent cache rows ``[c ; RoPE(k_rope)]`` — (B, S, d_latent + d_rope);
    under ``tp`` from this rank's columns of both, all-gathered in one
    call; every local head reads the whole row, so its cotangent is summed
    over ``model`` (``tp.copy``)."""
    c = layers.dense(params["wkv_down"], x, dtype=dtype)
    k_rope = layers.dense(params["wk_rope"], x, dtype=dtype)
    if tp is not None:
        c, k_rope = tp.gather_last(c, k_rope)
    k_rope = layers.rope(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)[:, :, 0]
    lat = torch.cat([c, k_rope], dim=-1)
    return lat if tp is None else tp.copy(lat)


def mla_absorbed_queries(params, x, *, cfg, positions, dtype=torch.bfloat16):
    """Absorbed queries ``q' = [q_nope W_uk ; RoPE(q_rope)]`` — (B, S, H,
    d_latent + d_rope), scored directly against the latent rows."""
    q_nope = _heads_matmul(x, params["wq_nope"], dtype)
    q_rope = _heads_matmul(x, params["wq_rope"], dtype)
    q_rope = layers.rope(q_rope, positions, theta=cfg.rope_theta)
    q_c = _per_head_matmul(q_nope, params["w_uk"], dtype)
    return torch.cat([q_c, q_rope], dim=-1)


def mla_unabsorb_output(params, attn, *, cfg, dtype=torch.bfloat16, tp=None):
    """Un-absorb values (per-head latent -> d_vhead) and merge heads;
    ``attn`` is (B, S, H, d_latent), this rank's heads under ``tp``."""
    m = cfg.mla
    b, s, h = attn.shape[:3]
    o = _per_head_matmul(attn, params["w_uv"], dtype)
    return layers.dense_across(params["wo"], o.reshape(b, s, h * m.d_vhead), dtype=dtype, tp=tp)


def _mla_apply_expanded(params, x, *, cfg, positions, causal=True, dtype=torch.bfloat16,
                        tp=None):
    """Non-absorbed MLA (training): K/V expanded per head, attended with
    Dk = d_nope + d_rope and Dv = d_vhead.  Mathematically the absorbed
    form: ``[q_nope W_uk ; q_rope] . [c ; k_rope] = [q_nope ; q_rope] .
    [c W_uk^T ; k_rope]`` and ``P (c W_uv)`` per head.  ``tp``: this
    rank's heads and latent columns; the latent row ``[c ; k_rope]`` is
    all-gathered (every head reads all of it), and the products that
    read ``x`` or ``c`` sum their partial cotangents over ``model``
    (``tp.products``)."""
    m = cfg.mla
    b, s, d = x.shape
    if tp is None:
        c = layers.dense(params["wkv_down"], x, dtype=dtype)  # (B, S, Dc)
        k_rope = layers.dense(params["wk_rope"], x, dtype=dtype)
        q_nope = _heads_matmul(x, params["wq_nope"], dtype)
        q_rope = _heads_matmul(x, params["wq_rope"], dtype)
    else:
        c, k_rope, q_nope, q_rope = tp.products(x.to(dtype), [
            params["wkv_down"]["w"].to(dtype), params["wk_rope"]["w"].to(dtype),
            params["wq_nope"].to(dtype).reshape(d, -1), params["wq_rope"].to(dtype).reshape(d, -1)])
        c, k_rope = tp.gather_last(c, k_rope)
        q_nope = q_nope.reshape(b, s, -1, m.d_nope)
        q_rope = q_rope.reshape(b, s, -1, m.d_rope)
    k_rope = layers.rope(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)  # (B, S, 1, Dr)
    q_rope = layers.rope(q_rope, positions, theta=cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)  # (B, S, H, Dn + Dr)
    h = q.shape[2]
    # einsum('bsc,hnc->bshn') and einsum('bsc,hcv->bshv'): fp32 accumulation,
    # one rounding to ``dtype``
    w_uk, w_uv = params["w_uk"].permute(2, 0, 1), params["w_uv"].permute(1, 0, 2)
    if tp is None:
        k_nope = _heads_matmul(c, w_uk, dtype)
        v = _heads_matmul(c, w_uv, dtype)  # (B, S, H, d_vhead)
    else:
        k_rope = tp.copy(k_rope)
        k_nope, v = tp.products(c.to(dtype), [w.to(dtype).reshape(m.d_latent, -1)
                                              for w in (w_uk, w_uv)])
        k_nope, v = k_nope.reshape(b, s, h, m.d_nope), v.reshape(b, s, h, m.d_vhead)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.d_rope)], dim=-1)
    attn = multi_head_attention(q, k, v, variant=cfg.attn_variant, causal=causal,
                                scale=mla_scale(cfg))
    return layers.dense_across(params["wo"], attn.reshape(b, s, h * m.d_vhead), dtype=dtype,
                               tp=tp), None


def init_latent_cache(cfg, batch, max_len, *, dtype, device):
    """Zeroed dense latent cache ``{"c": (batch, max_len, d_latent +
    d_rope)}``."""
    m = cfg.mla
    shape = (batch, max_len, m.d_latent + m.d_rope)
    return {"c": torch.zeros(shape, dtype=dtype, device=device)}


def mla_apply(
    params,
    x: torch.Tensor,  # (B, S, d)
    *,
    cfg,
    positions: torch.Tensor,  # (B, S)
    cache=None,
    cache_len=None,
    causal: bool = True,
    dtype=torch.bfloat16,
    tp=None,
):
    """MLA over a dense latent cache (updated in place) in the absorbed
    form; returns (y, cache); ``tp``: this rank's heads (the module
    docstring).  Prefill and decode both attend through the
    contiguous AMLA kernel (``ops.mla_decode``).  Without a cache
    (training) it is the expanded form, :func:`_mla_apply_expanded`, as in
    the reference, unless the config sets ``mla_absorbed_train``: then the
    absorbed form over the layer's own latent rows."""
    if cache is None and not cfg.mla_absorbed_train:
        return _mla_apply_expanded(params, x, cfg=cfg, positions=positions, causal=causal,
                                   dtype=dtype, tp=tp)
    if cache is not None and cache_len is None:
        raise ValueError("a cache needs its cache_len")
    b, s, _ = x.shape
    if tp is not None:  # every product reads x over this rank's columns
        x = tp.copy(x)
    c_full = mla_latents(params, x, cfg=cfg, positions=positions, dtype=dtype, tp=tp)
    q_full = mla_absorbed_queries(params, x, cfg=cfg, positions=positions, dtype=dtype)
    if cache is not None:
        update_rows(cache["c"], c_full, cache_len)
        c_all = cache["c"]
        kv_len, q_offset = as_batch_vec(cache_len, b) + s, as_batch_vec(cache_len, b)
    else:
        c_all = c_full
        kv_len, q_offset = np.full((b,), s, np.int32), np.zeros((b,), np.int32)
    attn = mla_attention(
        q_full,
        c_all,
        d_v=cfg.mla.d_latent,
        variant=cfg.attn_variant,
        causal=causal,
        scale=mla_scale(cfg),
        kv_len=kv_len,
        q_offset=q_offset,
    )  # (B, S, H, d_latent) fp32
    return mla_unabsorb_output(params, attn, cfg=cfg, dtype=dtype, tp=tp), cache
