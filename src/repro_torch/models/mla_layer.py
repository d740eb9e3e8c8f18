"""Multi-head Latent Attention, absorbed form (counterpart of
``repro/models/mla_layer.py``: the decode pieces the paged backend
composes, and ``mla_apply`` over a dense latent cache).

The KV cache stores only the shared latent ``[c (d_latent) ; k_rope
(d_rope)]`` per token (576 numbers at DeepSeek-V2 geometry).  Queries are
absorbed: the per-head no-rope query is premultiplied by ``W_uk`` so
scores are taken directly against the latent (paper §2.2).  Weights keep
the JAX package's layouts: ``wq_nope (d, h, n)``, ``wq_rope (d, h, r)``,
``w_uk (h, n, c)``, ``w_uv (h, c, v)``, ``wkv_down``/``wk_rope``/``wo``
as dense ``(d_in, d_out)``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.attention import mla_attention
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


def mla_latents(params, x, *, cfg, positions, dtype=torch.bfloat16):
    """Latent cache rows ``[c ; RoPE(k_rope)]`` — (B, S, d_latent + d_rope)."""
    c = layers.dense(params["wkv_down"], x, dtype=dtype)
    k_rope = layers.dense(params["wk_rope"], x, dtype=dtype)
    k_rope = layers.rope(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_rope], dim=-1)


def mla_absorbed_queries(params, x, *, cfg, positions, dtype=torch.bfloat16):
    """Absorbed queries ``q' = [q_nope W_uk ; RoPE(q_rope)]`` — (B, S, H,
    d_latent + d_rope), scored directly against the latent rows."""
    q_nope = _heads_matmul(x, params["wq_nope"], dtype)
    q_rope = _heads_matmul(x, params["wq_rope"], dtype)
    q_rope = layers.rope(q_rope, positions, theta=cfg.rope_theta)
    q_c = _per_head_matmul(q_nope, params["w_uk"], dtype)
    return torch.cat([q_c, q_rope], dim=-1)


def mla_unabsorb_output(params, attn, *, cfg, dtype=torch.bfloat16):
    """Un-absorb values (per-head latent -> d_vhead) and merge heads;
    ``attn`` is (B, S, H, d_latent)."""
    m = cfg.mla
    b, s, h = attn.shape[:3]
    o = _per_head_matmul(attn, params["w_uv"], dtype)
    return layers.dense(params["wo"], o.reshape(b, s, h * m.d_vhead), dtype=dtype)


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
):
    """Absorbed MLA over a dense latent cache, updated in place; returns
    (y, cache).  Prefill and decode both attend through the contiguous
    AMLA kernel (``ops.mla_decode``).  The expanded (non-absorbed) form the
    reference uses without a cache is training-only and not ported."""
    if cache is None:
        raise NotImplementedError(
            "mla_apply without a cache is the reference's expanded training "
            "form, which is not ported yet"
        )
    if cache_len is None:
        raise ValueError("a cache needs its cache_len")
    b, s, _ = x.shape
    c_full = mla_latents(params, x, cfg=cfg, positions=positions, dtype=dtype)
    q_full = mla_absorbed_queries(params, x, cfg=cfg, positions=positions, dtype=dtype)
    update_rows(cache["c"], c_full, cache_len)
    attn = mla_attention(
        q_full,
        cache["c"],
        d_v=cfg.mla.d_latent,
        variant=cfg.attn_variant,
        causal=causal,
        scale=mla_scale(cfg),
        kv_len=as_batch_vec(cache_len, b) + s,
        q_offset=as_batch_vec(cache_len, b),
    )  # (B, S, H, d_latent) fp32
    return mla_unabsorb_output(params, attn, cfg=cfg, dtype=dtype), cache
