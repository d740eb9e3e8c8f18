"""GQA/MQA/MHA attention layer with a dense KV cache (counterpart of
``repro/models/attention_layer.py``), RoPE, QK-norm and sliding windows.

The cache is kept in the kernels' layout, ``(B, Hkv, max_len, Dh)`` — the
reference's ``cache_layout="bhsd"`` — so the attention kernels read it
where it lies (``ops.gqa_attention`` takes it as a transposed view, with
no copy), and new rows are written into it in place.  The attention math
runs through :func:`repro_torch.core.attention.multi_head_attention`: the
CUDA kernels for CUDA tensors, their plain versions for CPU tensors.  The
reference's ``seqkv`` mesh branch (split-KV across devices) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.attention import multi_head_attention
from repro_torch.models import layers


def gqa_init(gen, cfg, *, device, dtype):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": layers.dense_init(gen, d, hq * dh, bias=cfg.qkv_bias, **kw),
        "wk": layers.dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias, **kw),
        "wv": layers.dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias, **kw),
        "wo": layers.dense_init(gen, hq * dh, d, std=1.0 / math.sqrt(hq * dh), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(dh, device=device)
        p["k_norm"] = layers.rmsnorm_init(dh, device=device)
    return p


def init_kv_cache(cfg, batch, max_len, *, dtype, device):
    """Zeroed ``{"k", "v"}`` of shape ``(batch, Hkv, max_len, Dh)``."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def update_rows(buf, new, cache_len) -> None:
    """Write ``new (B, s, ...)`` into ``buf (B, max_len, ...)`` at rows
    ``cache_len ...``, in place; a start past ``max_len - s`` is clamped,
    as the reference's dynamic-update-slice clamps it.

    A scalar ``cache_len`` (one position for the whole batch, as in a
    prefill) is one slice ``copy_``; per-example offsets (ragged decode)
    are one indexed write.
    """
    b, s = new.shape[:2]
    max_len = buf.shape[1]
    if np.ndim(cache_len) == 0:
        start = min(max(int(cache_len), 0), max_len - s)
        buf[:, start : start + s].copy_(new)
        return
    start = torch.as_tensor(cache_len, device=buf.device).reshape(b).to(torch.int64)
    start = torch.clamp(start, 0, max_len - s)
    rows = start[:, None] + torch.arange(s, device=buf.device)[None, :]
    buf[torch.arange(b, device=buf.device)[:, None], rows] = new.to(buf.dtype)


def as_batch_vec(x, b):
    """A scalar-or-(B,) length/offset as a host (B,) int32 array, or a
    (B,) tensor when given a tensor."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).expand(b) if x.ndim == 0 or x.numel() == 1 else x
    return np.array(np.broadcast_to(np.asarray(x, np.int32), (b,)))


def gqa_apply(
    params,
    x: torch.Tensor,  # (B, S, d)
    *,
    cfg,
    positions: torch.Tensor,  # (B, S) int
    window: int | None = None,
    cache=None,
    cache_len=None,  # (B,) or scalar, host array or tensor
    causal: bool = True,
    dtype=torch.bfloat16,
):
    """Returns (y, cache); the cache (when given) is updated in place."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = layers.dense(params["wq"], x, dtype=dtype).reshape(b, s, hq, dh)
    k = layers.dense(params["wk"], x, dtype=dtype).reshape(b, s, hkv, dh)
    v = layers.dense(params["wv"], x, dtype=dtype).reshape(b, s, hkv, dh)

    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, eps=cfg.norm_eps)
    if positions.ndim == 3:
        raise NotImplementedError("M-RoPE (qwen2-vl) positions are not ported yet")
    q = layers.rope(q, positions, theta=cfg.rope_theta)
    k = layers.rope(k, positions, theta=cfg.rope_theta)

    if cache is not None:
        if cache_len is None:
            raise ValueError("a cache needs its cache_len")
        # (B, max_len, Hkv, Dh) views of the (B, Hkv, max_len, Dh) cache
        k_all, v_all = cache["k"].transpose(1, 2), cache["v"].transpose(1, 2)
        update_rows(k_all, k, cache_len)
        update_rows(v_all, v, cache_len)
        kv_len = as_batch_vec(cache_len, b) + s
        q_offset = as_batch_vec(cache_len, b)
    else:
        k_all, v_all = k, v
        kv_len = np.full((b,), s, np.int32)
        q_offset = np.zeros((b,), np.int32)

    attn = multi_head_attention(
        q,
        k_all,
        v_all,
        variant=cfg.attn_variant,
        causal=causal,
        window=window,
        softcap=cfg.attn_softcap,
        scale=cfg.attn_scale or 1.0 / math.sqrt(dh),
        kv_len=kv_len,
        q_offset=q_offset,
    )
    y = layers.dense(params["wo"], attn.reshape(b, s, hq * dh), dtype=dtype)
    return y, cache
