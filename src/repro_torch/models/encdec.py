"""Encoder-decoder backbone (counterpart of ``repro/models/encdec.py``,
seamless-m4t-medium; the audio frontend is a stub: the caller supplies
frame embeddings ``(B, Ss, d)`` that feed the encoder directly).

The encoder is a stack of non-causal self-attention + MLP layers (K7 over
all frames); the decoder a causal stack with per-layer cross-attention
whose K/V are computed once per request from the encoder output
(:func:`encdec_cache_init`) and read by every decode step (K6 over the
static memory: single-pass softmax, no online rescale needed).

Parameters: ``enc_layers`` and ``dec_layers`` (lists of per-layer dicts,
the reference's ``vmap``-stacked layers unstacked, see
:mod:`repro_torch.convert`), ``embed`` (tied unembedding), ``enc_norm``
and ``final_norm``.  The cache is ``{"self": [per-layer {"k", "v"} of
(B, H, max_len, Dh)], "cross": [per-layer {"k", "v"} of (B, Ss, H,
Dh)]}``; the self-attention rows are written in place, as the dense
decoder's are.

Inside a rank-local step under a tensor-parallel plan (``mesh_ctx``
``tp_split``) every encoder self-attention, decoder self- and
cross-attention computes this rank's heads, every MLP its d_ff columns,
and the tied table's lookup and logits its vocabulary rows; each layer's
leaves come through ``mesh_ctx.working`` just before it runs.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.attention_layer import (
    cross_attention_apply,
    cross_attention_init,
    cross_kv,
    gqa_apply,
    gqa_init,
    init_kv_cache,
)
from repro_torch.models.transformer import default_positions
from repro_torch.runtime import mesh_ctx


def _enc_layer_init(gen, cfg, *, device, dtype):
    kw = dict(device=device, dtype=dtype)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(gen, cfg, **kw),
        "ln2": layers.rmsnorm_init(cfg.d_model, device=device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def _dec_layer_init(gen, cfg, *, device, dtype):
    kw = dict(device=device, dtype=dtype)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, device=device),
        "self_attn": gqa_init(gen, cfg, **kw),
        "ln_x": layers.rmsnorm_init(cfg.d_model, device=device),
        "cross_attn": cross_attention_init(gen, cfg, **kw),
        "ln2": layers.rmsnorm_init(cfg.d_model, device=device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def encdec_init(gen, cfg, *, device, dtype) -> dict:
    """Random parameters drawn tensor by tensor on ``device`` in ``dtype``
    (the tied table gets its fp32 copy,
    :func:`~repro_torch.models.layers.keep_fp32_table`)."""
    kw = dict(device=device, dtype=dtype)
    params = {
        "enc_layers": [_enc_layer_init(gen, cfg, **kw) for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg, **kw) for _ in range(cfg.n_layers)],
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "enc_norm": layers.rmsnorm_init(cfg.d_model, device=device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device=device),
    }
    layers.keep_fp32_table(params["embed"])
    return params


def encode(params, src_embeds, *, cfg, src_len=None, dtype=torch.bfloat16):
    """``src_embeds (B, Ss, d)`` stub frame embeddings -> encoder states
    ``(B, Ss, d)``.  Every frame attends to every frame: ``src_len`` is
    ignored, as in the reference (a padded frame is attended to)."""
    del src_len
    b, ss, _ = src_embeds.shape
    positions = default_positions(b, ss, None, src_embeds.device)
    x = src_embeds.to(dtype)
    for i, lp in enumerate(params["enc_layers"]):
        lp = mesh_ctx.working(lp, ("enc_layers", i))
        h = layers.rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
        y, _ = gqa_apply(lp["attn"], h, cfg=cfg, positions=positions, causal=False,
                         dtype=dtype, tp=mesh_ctx.tp_split("attn"))
        x = x + y
        h = layers.rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
        x = x + layers.mlp(lp["mlp"], h, act=cfg.act, dtype=dtype, tp=mesh_ctx.tp_split("mlp"))
    return layers.rmsnorm(mesh_ctx.working(params["enc_norm"], ("enc_norm",)), x,
                          eps=cfg.norm_eps)


def decode_stack(params, tokens, memory, *, cfg, cache=None, cache_len=None,
                 memory_len=None, dtype=torch.bfloat16):
    """The decoder over ``tokens (B, St)`` at positions ``cache_len +
    arange(St)``: causal self-attention (over the cache's rows when
    ``cache`` is given, written in place at ``cache_len``), then
    cross-attention over ``memory (B, Ss, d)`` or, with a cache, over its
    precomputed cross K/V (``memory`` None).  Returns (hidden (B, St, d)
    after the final norm, cache)."""
    b, st = tokens.shape
    x = layers.embed({"table": mesh_ctx.working(params["embed"]["table"], ("embed", "table"))},
                     tokens, dtype=dtype, tp=mesh_ctx.tp_split("embed"))
    positions = default_positions(b, st, cache_len, x.device)
    for l, lp in enumerate(params["dec_layers"]):
        lp = mesh_ctx.working(lp, ("dec_layers", l))
        h = layers.rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
        y, _ = gqa_apply(lp["self_attn"], h, cfg=cfg, positions=positions,
                         cache=cache["self"][l] if cache is not None else None,
                         cache_len=cache_len, dtype=dtype, tp=mesh_ctx.tp_split("attn"))
        x = x + y
        h = layers.rmsnorm(lp["ln_x"], x, eps=cfg.norm_eps)
        y, _ = cross_attention_apply(
            lp["cross_attn"], h, memory_kv=cache["cross"][l] if cache is not None else None,
            memory=memory, cfg=cfg, memory_len=memory_len, dtype=dtype,
            tp=mesh_ctx.tp_split("cross"))
        x = x + y
        h = layers.rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
        x = x + layers.mlp(lp["mlp"], h, act=cfg.act, dtype=dtype, tp=mesh_ctx.tp_split("mlp"))
    return layers.rmsnorm(mesh_ctx.working(params["final_norm"], ("final_norm",)), x,
                          eps=cfg.norm_eps), cache


def encdec_cache_init(params, cfg, src_embeds, max_len, *, dtype=torch.bfloat16) -> dict:
    """Run the encoder once and precompute every layer's cross K/V; the
    self-attention caches start zeroed, ``max_len`` rows each."""
    b = src_embeds.shape[0]
    memory = encode(params, src_embeds, cfg=cfg, dtype=dtype)
    return {
        "self": [init_kv_cache(cfg, b, max_len, dtype=dtype, device=memory.device)
                 for _ in params["dec_layers"]],
        "cross": [cross_kv(lp["cross_attn"], memory, cfg=cfg, dtype=dtype)
                  for lp in params["dec_layers"]],
    }
