"""Decoder-only LM (counterpart of ``repro/models/transformer.py``): the
dense-cache path (``lm_apply`` over per-layer caches, as the reference's
``ServingSession`` drives it) and the paged MLA backend.

Parameters are a dict: ``embed``/``unembed`` tables, ``final_norm``, and
``layers``, a list of per-layer dicts (``ln1``, ``attn``, ``ln2``,
``mlp``, and gemma2's ``post_ln1``/``post_ln2``) — the reference's scanned
``groups`` unstacked, as ``per_layer_params`` does there (see
:mod:`repro_torch.convert`).  A Python loop over that list takes the place
of the reference's ``scan`` over layer groups.  Dense caches are a list
with one dict per layer, updated in place.

Layer kinds "global" and "local" (GQA or MLA attention, "local" with the
config's sliding window) with a dense MLP are ported; recurrent, SSM and
MoE layers raise ``NotImplementedError``.

The paged path walks the layer stack host-side so each layer can (1)
append its latent row(s) into the shared page pool and (2) attend through
``ops.mla_decode_paged`` with ONE decode schedule built per step (or per
prefill chunk) and reused by every layer — all L layers share the block
table and kv_len, so the (request, kv_block) work queue is identical.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import decode_schedule as _sched
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.attention_layer import gqa_apply, gqa_init, init_kv_cache
from repro_torch.models.mla_layer import (
    init_latent_cache,
    mla_absorbed_queries,
    mla_apply,
    mla_init,
    mla_latents,
    mla_scale,
    mla_unabsorb_output,
)
from repro_torch.runtime.kv_cache import OutOfPagesError


def _has_mlp(cfg, kind):
    return kind != "ssm" and (cfg.d_ff > 0 or cfg.n_experts > 0)


def cfg_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg) -> None:
    """The layer kinds and families the port builds: "global"/"local"
    attention (GQA or MLA) with a dense MLP, in a decoder-only LM."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {"global", "local"}:
        raise NotImplementedError(
            f"config {cfg.name!r} has layer kinds {sorted(kinds)}; recurrent "
            f"and SSM layers are not ported yet"
        )
    if cfg.n_experts:
        raise NotImplementedError(
            f"config {cfg.name!r} has a MoE MLP, which is not ported yet"
        )
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet")


def layer_init(gen, cfg, kind, *, device, dtype):
    """One attention (GQA or MLA) + dense-MLP layer of ``kind``."""
    if kind not in ("global", "local"):
        raise NotImplementedError(f"{kind!r} layers are not ported yet")
    kw = dict(device=device, dtype=dtype)
    p = {"ln1": layers.rmsnorm_init(cfg.d_model, device=device)}
    p["attn"] = mla_init(gen, cfg, **kw) if cfg.mla else gqa_init(gen, cfg, **kw)
    if _has_mlp(cfg, kind):
        p["ln2"] = layers.rmsnorm_init(cfg.d_model, device=device)
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, **kw)
    if cfg.post_norms:
        p["post_ln1"] = layers.rmsnorm_init(cfg.d_model, device=device)
        if _has_mlp(cfg, kind):
            p["post_ln2"] = layers.rmsnorm_init(cfg.d_model, device=device)
    return p


def lm_init(gen, cfg, *, device, dtype):
    """Random parameters, drawn tensor by tensor on ``device`` in ``dtype``
    (a full-width bf16 model is built on the card without an fp32 copy)."""
    check_supported(cfg)
    kw = dict(device=device, dtype=dtype)
    params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw)
    params["layers"] = [layer_init(gen, cfg, kind, **kw) for kind in cfg.layer_kinds()]
    return params


def check_paged_compatible(cfg) -> None:
    """Paged serving covers MLA attention-only stacks (the paper's regime);
    GQA and windowed stacks serve through the dense backend."""
    if cfg.mla is None:
        raise ValueError(
            f"config {cfg.name!r} has no MLA geometry — the paged cache "
            f"backend stores 576-wide latent rows (try deepseek-v2-mla, or "
            f"serve this arch with the dense backend)"
        )
    kinds = set(cfg.layer_kinds())
    if kinds != {"global"}:
        raise ValueError(
            f"paged serving needs an all-'global' attention stack; config "
            f"{cfg.name!r} has layer kinds {sorted(kinds)}"
        )
    check_supported(cfg)


def embed_tokens(params, tokens, *, cfg):
    x = layers.embed(params["embed"], tokens, dtype=cfg_dtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


# --------------------------------------------------------------------------- #
# Dense-cache path
# --------------------------------------------------------------------------- #
def layer_cache_init(cfg, kind, batch, max_len, *, dtype, device):
    """The dense cache of one layer: a latent cache for MLA, else K/V.
    Local layers keep a linear ``max_len`` cache, as the reference does."""
    if kind not in ("global", "local"):
        raise NotImplementedError(f"{kind!r} layer caches are not ported yet")
    if cfg.mla:
        return init_latent_cache(cfg, batch, max_len, dtype=dtype, device=device)
    return init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)


def lm_cache_init(cfg, batch, max_len, *, dtype, device) -> list:
    """One zeroed dense cache per layer."""
    return [
        layer_cache_init(cfg, kind, batch, max_len, dtype=dtype, device=device)
        for kind in cfg.layer_kinds()
    ]


def layer_apply(params, x, *, cfg, kind, positions, cache=None, cache_len=None,
                dtype=torch.bfloat16):
    """Pre-norm residual block.  Returns (x, cache); the cache is updated
    in place."""
    if kind not in ("global", "local"):
        raise NotImplementedError(f"{kind!r} layers are not ported yet")
    h = layers.rmsnorm(params["ln1"], x, eps=cfg.norm_eps)
    if cfg.mla:
        y, cache = mla_apply(params["attn"], h, cfg=cfg, positions=positions,
                             cache=cache, cache_len=cache_len, dtype=dtype)
    else:
        window = cfg.window if kind == "local" else None
        y, cache = gqa_apply(params["attn"], h, cfg=cfg, positions=positions,
                             window=window, cache=cache, cache_len=cache_len,
                             dtype=dtype)
    if cfg.post_norms:
        y = layers.rmsnorm(params["post_ln1"], y, eps=cfg.norm_eps)
    x = x + y
    if _has_mlp(cfg, kind):
        h = layers.rmsnorm(params["ln2"], x, eps=cfg.norm_eps)
        y = layers.mlp(params["mlp"], h, act=cfg.act, dtype=dtype)
        if cfg.post_norms:
            y = layers.rmsnorm(params["post_ln2"], y, eps=cfg.norm_eps)
        x = x + y
    return x, cache


def lm_apply(params, tokens, *, cfg, positions=None, cache=None, cache_len=None,
             dtype=None):
    """Returns (hidden (B, S, d) after the final norm, cache).
    Unembedding is the caller's job (:func:`lm_logits`).  ``cache_len``
    (scalar or (B,), host array or tensor) is where the new tokens go."""
    b, s = tokens.shape
    dtype = dtype or cfg_dtype(cfg)
    x = embed_tokens(params, tokens, cfg=cfg).to(dtype)
    if positions is None:
        base = torch.as_tensor(cache_len if cache_len is not None else 0, device=x.device)
        steps = torch.arange(s, device=x.device)[None, :]
        positions = (base.reshape(-1, 1).to(torch.int64) + steps).expand(b, s)
    for l, (p_l, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        x, _ = layer_apply(
            p_l, x, cfg=cfg, kind=kind, positions=positions,
            cache=cache[l] if cache is not None else None, cache_len=cache_len,
            dtype=dtype,
        )
    x = layers.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return x, cache


def lm_logits(params, hidden, *, cfg, dtype=None):
    """fp32 vocab logits of ``hidden`` (final-softcapped where the config
    says so)."""
    table = params.get("unembed", params["embed"])
    return layers.unembed(table, hidden, dtype=dtype or cfg_dtype(cfg),
                          softcap=cfg.final_softcap)


# --------------------------------------------------------------------------- #
# Paged backend
# --------------------------------------------------------------------------- #
def paged_attn_inputs(p_l, x, positions, *, cfg):
    """Pre-attention half of one layer: latent rows + absorbed queries."""
    dtype = cfg_dtype(cfg)
    h = layers.rmsnorm(p_l["ln1"], x, eps=cfg.norm_eps)
    lat = mla_latents(p_l["attn"], h, cfg=cfg, positions=positions, dtype=dtype)
    q = mla_absorbed_queries(p_l["attn"], h, cfg=cfg, positions=positions, dtype=dtype)
    return lat, q


def paged_layer_post(p_l, x, attn, *, cfg):
    """Post-attention half: un-absorb, residual, MLP."""
    dtype = cfg_dtype(cfg)
    y = mla_unabsorb_output(p_l["attn"], attn.to(dtype), cfg=cfg, dtype=dtype)
    if cfg.post_norms:
        y = layers.rmsnorm(p_l["post_ln1"], y, eps=cfg.norm_eps)
    x = x + y
    if _has_mlp(cfg, "global"):
        h = layers.rmsnorm(p_l["ln2"], x, eps=cfg.norm_eps)
        y = layers.mlp(p_l["mlp"], h, act=cfg.act, dtype=dtype)
        if cfg.post_norms:
            y = layers.rmsnorm(p_l["post_ln2"], y, eps=cfg.norm_eps)
        x = x + y
    return x


def paged_logits(params, x, *, cfg):
    """Final norm + fp32 unembedding of ``x (B, S, d)``."""
    x = layers.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return lm_logits(params, x, cfg=cfg)


def _paged_attend(q, cache, layer, bt, kv_len, *, cfg, block_k, schedule,
                  q_offset, q_positions, num_splits, compute_dtype, variant):
    return ops.mla_decode_paged(
        q,
        cache.layer_pages(layer),
        bt,
        kv_len,
        d_v=cfg.mla.d_latent,
        variant=variant,
        scale=mla_scale(cfg),
        q_offset=q_offset,
        q_positions=q_positions,
        scheduler="queue",
        block_k=block_k,
        num_splits=num_splits,
        schedule=schedule,
        compute_dtype=compute_dtype,
    )


def _check_head_shards(head_shards: int) -> None:
    if head_shards != 1:
        raise NotImplementedError(
            "head_shards > 1 (tensor-parallel head groups) is not ported yet"
        )


def lm_prefill_paged(
    params,
    tokens,  # (S,) prompt token ids
    *,
    cfg,
    cache,  # runtime.kv_cache.LayeredPagedKVCache
    rid: int,
    start_pos: int = 0,
    chunk: int = 32,
    table_width: int | None = None,
    block_k: int | None = None,
    variant: str = "amla",
    compute_dtype=None,
    head_shards: int = 1,
    need_logits: bool = True,
):
    """Chunked prefill-into-pages; returns last-token logits ``(1, vocab)``.

    The prompt runs in fixed chunks of ``chunk`` tokens (the tail chunk
    zero-padded: its padded query rows attend like real ones and are
    dropped); each chunk's latents are appended into ``rid``'s pages layer
    by layer, and each layer attends its ``chunk * H`` query rows over the
    request's pages with per-row causal positions.
    """
    check_paged_compatible(cfg)
    _check_head_shards(head_shards)
    dev = cache.device
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    s_total = int(tokens.shape[0])
    if s_total < 1:
        raise ValueError("prefill needs at least one token")
    tw = table_width or cache.num_pages
    if block_k is None:
        block_k = ops.default_paged_block_k(cache.page_size, tw)
    logits = None
    for s0 in range(0, s_total, chunk):
        valid = min(chunk, s_total - s0)
        tok = np.zeros((1, chunk), np.int64)
        tok[0, :valid] = tokens[s0 : s0 + valid]
        abs0 = start_pos + s0
        positions = torch.arange(abs0, abs0 + chunk, device=dev)[None]
        plan = cache.reserve(rid, valid)
        bt, kv_len = cache.block_table([rid], width=tw)
        # One schedule per chunk, shared by all L layers.
        schedule = _sched.build_schedule(kv_len, block_k=block_k, num_splits=1)
        bt = torch.as_tensor(bt, device=dev)
        kv_len = torch.as_tensor(kv_len, device=dev)
        q_off = torch.full((1,), abs0, dtype=torch.int32, device=dev)
        x = embed_tokens(params, torch.as_tensor(tok, device=dev), cfg=cfg)
        for l, p_l in enumerate(params["layers"]):
            lat, q = paged_attn_inputs(p_l, x, positions, cfg=cfg)
            cache.write_layer(l, plan, lat[0, :valid])
            attn = _paged_attend(
                q, cache, l, bt, kv_len, cfg=cfg, block_k=block_k,
                schedule=schedule, q_offset=q_off, q_positions=None,
                num_splits=1, compute_dtype=compute_dtype, variant=variant,
            )
            x = paged_layer_post(p_l, x, attn, cfg=cfg)
        if need_logits and s0 + chunk >= s_total:
            logits = paged_logits(params, x[:, valid - 1 : valid], cfg=cfg)
    return logits[:, 0] if need_logits else None


def lm_decode_step_paged(
    params,
    tokens,  # (B, S) int — S new tokens per live request, rid order
    *,
    cfg,
    cache,  # runtime.kv_cache.LayeredPagedKVCache
    rids: list[int],
    scheduler=None,  # kernels.decode_schedule.DecodeScheduler (memoized)
    extra_key=None,
    table_width: int | None = None,
    block_k: int | None = None,
    num_splits: int = 1,
    variant: str = "amla",
    compute_dtype=None,
    head_shards: int = 1,
    prefix_sharing: bool = False,
):
    """One paged full-model decode step; returns logits ``(B, S, vocab)``.

    Appends are atomic (:class:`OutOfPagesError` before any page is
    claimed), then each layer appends its latent row(s) and attends.  The
    schedule is built once per step and shared by every layer (memoized
    across steps when ``scheduler`` is given).  ``S > 1`` attends all rows
    in one call with explicit per-row positions (``q_positions``).
    """
    check_paged_compatible(cfg)
    _check_head_shards(head_shards)
    if prefix_sharing:
        raise NotImplementedError(
            "prefix_sharing (group-batched shared-prefix attention) is not "
            "ported yet; it comes in a later slice of the port"
        )
    if len(rids) == 0:
        raise ValueError("decode step needs at least one live request")
    tokens = np.asarray(tokens, np.int64)
    if tokens.ndim != 2 or tokens.shape[0] != len(rids):
        raise ValueError(f"tokens must be (B={len(rids)}, S); got {tokens.shape}")
    s = int(tokens.shape[1])
    if s < 1:
        raise ValueError("decode step needs at least one token per request")
    dev = cache.device
    tw = table_width or cache.num_pages
    if block_k is None:
        block_k = ops.default_paged_block_k(cache.page_size, tw)

    start = np.asarray([cache.seq_len(r) for r in rids], np.int32)
    positions = start[:, None] + np.arange(s, dtype=np.int32)[None, :]
    need = sum(cache.pages_needed_for_append(r, s) for r in rids)
    if need > cache.num_free_pages:
        raise OutOfPagesError(
            f"decode step needs {need} new pages for {len(rids)} appends "
            f"of {s} row(s); only {cache.num_free_pages} free — evict and "
            f"retry"
        )
    plans = [cache.reserve(r, s) for r in rids]
    # One (page, offset) per appended row: an S-row run may cross a page.
    pids = np.empty((len(rids) * s,), np.int64)
    offs = np.empty((len(rids) * s,), np.int64)
    w = 0
    for plan in plans:
        for pid, off0, m in plan:
            pids[w : w + m] = pid
            offs[w : w + m] = off0 + np.arange(m)
            w += m
    bt, kv_len = cache.block_table(rids, width=tw)
    if scheduler is not None:
        schedule = scheduler.schedule(kv_len, extra_key=extra_key)
    else:
        schedule = _sched.build_schedule(kv_len, block_k=block_k, num_splits=num_splits)

    # Host -> device once per step; every layer reuses these tensors.
    bt = torch.as_tensor(bt, device=dev)
    kv_len = torch.as_tensor(kv_len, device=dev)
    pids = torch.as_tensor(pids, device=dev)
    offs = torch.as_tensor(offs, device=dev)
    pos = torch.as_tensor(positions, device=dev)
    q_positions = pos if s > 1 else None
    x = embed_tokens(params, torch.as_tensor(tokens, device=dev), cfg=cfg)
    for l, p_l in enumerate(params["layers"]):
        lat, q = paged_attn_inputs(p_l, x, pos, cfg=cfg)
        cache.write_layer_tokens(l, pids, offs, lat.reshape(len(rids) * s, -1))
        attn = _paged_attend(
            q, cache, l, bt, kv_len, cfg=cfg, block_k=block_k,
            schedule=schedule, q_offset=None, q_positions=q_positions,
            num_splits=num_splits, compute_dtype=compute_dtype, variant=variant,
        )
        x = paged_layer_post(p_l, x, attn, cfg=cfg)
    return paged_logits(params, x, cfg=cfg)
