"""Decoder-only LM (counterpart of ``repro/models/transformer.py``): the
dense-cache path (``lm_apply`` over per-layer caches, as the reference's
``ServingSession`` drives it) and the paged MLA backend.

Parameters are a dict: ``embed``/``unembed`` tables, ``final_norm``, and
``layers``, a list of per-layer dicts (``ln1``; ``attn``, ``rec`` or
``ssm``; ``ln2`` and ``mlp``, dense or MoE; gemma2's ``post_ln1``/
``post_ln2``) — the reference's scanned
``groups`` unstacked, as ``per_layer_params`` does there (see
:mod:`repro_torch.convert`).  A Python loop over that list takes the place
of the reference's ``scan`` over layer groups.  Dense caches are a list
with one dict per layer, updated in place.

Layer kinds: "global" and "local" (GQA or MLA attention, "local" with the
config's sliding window), "recurrent" (RG-LRU, :mod:`.recurrent`) and
"ssm" (Mamba-2, :mod:`.ssm`, no separate MLP); the MLP is dense or MoE
(:mod:`.moe`) per config.  Recurrent and SSM layers keep a per-slot state
cache (``h`` and ``conv``) in place of K/V.  The vision-language family
(qwen2-vl) is this decoder with M-RoPE positions ``(3, B, S)`` and patch
embeddings in place of the first token embeddings (``lm_apply``'s
``positions`` and ``embeds_override``); the encoder-decoder family has a
model of its own (:mod:`.encdec`).

The paged path walks the layer stack host-side so each layer can (1)
append its latent row(s) into the shared page pool and (2) attend through
``ops.mla_decode_paged`` with ONE decode schedule built per step (or per
prefill chunk) and reused by every layer — all L layers share the block
table and kv_len, so the (request, kv_block) work queue is identical.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core import tree as _tree
from repro_torch.kernels import decode_schedule as _sched
from repro_torch.kernels import ops
from repro_torch.models import layers, moe
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
from repro_torch.models.recurrent import (
    init_rglru_cache,
    rglru_block_apply,
    rglru_block_init,
)
from repro_torch.models.ssm import init_ssm_cache, mamba2_block_apply, mamba2_block_init
from repro_torch.runtime import mesh_ctx
from repro_torch.runtime.kv_cache import OutOfPagesError

LAYER_KINDS = ("global", "local", "recurrent", "ssm")


def _has_mlp(cfg, kind):
    return kind != "ssm" and (cfg.d_ff > 0 or cfg.n_experts > 0)


def cfg_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg) -> None:
    """The layer kinds and families this decoder-only LM builds:
    "global"/"local" attention (GQA or MLA), "recurrent" and "ssm" layers,
    with a dense or MoE MLP; the ``encdec`` family is
    :class:`~repro_torch.models.model_zoo.EncDecModel`'s."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= set(LAYER_KINDS):
        raise ValueError(f"config {cfg.name!r} has unknown layer kinds {sorted(kinds)}")
    if cfg.family == "encdec":
        raise ValueError(
            f"config {cfg.name!r} is an encoder-decoder: build it with "
            "model_zoo.build_model (EncDecModel), not as a decoder-only LM")


def layer_init(gen, cfg, kind, *, device, dtype):
    """One layer of ``kind``: its mixer (attention, RG-LRU or Mamba-2) and,
    but for "ssm", a dense or MoE MLP."""
    kw = dict(device=device, dtype=dtype)
    p = {"ln1": layers.rmsnorm_init(cfg.d_model, device=device)}
    if kind in ("global", "local"):
        p["attn"] = mla_init(gen, cfg, **kw) if cfg.mla else gqa_init(gen, cfg, **kw)
    elif kind == "recurrent":
        p["rec"] = rglru_block_init(gen, cfg, **kw)
    elif kind == "ssm":
        p["ssm"] = mamba2_block_init(gen, cfg, **kw)
    else:
        raise ValueError(kind)
    if _has_mlp(cfg, kind):
        p["ln2"] = layers.rmsnorm_init(cfg.d_model, device=device)
        p["mlp"] = (moe.moe_init(gen, cfg, **kw) if cfg.n_experts
                    else layers.mlp_init(gen, cfg.d_model, cfg.d_ff, **kw))
    if cfg.post_norms:
        p["post_ln1"] = layers.rmsnorm_init(cfg.d_model, device=device)
        if _has_mlp(cfg, kind):
            p["post_ln2"] = layers.rmsnorm_init(cfg.d_model, device=device)
    return p


def lm_init(gen, cfg, *, device, dtype, keep=None):
    """Random parameters, drawn tensor by tensor on ``device`` in ``dtype``
    (a full-width bf16 model is built on the card without an fp32 copy of
    its weights; the unembedding table gets one,
    :func:`~repro_torch.models.layers.keep_fp32_table`).  ``keep(path,
    tensor)``, where given, is applied to each leaf as soon as its table
    or layer is drawn, and what it returns is kept (one rank keeps its
    shards: the whole model is never resident); the draws are the same."""
    check_supported(cfg)
    kw = dict(device=device, dtype=dtype)

    def kept(prefix, tree):
        if keep is None:
            return tree
        return _tree.map_with_paths(lambda path, t: keep(prefix + path, t), tree)

    params = {
        "embed": kept(("embed",), layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw)),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = kept(("unembed",),
                                 layers.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw))
    params["layers"] = [kept(("layers", l), layer_init(gen, cfg, kind, **kw))
                        for l, kind in enumerate(cfg.layer_kinds())]
    layers.keep_fp32_table(params.get("unembed", params["embed"]))
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


def embed_tokens(params, tokens, *, cfg, embeds_override=None):
    """Token embeddings at the config's dtype; ``embeds_override (B, Nv,
    d)`` (the vision stub's patch embeddings) replaces the first ``Nv``
    positions before gemma-style scaling, in the reference's order."""
    table = mesh_ctx.working(params["embed"]["table"], ("embed", "table"))
    x = layers.embed({"table": table}, tokens, dtype=cfg_dtype(cfg),
                     tp=mesh_ctx.tp_split("embed"))
    if embeds_override is not None:
        nv = embeds_override.shape[1]
        x = torch.cat([embeds_override.to(x.dtype), x[:, nv:]], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


# --------------------------------------------------------------------------- #
# Dense-cache path
# --------------------------------------------------------------------------- #
def layer_cache_init(cfg, kind, batch, max_len, *, dtype, device):
    """The dense cache of one layer: a latent cache for MLA, K/V for GQA
    (local layers keep a linear ``max_len`` cache, as the reference does),
    the fp32 state of a recurrent or SSM layer (``dtype`` and ``max_len``
    do not apply to it, as in the reference)."""
    if kind == "recurrent":
        return init_rglru_cache(cfg, batch, device=device)
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, device=device)
    if kind not in ("global", "local"):
        raise ValueError(kind)
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
    """Pre-norm residual block.  Returns (x, cache, aux): the cache is
    updated in place, ``aux`` is a MoE MLP's load-balancing loss (0.0 for
    any other layer: no tensor, so a serving step launches nothing for
    it)."""
    h = layers.rmsnorm(params["ln1"], x, eps=cfg.norm_eps)
    if kind == "recurrent":
        y, cache = rglru_block_apply(params["rec"], h, cfg=cfg, cache=cache, dtype=dtype,
                                     tp=mesh_ctx.tp_split("rec"))
    elif kind == "ssm":
        y, cache = mamba2_block_apply(params["ssm"], h, cfg=cfg, cache=cache, dtype=dtype,
                                      tp=mesh_ctx.tp_split("ssm"))
    elif kind not in ("global", "local"):
        raise ValueError(kind)
    elif cfg.mla:
        y, cache = mla_apply(params["attn"], h, cfg=cfg, positions=positions,
                             cache=cache, cache_len=cache_len, dtype=dtype,
                             tp=mesh_ctx.tp_split("attn"))
    else:
        window = cfg.window if kind == "local" else None
        y, cache = gqa_apply(params["attn"], h, cfg=cfg, positions=positions,
                             window=window, cache=cache, cache_len=cache_len,
                             dtype=dtype, tp=mesh_ctx.tp_split("attn"))
    if cfg.post_norms:
        y = layers.rmsnorm(params["post_ln1"], y, eps=cfg.norm_eps)
    x = x + y
    aux = 0.0
    if _has_mlp(cfg, kind):
        y, aux = mlp_post(params, x, cfg=cfg, dtype=dtype)
        x = x + y
    return x, cache, aux


def _layer_at_use(p_l, x, *, prefix, **kw):
    """:func:`layer_apply` on the layer's working leaves, gathered here
    (inside a checkpoint: again in its recompute, so the checkpoint keeps
    only the rank's shards and ``x``) and dropped after it
    (``mesh_ctx.working``)."""
    return layer_apply(mesh_ctx.working(p_l, prefix), x, **kw)


def mlp_post(params, x, *, cfg, dtype):
    """The MLP half of a layer (dense or MoE, sandwich-normed where the
    config says so), without its residual add: (y, aux), ``aux`` the MoE
    load-balancing loss (0.0 for a dense MLP)."""
    h = layers.rmsnorm(params["ln2"], x, eps=cfg.norm_eps)
    if cfg.n_experts:  # the plan's split of the experts: by expert or within each by d_ff
        y, aux = moe.moe_apply(params["mlp"], h, cfg=cfg, dtype=dtype,
                               tp=mesh_ctx.tp_split("moe"))
    else:
        y, aux = layers.mlp(params["mlp"], h, act=cfg.act, dtype=dtype,
                            tp=mesh_ctx.tp_split("mlp")), 0.0
    if cfg.post_norms:
        y = layers.rmsnorm(params["post_ln2"], y, eps=cfg.norm_eps)
    return y, aux


def default_positions(b, s, cache_len, device):
    """``(B, S)`` positions ``cache_len + arange(S)`` (``cache_len``
    scalar or (B,), host value or tensor; 0 when None)."""
    base = torch.as_tensor(cache_len if cache_len is not None else 0, device=device)
    steps = torch.arange(s, device=device)[None, :]
    return (base.reshape(-1, 1).to(torch.int64) + steps).expand(b, s)


def lm_apply(params, tokens, *, cfg, positions=None, cache=None, cache_len=None,
             embeds_override=None, remat=False, dtype=None):
    """Returns (hidden (B, S, d) after the final norm, cache, aux), ``aux``
    the MoE load-balancing loss summed over the layers (a fp32 tensor; 0.0
    without MoE layers; serving callers drop it).  Unembedding is the caller's job (:func:`lm_logits`, or the
    chunked cross-entropy in training).  ``cache_len`` (scalar or (B,),
    host array or tensor) is where the new tokens go; ``positions`` is
    ``(B, S)`` (default ``cache_len + arange(S)``) or M-RoPE's ``(3, B,
    S)``; ``embeds_override (B, Nv, d)`` replaces the first ``Nv`` token
    embeddings (qwen2-vl's patch embeddings).  ``remat=True`` (no cache)
    keeps only each layer's input for the backward and runs the layer
    again there (``torch.utils.checkpoint``; the reference wraps each
    layer group in ``jax.checkpoint``).  Inside a rank-local step each
    layer's leaves are gathered just before it runs, inside the
    checkpoint (:func:`_layer_at_use`)."""
    b, s = tokens.shape
    dtype = dtype or cfg_dtype(cfg)
    x = embed_tokens(params, tokens, cfg=cfg, embeds_override=embeds_override).to(dtype)
    if positions is None:
        positions = default_positions(b, s, cache_len, x.device)
    aux_total = 0.0
    for l, (p_l, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        kw = dict(cfg=cfg, kind=kind, positions=positions, cache_len=cache_len, dtype=dtype,
                  prefix=("layers", l))
        if remat and cache is None:
            x, _, aux = torch.utils.checkpoint.checkpoint(
                functools.partial(_layer_at_use, **kw), p_l, x, use_reentrant=False)
        else:
            x, _, aux = _layer_at_use(p_l, x, cache=cache[l] if cache is not None else None,
                                      **kw)
        aux_total = aux_total + aux
    x = layers.rmsnorm(mesh_ctx.working(params["final_norm"], ("final_norm",)), x,
                       eps=cfg.norm_eps)
    return x, cache, aux_total


def working_table(params, name, dtype):
    """``params[name]`` (an embedding table's dict) with the leaf the
    unembedding at ``dtype`` multiplies by (its fp32 copy, or the table:
    :func:`~repro_torch.models.layers.unembed_key`) gathered at its use
    (``mesh_ctx.working``); the other leaves as they are."""
    work = dict(params[name])
    key = layers.unembed_key(work, dtype)
    work[key] = mesh_ctx.working(work[key], (name, key))
    return work


def lm_logits(params, hidden, *, cfg, dtype=None):
    """fp32 vocab logits of ``hidden`` (final-softcapped where the config
    says so)."""
    dtype = dtype or cfg_dtype(cfg)
    table = working_table(params, "unembed" if "unembed" in params else "embed", dtype)
    return layers.unembed(table, hidden, dtype=dtype, softcap=cfg.final_softcap,
                          tp=mesh_ctx.tp_split("logits"))


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
    """Post-attention half: un-absorb, residual, MLP (dense or MoE)."""
    dtype = cfg_dtype(cfg)
    y = mla_unabsorb_output(p_l["attn"], attn.to(dtype), cfg=cfg, dtype=dtype)
    if cfg.post_norms:
        y = layers.rmsnorm(p_l["post_ln1"], y, eps=cfg.norm_eps)
    x = x + y
    if _has_mlp(cfg, "global"):
        x = x + mlp_post(p_l, x, cfg=cfg, dtype=dtype)[0]
    return x


def paged_logits(params, x, *, cfg):
    """Final norm + fp32 unembedding of ``x (B, S, d)``."""
    x = layers.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return lm_logits(params, x, cfg=cfg)


def _paged_attend(q, cache, layer, bt, kv_len, *, cfg, block_k, schedule,
                  q_offset, q_positions, num_splits, compute_dtype, variant,
                  head_shards: int = 1):
    def attend(q_part):
        return ops.mla_decode_paged(
            q_part,
            cache.layer_pages(layer),
            bt,
            kv_len,
            # int8 pools carry per-row dequant scales (None otherwise).
            kv_scales=cache.layer_scales(layer),
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

    if head_shards <= 1:
        return attend(q)
    # Tensor-parallel head groups (the reference's mesh ``model`` axis):
    # query heads are independent rows of the queue kernel (each its own
    # softmax over the same pages), so every chunk of heads reuses the one
    # per-(request, block) schedule and the concatenation is the unchunked
    # call's result.  One card runs the chunks one after another: one K2
    # and one K3 launch per chunk.
    hq = q.shape[2]
    if hq % head_shards:
        raise ValueError(f"head_shards={head_shards} must divide n_heads={hq}")
    step = hq // head_shards
    return torch.cat(
        [attend(q[:, :, i * step : (i + 1) * step]) for i in range(head_shards)], dim=2)


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
    request's pages with per-row causal positions.  ``start_pos > 0``
    continues a sequence (a forked request's suffix) over the pages it
    aliases, which it never recomputes.
    """
    check_paged_compatible(cfg)
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
                head_shards=head_shards,
            )
            x = paged_layer_post(p_l, x, attn, cfg=cfg)
        if need_logits and s0 + chunk >= s_total:
            logits = paged_logits(params, x[:, valid - 1 : valid], cfg=cfg)
    return logits[:, 0] if need_logits else None


@dataclasses.dataclass
class PagedStepPlan:
    """Host staging of one paged decode step (numpy): the tokens, every
    row's position, the ``(page, offset)`` each appended row lands in, the
    block table, ``kv_len`` after the appends, and the step's schedule."""

    tokens: np.ndarray  # (B, S) int64
    positions: np.ndarray  # (B, S) int32
    pids: np.ndarray  # (B * S,) int64
    offs: np.ndarray  # (B * S,) int64
    block_tables: np.ndarray  # (B, W) int32
    kv_len: np.ndarray  # (B,) int32
    schedule: object  # DecodeSchedule or PrefixSchedule
    block_k: int


@dataclasses.dataclass
class PagedStepInputs:
    """What the device walk of a paged decode step reads: a
    :class:`PagedStepPlan`'s arrays as tensors on the cache's device."""

    tokens: torch.Tensor
    positions: torch.Tensor
    pids: torch.Tensor
    offs: torch.Tensor
    block_tables: torch.Tensor
    kv_len: torch.Tensor

    @classmethod
    def like(cls, plan: PagedStepPlan, device) -> "PagedStepInputs":
        """Uninitialised tensors of ``plan``'s shapes and dtypes."""
        return cls(**{f.name: torch.empty(getattr(plan, f.name).shape,
                                          dtype=torch.from_numpy(getattr(plan, f.name)).dtype,
                                          device=device)
                      for f in dataclasses.fields(cls)})

    def fill(self, plan: PagedStepPlan) -> "PagedStepInputs":
        """Copy ``plan``'s arrays in, in place (the tensors keep their
        addresses)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(torch.from_numpy(getattr(plan, f.name)))
        return self


def stage_decode_step_paged(
    tokens,
    *,
    cfg,
    cache,
    rids: list[int],
    scheduler=None,
    extra_key=None,
    table_width: int | None = None,
    block_k: int | None = None,
    num_splits: int = 1,
    prefix_sharing: bool = False,
) -> PagedStepPlan:
    """The host half of :func:`lm_decode_step_paged`: the checks, the
    atomic page reservation (:class:`OutOfPagesError` before any page is
    claimed; a shared boundary page is copied here), each appended row's
    ``(page, offset)``, the block table, ``kv_len``, the positions and the
    step's schedule, all on the host."""
    check_paged_compatible(cfg)
    if len(rids) == 0:
        raise ValueError("decode step needs at least one live request")
    tokens = np.asarray(tokens, np.int64)
    if tokens.ndim != 2 or tokens.shape[0] != len(rids):
        raise ValueError(f"tokens must be (B={len(rids)}, S); got {tokens.shape}")
    s = int(tokens.shape[1])
    if s < 1:
        raise ValueError("decode step needs at least one token per request")
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
        if prefix_sharing:
            schedule = scheduler.schedule_prefix(
                kv_len, bt, page_size=cache.page_size, extra_key=extra_key
            )
        else:
            schedule = scheduler.schedule(kv_len, extra_key=extra_key)
    elif prefix_sharing:
        schedule = _sched.build_prefix_schedule(
            kv_len, bt, page_size=cache.page_size, block_k=block_k,
            num_splits=num_splits,
        )
    else:
        schedule = _sched.build_schedule(kv_len, block_k=block_k, num_splits=num_splits)
    return PagedStepPlan(tokens, positions, pids, offs, bt, kv_len, schedule, block_k)


def decode_walk_paged(
    params,
    inputs: PagedStepInputs,
    *,
    cfg,
    cache,
    schedule,
    block_k: int,
    num_splits: int = 1,
    q_positions=None,
    variant: str = "amla",
    compute_dtype=None,
    head_shards: int = 1,
):
    """The device half of :func:`lm_decode_step_paged`: embed, every layer
    (append its latent rows at ``inputs.pids``/``offs``, attend through
    ``ops.mla_decode_paged`` with the one ``schedule``, per chunk of
    ``n_heads / head_shards`` heads, post-attention half) and the logits
    ``(B, S, vocab)``.  With ``schedule`` an
    ``ops.DeviceQueue`` and no host ``q_positions`` it reads only tensors
    already on the device, so a CUDA graph can capture it."""
    b, s = inputs.tokens.shape
    x = embed_tokens(params, inputs.tokens, cfg=cfg)
    for l, p_l in enumerate(params["layers"]):
        lat, q = paged_attn_inputs(p_l, x, inputs.positions, cfg=cfg)
        cache.write_layer_tokens(l, inputs.pids, inputs.offs, lat.reshape(b * s, -1))
        attn = _paged_attend(
            q, cache, l, inputs.block_tables, inputs.kv_len, cfg=cfg, block_k=block_k,
            schedule=schedule, q_offset=None, q_positions=q_positions,
            num_splits=num_splits, compute_dtype=compute_dtype, variant=variant,
            head_shards=head_shards,
        )
        x = paged_layer_post(p_l, x, attn, cfg=cfg)
    return paged_logits(params, x, cfg=cfg)


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

    Host staging (:func:`stage_decode_step_paged`: atomic appends, the
    block table, positions and one schedule), then the device walk
    (:func:`decode_walk_paged`) over its arrays.  The schedule is built
    once per step and shared by every layer (memoized across steps when
    ``scheduler`` is given); with ``prefix_sharing`` it is a
    ``PrefixSchedule``, so requests that alias the same leading pages
    attend their shared blocks once per group in every layer.  ``S > 1``
    attends all rows in one call with explicit per-row positions: the
    host array, as the reference passes it, so their values are checked
    (``q_positions``).  The serving sessions stage into fixed buffers and
    replay the walk as a CUDA graph (:mod:`repro_torch.runtime.step_graph`).
    ``head_shards > 1`` attends each chunk of heads with its own K2 and
    K3 launch over the same schedule (:func:`_paged_attend`).
    """
    plan = stage_decode_step_paged(
        tokens, cfg=cfg, cache=cache, rids=rids, scheduler=scheduler, extra_key=extra_key,
        table_width=table_width, block_k=block_k, num_splits=num_splits,
        prefix_sharing=prefix_sharing,
    )
    inputs = PagedStepInputs.like(plan, cache.device).fill(plan)
    return decode_walk_paged(
        params, inputs, cfg=cfg, cache=cache, schedule=plan.schedule, block_k=plan.block_k,
        num_splits=num_splits, q_positions=plan.positions if plan.tokens.shape[1] > 1 else None,
        variant=variant, compute_dtype=compute_dtype, head_shards=head_shards,
    )
