"""GQA/MQA/MHA attention layer with a dense KV cache (counterpart of
``repro/models/attention_layer.py``), RoPE or M-RoPE (qwen2-vl), QK-norm,
sliding windows, and the encoder-decoder's cross-attention.

The cache is kept in the kernels' layout, ``(B, Hkv, max_len, Dh)`` — the
reference's ``cache_layout="bhsd"`` — so the attention kernels read it
where it lies (``ops.gqa_attention`` takes it as a transposed view, with
no copy), and new rows are written into it in place.  The attention math
runs through :func:`repro_torch.core.attention.multi_head_attention`: the
CUDA kernels for CUDA tensors, their plain versions for CPU tensors.

Under ``mesh_ctx(mesh, "seqkv")`` a decode step (a cache, at most 8 new
tokens, the cache's length divisible by ``mesh.shape["model"]``) takes
the reference's split-KV branch instead:
:func:`repro_torch.core.distributed.gqa_split_kv_decode` over the cache's
sequence sharded on ``model`` (the batch on the data axes when it
divides), K6 per shard and one LSE merge.  In one process the shards are
logical (a :func:`repro_torch.launch.mesh.logical_mesh`).  Inside a step
run rank-locally on a mesh of processes
(:func:`repro_torch.runtime.mesh_ctx.on_ranks`) the cache holds this
rank's slice of the sequence only (rows ``start = coordinate x S_local``
on): a new row is written where this rank holds its position, a decode
step runs K6 once over the slice and all-gathers the partials over
``model``, and a prefill from position 0 attends over the prompt's own
K/V (K7, as in one process) and keeps its slice of the rows.

Under a tensor-parallel plan (``tp``, the rank-local serve step under
``tp`` / ``tp_fsdp``; :class:`~repro_torch.runtime.sharding.TPPlan`) the
layer computes this rank's query heads only: ``wq`` gives their columns,
``wk`` / ``wv`` the kv heads they read (their columns where the kv heads
split over ``model``, else a slice of the whole weight), the cache holds
those kv heads (the step writes every head's new rows into the rank's
shard after the call), attention runs over the local heads and ``o`` is
all-gathered into ``wo``, which gives this rank's d_model columns
(:func:`~repro_torch.models.layers.dense_across`); the cross-attention
splits so too, over its precomputed K/V's heads
(:func:`cross_attention_apply`).  Without a cache (the
train step) the same split runs under autograd: the input's cotangent is
summed over ``model`` (``tp.products``), and the gradient of a whole leaf the
rank reads in part (the q / k / v biases, a whole ``wk`` / ``wv``, the
QK-norm scales) is this rank's term of a sum over ``model``, which the
step adds up (:meth:`~repro_torch.runtime.sharding.TPPlan.partial`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.attention import multi_head_attention
from repro_torch.core.distributed import axis_index, gqa_split_kv_decode
from repro_torch.models import layers
from repro_torch.runtime import mesh_ctx


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


def _rows_at(cache_len, b, s, max_len, device):
    """The index of the ``s`` rows per batch row at ``cache_len`` in a
    ``(B, max_len, ...)`` buffer: a slice for a scalar ``cache_len``, else
    ``(batch, rows)`` index tensors; a start past ``max_len - s`` is
    clamped, as the reference's dynamic-update-slice clamps it."""
    if np.ndim(cache_len) == 0:
        start = min(max(int(cache_len), 0), max_len - s)
        return slice(None), slice(start, start + s)
    start = torch.as_tensor(cache_len, device=device).reshape(b).to(torch.int64)
    start = torch.clamp(start, 0, max_len - s)
    rows = start[:, None] + torch.arange(s, device=device)[None, :]
    return torch.arange(b, device=device)[:, None], rows


def read_rows(buf, cache_len, s: int) -> torch.Tensor:
    """The ``(B, s, ...)`` rows of ``buf`` that :func:`update_rows` writes
    at ``cache_len`` (without ``total``)."""
    return buf[_rows_at(cache_len, buf.shape[0], s, buf.shape[1], buf.device)]


def update_rows(buf, new, cache_len, *, start: int = 0, total: int | None = None) -> None:
    """Write ``new (B, s, ...)`` into ``buf (B, max_len, ...)`` at rows
    ``cache_len ...``, in place; a start past ``max_len - s`` is clamped,
    as the reference's dynamic-update-slice clamps it.

    A scalar ``cache_len`` (one position for the whole batch, as in a
    prefill) is one slice ``copy_``; per-example offsets (ragged decode)
    are one indexed write.

    With ``total``, ``buf`` is the slice of a ``total``-row sequence that
    begins at row ``start`` (one rank's, under ``seqkv``): the positions
    are clamped against ``total``, and only the rows that fall inside the
    slice are written, at ``position - start``.
    """
    b, s = new.shape[:2]
    if total is not None:
        pos = torch.as_tensor(as_batch_vec(cache_len, b), device=buf.device).to(torch.int64)
        rows = (torch.clamp(pos, 0, total - s)[:, None] - start
                + torch.arange(s, device=buf.device)[None, :])
        inside = (rows >= 0) & (rows < buf.shape[1])
        bi = torch.arange(b, device=buf.device)[:, None].expand(b, s)
        buf[bi[inside], rows[inside]] = new[inside].to(buf.dtype)
        return
    at = _rows_at(cache_len, b, s, buf.shape[1], buf.device)
    if isinstance(at[1], slice):
        buf[at].copy_(new)
    else:
        buf[at] = new.to(buf.dtype)


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
    positions: torch.Tensor,  # (B, S) int, or (3, B, S) for M-RoPE
    window: int | None = None,
    cache=None,
    cache_len=None,  # (B,) or scalar, host array or tensor
    causal: bool = True,
    dtype=torch.bfloat16,
    tp=None,
):
    """Returns (y, cache); the cache (when given) is updated in place.
    ``tp``: this rank's heads only (the module docstring)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    wqkv = [params["wq"], params["wk"], params["wv"]] if tp is None else _tp_qkv(params, cfg, tp)
    q, k, v = (y.reshape(b, s, -1, dh) for y in layers.dense_many(wqkv, x, dtype=dtype, tp=tp))
    hq = q.shape[2]

    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, eps=cfg.norm_eps)
    if positions.ndim == 3:  # M-RoPE (qwen2-vl)
        q = layers.mrope(q, positions, sections=cfg.mrope_sections, theta=cfg.rope_theta)
        k = layers.mrope(k, positions, sections=cfg.mrope_sections, theta=cfg.rope_theta)
    else:
        q = layers.rope(q, positions, theta=cfg.rope_theta)
        k = layers.rope(k, positions, theta=cfg.rope_theta)

    mesh = mesh_ctx.current_mesh()
    seqkv = cache is not None and mesh is not None and mesh_ctx.current_policy() == "seqkv"
    # under seqkv on ranks this rank's cache is its slice of the sequence
    slice_only = seqkv and mesh_ctx.on_ranks()
    if cache is not None:
        if cache_len is None:
            raise ValueError("a cache needs its cache_len")
        # (B, max_len, Hkv, Dh) views of the (B, Hkv, max_len, Dh) cache
        k_all, v_all = cache["k"].transpose(1, 2), cache["v"].transpose(1, 2)
        if slice_only:
            s_local = cache["k"].shape[2]
            where = dict(start=axis_index(("model",), mesh)[0] * s_local,
                         total=s_local * mesh.shape["model"])
        else:
            where = {}
        update_rows(k_all, k, cache_len, **where)
        update_rows(v_all, v, cache_len, **where)
        kv_len = as_batch_vec(cache_len, b) + s
        q_offset = as_batch_vec(cache_len, b)
        if slice_only and s > 8:
            # a prompt (more than 8 rows) starts at position 0: the prefill
            # kernel takes no offset (ops.gqa_attention raises), so the
            # prompt's own K/V are every key it sees
            k_all, v_all = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    else:
        k_all, v_all = k, v
        kv_len = np.full((b,), s, np.int32)
        q_offset = np.zeros((b,), np.int32)

    if seqkv and s <= 8 and (slice_only or cache["k"].shape[2] % mesh.shape["model"] == 0):
        dax = mesh_ctx.data_axes_in_ctx()
        bshard = b % math.prod(mesh.shape[a] for a in dax) == 0
        # bf16 rows into K6, as ops.gqa_attention gives them; the cache
        # (B, Hkv, max_len, Dh) is passed where it lies
        attn = gqa_split_kv_decode(
            q.to(torch.bfloat16), cache["k"].to(torch.bfloat16),
            cache["v"].to(torch.bfloat16), mesh=mesh, seq_axis="model",
            batch_axes=dax if bshard else (), variant=cfg.attn_variant,
            scale=cfg.attn_scale or 1.0 / math.sqrt(dh), kv_len=kv_len,
            q_offset=q_offset, window=window, softcap=cfg.attn_softcap, kv_layout="bhsd",
            ranks=slice_only,
        ).to(q.dtype)
        y = layers.dense(params["wo"], attn.reshape(b, s, hq * dh), dtype=dtype)
        return y, cache

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
    y = layers.dense_across(params["wo"], attn.reshape(b, s, hq * dh), dtype=dtype, tp=tp)
    return y, cache


def _tp_qkv(params, cfg, tp):
    """The q, k and v projections of this rank's heads: ``wq`` (and
    ``wk`` / ``wv`` where the kv heads split over ``model``) hold their
    columns already; a replicated ``wk`` / ``wv`` is sliced to the kv
    heads the rank's query heads read.  A 1-D bias (replicated by the
    specs) is sliced to the same columns."""
    dh = cfg.head_dim
    h0, h1 = tp.part(cfg.n_heads)
    k0, k1 = tp.kv_heads

    def cols(p, lo, hi, local):
        out = {"w": p["w"] if local else p["w"][:, lo * dh:hi * dh]}
        if "b" in p:
            out["b"] = p["b"][lo * dh:hi * dh]
        return out

    return (cols(params["wq"], h0, h1, True), cols(params["wk"], k0, k1, tp.kv_local),
            cols(params["wv"], k0, k1, tp.kv_local))


def cross_attention_init(gen, cfg, *, device, dtype):
    d, hq, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": layers.dense_init(gen, d, hq * dh, **kw),
        "wk": layers.dense_init(gen, d, hq * dh, **kw),
        "wv": layers.dense_init(gen, d, hq * dh, **kw),
        "wo": layers.dense_init(gen, hq * dh, d, std=1.0 / math.sqrt(hq * dh), **kw),
    }


def cross_kv(params, memory, *, cfg, dtype=torch.bfloat16, tp=None):
    """``{"k", "v"}`` of shape ``(B, Ss, H, Dh)``: the cross-attention's
    keys and values of the encoder output ``memory (B, Ss, d)``.  Under
    ``tp`` ``wk`` / ``wv`` hold this rank's heads' columns and ``memory``
    is replicated (its cotangent summed over ``model``): this rank's
    ``H / m`` heads."""
    b, ss, _ = memory.shape
    k, v = layers.dense_many([params["wk"], params["wv"]], memory, dtype=dtype, tp=tp)
    return {"k": k.reshape(b, ss, -1, cfg.head_dim), "v": v.reshape(b, ss, -1, cfg.head_dim)}


def cross_attention_apply(
    params,
    x: torch.Tensor,  # (B, St, d) decoder states
    memory_kv=None,  # precomputed {"k", "v"}: (B, Ss, H, Dh), the decode path
    memory: torch.Tensor | None = None,  # (B, Ss, d) encoder output
    *,
    cfg,
    memory_len=None,  # (B,) valid frames; None: all of them
    dtype=torch.bfloat16,
    tp=None,
):
    """Encoder-decoder cross-attention over a static memory: every query
    sees every frame below ``memory_len`` (``causal=False``), through K6
    for St <= 8 rows and K7 above.  Returns (y, memory_kv).

    Under ``tp`` (MHA: a rank's query heads read their own kv heads)
    this rank computes its ``H / m`` heads: ``q`` from its ``wq``
    columns, ``k`` / ``v`` from its ``wk`` / ``wv`` columns (a
    precomputed ``memory_kv`` is already its heads), each replicated
    input (``x``, ``memory``) behind ``tp.products``; ``o`` is gathered
    into ``wo``, which gives this rank's d_model columns
    (:func:`~repro_torch.models.layers.dense_across`), as in
    :func:`gqa_apply`."""
    b, st, _ = x.shape
    dh = cfg.head_dim
    q = layers.dense_many([params["wq"]], x, dtype=dtype, tp=tp)[0].reshape(b, st, -1, dh)
    hq = q.shape[2]
    if memory_kv is None:
        if memory is None:
            raise ValueError("cross-attention needs memory_kv or memory")
        memory_kv = cross_kv(params, memory, cfg=cfg, dtype=dtype, tp=tp)
    attn = multi_head_attention(
        q,
        memory_kv["k"],
        memory_kv["v"],
        variant=cfg.attn_variant,
        causal=False,
        scale=1.0 / math.sqrt(dh),
        kv_len=memory_len,
    )
    y = layers.dense_across(params["wo"], attn.reshape(b, st, hq * dh), dtype=dtype, tp=tp)
    return y, memory_kv
