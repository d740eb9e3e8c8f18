"""Shared layers, PyTorch counterpart of ``repro/models/layers.py``.

Parameters are plain dicts of tensors with the JAX package's layouts
(``w`` is ``(d_in, d_out)``, embedding tables ``(vocab, d)``), so converted
reference weights drop in unchanged.  Matmuls run in the compute dtype with
fp32 accumulation and one rounding of the result (the reference's
``preferred_element_type=float32`` followed by a cast); norms stay fp32.
Initialisers draw from an explicit ``torch.Generator`` on the target device
in the target dtype, tensor by tensor; they do not reproduce
``jax.random`` (tests carry reference weights across instead).

``tp`` (a :class:`~repro_torch.runtime.sharding.TPPlan`, given only inside
the rank-local serve and train steps under ``tp`` / ``tp_fsdp``) splits a
function over the ``model`` ranks as the reference's partition specs lay
the weights out: each weight holds this rank's output columns (an
embedding table its vocabulary rows), an activation a product contracts
over is all-gathered first, and each output element is computed by one
rank over the whole contraction, then all-gathered: nothing is summed
across ranks in the forward but the embedding lookup's one nonzero term
and the vocabulary-parallel loss's exp-sum and label logit.  Under
autograd every replicated input of a product over this rank's columns
passes ``tp.copy`` or ``tp.products`` (its cotangent summed over
``model``, the ranks' partials in fp32: :func:`dense_many`), and a
gather's adjoint keeps this rank's slice.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint


def truncnorm(gen, shape, std, *, device, dtype):
    """``std * N(0, 1)`` truncated to ``[-2, 2]`` standard deviations,
    drawn in fp32 and stored in ``dtype``."""
    t = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)
    return t.to(dtype)


# -- norms ----------------------------------------------------------------- #
def rmsnorm_init(dim, *, device):
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, *, eps=1e-6):
    """RMSNorm with Gemma-style ``(1 + scale)`` parameterisation."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


# -- linear / embedding ---------------------------------------------------- #
def dense_init(gen, d_in, d_out, *, bias=False, std=None, device, dtype):
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncnorm(gen, (d_in, d_out), std, device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense(params, x, *, dtype=torch.bfloat16):
    return _biased(params, torch.matmul(x.to(dtype), params["w"].to(dtype)), dtype)


def _biased(params, y, dtype):
    if "b" in params:
        # fp32 bias on the product, as the reference adds it; at bf16 the
        # product is rounded once more before the add than there.
        y = (y.to(torch.float32) + params["b"]).to(dtype)
    return y


def dense_many(ps, x, *, dtype=torch.bfloat16, tp=None):
    """``[dense(p, x) for p in ps]``; under ``tp`` each ``p`` gives this
    rank's output columns of a product whose input ``x`` is replicated
    over ``model``: the ranks' partial input cotangents are summed in fp32
    and rounded once (``tp.products``)."""
    if tp is None:
        return [dense(p, x, dtype=dtype) for p in ps]
    ys = tp.products(x.to(dtype), [p["w"].to(dtype) for p in ps])
    return [_biased(p, y, dtype) for p, y in zip(ps, ys)]


def embed_init(gen, vocab, dim, *, device, dtype):
    return {"table": truncnorm(gen, (vocab, dim), 1.0, device=device, dtype=dtype)}


def dense_across(params, x, *, dtype=torch.bfloat16, tp=None):
    """:func:`dense` of ``x``; under ``tp`` ``x`` holds this rank's part
    of its last dim (heads, d_ff columns): it is all-gathered, ``params``
    give this rank's output columns, and those are all-gathered."""
    if tp is None:
        return dense(params, x, dtype=dtype)
    return tp.gather(dense_many([params], tp.gather(x, -1), dtype=dtype, tp=tp)[0], -1)


def embed(params, tokens, *, dtype=torch.bfloat16, tp=None):
    """Rows of the table at ``tokens``; under ``tp`` the table holds this
    rank's vocabulary rows: a token outside them looks up zeros and the
    lookups are summed over ``model`` (exact: one term is nonzero)."""
    if tp is None:
        return params["table"][tokens].to(dtype)
    table = params["table"]
    local = tokens - tp.idx * table.shape[0]
    own = (local >= 0) & (local < table.shape[0])
    rows = torch.where(own[..., None], table[torch.where(own, local, 0)], 0)
    return tp.sum(rows).to(dtype)


def unembed_key(params, dtype) -> str:
    """The leaf of an embedding table's dict that the unembedding at
    ``dtype`` reads: ``"table_f32"``, the fp32 copy of a table at
    ``dtype``, where it has one, else ``"table"``."""
    return "table_f32" if "table_f32" in params and params["table"].dtype == dtype else "table"


def _unembed_table(params, dtype):
    """The fp32 table the unembedding multiplies by: the fp32 copy of a
    table at ``dtype`` where it has one, else the table cast for the call."""
    if unembed_key(params, dtype) == "table_f32":
        return params["table_f32"]
    return params["table"].to(dtype).to(torch.float32)


def keep_fp32_table(params) -> dict:
    """Give an embedding table below fp32 the fp32 copy :func:`unembed`
    multiplies by (``params["table_f32"]``, twice the table's bytes at
    bf16), so the table is not cast on every call.  Made where the
    parameters are built or loaded (``transformer.lm_init``,
    ``convert_params``); a table replaced after that needs it made again."""
    if params["table"].dtype != torch.float32:
        params["table_f32"] = params["table"].float()
    return params


def unembed(params, x, *, dtype=torch.bfloat16, softcap=None, tp=None):
    """Project to fp32 vocab logits (optionally soft-capped).  The product
    takes ``x`` and the table at ``dtype`` and runs in fp32 (the
    reference's bf16 dot with fp32 accumulation and output); fp32 logits
    keep greedy ties as rare as the reference's.  A table at ``dtype``
    multiplies through its fp32 copy where it has one
    (:func:`keep_fp32_table`); any other is cast for the call.  Under
    ``tp`` the table (and its copy) hold this rank's vocabulary rows: its
    logit columns are all-gathered over ``model``."""
    logits = torch.matmul(x.to(dtype).to(torch.float32), _unembed_table(params, dtype).T)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits if tp is None else tp.gather(logits, -1)


# -- MLP (SwiGLU / GeGLU) -------------------------------------------------- #
def mlp_init(gen, d_model, d_ff, *, device, dtype):
    kw = dict(device=device, dtype=dtype)
    return {
        "gate": dense_init(gen, d_model, d_ff, **kw),
        "up": dense_init(gen, d_model, d_ff, **kw),
        "down": dense_init(gen, d_ff, d_model, std=1.0 / math.sqrt(d_ff), **kw),
    }


def mlp(params, x, *, act="silu", dtype=torch.bfloat16, tp=None):
    """Gated MLP; under ``tp`` ``gate`` / ``up`` give this rank's d_ff
    columns and ``down`` its d_model columns (:func:`dense_across`)."""
    g, u = dense_many([params["gate"], params["up"]], x, dtype=dtype, tp=tp)
    if act == "silu":
        g = torch.nn.functional.silu(g.to(torch.float32)).to(dtype)
    elif act == "gelu":
        g = torch.nn.functional.gelu(g.to(torch.float32), approximate="tanh").to(dtype)
    else:
        raise ValueError(act)
    return dense_across(params["down"], g * u, dtype=dtype, tp=tp)


# -- rotary embeddings ------------------------------------------------------ #
def rope(x, positions, *, theta: float = 10000.0):
    """NeoX-style RoPE.  x: (B, S, H, D), positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device)
        / half
    )
    ang = positions.to(torch.float32)[..., None] * freqs  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope(x, positions3, *, sections, theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D), positions3: (3, B, S)
    int (temporal / height / width).  The D/2 rotary frequencies are split
    into ``sections`` (summing to D/2); each section rotates by its own
    position component.  With t = h = w it is :func:`rope`."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to D/2 = {half}")
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device)
        / half
    )
    # per-frequency position source (section membership)
    sel = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions3.to(torch.float32)[sel]  # (half, B, S)
    ang = pos.permute(1, 2, 0) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- losses ---------------------------------------------------------------- #
def _chunk_nll(unembed_params, h, labels, softcap, dtype, tp=None):
    """Summed next-token NLL of one chunk (labels ``-1`` ignored).  Under
    ``tp`` the table holds this rank's vocabulary rows and the whole
    vocabulary's logits are never gathered: the row maximum is taken over
    ``model`` (no gradient: the LSE does not depend on it), then the
    exp-sum and the label's logit (taken on the rank that owns the label,
    0 elsewhere) are summed over ``model`` in one call."""
    h = h.to(dtype).to(torch.float32)
    if tp is not None:  # after the cast: the ranks' fp32 partial cotangents
        h = tp.copy(h)  # are summed before the one rounding to h's dtype
    logits = torch.matmul(h, _unembed_table(unembed_params, dtype).T)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        lab_logit = torch.gather(logits, -1, torch.clamp_min(labels, 0)[..., None])[..., 0]
        return torch.where(labels >= 0, lse - lab_logit, 0.0).sum()
    v = logits.shape[-1]
    m = tp.max(logits.detach().amax(dim=-1))
    local = labels - tp.idx * v
    own = (local >= 0) & (local < v)
    lab = torch.gather(logits, -1, torch.where(own, local, 0)[..., None])[..., 0]
    se, lab_logit = tp.sum(torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                                        torch.where(own, lab, 0.0)]))
    return torch.where(labels >= 0, m + torch.log(se) - lab_logit, 0.0).sum()


def chunked_cross_entropy(unembed_params, hidden, labels, *, n_chunks=8, softcap=None,
                          dtype=torch.bfloat16, tp=None):
    """Mean cross-entropy of ``hidden (B, S, d)`` against ``labels (B, S)``
    (``-1`` = ignore) without the full ``(B*S, vocab)`` logits: the
    sequence is cut into ``n_chunks`` chunks, each computes its logits,
    its LSE and the label logit and drops the logits.  Under autograd each
    chunk is checkpointed (its logits made again in the backward, its
    collectives under ``tp`` called again, in the same order on every
    rank), so only one chunk's logits are alive at a time, as the
    reference's scan keeps them.  ``tp``: vocabulary-parallel
    (:func:`_chunk_nll`)."""
    b, s, _ = hidden.shape
    if s % n_chunks:
        raise ValueError(f"sequence {s} is not a multiple of n_chunks={n_chunks}")
    c = s // n_chunks
    total, count = 0.0, 0
    for i in range(n_chunks):
        h, lab = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            nll = torch.utils.checkpoint.checkpoint(
                _chunk_nll, unembed_params, h, lab, softcap, dtype, tp, use_reentrant=False)
        else:
            nll = _chunk_nll(unembed_params, h, lab, softcap, dtype, tp)
        total, count = total + nll, count + (lab >= 0).sum()
    return total / torch.clamp_min(count, 1)
