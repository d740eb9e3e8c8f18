"""Shared layers, PyTorch counterpart of ``repro/models/layers.py``.

Parameters are plain dicts of tensors with the JAX package's layouts
(``w`` is ``(d_in, d_out)``, embedding tables ``(vocab, d)``), so converted
reference weights drop in unchanged.  Matmuls run in the compute dtype with
fp32 accumulation and one rounding of the result (the reference's
``preferred_element_type=float32`` followed by a cast); norms stay fp32.
Initialisers draw from an explicit ``torch.Generator`` on the target device
in the target dtype, tensor by tensor; they do not reproduce
``jax.random`` (tests carry reference weights across instead).
"""

from __future__ import annotations

import math

import torch


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
    y = torch.matmul(x.to(dtype), params["w"].to(dtype))
    if "b" in params:
        # fp32 bias on the product, as the reference adds it; at bf16 the
        # product is rounded once more before the add than there.
        y = (y.to(torch.float32) + params["b"]).to(dtype)
    return y


def embed_init(gen, vocab, dim, *, device, dtype):
    return {"table": truncnorm(gen, (vocab, dim), 1.0, device=device, dtype=dtype)}


def embed(params, tokens, *, dtype=torch.bfloat16):
    return params["table"][tokens].to(dtype)


def unembed(params, x, *, dtype=torch.bfloat16, softcap=None):
    """Project to fp32 vocab logits (optionally soft-capped).  The product
    runs at ``dtype``; fp32 logits keep greedy ties as rare as the
    reference's fp32-accumulated output."""
    table = params["table"].to(dtype)
    if dtype == torch.float32:
        logits = torch.matmul(x.to(dtype), table.T)
    else:
        logits = torch.matmul(x.to(dtype).to(torch.float32), table.T.to(torch.float32))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# -- MLP (SwiGLU / GeGLU) -------------------------------------------------- #
def mlp_init(gen, d_model, d_ff, *, device, dtype):
    kw = dict(device=device, dtype=dtype)
    return {
        "gate": dense_init(gen, d_model, d_ff, **kw),
        "up": dense_init(gen, d_model, d_ff, **kw),
        "down": dense_init(gen, d_ff, d_model, std=1.0 / math.sqrt(d_ff), **kw),
    }


def mlp(params, x, *, act="silu", dtype=torch.bfloat16):
    g = dense(params["gate"], x, dtype=dtype)
    u = dense(params["up"], x, dtype=dtype)
    if act == "silu":
        g = torch.nn.functional.silu(g.to(torch.float32)).to(dtype)
    elif act == "gelu":
        g = torch.nn.functional.gelu(g.to(torch.float32), approximate="tanh").to(dtype)
    else:
        raise ValueError(act)
    return dense(params["down"], g * u, dtype=dtype)


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
