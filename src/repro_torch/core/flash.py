"""Base FlashAttention (paper Algorithm 1) as a blockwise PyTorch reference
(counterpart of ``repro/core/flash.py``).

Online-softmax FlashAttention with the standard ``O <- O * exp(m_prev -
m_new) + P V`` rescale as an fp32 multiply every KV block.  Products
follow ``matmul_dtype``: both inputs are rounded to it and multiplied with
an fp32 result (the reference's ``preferred_element_type=float32``), and
``P`` is rounded to it before ``P V``.

The reference writes one head group ``(G, D)`` and ``vmap``s it over batch
and KV heads; these functions take any leading batch dims, ``q (..., G,
Dk)``, ``k (..., S, Dk)``, ``v (..., S, Dv)``, with ``q_pos (..., G)`` and
``kv_len (...)`` broadcast against them.  The per-row math is the
reference's, block for block, so autograd through it is the gradient the
reference trains with (:mod:`repro_torch.core.attention`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import numerics


class BlockMaskArgs(NamedTuple):
    """Description of the valid (q, k) region."""

    q_pos: torch.Tensor | None  # (..., G) absolute positions of query rows, or None
    kv_len: torch.Tensor | None  # (...) count of valid keys (padding mask)
    causal: bool
    window: int | None  # sliding-window size (keys in (q_pos - window, q_pos])


def matmul(a: torch.Tensor, b: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """``a @ b`` of inputs rounded to ``matmul_dtype``, fp32 result."""
    return torch.matmul(a.to(matmul_dtype).float(), b.to(matmul_dtype).float())


def block_scores(q, k_blk, *, scale, softcap, k_pos_blk, margs, matmul_dtype=torch.bfloat16):
    """Masked, scaled (and optionally soft-capped) fp32 scores ``(..., G,
    block)`` for one KV block, invalid entries ``-inf`` (safe: the running
    max starts at a finite ``M_INIT``)."""
    s = matmul(q, k_blk.transpose(-1, -2), matmul_dtype) * scale
    if softcap is not None:
        s = numerics.softcap(s, softcap)
    s = torch.clamp(s, -numerics.M_CLAMP, numerics.M_CLAMP)
    k_pos = k_pos_blk[None, :]
    mask = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    if margs.kv_len is not None:
        mask = mask & (k_pos < margs.kv_len[..., None, None])
    if margs.q_pos is not None:
        q_pos = margs.q_pos[..., :, None]
        if margs.causal:
            mask = mask & (k_pos <= q_pos)
        if margs.window is not None:
            mask = mask & (k_pos > q_pos - margs.window)
    return torch.where(mask, s, -torch.inf)


def _pad_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero rows appended along the sequence axis (-2) up to a multiple of
    ``block``."""
    pad = (-x.shape[-2]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x


def _as_tensor(x, device):
    return None if x is None else torch.as_tensor(x, device=device)


def flash_attention_base(
    q: torch.Tensor,  # (..., G, Dk)
    k: torch.Tensor,  # (..., S, Dk)
    v: torch.Tensor,  # (..., S, Dv)
    *,
    scale: float,
    block_size: int = 512,
    q_pos=None,  # (..., G) absolute positions (causal/window)
    kv_len=None,  # (...) valid-key count
    causal: bool = False,
    window: int | None = None,
    softcap: float | None = None,
    matmul_dtype=torch.bfloat16,
    return_residuals: bool = False,
):
    """Algorithm 1 (Base).  Returns fp32 ``(..., G, Dv)``; with
    ``return_residuals=True`` returns ``(acc, m, l)`` where ``acc =
    sum_j exp(s_j - m) v_j`` (un-normalised), for log-sum-exp combining."""
    dev = q.device
    s_keys = k.shape[-2]
    k = _pad_blocks(k, block_size)
    v = _pad_blocks(v, block_size)
    n_blocks = k.shape[-2] // block_size
    kv_len = _as_tensor(kv_len, dev)
    if kv_len is None:
        kv_len = torch.tensor(s_keys, device=dev)  # mask the padding we just added
    margs = BlockMaskArgs(q_pos=_as_tensor(q_pos, dev), kv_len=kv_len, causal=causal,
                          window=window)

    lead, g, d_v = q.shape[:-2], q.shape[-2], v.shape[-1]
    m = torch.full((*lead, g), numerics.M_INIT, dtype=torch.float32, device=dev)
    l = torch.zeros((*lead, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((*lead, g, d_v), dtype=torch.float32, device=dev)
    for i in range(n_blocks):
        lo = i * block_size
        k_blk, v_blk = k[..., lo:lo + block_size, :], v[..., lo:lo + block_size, :]
        p_blk = lo + torch.arange(block_size, dtype=torch.int32, device=dev)
        s = block_scores(q, k_blk, scale=scale, softcap=softcap, k_pos_blk=p_blk,
                         margs=margs, matmul_dtype=matmul_dtype)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))  # [V1]
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        t = matmul(p, v_blk, matmul_dtype)  # [C2]
        acc = acc * alpha[..., None] + t  # [V2]: the rescale AMLA removes
        m = m_new
    if return_residuals:
        return acc, m, l
    safe_l = torch.where(l > 0, l, 1.0)
    return torch.where(l[..., None] > 0, acc / safe_l[..., None], 0.0)
