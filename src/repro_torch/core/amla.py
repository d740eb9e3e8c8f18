"""AMLA (paper Algorithm 2): FlashAttention with MUL-by-ADD rescaling, as a
blockwise PyTorch reference (counterpart of ``repro/core/amla.py``).

The rescale factor ``exp(m_prev - m_new)`` is rounded to a power of two
``2**(n_new - n_prev)`` (``n = round(-m/ln2)``) and applied to the fp32
accumulator as an int32 addition on its exponent field (Lemma 3.1); the
residual ``1/r`` is folded into ``P`` during the softmax stage.  Appendix
A's error compensation multiplies the accumulator by ``gamma_prev /
gamma`` (``gamma = S32/S16``), folded into the same integer increment.

The compensation term is the reference's erratum-corrected one, ``eps =
gamma_{i-1}/gamma_i - 1`` (Algorithm 2 line 10 states the reciprocal
ratio; with it the compensation doubles the quantisation error).

Written over leading batch dims as :mod:`repro_torch.core.flash` is.  The
int32 add goes through a bit view, which carries no gradient (as the
reference's bitcast carries none): autograd through this function sees the
accumulator's path to every KV block but the last cut, exactly as the
reference's training gradient does.
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics
from repro_torch.core.flash import BlockMaskArgs, _as_tensor, _pad_blocks, block_scores, matmul


def flash_attention_amla(
    q: torch.Tensor,  # (..., G, Dk)
    k: torch.Tensor,  # (..., S, Dk)
    v: torch.Tensor,  # (..., S, Dv)
    *,
    scale: float,
    block_size: int = 512,
    q_pos=None,
    kv_len=None,
    causal: bool = False,
    window: int | None = None,
    softcap: float | None = None,
    matmul_dtype=torch.bfloat16,
    error_compensation: bool = True,  # Appendix A (ablation switch)
    int_add: bool = True,  # False => same math via exact fp32 multiplies
    return_residuals: bool = False,
):
    """Algorithm 2 (AMLA).  Returns fp32 ``(..., G, Dv)``; with
    ``return_residuals=True`` returns ``(acc, m, l)`` in standard units
    (the S16 scaling divided out), combinable with Base's residuals."""
    dev = q.device
    s_keys = k.shape[-2]
    k = _pad_blocks(k, block_size)
    v = _pad_blocks(v, block_size)
    n_blocks = k.shape[-2] // block_size
    kv_len = _as_tensor(kv_len, dev)
    if kv_len is None:
        kv_len = torch.tensor(s_keys, device=dev)
    margs = BlockMaskArgs(q_pos=_as_tensor(q_pos, dev), kv_len=kv_len, causal=causal,
                          window=window)

    lead, g, d_v = q.shape[:-2], q.shape[-2], v.shape[-1]
    m = torch.full((*lead, g), numerics.M_INIT, dtype=torch.float32, device=dev)
    n, inv_r0 = numerics.round_scale_to_pow2(m)
    l = torch.zeros((*lead, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((*lead, g, d_v), dtype=torch.float32, device=dev)  # the paper's O-tilde
    gamma = torch.ones((*lead, g), dtype=torch.float32, device=dev)  # S32/S16, previous block
    s16 = numerics.bf16_round(inv_r0)  # S16 of the previous block (final divide)
    for i in range(n_blocks):
        lo = i * block_size
        k_blk, v_blk = k[..., lo:lo + block_size, :], v[..., lo:lo + block_size, :]
        p_blk = lo + torch.arange(block_size, dtype=torch.int32, device=dev)
        s = block_scores(q, k_blk, scale=scale, softcap=softcap, k_pos_blk=p_blk,
                         margs=margs, matmul_dtype=matmul_dtype)  # [C1] + start of [V1]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        l = l * torch.exp(m - m_new) + p.sum(-1)

        # [V1] continued: power-of-two split of the scale (Alg. 2 lines 6-10).
        n_new, inv_r32 = numerics.round_scale_to_pow2(m_new)  # S32 = 1/r
        s16 = numerics.bf16_round(inv_r32)  # S16
        gamma_new = inv_r32 / s16  # line 9's c = S32/S16
        p_scaled = p * s16[..., None]
        eps = gamma / gamma_new - 1.0 if error_compensation else None  # the erratum

        delta_n = n_new - n
        if int_add:
            # the paper's AtomicAdd<INT32>: an exponent-field integer add
            inc = numerics.pow2_int_increment(delta_n, eps)
            acc_scaled = numerics.apply_int_increment(acc, inc[..., None])
        else:
            # ablation: the same update with exact fp32 multiplies
            factor = torch.exp2(torch.clamp_min(delta_n.float(), float(numerics.MIN_EXP_DELTA)))
            if eps is not None:
                factor = factor * (1.0 + eps)
            acc_scaled = acc * factor[..., None]

        acc = acc_scaled + matmul(p_scaled, v_blk, matmul_dtype)  # [C2], AtomicAdd<FP32>
        m, n, gamma = m_new, n_new, gamma_new
    if return_residuals:
        return acc / s16[..., None], m, l
    denom = l * s16  # Alg. 2 line 20
    safe = torch.where(denom > 0, denom, 1.0)
    return torch.where(denom[..., None] > 0, acc / safe[..., None], 0.0)


def rescale_skip_rate(m_trace: torch.Tensor) -> torch.Tensor:
    """Fraction of KV blocks whose AMLA rescale is a no-op (delta_n == 0):
    the running max rarely crosses a power-of-two boundary, so rounding the
    scale to a power of two lets most block updates skip the rescale.
    ``m_trace`` is the per-block running max history ``(n_blocks, G)``."""
    n_trace = torch.round(-m_trace.float() / numerics.LN2).to(torch.int32)
    changed = torch.any(n_trace[1:] != n_trace[:-1], dim=-1)
    return 1.0 - changed.float().mean()
