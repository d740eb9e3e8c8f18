"""Bit-level numerics for AMLA (paper §3, Lemma 3.1, Appendix A).

PyTorch counterpart of ``repro.core.numerics``; every int32 bit pattern
these functions produce equals the reference's.  The core identity
(Lemma 3.1): for a normalized FP32 value ``F`` with biased exponent
``0 < E < 255`` and an integer ``n`` with ``-E < n < 255 - E``::

    F * 2**n  ==  AS_FP32(AS_INT32(F) + n * 2**23)

AMLA uses it to turn the FlashAttention output rescale
``O *= exp(m_prev - m_new)`` into an integer add on the accumulator's bits.
The CUDA kernels (``csrc/amla.cuh``) implement the same functions per
element; these tensor versions are their plain counterparts.
"""

from __future__ import annotations

import torch

MANTISSA_BITS = 23
EXP2_SHIFT = 1 << MANTISSA_BITS

LN2 = 0.6931471805599453

# Running-max initialisation / clamp: finite, so ``round(-m / ln2)`` fits
# int32 and ``exp(m_prev - m_new)`` underflows to 0 instead of NaN.
M_INIT = -1.0e5
M_CLAMP = 8.0e4

# Paper Algorithm 2, line 11: the exponent decrement is clamped; smaller
# accumulators are flushed to zero by the underflow guard.
MIN_EXP_DELTA = -30


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """Bit-preserving reinterpretation FP32 -> INT32 (paper Eq. 7)."""
    return x.to(torch.float32).view(torch.int32)


def as_fp32(i: torch.Tensor) -> torch.Tensor:
    """Bit-preserving reinterpretation INT32 -> FP32 (paper Eq. 7)."""
    return i.to(torch.int32).view(torch.float32)


def biased_exponent(x: torch.Tensor) -> torch.Tensor:
    """Extract the biased 8-bit exponent field E of an FP32 tensor."""
    return (as_int32(x) >> MANTISSA_BITS) & 0xFF


def pow2_mul_by_add(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``x * 2**n`` via INT32 addition on the FP32 bit pattern (Eq. 8/9).

    Guards beyond the Lemma: zeros stay zero, exponent underflow flushes
    to zero, exponent overflow saturates to ``±3.4e38``.  "Zero" is a zero
    exponent field, subnormals included: the reference's platforms flush
    subnormals (a TPU, and XLA on the CPU with denormals-are-zero), so its
    ``x == 0`` test is true for them, and the port tests the bits to match.
    """
    x = x.to(torch.float32)
    n = n.to(torch.int32)
    i = as_int32(x)
    e = (i >> MANTISSA_BITS) & 0xFF
    new_e = e + n
    out = as_fp32(i + n * EXP2_SHIFT)
    zero = torch.zeros_like(x)
    out = torch.where((new_e <= 0) | (e == 0), zero, out)
    big = torch.where(x > 0, torch.full_like(x, 3.4e38), torch.full_like(x, -3.4e38))
    return torch.where((new_e >= 255) & (e != 0), big, out)


def pow2_int_increment(
    delta_n: torch.Tensor, eps: torch.Tensor | None = None
) -> torch.Tensor:
    """INT32 increment implementing ``* 2**delta_n * (1 + eps)``:
    ``round(2^23 * (max(delta_n, MIN_EXP_DELTA) + 1.5 * eps))``.

    Round half to even, with the paper's +1e-6 bias dropped (as the
    reference does): a no-op update then rounds to exactly 0, which is what
    lets the rescale be skipped.
    """
    d = torch.clamp_min(delta_n.to(torch.float32), float(MIN_EXP_DELTA))
    if eps is not None:
        d = d + 1.5 * eps.to(torch.float32)
    return torch.round(d * float(EXP2_SHIFT)).to(torch.int32)


def apply_int_increment(x: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Apply a precomputed INT32 exponent-field increment to FP32 ``x``.

    ``n_eff`` is the increment's exponent delta rounded to nearest (an
    arithmetic shift of a possibly negative ``inc``); a zero (or
    subnormal, see :func:`pow2_mul_by_add`) or underflowing accumulator
    flushes to zero — for negative values the raw add would otherwise wrap
    into garbage.
    """
    x = x.to(torch.float32)
    inc = inc.to(torch.int32)
    i = as_int32(x)
    e = (i >> MANTISSA_BITS) & 0xFF
    n_eff = (inc + (1 << (MANTISSA_BITS - 1))) >> MANTISSA_BITS
    out = as_fp32(i + inc)
    bad = (e == 0) | (e + n_eff <= 0)
    return torch.where(bad, torch.zeros_like(x), out)


def round_scale_to_pow2(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``exp(-m)`` into ``2**n * r``: returns ``(n, inv_r)`` with
    ``n = round(-m / ln2)`` (int32) and ``inv_r = exp(n*ln2 + m)`` (S32)."""
    m = m.to(torch.float32)
    n = torch.round(-m / LN2).to(torch.int32)
    inv_r = torch.exp(n.to(torch.float32) * LN2 + m)
    return n, inv_r


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round-trip through BF16, round to nearest even (the paper's S16)."""
    return x.to(torch.bfloat16).to(torch.float32)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)
