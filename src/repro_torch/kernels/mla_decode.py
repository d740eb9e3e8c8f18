"""The AMLA MUL-by-ADD online-softmax state machine, in plain PyTorch.

Counterpart of ``init_decode_state`` / ``decode_block_update`` /
``finalize_decode`` in ``repro/kernels/mla_decode.py`` (the body shared by
the reference's decode kernels).  Per KV block of ``block_k`` rows:

* online softmax: ``m_new = max(m, rowmax(s))``, ``p = exp(s - m_new)``,
  ``l = l * exp(m - m_new) + rowsum(p)``;
* ``amla``: ``exp(-m_new)`` is split into ``2^n · r`` with
  ``S16 = bf16(1/r)``; the accumulator rescale is the int32 increment
  ``round(2^23 · (Δn + 1.5ε))`` added to its bits, skipped where it is 0;
  ``p · S16`` (rounded to the matmul dtype) feeds PV;
* ``base``: Algorithm 1's fp32 multiply by ``exp(m - m_new)``;
* finalize: ``acc / (l · S16)`` (``amla``) or ``acc / l``, 0 when empty.

The reference skips the rescale only when the increment is zero in *every*
row of the block; here (and in the CUDA kernel) the decision is per row.
The two differ only where the zero/underflow guard of
``apply_int_increment`` flushes a subnormal accumulator of a row whose own
increment is zero.

The CUDA kernel in ``csrc/mla_decode_paged.cu`` runs the same arithmetic
per row; these tensor functions are its plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import numerics

DEFAULT_BLOCK_K = 512


@dataclasses.dataclass
class DecodeState:
    """Online-softmax state of ``G`` query rows (the reference's scratch)."""

    acc: torch.Tensor  # (G, Dv) f32
    m: torch.Tensor  # (G, 1) f32 running max
    l: torch.Tensor  # (G, 1) f32 softmax mass
    n: torch.Tensor  # (G, 1) i32 power-of-two exponent of exp(-m)   } amla
    gamma: torch.Tensor  # (G, 1) f32 inv_r / S16                     }
    s16: torch.Tensor  # (G, 1) f32 bf16(inv_r)                       }


def init_decode_state(g: int, d_v: int, device) -> DecodeState:
    """Fresh state: zero accumulator, ``m = M_INIT``, ``l = 0``."""
    m = torch.full((g, 1), numerics.M_INIT, dtype=torch.float32, device=device)
    n0, inv_r0 = numerics.round_scale_to_pow2(m)
    return DecodeState(
        acc=torch.zeros((g, d_v), dtype=torch.float32, device=device),
        m=m,
        l=torch.zeros((g, 1), dtype=torch.float32, device=device),
        n=n0,
        gamma=torch.ones((g, 1), dtype=torch.float32, device=device),
        s16=numerics.bf16_round(inv_r0),
    )


def decode_block_update(
    st: DecodeState,
    s: torch.Tensor,  # (G, Bk) f32 masked scores (-inf where masked)
    c_blk: torch.Tensor,  # (Bk, Dk) latent block; V = first d_v columns
    *,
    d_v: int,
    variant: str,
    mm_dtype: torch.dtype,
) -> None:
    """One KV-block update of ``st``, in place."""
    m_prev = st.m
    m_new = torch.maximum(m_prev, s.amax(dim=1, keepdim=True))
    p = torch.exp(s - m_new)
    st.l = st.l * torch.exp(m_prev - m_new) + p.sum(dim=1, keepdim=True)
    st.m = m_new

    if variant == "amla":
        n_new, inv_r32 = numerics.round_scale_to_pow2(m_new)
        s16 = numerics.bf16_round(inv_r32)
        gamma_new = inv_r32 / s16
        eps = st.gamma / gamma_new - 1.0
        inc = numerics.pow2_int_increment(n_new - st.n, eps)
        st.n, st.gamma, st.s16 = n_new, gamma_new, s16
        p_mm = (p * s16).to(mm_dtype)
        # MUL-by-ADD rescale, skipped per row where the increment is 0.
        st.acc = torch.where(
            inc != 0, numerics.apply_int_increment(st.acc, inc), st.acc
        )
    elif variant == "base":
        st.acc = st.acc * torch.exp(m_prev - m_new)
        p_mm = p.to(mm_dtype)
    else:
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")

    # T = P V with V = the first d_v columns, both at the matmul dtype and
    # accumulated in fp32 (the reference's preferred_element_type=f32).
    v_blk = c_blk[:, :d_v].to(mm_dtype)
    st.acc = st.acc + p_mm.to(torch.float32) @ v_blk.to(torch.float32)


def finalize_decode(st: DecodeState, *, variant: str) -> torch.Tensor:
    """Divide out the softmax denominator (and S16 for AMLA); 0 if empty."""
    denom = st.l * st.s16 if variant == "amla" else st.l
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, st.acc / safe, torch.zeros_like(st.acc))
