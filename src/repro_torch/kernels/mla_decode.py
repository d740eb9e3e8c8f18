"""The AMLA MUL-by-ADD online-softmax state machine, in plain PyTorch, and
the contiguous MLA decode kernel (K4) built on it.

Counterpart of ``init_decode_state`` / ``decode_block_update`` /
``finalize_decode`` in ``repro/kernels/mla_decode.py`` (the body shared by
the reference's decode kernels) and of its ``mla_decode_rows``.  Per KV
block of ``block_k`` rows:

* online softmax: ``m_new = max(m, rowmax(s))``, ``p = exp(s - m_new)``,
  ``l = l * exp(m - m_new) + rowsum(p)``;
* ``amla``: ``exp(-m_new)`` is split into ``2^n · r`` with
  ``S16 = bf16(1/r)``; the accumulator rescale is the int32 increment
  ``round(2^23 · (Δn + 1.5ε))`` added to its bits, skipped where it is 0;
  ``p · S16`` (rounded to the matmul dtype) feeds PV;
* ``base``: Algorithm 1's fp32 multiply by ``exp(m - m_new)``;
* int8 pages: scores arrive multiplied by each key's scale σ, and σ is
  folded into the probabilities before P·V;
* finalize: ``acc / (l · S16)`` (``amla``) or ``acc / l``, 0 when empty.

The reference skips the rescale only when the increment is zero in *every*
row of the block; here (and in the CUDA kernel) the decision is per row.
The two differ only where the zero/underflow guard of
``apply_int_increment`` flushes a subnormal accumulator of a row whose own
increment is zero.

The CUDA row bodies ``csrc/mla_rows.cuh`` (scalar) and
``csrc/mla_rows_mma.cuh`` (tensor cores), under K2, K4 and K5,
``csrc/gqa_rows.cuh`` (scalar, K6 and K7 at fp32) and the tensor-core
body again under K6 and K7 at bf16, run the same arithmetic per row;
these tensor functions are their plain version.  They take any leading
row shape: ``(G,)`` for one request, ``(B, G)`` for a batch.

:func:`mla_decode_rows` is K4: on a CUDA tensor it launches
``csrc/mla_decode.cu``, on a CPU tensor it runs :func:`_rows_plain`, which
walks the same blocks with the same int32 rescale.  Which row body a
kernel (K2, K2′, K4, K5; K6 and K7 too) runs, and the geometry the
tensor-core one takes, is decided here once for all of them
(:func:`_takes_mma_body`, :func:`_check_mma_geometry`,
:func:`_check_mma_alignment`; the GQA kernels' strided rows have their
own bound, ``gqa_decode.check_mma_rows``).  A meta ``q`` (the dry run)
returns K4's output by shape; under a counter
(:mod:`repro_torch.roofline.op_cost`) each K4 launch charges
:func:`rows_cost`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import numerics
from repro_torch.kernels import _build
from repro_torch.roofline import op_cost

DEFAULT_BLOCK_K = 512
SUB_K = 128  # the reference's preload sub-tile; block_k is a multiple of it


@dataclasses.dataclass
class DecodeState:
    """Online-softmax state of ``(..., G)`` query rows (the reference's
    scratch)."""

    acc: torch.Tensor  # (..., G, Dv) f32
    m: torch.Tensor  # (..., G, 1) f32 running max
    l: torch.Tensor  # (..., G, 1) f32 softmax mass
    n: torch.Tensor  # (..., G, 1) i32 power-of-two exponent of exp(-m) } amla
    gamma: torch.Tensor  # (..., G, 1) f32 inv_r / S16                  }
    s16: torch.Tensor  # (..., G, 1) f32 bf16(inv_r)                    }


def init_decode_state(rows, d_v: int, device) -> DecodeState:
    """Fresh state of ``rows`` (an int or a shape) query rows: zero
    accumulator, ``m = M_INIT``, ``l = 0``."""
    lead = (rows,) if isinstance(rows, int) else tuple(rows)
    m = torch.full(lead + (1,), numerics.M_INIT, dtype=torch.float32, device=device)
    n0, inv_r0 = numerics.round_scale_to_pow2(m)
    return DecodeState(
        acc=torch.zeros(lead + (d_v,), dtype=torch.float32, device=device),
        m=m,
        l=torch.zeros(lead + (1,), dtype=torch.float32, device=device),
        n=n0,
        gamma=torch.ones(lead + (1,), dtype=torch.float32, device=device),
        s16=numerics.bf16_round(inv_r0),
    )


def decode_block_update(
    st: DecodeState,
    s: torch.Tensor,  # (..., G, Bk) f32 masked scores (-inf where masked)
    c_blk: torch.Tensor,  # (..., Bk, Dk) key block; V = first d_v columns
    *,
    d_v: int,
    variant: str,
    mm_dtype: torch.dtype,
    kv_scale: torch.Tensor | None = None,  # (..., 1, Bk) f32, int8 pages
) -> None:
    """One KV-block update of ``st``, in place.

    With int8 pages ``c_blk`` holds the raw int8 rows and ``kv_scale`` their
    per-row dequant scales: ``s`` arrives already multiplied by them, and
    they are folded into the probabilities before P·V (``p * S16 * σ`` for
    amla, ``p * σ`` for base), in the reference's order."""
    m_prev = st.m
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    st.l = st.l * torch.exp(m_prev - m_new) + p.sum(dim=-1, keepdim=True)
    st.m = m_new

    if variant == "amla":
        n_new, inv_r32 = numerics.round_scale_to_pow2(m_new)
        s16 = numerics.bf16_round(inv_r32)
        gamma_new = inv_r32 / s16
        eps = st.gamma / gamma_new - 1.0
        inc = numerics.pow2_int_increment(n_new - st.n, eps)
        st.n, st.gamma, st.s16 = n_new, gamma_new, s16
        p_v = p * s16 if kv_scale is None else p * s16 * kv_scale
        p_mm = p_v.to(mm_dtype)
        # MUL-by-ADD rescale, skipped per row where the increment is 0.
        st.acc = torch.where(
            inc != 0, numerics.apply_int_increment(st.acc, inc), st.acc
        )
    elif variant == "base":
        st.acc = st.acc * torch.exp(m_prev - m_new)
        p_mm = (p if kv_scale is None else p * kv_scale).to(mm_dtype)
    else:
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")

    # T = P V with V = the first d_v columns, both at the matmul dtype and
    # accumulated in fp32 (the reference's preferred_element_type=f32).
    v_blk = c_blk[..., :d_v].to(mm_dtype)
    st.acc = st.acc + p_mm.to(torch.float32) @ v_blk.to(torch.float32)


def finalize_decode(st: DecodeState, *, variant: str) -> torch.Tensor:
    """Divide out the softmax denominator (and S16 for AMLA); 0 if empty."""
    denom = st.l * st.s16 if variant == "amla" else st.l
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, st.acc / safe, torch.zeros_like(st.acc))


def contiguous_block_k(block_k: int, s: int) -> int:
    """The reference's block size for a cache of ``s`` rows: ``block_k``
    clamped to the cache, in whole 128-row sub-tiles."""
    sub_k = min(SUB_K, max(block_k, 1))
    block_k = min(block_k, -(-max(s, 1) // sub_k) * sub_k)
    if block_k % sub_k:
        raise ValueError(f"block_k={block_k} must be a multiple of {sub_k}")
    return block_k


def masked_scores(q, k_blk, start, *, scale, softcap, visible):
    """Scores of rows ``q (..., G, D)`` against a key block ``k_blk (...,
    Bk, D)`` (both at the matmul dtype, multiplied in fp32), scaled,
    soft-capped, clamped to +-M_CLAMP, and -inf where ``visible(k_pos)``
    is False; ``k_pos (Bk,)`` are the block's absolute key positions."""
    s = q.to(torch.float32) @ k_blk.to(torch.float32).transpose(-1, -2)
    s = s * scale
    if softcap is not None:
        s = numerics.softcap(s, softcap)
    s = torch.clamp(s, -numerics.M_CLAMP, numerics.M_CLAMP)
    k_pos = start + torch.arange(k_blk.shape[-2], device=q.device)
    return torch.where(visible(k_pos), s, -torch.inf)


def key_block(t, start: int, block_k: int) -> torch.Tensor:
    """Rows ``[start, start + block_k)`` of ``t (..., S, D)`` along its
    sequence axis, zero-padded past ``S`` as the reference pads."""
    blk = t[..., start : start + block_k, :]
    short = block_k - blk.shape[-2]
    if short:
        blk = torch.nn.functional.pad(blk, (0, 0, 0, short))
    return blk


def _rows_plain(q, c_kv, kv_len, q_pos, *, d_v, variant, scale, block_k, softcap):
    """Plain version of K4: every block below the longest kv_len, one state
    update per block for all rows (a block a row cannot see leaves its
    state unchanged)."""
    b, g, _ = q.shape
    st = init_decode_state((b, g), d_v, q.device)
    lens = kv_len.to(torch.int64)[:, None, None]
    pos = q_pos.to(torch.int64)[:, :, None]
    n_live = min(int(kv_len.max()) if b else 0, c_kv.shape[1])
    for start in range(0, n_live, block_k):
        c_blk = key_block(c_kv, start, block_k).to(q.dtype)
        s = masked_scores(
            q, c_blk, start, scale=scale, softcap=softcap,
            visible=lambda k: (k < lens) & (k <= pos),
        )
        decode_block_update(st, s, c_blk, d_v=d_v, variant=variant, mm_dtype=q.dtype)
    return finalize_decode(st, variant=variant)


def rows_cost(q, c_kv, kv_len, q_pos, *, d_v):
    """K4's charge: 2 * (Dk + Dv) operations per (row, visible key), and q,
    the latent rows seen by each request and the fp32 output read or
    written once.  Visible keys come from ``kv_len`` and ``q_pos`` (a host
    read); on meta every key below the cache length is live."""
    from repro_torch.kernels import gqa_decode as _gqa

    b, g, d_k = q.shape
    s = c_kv.shape[1]
    if q.is_meta:
        pairs, seen = _gqa.meta_visible_keys(b, g, s=s, window=None)
    else:
        pairs, seen = _gqa.visible_keys(kv_len, q_pos, s=s, window=None)
    nbytes = q.numel() * q.element_size() + int(seen.sum()) * d_k * c_kv.element_size()
    return 2.0 * (d_k + d_v) * int(pairs.sum()), nbytes + b * g * d_v * 4


def _takes_mma_body(q, kv) -> bool:
    """Whether a kernel (K2, K2′, K4, K5, K6, K7) runs the tensor-core body
    (bf16 ``q`` over bf16 or int8 rows) rather than the scalar one.  K4,
    K5, K6 and K7 take no int8 rows."""
    return q.dtype == torch.bfloat16 and kv.dtype in (torch.bfloat16, torch.int8)


def _check_mma_geometry(kv_dtype, n_blocks, block_rows, d_k, d_v) -> None:
    """Raise ``ValueError`` unless the tensor-core body can address the
    rows: it copies rows in 16-byte pieces (8 bf16 or 16 int8 elements), so
    ``d_k`` and ``d_v`` are whole pieces, and it addresses the rows one base
    pointer reaches (a paged pool's ``num_pages x page_size``, a contiguous
    cache's ``1 x S`` per request) by 32-bit offsets in such pieces, so they
    hold fewer than 2**31 of them."""
    unit = 16 // kv_dtype.itemsize
    if d_k % unit or d_v % unit:
        raise ValueError(
            f"d_k={d_k}, d_v={d_v}: bf16 q over {kv_dtype} rows takes d_k "
            f"and d_v that are multiples of {unit} (16-byte rows)"
        )
    if n_blocks * block_rows * d_k // unit >= 2**31:
        raise ValueError(
            f"rows of {n_blocks} x {block_rows} x {d_k} elements: the "
            "tensor-core body addresses rows in 32-bit 16-byte units"
        )


def _check_mma_alignment(batch_stride_bytes: int = 0, **tensors) -> None:
    """Raise ``ValueError`` unless each tensor starts on a 16-byte boundary
    and the batch stride keeps the next request's rows on one, as the
    tensor-core body's 16-byte copies need."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"bf16 {name} must start on a 16-byte boundary")
    if batch_stride_bytes % 16:
        raise ValueError(
            f"a batch stride of {batch_stride_bytes} bytes: the tensor-core "
            "body needs it a multiple of 16"
        )


def _rows_cuda(q, c_kv, kv_len, q_pos, *, d_v, variant, scale, block_k, softcap):
    """Launch ``csrc/mla_decode.cu`` on the current stream."""
    b, g, d_k = q.shape
    dev = q.device
    for name, t in (("c_kv", c_kv), ("kv_len", kv_len), ("q_pos", q_pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("c_kv", c_kv)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes bf16 or fp32")
    if d_v > 512 or d_v > d_k or block_k > 512:
        raise ValueError(
            f"d_v={d_v}, block_k={block_k}: the kernel takes d_v <= min(512, "
            f"d_k) and block_k <= 512"
        )
    mma = _takes_mma_body(q, c_kv)
    if mma:
        _check_mma_geometry(c_kv.dtype, 1, c_kv.shape[1], d_k, d_v)
    if c_kv.stride(2) != 1 or c_kv.stride(1) != d_k:
        raise ValueError(
            f"c_kv strides {c_kv.stride()}: the kernel reads (S, Dk) rows "
            f"stored contiguously (any batch stride)"
        )
    q = q.contiguous()
    if mma:
        stride = c_kv.stride(0) * c_kv.element_size() if b > 1 else 0
        _check_mma_alignment(stride, q=q, c_kv=c_kv)
    lens = kv_len.to(torch.int32).contiguous()
    pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty((b, g, d_v), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.amla_mla_decode_rows(
        q.data_ptr(), c_kv.data_ptr(), lens.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, g, d_k, d_v, c_kv.shape[1], block_k, c_kv.stride(0), float(scale),
        0.0 if softcap is None else float(softcap),
        1 if variant == "amla" else 0,
        1 if q.dtype == torch.bfloat16 else 0,
        1 if c_kv.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "mla_decode_rows")
    mla_decode_rows.launches += 1
    mla_decode_rows.mma_launches += mma
    return out


def mla_decode_rows(
    q: torch.Tensor,  # (B, G, Dk) matmul dtype
    c_kv: torch.Tensor,  # (B, S, Dk) latent cache (its dtype; rounded per use)
    kv_len: torch.Tensor,  # (B,) int
    q_pos: torch.Tensor,  # (B, G) int
    *,
    d_v: int = 512,
    variant: str = "amla",
    scale: float,
    block_k: int = DEFAULT_BLOCK_K,
    softcap: float | None = None,
) -> torch.Tensor:
    """Contiguous-cache MLA decode (K4); returns ``(B, G, Dv)`` fp32.

    Cache rows are rounded to ``q``'s dtype where they are used, so an
    fp32 cache with bf16 queries computes what the reference computes
    after casting the cache, without a copy of it.  A CUDA ``q`` launches
    the kernel (and counts one launch in ``mla_decode_rows.launches``); a
    CPU ``q`` runs the plain version; a meta ``q`` returns the output by
    shape.  A bf16 ``q`` over a bf16 cache runs
    the tensor-core body and counts in ``.mma_launches`` as well; it takes
    ``d_k`` and ``d_v`` in whole 16-byte pieces, a cache of fewer than 2**31
    such pieces per request, and 16-byte aligned ``q``, cache and batch
    stride, and raises ``ValueError`` otherwise.  There is no fallback
    between the kernel and the plain version, nor between the two bodies.
    """
    if variant not in ("amla", "base"):
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")
    block_k = contiguous_block_k(block_k, c_kv.shape[1])
    impl = _rows_cuda if q.is_cuda else _rows_meta if q.is_meta else _rows_plain
    kw = dict(d_v=d_v, variant=variant, scale=scale, block_k=block_k, softcap=softcap)
    if not op_cost.counting():
        return impl(q, c_kv, kv_len, q_pos, **kw)
    with op_cost.kernel("mla_decode_rows", lambda: rows_cost(q, c_kv, kv_len, q_pos, d_v=d_v)):
        return impl(q, c_kv, kv_len, q_pos, **kw)


def _rows_meta(q, c_kv, kv_len, q_pos, *, d_v, **_):
    """K4's output by shape (a meta ``q``)."""
    return torch.empty((*q.shape[:2], d_v), device=q.device)


mla_decode_rows.launches = 0
mla_decode_rows.mma_launches = 0
