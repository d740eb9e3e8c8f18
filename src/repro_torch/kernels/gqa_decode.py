"""GQA/MQA/MHA decode attention with the AMLA rescale (K6).

Counterpart of ``repro/kernels/gqa_decode.py``.  Layout is cache-native:

    q: (B, Hkv, G, Dh)   with G = Sq * group   (group = Hq // Hkv)
    k: (B, Hkv, S, Dh)
    v: (B, Hkv, S, Dh)

so a dense ``(B, Hkv, S, Dh)`` cache feeds the kernel where it lies; the
CUDA kernel takes k and v through their strides, so a transposed view or
one slot of a larger cache is not copied.  Each row keeps one online-
softmax state over ``block_k``-key blocks (``min(512, max(S, 128))``, the
reference's rule); ``variant="amla"`` replaces the per-block fp32 rescale
multiply with the skippable int32 exponent add.  Sliding-window layers mask
``k_pos > q_pos - window``.

On a CUDA tensor :func:`gqa_decode_rows` launches ``csrc/gqa_decode.cu``;
on a CPU tensor it runs :func:`attend_plain`, which walks the same blocks
with the same int32 rescale.  bf16 ``q`` (over bf16 k and v) runs the
kernel's tensor-core body, split over the KV blocks of each ``(b, kv
head)`` (:func:`decode_splits`) and merged by the combine kernel (K3,
:func:`repro_torch.kernels.mla_decode_combine.combine_split_partials`);
``attend_plain(num_splits=...)`` walks the same splits.

A meta ``q`` (the dry run, :mod:`repro_torch.launch.dryrun`) returns an
output of the kernel's shape and dtype and reads no value; under a
counter (:mod:`repro_torch.roofline.op_cost`) every launch charges
:func:`decode_cost`, and a meta launch splits by the H100's 132 SMs.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import mla_decode_combine as _combine
from repro_torch.roofline import op_cost

DEFAULT_BLOCK_K = 512
MMA_TILE_ROWS = 16  # the tensor-core body's row tile while its grid is below the SM count
H100_SMS = 132  # the SM count a meta launch splits by


def visible_keys(kv_len, q_pos, *, s, window, causal=True):
    """``(pairs (B,), seen (B,))`` int64 of rows at positions ``q_pos (B,
    R)`` over ``s`` cache rows: the (row, key) pairs a request's rows see
    (keys below ``min(kv_len, s)``, causal: at most the row's position,
    window: past ``position - window``) and the keys any of its rows sees
    (the span from the lowest window start to the highest key seen)."""
    lens = kv_len.to(torch.int64).clamp(max=s)[:, None]
    pos = q_pos.to(torch.int64)
    hi = torch.minimum(lens, pos + 1) if causal else lens.expand(pos.shape)
    lo = (pos - window + 1).clamp_min(0) if window is not None else torch.zeros_like(pos)
    pairs = (hi - lo).clamp_min(0).sum(dim=1)
    seen = (hi.max(dim=1).values - lo.min(dim=1).values).clamp_min(0)
    return pairs, seen


def meta_visible_keys(b, rows, *, s, window):
    """:func:`visible_keys` by shape alone, as the dry run reads a decode
    step: every key below the cache length ``s`` is live and each row sits
    at the last position, so it sees ``min(s, window)`` keys."""
    n = s if window is None else min(s, window)
    return torch.full((b,), rows * n, dtype=torch.int64), torch.full((b,), n, dtype=torch.int64)


def attention_cost(q, k, v, pairs, seen, *, heads_per_kv=1):
    """``(flops, bytes)`` of a GQA kernel launch (K6, K7): 4 * Dh
    operations per (row, visible key), and q, the K and V rows seen by
    each ``(b, kv head)`` and the fp32 output read or written once.
    ``pairs`` counts one head's rows; ``heads_per_kv`` q heads share a kv
    head's rows."""
    hkv, dh = k.shape[1], q.shape[-1]
    rows_pairs = int(pairs.sum()) * hkv * heads_per_kv
    kv_bytes = int(seen.sum()) * hkv * dh * (k.element_size() + v.element_size())
    q_bytes = q.numel() * q.element_size()
    return 4.0 * dh * rows_pairs, q_bytes + kv_bytes + q.numel() * 4


def split_edges(kv_len, q_pos, *, s, block_k, window, causal, num_splits):
    """``(B, num_splits + 1)`` block indices: split ``j`` of request ``b``
    walks blocks ``[edges[b, j], edges[b, j + 1])``.  A request's live blocks
    run from the one that holds the window start of its smallest position
    (the reference's whole-block window skip) to the one that holds
    ``min(kv_len, s)`` (causal: and its largest position + 1); each split
    takes a contiguous run of them, as the kernel does."""
    lens = kv_len.to(torch.int64).clamp(max=s)
    pos = q_pos.to(torch.int64)
    end = torch.minimum(lens, pos.max(dim=1).values + 1) if causal else lens
    first = torch.zeros_like(lens)
    if window is not None:
        first = (pos.min(dim=1).values - window + 1).clamp_min(0) // block_k
    n = ((end + block_k - 1) // block_k - first).clamp_min(0)
    j = torch.arange(num_splits + 1, device=lens.device)
    return first[:, None] + j[None, :] * n[:, None] // num_splits


def attend_plain(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap,
                 window, causal=True, num_splits=1, return_partials=False):
    """Plain version of the GQA kernels: rows ``q (B, H, R, Dh)`` against
    their own heads ``k, v (B, H, S, Dh)``, positions ``q_pos (B, R)``.
    Every block below the longest kv_len takes one state update for all
    rows (a block a row cannot see leaves its state unchanged, so leaving
    out the blocks outside :func:`split_edges` changes no number).  With
    ``num_splits > 1`` each split starts a state of its own, and the
    normalized partials are merged by the combine's plain version, as the
    kernel's splits are; ``return_partials=True`` returns them unmerged
    instead, ``(num_splits, B, H, R, Dh)`` and their lse ``(num_splits, B,
    H, R)`` (-inf where a split saw no key)."""
    b, h, r, _ = q.shape
    d_v = v.shape[-1]
    lens = kv_len.to(torch.int64)[:, None, None, None]
    pos = q_pos.to(torch.int64)[:, None, :, None]
    n_live = min(int(kv_len.max()) if b else 0, k.shape[2])
    edges = split_edges(kv_len, q_pos, s=k.shape[2], block_k=block_k, window=window,
                        causal=causal, num_splits=num_splits)
    o_parts, lse_parts = [], []
    for j in range(num_splits):
        st = _mla.init_decode_state((b, h, r), d_v, q.device)
        for start in range(0, n_live, block_k):
            i = start // block_k
            inside = ((edges[:, j] <= i) & (i < edges[:, j + 1]))[:, None, None, None]
            if not bool(inside.any()):
                continue

            def visible(k_pos, inside=inside):
                mask = (k_pos < lens) & inside
                if causal:
                    mask = mask & (k_pos <= pos)
                if window is not None:
                    mask = mask & (k_pos > pos - window)
                return mask

            k_blk = _mla.key_block(k, start, block_k).to(q.dtype)
            v_blk = _mla.key_block(v, start, block_k).to(q.dtype)
            s = _mla.masked_scores(q, k_blk, start, scale=scale, softcap=softcap,
                                   visible=visible)
            _mla.decode_block_update(st, s, v_blk, d_v=d_v, variant=variant, mm_dtype=q.dtype)
        o_parts.append(_mla.finalize_decode(st, variant=variant))
        lse_parts.append(torch.where(st.l > 0, st.m + torch.log(st.l), -torch.inf))
    if return_partials:
        return torch.stack(o_parts), torch.stack(lse_parts)[..., 0]
    if num_splits == 1:
        return o_parts[0]
    dest, n_splits = split_tables(b * h, num_splits, q.device)
    out = _combine._combine_plain(
        torch.stack(o_parts).reshape(num_splits * b * h, r, d_v),
        torch.stack(lse_parts).reshape(num_splits * b * h, r, 1), dest, n_splits)
    return out.reshape(b, h, r, d_v)


@functools.lru_cache(maxsize=None)
def split_tables(columns: int, splits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The combine's ``dest_table (columns, splits)`` and ``n_splits
    (columns,)`` for partials in slot ``split * columns + column``: every
    column (a ``(b, kv head)``) merges all of its splits, an empty one
    weighing 0."""
    dest = torch.arange(splits, dtype=torch.int32)[None, :] * columns + torch.arange(
        columns, dtype=torch.int32)[:, None]
    return dest.to(device), torch.full((columns,), splits, dtype=torch.int32, device=device)


def decode_splits(sms: int, ctas: int, n_blocks: int) -> int:
    """K6's split count, from host-known shapes only: 1 once its ``ctas``
    (``B x Hkv x`` 16-row tiles) fill the ``sms``; else enough for about
    two CTAs per SM, at most one per ``block_k`` block of the cache.  A
    decode batch is ragged and a split with no live block exits at once, so
    the second wave is mostly empty splits."""
    if ctas >= sms:
        return 1
    return max(1, min(n_blocks, -(-2 * sms // ctas)))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_count(q, k, block_k: int) -> int:
    """The splits a CUDA launch of K6 on ``q (B, Hkv, G, Dh)`` over ``k
    (B, Hkv, S, Dh)`` takes: :func:`decode_splits` on the tensor-core body,
    1 on the scalar one."""
    if not _mla._takes_mma_body(q, k):
        return 1
    b, hkv, g, _ = q.shape
    ctas = b * hkv * -(-g // MMA_TILE_ROWS)
    return decode_splits(_sm_count(q.device), ctas, -(-k.shape[2] // block_k))


def check_kv(q, k, v, kv_len, *more):
    """What the GQA kernels take, or raise: one device, bf16 or fp32
    throughout, head dim a multiple of 8 up to 256 (a multiple of 32 past
    32), k and v with unit stride along Dh and 16-byte aligned rows."""
    dev = q.device
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len), *more):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel takes "
            "all bf16 or all fp32"
        )
    dh = q.shape[-1]
    if k.shape[-1] != dh or v.shape[-1] != dh:
        raise ValueError(f"head dims differ: q {dh}, k {k.shape[-1]}, v {v.shape[-1]}")
    if dh % 8 or dh > 256 or (dh > 32 and dh % 32):
        raise ValueError(
            f"head_dim={dh}: the kernel takes a multiple of 8 up to 256 "
            "(a multiple of 32 above 32)"
        )
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} strides {t.stride()}: the kernel reads rows of Dh "
                "with unit stride, 16-byte aligned (strides multiples of 8)"
            )


def check_mma_rows(q, k, v) -> None:
    """Raise ``ValueError`` unless the tensor-core body can address ``k``
    and ``v`` (``check_kv`` has held head dim, strides and alignment to
    16-byte pieces): it addresses a ``(b, head)``'s rows by 32-bit offsets
    in 16-byte pieces from that head's base, so ``S x`` sequence stride
    stays below 2**31 pieces; and ``q`` starts on a 16-byte boundary."""
    for name, t in (("k", k), ("v", v)):
        if t.shape[2] * t.stride(2) // 8 >= 2**31:
            raise ValueError(
                f"{name} of {t.shape[2]} rows {t.stride(2)} elements apart: the "
                "tensor-core body addresses rows in 32-bit 16-byte units"
            )
    _mla._check_mma_alignment(q=q)


def kv_strides(t):
    """(batch, head, sequence) element strides of a (B, H, S, Dh) tensor."""
    return t.stride(0), t.stride(1), t.stride(2)


def _decode_cuda(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap, window,
                 return_partials=False):
    """Launch ``csrc/gqa_decode.cu`` on the current stream (and, over more
    than one split and without ``return_partials``, the combine)."""
    b, hkv, g, dh = q.shape
    check_kv(q, k, v, kv_len, ("q_pos", q_pos))
    if q_pos.shape != (b, g):
        raise ValueError(f"q_pos must be (B={b}, G={g}); got {tuple(q_pos.shape)}")
    mma = _mla._takes_mma_body(q, k)
    q = q.contiguous()
    if mma:
        check_mma_rows(q, k, v)
    splits = split_count(q, k, block_k)
    lens = kv_len.to(torch.int32).contiguous()
    pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty((splits * b * hkv, g, dh), dtype=torch.float32, device=q.device)
    lse = (torch.empty((splits * b * hkv, g, 1), dtype=torch.float32, device=q.device)
           if splits > 1 or return_partials else None)
    lib = _build.load()
    err = lib.amla_gqa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, hkv, g, dh, k.shape[2],
        block_k, splits, *kv_strides(k), *kv_strides(v), float(scale),
        0.0 if softcap is None else float(softcap), 0 if window is None else int(window),
        1 if variant == "amla" else 0, 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "gqa_decode_rows")
    gqa_decode_rows.launches += 1
    gqa_decode_rows.mma_launches += mma
    if return_partials:
        return out.view(splits, b, hkv, g, dh), lse.view(splits, b, hkv, g)
    if splits > 1:
        out = _combine.combine_split_partials(out, lse, *split_tables(b * hkv, splits, q.device))
    return out.view(b, hkv, g, dh)


def _decode_meta(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap, window,
                  return_partials=False):
    """The kernel's outputs by shape (the CUDA path's split rule at
    :data:`H100_SMS`), reading no value; more than one split merges
    through the combine's meta branch, as a launch runs K3."""
    b, hkv, g, dh = q.shape
    splits = 1
    if _mla._takes_mma_body(q, k):
        ctas = b * hkv * -(-g // MMA_TILE_ROWS)
        splits = decode_splits(H100_SMS, ctas, -(-k.shape[2] // block_k))
    if return_partials:
        return (torch.empty((splits, b, hkv, g, dh), device=q.device),
                torch.empty((splits, b, hkv, g), device=q.device))
    out = torch.empty((splits * b * hkv, g, dh), device=q.device)
    if splits > 1:
        lse = torch.empty((splits * b * hkv, g, 1), device=q.device)
        dest = torch.empty((b * hkv, splits), dtype=torch.int32, device=q.device)
        n = torch.empty((b * hkv,), dtype=torch.int32, device=q.device)
        out = _combine.combine_split_partials(out, lse, dest, n)
    return out.view(b, hkv, g, dh)


def decode_cost(q, k, v, kv_len, q_pos, *, window):
    """K6's charge (:func:`attention_cost`): visible keys from ``kv_len``
    and ``q_pos`` (a host read), or by shape on meta."""
    b, _, g, _ = q.shape
    if q.is_meta:
        pairs, seen = meta_visible_keys(b, g, s=k.shape[2], window=window)
    else:
        pairs, seen = visible_keys(kv_len, q_pos, s=k.shape[2], window=window)
    return attention_cost(q, k, v, pairs, seen)


def _decode_plain(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap, window,
                  return_partials=False):
    return attend_plain(q, k, v, kv_len, q_pos, variant=variant, scale=scale,
                        block_k=block_k, softcap=softcap, window=window,
                        return_partials=return_partials)


def gqa_decode_rows(
    q: torch.Tensor,  # (B, Hkv, G, Dh)
    k: torch.Tensor,  # (B, Hkv, S, Dh)
    v: torch.Tensor,  # (B, Hkv, S, Dh)
    kv_len: torch.Tensor,  # (B,)
    q_pos: torch.Tensor,  # (B, G)
    *,
    variant: str = "amla",
    scale: float,
    block_k: int = DEFAULT_BLOCK_K,
    softcap: float | None = None,
    window: int | None = None,
    return_partials: bool = False,
):
    """GQA decode (K6); returns ``(B, Hkv, G, Dh)`` fp32, exact zeros for a
    row with no visible key.  With ``return_partials=True`` it returns
    each split's normalized rows ``(splits, B, Hkv, G, Dh)`` and their lse
    ``(splits, B, Hkv, G)`` (-inf where a split saw no key) for the caller
    to merge (:func:`repro_torch.core.distributed.combine_shard_partials`):
    no combine launch; ``splits`` is :func:`split_count`'s on CUDA, 1 on
    the CPU.

    A CUDA ``q`` launches the kernel (and counts one launch in
    ``gqa_decode_rows.launches``); a CPU ``q`` runs the plain version; a
    meta ``q`` returns outputs by shape.  A
    bf16 ``q`` runs the tensor-core body and counts in ``.mma_launches``
    as well; over more than one split (:func:`split_count`) it also
    launches the combine.  There is no fallback between the kernel and the
    plain version, nor between the two bodies: rows the tensor-core body
    cannot address raise ``ValueError``.
    """
    if variant not in ("amla", "base"):
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be a positive key count")
    block_k = min(block_k, max(k.shape[2], 128))
    impl = _decode_cuda if q.is_cuda else _decode_meta if q.is_meta else _decode_plain
    kw = dict(variant=variant, scale=scale, block_k=block_k, softcap=softcap, window=window,
              return_partials=return_partials)
    if not op_cost.counting():
        return impl(q, k, v, kv_len, q_pos, **kw)
    with op_cost.kernel("gqa_decode_rows",
                        lambda: decode_cost(q, k, v, kv_len, q_pos, window=window)):
        return impl(q, k, v, kv_len, q_pos, **kw)


gqa_decode_rows.launches = 0
gqa_decode_rows.mma_launches = 0
