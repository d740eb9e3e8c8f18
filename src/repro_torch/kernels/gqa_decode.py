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
with the same int32 rescale.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as _mla

DEFAULT_BLOCK_K = 512


def attend_plain(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap,
                 window, causal=True):
    """Plain version of the GQA kernels: rows ``q (B, H, R, Dh)`` against
    their own heads ``k, v (B, H, S, Dh)``, positions ``q_pos (B, R)``.
    Every block below the longest kv_len takes one state update for all
    rows (a block a row cannot see leaves its state unchanged)."""
    b, h, r, _ = q.shape
    d_v = v.shape[-1]
    st = _mla.init_decode_state((b, h, r), d_v, q.device)
    lens = kv_len.to(torch.int64)[:, None, None, None]
    pos = q_pos.to(torch.int64)[:, None, :, None]

    def visible(k_pos):
        mask = k_pos < lens
        if causal:
            mask = mask & (k_pos <= pos)
        if window is not None:
            mask = mask & (k_pos > pos - window)
        return mask

    n_live = min(int(kv_len.max()) if b else 0, k.shape[2])
    for start in range(0, n_live, block_k):
        k_blk = _mla.key_block(k, start, block_k).to(q.dtype)
        v_blk = _mla.key_block(v, start, block_k).to(q.dtype)
        s = _mla.masked_scores(q, k_blk, start, scale=scale, softcap=softcap,
                               visible=visible)
        _mla.decode_block_update(st, s, v_blk, d_v=d_v, variant=variant, mm_dtype=q.dtype)
    return _mla.finalize_decode(st, variant=variant)


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


def kv_strides(t):
    """(batch, head, sequence) element strides of a (B, H, S, Dh) tensor."""
    return t.stride(0), t.stride(1), t.stride(2)


def _decode_cuda(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap, window):
    """Launch ``csrc/gqa_decode.cu`` on the current stream."""
    b, hkv, g, dh = q.shape
    check_kv(q, k, v, kv_len, ("q_pos", q_pos))
    if q_pos.shape != (b, g):
        raise ValueError(f"q_pos must be (B={b}, G={g}); got {tuple(q_pos.shape)}")
    q = q.contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty((b, hkv, g, dh), dtype=torch.float32, device=q.device)
    lib = _build.load()
    err = lib.amla_gqa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, hkv, g, dh, k.shape[2], block_k, *kv_strides(k),
        *kv_strides(v), float(scale), 0.0 if softcap is None else float(softcap),
        0 if window is None else int(window), 1 if variant == "amla" else 0,
        1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "gqa_decode_rows")
    gqa_decode_rows.launches += 1
    return out


def _decode_plain(q, k, v, kv_len, q_pos, *, variant, scale, block_k, softcap, window):
    return attend_plain(q, k, v, kv_len, q_pos, variant=variant, scale=scale,
                        block_k=block_k, softcap=softcap, window=window)


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
) -> torch.Tensor:
    """GQA decode (K6); returns ``(B, Hkv, G, Dh)`` fp32, exact zeros for a
    row with no visible key.

    A CUDA ``q`` launches the kernel (and counts one launch in
    ``gqa_decode_rows.launches``); a CPU ``q`` runs the plain version.
    There is no fallback between the two.
    """
    if variant not in ("amla", "base"):
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be a positive key count")
    block_k = min(block_k, max(k.shape[2], 128))
    impl = _decode_cuda if q.is_cuda else _decode_plain
    return impl(q, k, v, kv_len, q_pos, variant=variant, scale=scale,
                block_k=block_k, softcap=softcap, window=window)


gqa_decode_rows.launches = 0
