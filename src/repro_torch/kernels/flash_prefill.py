"""Causal flash prefill with the AMLA rescale option (K7).

Counterpart of ``repro/kernels/flash_prefill.py``.  Layouts:
``q (B, Hq, Sq, Dh)``, ``k``/``v (B, Hkv, S, Dh)``; GQA is an index (query
head ``h`` reads KV head ``h // group``), so no KV replication is
materialised by the kernel.  Causal and sliding-window masks, gemma2-style
logit soft-capping, and ``variant={"base","amla"}``.  Query positions
count from 0, as in the reference, which takes no query offset.

On a CUDA tensor :func:`flash_prefill` launches ``csrc/flash_prefill.cu``
(k and v read through their strides; bf16 on the tensor-core body, fp32
on the scalar one); on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.gqa_decode.attend_plain` over the same
``block_k``-key blocks with the same int32 rescale; on a meta tensor it
returns the output by shape.  Under a counter each launch charges
:func:`prefill_cost`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gqa_decode as _gqa
from repro_torch.kernels import mla_decode as _mla
from repro_torch.roofline import op_cost

DEFAULT_BLOCK_K = 512


def _prefill_cuda(q, k, v, kv_len, *, variant, scale, block_k, softcap, window, causal):
    """Launch ``csrc/flash_prefill.cu`` on the current stream."""
    b, hq, sq, dh = q.shape
    _gqa.check_kv(q, k, v, kv_len)
    mma = _mla._takes_mma_body(q, k)
    q = q.contiguous()
    if mma:
        _gqa.check_mma_rows(q, k, v)
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty((b, hq, sq, dh), dtype=torch.float32, device=q.device)
    lib = _build.load()
    err = lib.amla_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, hq, k.shape[1], sq, dh, k.shape[2], block_k, *_gqa.kv_strides(k),
        *_gqa.kv_strides(v), float(scale), 0.0 if softcap is None else float(softcap),
        0 if window is None else int(window), 1 if causal else 0,
        1 if variant == "amla" else 0, 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_prefill")
    flash_prefill.launches += 1
    flash_prefill.mma_launches += mma
    return out


def _prefill_meta(q, k, v, kv_len, **_):
    return torch.empty(q.shape, device=q.device)


def prefill_cost(q, k, v, kv_len, *, window, causal):
    """K7's charge (``gqa_decode.attention_cost``): query positions count
    from 0; keys below ``kv_len`` (a host read), or below the cache
    length on meta."""
    b, hq, sq, _ = q.shape
    s = k.shape[2]
    lens = (torch.full((b,), s, dtype=torch.int64) if q.is_meta
            else kv_len.to("cpu", torch.int64))
    pos = torch.arange(sq, dtype=torch.int64).expand(b, sq)
    pairs, seen = _gqa.visible_keys(lens, pos, s=s, window=window, causal=causal)
    return _gqa.attention_cost(q, k, v, pairs, seen, heads_per_kv=hq // k.shape[1])


def _prefill_plain(q, k, v, kv_len, *, variant, scale, block_k, softcap, window, causal):
    b, hq, sq, _ = q.shape
    group = hq // k.shape[1]
    q_pos = torch.arange(sq, device=q.device).expand(b, sq)
    return _gqa.attend_plain(
        q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1),
        kv_len, q_pos, variant=variant, scale=scale, block_k=block_k,
        softcap=softcap, window=window, causal=causal,
    )


def flash_prefill(
    q: torch.Tensor,  # (B, Hq, Sq, Dh)
    k: torch.Tensor,  # (B, Hkv, S, Dh)
    v: torch.Tensor,  # (B, Hkv, S, Dh)
    kv_len: torch.Tensor,  # (B,)
    *,
    variant: str = "amla",
    scale: float,
    block_k: int = DEFAULT_BLOCK_K,
    softcap: float | None = None,
    window: int | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Flash prefill (K7); returns ``(B, Hq, Sq, Dh)`` fp32.

    A CUDA ``q`` launches the kernel (and counts one launch in
    ``flash_prefill.launches``); a CPU ``q`` runs the plain version; a
    meta ``q`` returns the output by shape.  A
    bf16 ``q`` runs the tensor-core body and counts in ``.mma_launches`` as
    well.  There is no fallback between the kernel and the plain version,
    nor between the two bodies: rows the tensor-core body cannot address
    raise ``ValueError``.
    """
    if variant not in ("amla", "base"):
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be a positive key count")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} is not a multiple of Hkv={k.shape[1]}")
    block_k = min(block_k, max(k.shape[2], 128))
    impl = _prefill_cuda if q.is_cuda else _prefill_meta if q.is_meta else _prefill_plain
    kw = dict(variant=variant, scale=scale, block_k=block_k, softcap=softcap, window=window,
              causal=causal)
    if not op_cost.counting():
        return impl(q, k, v, kv_len, **kw)
    with op_cost.kernel("flash_prefill",
                        lambda: prefill_cost(q, k, v, kv_len, window=window, causal=causal)):
        return impl(q, k, v, kv_len, **kw)


flash_prefill.launches = 0
flash_prefill.mma_launches = 0
