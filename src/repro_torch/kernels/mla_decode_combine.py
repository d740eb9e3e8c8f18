"""Split-KV combine for work-queue AMLA decode (flash-decoding stage 2).

Counterpart of ``repro/kernels/mla_decode_combine.py``.  The queue kernel
may split a long request's KV blocks across destination slots; each slot
holds a *normalized* partial ``o_i`` and its log-sum-exp
``lse_i = m_i + log(l_i)``.  Exact recombination is the softmax-weighted
average

    o = sum_i exp(lse_i - M) * o_i / sum_i exp(lse_i - M),   M = max_i lse_i

taken as a running ``(acc, m, w)`` merge over the first ``n_splits[b]``
slots of ``dest_table[b]``.  The running max starts at :data:`BIG_NEG`, so
an empty partial (``lse == -inf``) weighs exactly 0 and a request with no
live split gives exact zeros.

On a CUDA tensor :func:`combine_split_partials` launches
``csrc/mla_decode_combine.cu``; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# Finite stand-in for -inf in the running max so that fully-empty slots
# (lse == -inf) contribute exp(-inf - BIG_NEG) == 0 instead of NaN.
BIG_NEG = -3.0e38


def _combine_plain(o_part, lse, dest_table, n_splits):
    d, g, d_v = o_part.shape
    b, s = dest_table.shape
    dev = o_part.device
    acc = torch.zeros((b, g, d_v), dtype=torch.float32, device=dev)
    m = torch.full((b, g, 1), BIG_NEG, dtype=torch.float32, device=dev)
    w = torch.zeros((b, g, 1), dtype=torch.float32, device=dev)
    dest_table = dest_table.to(device=dev, dtype=torch.long)
    n_splits = n_splits.to(dev)
    for j in range(s):
        live = (j < n_splits)[:, None, None]
        slot = dest_table[:, j]
        lse_j, o_j = lse[slot], o_part[slot]
        m_new = torch.maximum(m, lse_j)
        alpha = torch.exp(m - m_new)
        w_j = torch.exp(lse_j - m_new)  # 0 for empty partials (lse == -inf)
        acc = torch.where(live, acc * alpha + w_j * o_j, acc)
        w = torch.where(live, w * alpha + w_j, w)
        m = torch.where(live, m_new, m)
    safe = torch.where(w > 0, w, torch.ones_like(w))
    return torch.where(w > 0, acc / safe, torch.zeros_like(acc))


def _combine_cuda(o_part, lse, dest_table, n_splits):
    d, g, d_v = o_part.shape
    b, s = dest_table.shape
    dev = o_part.device
    if o_part.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError("o_part and lse must be float32")
    if lse.shape != (d, g, 1):
        raise ValueError(f"lse must be (D={d}, G={g}, 1); got {tuple(lse.shape)}")
    if d_v > 512:
        raise ValueError(f"d_v={d_v}: the kernel takes d_v <= 512")
    for name, t in (("lse", lse), ("dest_table", dest_table), ("n_splits", n_splits)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, o_part on {dev}")
    o_part, lse = o_part.contiguous(), lse.contiguous()
    dest_table = dest_table.to(torch.int32).contiguous()
    n_splits = n_splits.to(torch.int32).contiguous()
    out = torch.empty((b, g, d_v), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.amla_combine_split_partials(
        o_part.data_ptr(), lse.data_ptr(), dest_table.data_ptr(),
        n_splits.data_ptr(), out.data_ptr(), b, g, d_v, s,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "combine_split_partials")
    combine_split_partials.launches += 1
    return out


def combine_split_partials(
    o_part: torch.Tensor,  # (D, G, Dv) f32 normalized partial outputs
    lse: torch.Tensor,  # (D, G, 1) f32 log-sum-exp per partial
    dest_table: torch.Tensor,  # (B, S) int32 slot ids (see decode_schedule)
    n_splits: torch.Tensor,  # (B,) int32 live splits per request
) -> torch.Tensor:
    """Merge per-slot split-KV partials into ``(B, G, Dv)`` fp32 outputs.

    A CUDA ``o_part`` launches the kernel (one more in
    ``combine_split_partials.launches``); a CPU one runs the plain version.
    """
    impl = _combine_cuda if o_part.is_cuda else _combine_plain
    return impl(o_part, lse, dest_table, n_splits)


combine_split_partials.launches = 0
