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

:func:`combine_hetero_partials` merges partials of two passes (the
shared-prefix path): the kernel reads both where they lie, the plain
version concatenates them first.

On a CUDA tensor both launch ``csrc/mla_decode_combine.cu``; on a CPU
tensor they run the plain version; on a meta tensor they return the
output by shape.  Under a counter (:mod:`repro_torch.roofline.op_cost`)
each launch charges :func:`combine_cost`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import op_cost

# Finite stand-in for -inf in the running max so that fully-empty slots
# (lse == -inf) contribute exp(-inf - BIG_NEG) == 0 instead of NaN.
BIG_NEG = -3.0e38


def combine_cost(o_part, dest_table, n_splits):
    """K3's charge: 3 * Dv operations per (row, live split), and the live
    partials with their lse and the fp32 output read or written once.
    Live splits come from ``n_splits`` (a host read); on meta every slot of
    the table is live."""
    _, g, d_v = o_part.shape
    b, s = dest_table.shape
    live = b * s if o_part.is_meta else int(n_splits.to(torch.int64).clamp(max=s).sum())
    return 3.0 * d_v * g * live, (live * g * (d_v + 1) + b * g * d_v) * 4


def _combine(o_parts, lse_parts, dest_table, n_splits):
    """One K3 launch over one or two sources (the kernel), their
    concatenation (the plain version), or the output by shape (meta)."""
    o0 = o_parts[0]
    if not op_cost.counting():
        return _combine_any(o_parts, lse_parts, dest_table, n_splits)
    with op_cost.kernel("combine_split_partials",
                        lambda: combine_cost(o0, dest_table, n_splits)):
        return _combine_any(o_parts, lse_parts, dest_table, n_splits)


def _combine_any(o_parts, lse_parts, dest_table, n_splits):
    """The launch on ``o_parts[0]``'s device: the kernel, the output by
    shape, or the plain version over the sources' concatenation."""
    o0 = o_parts[0]
    if o0.is_cuda:
        return _combine_cuda(o_parts, lse_parts, dest_table, n_splits)
    if o0.is_meta:
        return torch.empty((dest_table.shape[0], *o0.shape[1:]), device=o0.device)
    o_all = o0 if len(o_parts) == 1 else torch.cat(o_parts, 0)
    lse_all = lse_parts[0] if len(lse_parts) == 1 else torch.cat(lse_parts, 0)
    return _combine_plain(o_all, lse_all, dest_table, n_splits)


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


def _combine_cuda(o_parts, lse_parts, dest_table, n_splits):
    """One launch of ``csrc/mla_decode_combine.cu`` merging the partials of
    one or two sources (slot ``s < D0`` of the first, ``s - D0`` of the
    second) where they lie: no concatenated copy, nothing allocated but
    the output."""
    if not 1 <= len(o_parts) <= 2 or len(lse_parts) != len(o_parts):
        raise ValueError(
            f"the kernel merges one or two sources; got {len(o_parts)} partial "
            f"and {len(lse_parts)} lse arrays"
        )
    _, g, d_v = o_parts[0].shape
    dev = o_parts[0].device
    for i, (o, lse) in enumerate(zip(o_parts, lse_parts)):
        if o.dtype != torch.float32 or lse.dtype != torch.float32:
            raise TypeError("o_part and lse must be float32")
        if o.dim() != 3 or o.shape[1:] != (g, d_v):
            raise ValueError(
                f"source {i} has partials {tuple(o.shape)}; every source must "
                f"share G={g} and Dv={d_v}"
            )
        if lse.shape != (o.shape[0], g, 1):
            raise ValueError(
                f"lse must be (D={o.shape[0]}, G={g}, 1); got {tuple(lse.shape)}"
            )
        for name, t in (("o_part", o), ("lse", lse)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, o_part on {dev}")
    for name, t in (("dest_table", dest_table), ("n_splits", n_splits)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, o_part on {dev}")
    o_parts = [o.contiguous() for o in o_parts]
    lse_parts = [lse.contiguous() for lse in lse_parts]
    dest_table = dest_table.to(torch.int32).contiguous()
    n_splits = n_splits.to(torch.int32).contiguous()
    b, s = dest_table.shape
    out = torch.empty((b, g, d_v), dtype=torch.float32, device=dev)
    second = len(o_parts) == 2
    lib = _build.load()
    err = lib.amla_combine_split_partials(
        o_parts[0].data_ptr(), lse_parts[0].data_ptr(),
        o_parts[1].data_ptr() if second else None, lse_parts[1].data_ptr() if second else None,
        dest_table.data_ptr(), n_splits.data_ptr(), out.data_ptr(), o_parts[0].shape[0],
        b, g, d_v, s, torch.cuda.current_stream(dev).cuda_stream,
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
    ``combine_split_partials.launches``); a CPU one runs the plain version;
    a meta one returns the output by shape.
    """
    return _combine([o_part], [lse], dest_table, n_splits)


combine_split_partials.launches = 0


def combine_hetero_partials(
    o_parts: list[torch.Tensor],  # each (Di, G, Dv) f32 normalized partials
    lse_parts: list[torch.Tensor],  # each (Di, G, 1) f32
    dest_table: torch.Tensor,  # (B, S) slot ids into the concatenated array
    n_splits: torch.Tensor,  # (B,) live partials per request
) -> torch.Tensor:
    """Merge partials drawn from heterogeneous sources (a per-request
    suffix pass and a group-batched shared-prefix pass): ``dest_table``
    points into the sources' concatenation along the slot axis
    (``decode_schedule.PrefixSchedule.hetero_dest_tables`` builds it).

    On CUDA tensors one or two sources are merged where they lie by one
    kernel launch (counted in ``combine_split_partials.launches``); on CPU
    tensors the plain version runs on the concatenation, which is the
    reference's definition."""
    return _combine(o_parts, lse_parts, dest_table, n_splits)
