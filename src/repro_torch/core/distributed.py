"""Merging attention partials across shards (counterpart of
``repro/core/distributed.py``'s ``combine_partials`` and
``combine_shard_partials``).

A request whose KV is split between shards (or between two page pools of
one card) is attended shard by shard; each shard returns its partial,
and one log-sum-exp merge reconciles them:

    M = max_s lse_s
    O = sum_s exp(lse_s - M) * o_s  /  sum_s exp(lse_s - M)

The merge runs once per step, outside any kernel, in plain torch, as the
reference's does in ``jnp``.  The reference's sequence-parallel decodes
over a mesh (``seq_parallel_decode``, ``gqa_split_kv_decode``,
``seq_parallel_decode_batched``) are not ported here.
"""

from __future__ import annotations

import torch

# An lse at or below this marks a shard that saw no valid key (the
# kernels' BIG_NEG, about -3e38, or -inf).
EMPTY_LSE = -1.0e38


def combine_partials(acc, m, l) -> torch.Tensor:
    """LSE-combine un-normalised residuals along a leading shard axis.

    acc: (S, G, Dv), m: (S, G), l: (S, G)  ->  (G, Dv) normalised output
    (zero where no shard saw a key)."""
    m_star = torch.amax(m, dim=0)
    w = torch.exp(m - m_star[None])  # (S, G)
    num = torch.sum(acc * w[..., None], dim=0)
    den = torch.sum(l * w, dim=0)
    safe = torch.where(den > 0, den, 1.0)
    return torch.where(den[:, None] > 0, num / safe[:, None], 0.0)


def combine_shard_partials(o_parts, lse_parts) -> torch.Tensor:
    """Merge *normalized* per-shard partials, the paged queue kernel's
    format (``o_s = acc_s / l_s``, ``lse_s = m_s + log l_s``;
    :func:`repro_torch.kernels.ops.mla_decode_paged` with
    ``return_partials=True``).

    o_parts: (S, ..., Dv), lse_parts: (S, ...) -> (..., Dv) fp32.  A shard
    whose lse is at or below ``EMPTY_LSE`` (BIG_NEG or ``-inf``) weighs 0
    whatever its ``o`` holds, and a row where every shard is empty is
    exact zeros.  The mask reads the raw lse: after the max shift an
    all-empty row would weigh each shard ``exp(0) = 1`` (BIG_NEG) or NaN
    (``-inf - -inf``), and both are replaced, not multiplied, so no NaN
    passes the ``where``."""
    o_parts = torch.as_tensor(o_parts).float()
    lse_parts = torch.as_tensor(lse_parts).float()
    valid = lse_parts > EMPTY_LSE
    m_star = torch.amax(lse_parts, dim=0)
    w = torch.where(valid, torch.exp(lse_parts - m_star[None]), 0.0)
    num = torch.sum(torch.where(valid[..., None], o_parts * w[..., None], 0.0), dim=0)
    den = torch.sum(w, dim=0)
    safe = torch.where(den > 0, den, 1.0)
    return torch.where(den[..., None] > 0, num / safe[..., None], 0.0)
