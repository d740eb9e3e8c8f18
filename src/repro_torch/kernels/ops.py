"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``: the contiguous MLA decode, the GQA decode /
prefill dispatch, and the paged work-queue path).

They adapt the framework's ``(B, S, H, D)`` convention to the kernels'
row layouts, fill in default positions, validate geometry with the
reference's messages and error classes, build the decode schedule, and
run the kernels.  Every kernel runs its CUDA version on a CUDA tensor and
its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import decode_schedule as _sched
from repro_torch.kernels import flash_prefill as _prefill
from repro_torch.kernels import gqa_decode as _gqa
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import mla_decode_combine as _combine
from repro_torch.kernels import mla_decode_paged as _mla_paged


def _default_pos(b, sq, kv_len, sk, device):
    """``(kv_len (B,), q_pos (B, Sq))`` int32: queries are the last ``sq``
    positions of the keys (all ``sk`` of them when ``kv_len`` is None)."""
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=device)
    kv_len = torch.as_tensor(kv_len, device=device).to(torch.int32).reshape(b)
    base = torch.clamp_min(kv_len - sq, 0)
    q_pos = base[:, None] + torch.arange(sq, dtype=torch.int32, device=device)[None, :]
    return kv_len, q_pos


def _offset_pos(q_offset, sq, device):
    """``q_offset[:, None] + arange(sq)`` as int32 on ``device``."""
    off = torch.as_tensor(q_offset, device=device).to(torch.int32).reshape(-1)
    return off[:, None] + torch.arange(sq, dtype=torch.int32, device=device)[None, :]


def mla_decode(
    q: torch.Tensor,  # (B, Sq, Hq, Dk)
    c_kv: torch.Tensor,  # (B, S, Dk)
    *,
    d_v: int = 512,
    variant: str = "amla",
    scale: float,
    kv_len=None,
    causal: bool = True,
    q_offset=None,
    block_k: int = _mla.DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """MLA decode over a contiguous latent cache (K4); ``(B, Sq, Hq, Dv)``
    fp32.  Rows are ``(Sq, Hq)`` flattened, every head at its token's
    position: ``kv_len - Sq + arange(Sq)`` by default, ``q_offset +
    arange(Sq)`` when given; ``causal=False`` lifts the causal bound.
    Queries run in bf16; the cache is rounded to bf16 where it is read."""
    b, sq, hq, dk = q.shape
    dev = q.device
    sk = c_kv.shape[1]
    kv_len, q_pos = _default_pos(b, sq, kv_len, sk, dev)
    if q_offset is not None:
        q_pos = _offset_pos(q_offset, sq, dev)
    if not causal:
        q_pos = torch.full((b, sq), sk, dtype=torch.int32, device=dev)
    # rows = (Sq, Hq) flattened; every head of one token shares a position.
    rows_pos = torch.repeat_interleave(q_pos, hq, dim=1)  # (B, Sq*Hq)
    q_rows = q.reshape(b, sq * hq, dk).to(torch.bfloat16)
    out = _mla.mla_decode_rows(
        q_rows, c_kv, kv_len, rows_pos, d_v=d_v, variant=variant, scale=scale,
        block_k=block_k,
    )
    return out.reshape(b, sq, hq, d_v)


def _all_zero(x) -> bool:
    host = _host_values(x)
    if host is not None:
        return not np.any(host)
    return not bool(torch.any(x != 0))


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,  # (B, Sk, Hkv, Dh)
    *,
    variant: str = "amla",
    causal: bool = False,
    window: int | None = None,
    softcap: float | None = None,
    scale: float,
    kv_len=None,
    q_offset=None,
    decode_threshold: int = 8,
) -> torch.Tensor:
    """GQA/MQA/MHA attention in ``q``'s dtype: decode-shaped calls (Sq <=
    ``decode_threshold``) go to the decode kernel (K6), longer ones to the
    flash prefill (K7).

    ``k``/``v`` are transposed to the kernels' ``(B, Hkv, Sk, Dh)`` as
    views; a ``(B, Hkv, Sk, Dh)`` cache passed as ``k_cache.transpose(1,
    2)`` reaches the kernels where it lies, with no copy.  The flash
    prefill counts query positions from 0 (the reference's kernel takes
    no offset), so a nonzero ``q_offset`` with Sq > ``decode_threshold``
    raises ``ValueError`` rather than return the reference's silently
    misaligned answer.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    kb = k.transpose(1, 2).to(torch.bfloat16)
    vb = v.transpose(1, 2).to(torch.bfloat16)
    if sq <= decode_threshold:
        kv_len_a, q_pos = _default_pos(b, sq, kv_len, sk, dev)
        if q_offset is not None:
            q_pos = _offset_pos(q_offset, sq, dev)
        if not causal and sq > 1:
            q_pos = torch.full((b, sq), sk, dtype=torch.int32, device=dev)
        # rows within a kv head: (Sq, group) — position repeats per group.
        rows_pos = torch.repeat_interleave(q_pos, group, dim=1)  # (B, Sq*group)
        qr = (
            q.reshape(b, sq, hkv, group, dh)
            .permute(0, 2, 1, 3, 4)
            .reshape(b, hkv, sq * group, dh)
        )
        out = _gqa.gqa_decode_rows(
            qr.to(torch.bfloat16), kb, vb, kv_len_a, rows_pos, variant=variant,
            scale=scale, softcap=softcap, window=window,
        )
        out = out.reshape(b, hkv, sq, group, dh).permute(0, 2, 1, 3, 4)
        return out.reshape(b, sq, hq, dh).to(q.dtype)

    if q_offset is not None and not _all_zero(q_offset):
        raise ValueError(
            f"q_offset must be 0 for Sq={sq} > decode_threshold="
            f"{decode_threshold}: the flash prefill kernel counts query "
            "positions from 0 (the reference ignores the offset there)"
        )
    kv_len_a = (
        torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(b)
        if kv_len is not None
        else torch.full((b,), sk, dtype=torch.int32, device=dev)
    )
    out = _prefill.flash_prefill(
        q.transpose(1, 2).to(torch.bfloat16), kb, vb, kv_len_a, variant=variant,
        scale=scale, softcap=softcap, window=window, causal=causal,
    )
    return out.transpose(1, 2).to(q.dtype)


def default_paged_block_k(page_size: int, table_width: int) -> int:
    """§4.2 KV-block size for the work-queue path: 512 rows (4 pages of
    128), in units of whole pages, clamped to the table's capacity."""
    pages_per_block = max(1, _mla.DEFAULT_BLOCK_K // page_size)
    return page_size * min(pages_per_block, max(table_width, 1))


def _host_values(x) -> np.ndarray | None:
    """Host copy of ``x`` for value checks, or None for device data (the
    checks then skip, as they do for a traced array in the reference —
    reading a device tensor back would stall the stream)."""
    if isinstance(x, torch.Tensor):
        return None if x.is_cuda else x.numpy()
    return np.asarray(x)


def _validate_paged_geometry(
    q, kv_pages, block_tables, kv_len, block_k, kv_scales=None, scheduler="queue"
):
    """Fail fast, with actionable messages, on geometry the kernels would
    otherwise reject late (or worse, read garbage)."""
    b = q.shape[0]
    num_pages, page_size, dk_pages = kv_pages.shape
    if kv_pages.dtype == torch.int8 or kv_scales is not None:
        raise NotImplementedError(
            "int8 pages with kv_scales are not ported yet: the quantized "
            "queue kernel comes in a later slice of the port"
        )
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"block_tables must be (B={b}, W); got {tuple(block_tables.shape)} — "
            f"one row of logical->physical page ids per request"
        )
    w = block_tables.shape[1]
    if w < 1:
        raise ValueError(
            "block_tables must have at least one page column (W >= 1); "
            "use PagedKVCache.block_table, which pads empty sequences to "
            "width 1"
        )
    if q.shape[-1] != dk_pages:
        raise ValueError(
            f"q feature width {q.shape[-1]} != page row width {dk_pages}; "
            f"queries and the latent page pool must share D_k"
        )
    if block_k is not None and (block_k < page_size or block_k % page_size):
        raise ValueError(
            f"block_k={block_k} must be a positive multiple of the pool's "
            f"page_size={page_size} (one work item covers whole pages; "
            f"e.g. block_k={max(block_k // page_size, 1) * page_size or page_size}"
            f" or leave block_k=None for the §4.2 default)"
        )
    lens = _host_values(kv_len)
    if lens is not None:
        lens = lens.reshape(-1)
        if lens.size and int(lens.max()) > w * page_size:
            worst = int(np.argmax(lens))
            raise ValueError(
                f"kv_len[{worst}]={int(lens.max())} exceeds the block "
                f"table's reach W*page_size={w}*{page_size}={w * page_size}"
                f" rows; widen block_tables (PagedKVCache.block_table("
                f"width=...)) or check kv_len bookkeeping"
            )


def _validate_q_positions(q_positions, b, sq, kv_len, scheduler, q_offset, causal):
    """Fail fast on the multi-row position surface."""
    if scheduler == "padded":
        raise NotImplementedError(
            "q_positions (the multi-row speculative-decode surface) is only "
            "implemented for scheduler='queue'; the padded (B, W) grid "
            "derives row positions from kv_len and has no per-row override"
        )
    if q_offset is not None:
        raise ValueError(
            "pass q_positions or q_offset, not both — q_positions already "
            "carries every row's absolute position"
        )
    if not causal:
        raise ValueError(
            "q_positions with causal=False is contradictory: explicit "
            "per-row positions exist to apply per-row causal masks"
        )
    shape = tuple(q_positions.shape)
    if shape != (b, sq):
        raise ValueError(
            f"q_positions must be (B={b}, Sq={sq}) — one absolute position "
            f"per query token row (heads share their token's position); "
            f"got {shape}"
        )
    arr = _host_values(q_positions)
    if arr is None:
        return
    if arr.size and int(arr.min()) < 0:
        raise ValueError(
            f"q_positions must be non-negative; got min {int(arr.min())} "
            f"(negative rows are the kernels' internal padding convention, "
            f"not a caller surface)"
        )
    if sq > 1 and np.any(np.diff(arr.astype(np.int64), axis=1) <= 0):
        bad = int(np.argmax(np.any(np.diff(arr, axis=1) <= 0, axis=1)))
        raise ValueError(
            f"q_positions must be strictly increasing per request "
            f"(speculative rows verify in sequence order); request {bad} "
            f"has {arr[bad].tolist()}"
        )
    lens = _host_values(kv_len)
    if lens is not None:
        over = arr >= lens.reshape(-1)[:, None]
        if np.any(over):
            bad = int(np.argmax(np.any(over, axis=1)))
            raise ValueError(
                f"q_positions[{bad}] reaches {int(arr[bad].max())} but "
                f"kv_len[{bad}]={int(lens.reshape(-1)[bad])}: every verify row "
                f"must already have its latent in the cache (append the k rows "
                f"before attending)"
            )


def _schedule_tensors(schedule, device) -> tuple[torch.Tensor, ...]:
    """The schedule's queue arrays, dest table and split counts as int32
    tensors on ``device``, copied once per schedule and device."""
    key = str(device)
    if key not in schedule.device_arrays:
        arrays = (*schedule.prefetch_arrays(), schedule.dest_table, schedule.n_splits)
        schedule.device_arrays[key] = tuple(
            torch.as_tensor(a, dtype=torch.int32, device=device) for a in arrays
        )
    return schedule.device_arrays[key]


def mla_decode_paged(
    q: torch.Tensor,  # (B, Sq, Hq, Dk)
    kv_pages: torch.Tensor,  # (P, page_size, Dk) physical page pool
    block_tables: torch.Tensor,  # (B, W) int32 logical -> physical page ids
    kv_len,  # (B,) int32 valid tokens per request (host array or tensor)
    *,
    kv_scales=None,
    d_v: int = 512,
    variant: str = "amla",
    scale: float,
    causal: bool = True,
    q_offset=None,
    q_positions=None,
    softcap: float | None = None,
    scheduler: str = "queue",
    block_k: int | None = None,
    num_splits: int = 1,
    schedule=None,
    prefix_sharing: bool = False,
    compute_dtype=None,
) -> torch.Tensor:
    """MLA decode over a paged latent cache; returns ``(B, Sq, Hq, Dv)`` fp32.

    Query rows are ``(Sq, Hq)`` flattened, each head repeating its token's
    position: ``kv_len - Sq + arange(Sq)`` by default, ``q_offset +
    arange(Sq)``, or explicit ``q_positions (B, Sq)``; ``causal=False``
    lifts the causal bound.  The work queue is built host-side from
    ``kv_len`` unless a precomputed ``schedule`` (a
    :class:`~repro_torch.kernels.decode_schedule.DecodeSchedule` for the
    same block counts) is passed; requests with more than one block split
    across up to ``num_splits`` slots, merged by the combine kernel, which
    runs on every call.  ``compute_dtype`` (default bf16) is the matmul
    dtype; pages are read in their storage dtype and cast per element.

    Value checks on ``kv_len`` / ``q_positions`` run when they are host data
    (numpy, lists or CPU tensors) and are skipped for CUDA tensors.
    ``prefix_sharing``, ``kv_scales`` (int8 pools) and
    ``scheduler="padded"`` belong to later slices of the port and raise
    ``NotImplementedError``.
    """
    b, sq, hq, dk = q.shape
    dev = q.device
    compute_dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
    if scheduler == "padded":
        raise NotImplementedError(
            "scheduler='padded' (the (B, W) baseline kernel) is not ported "
            "yet; it comes in a later slice of the port"
        )
    if scheduler != "queue":
        raise ValueError(f"unknown scheduler {scheduler!r}")
    if prefix_sharing:
        raise NotImplementedError(
            "prefix_sharing (the group-batched shared-prefix kernel) is not "
            "ported yet; it comes in a later slice of the port"
        )
    _validate_paged_geometry(q, kv_pages, block_tables, kv_len, block_k, kv_scales)
    if q_positions is not None:
        _validate_q_positions(q_positions, b, sq, kv_len, scheduler, q_offset, causal)
    lens = torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(-1)
    steps = torch.arange(sq, dtype=torch.int32, device=dev)[None, :]
    q_pos = torch.clamp_min(lens - sq, 0)[:, None] + steps
    if q_offset is not None:
        q_pos = torch.as_tensor(q_offset, device=dev).to(torch.int32)[:, None] + steps
    if q_positions is not None:
        q_pos = torch.as_tensor(q_positions, device=dev).to(torch.int32)
    if not causal:
        cap = block_tables.shape[1] * kv_pages.shape[1]
        q_pos = torch.full((b, sq), cap, dtype=torch.int32, device=dev)
    rows_pos = torch.repeat_interleave(q_pos, hq, dim=1)  # (B, Sq*Hq)
    q_rows = q.reshape(b, sq * hq, dk).to(compute_dtype)

    page_size = kv_pages.shape[1]
    if block_k is None:
        block_k = default_paged_block_k(page_size, block_tables.shape[1])
    if schedule is not None and schedule.block_k != block_k:
        raise ValueError(
            f"schedule was built for block_k={schedule.block_k}, "
            f"call requested {block_k}"
        )
    if schedule is None:
        host_lens = _host_values(kv_len)
        if host_lens is None:
            host_lens = lens.cpu().numpy()
        schedule = _sched.build_schedule(
            host_lens, block_k=block_k, num_splits=num_splits
        )
    *items, dest_table, n_splits = _schedule_tensors(schedule, dev)
    o_part, lse = _mla_paged.mla_decode_paged_queue_rows(
        q_rows,
        kv_pages,
        torch.as_tensor(block_tables, device=dev),
        lens,
        rows_pos,
        *items,
        d_v=d_v,
        variant=variant,
        scale=scale,
        block_k=block_k,
        num_dest_slots=schedule.num_dest_slots,
        softcap=softcap,
    )
    out = _combine.combine_split_partials(o_part, lse, dest_table, n_splits)
    return out.reshape(b, sq, hq, d_v)
