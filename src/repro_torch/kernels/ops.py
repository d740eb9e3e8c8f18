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

import dataclasses

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
    """Whether every value of ``x`` is 0: read on the host, or on the
    card (a sync); a meta tensor has no values and passes."""
    host = _host_values(x)
    if host is not None:
        return not np.any(host)
    if x.is_meta:
        return True
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
    misaligned answer.  Non-causal windowless attention (an encoder, a
    cross-attention) sees every key below ``kv_len`` from every position,
    so there the offset changes nothing and is not checked.
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

    positional = causal or window is not None
    if positional and q_offset is not None and not _all_zero(q_offset):
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
    reading a device tensor back would stall the stream) and for a meta
    tensor, which has no values."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.device.type == "cpu" else None
    return np.asarray(x)


def _validate_paged_geometry(
    q, kv_pages, block_tables, kv_len, block_k, kv_scales=None, scheduler="queue"
):
    """Fail fast, with actionable messages, on geometry the kernels would
    otherwise reject late (or worse, read garbage)."""
    b = q.shape[0]
    num_pages, page_size, dk_pages = kv_pages.shape
    if kv_pages.dtype == torch.int8:
        if kv_scales is None:
            raise ValueError(
                "int8 kv_pages need their per-row fp32 scale pool: pass "
                "kv_scales (PagedKVCache.scales) — symmetric int8 rows are "
                "meaningless without the dequant scales"
            )
        if scheduler != "queue":
            raise ValueError(
                f"scheduler={scheduler!r} does not support int8 pages; the "
                f"fused in-pipeline dequant lives in the work-queue kernel "
                f"(the padded (B, W) baseline stays bf16-only)"
            )
    if kv_scales is not None:
        if kv_pages.dtype != torch.int8:
            raise ValueError(
                f"kv_scales given but kv_pages dtype is {kv_pages.dtype} — "
                f"scale pools accompany int8 pools only"
            )
        if tuple(kv_scales.shape) != (num_pages, page_size):
            raise ValueError(
                f"kv_scales must be (num_pages={num_pages}, "
                f"page_size={page_size}) — one fp32 scale per page row; "
                f"got {tuple(kv_scales.shape)}"
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


@dataclasses.dataclass(frozen=True)
class DeviceQueue:
    """A plain decode schedule on the device: its six queue arrays
    (``items``), ``dest_table`` and ``n_splits`` as int32 tensors, with the
    host facts the kernels' shapes need.  :func:`mla_decode_paged` takes one
    as its ``schedule`` and reads it where it lies, so a caller that stages
    each step's schedule into the same tensors (a CUDA graph of the decode
    walk) reads no host value there."""

    items: tuple[torch.Tensor, ...]  # item_req, _block, _dest, _first, _last, _valid
    dest_table: torch.Tensor  # (B, num_splits)
    n_splits: torch.Tensor  # (B,)
    block_k: int
    num_dest_slots: int


def _schedule_tensors(schedule, device) -> DeviceQueue:
    """A :class:`~repro_torch.kernels.decode_schedule.DecodeSchedule` as a
    :class:`DeviceQueue` on ``device``, copied once per schedule and device
    (a ``DeviceQueue`` is returned as it is)."""
    if isinstance(schedule, DeviceQueue):
        return schedule
    key = str(device)
    if key not in schedule.device_arrays:
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        schedule.device_arrays[key] = DeviceQueue(
            tuple(i32(a) for a in schedule.prefetch_arrays()), i32(schedule.dest_table),
            i32(schedule.n_splits), schedule.block_k, schedule.num_dest_slots,
        )
    return schedule.device_arrays[key]


def _prefix_tensors(ps, device) -> tuple[torch.Tensor, ...]:
    """A :class:`~repro_torch.kernels.decode_schedule.PrefixSchedule`'s
    group arrays, prefix queue and combine tables on ``device``, copied
    once per schedule and device."""
    key = str(device)
    if key not in ps.device_arrays:
        g = ps.groups
        dest, n_live = ps.hetero_dest_tables()
        arrays = (g.group_member, g.group_rep, ps.prefix_lens, dest, n_live)
        if ps.prefix is not None:
            arrays += ps.prefix.prefetch_arrays()
        ps.device_arrays[key] = tuple(
            torch.as_tensor(a, dtype=torch.int32, device=device) for a in arrays
        )
    return ps.device_arrays[key]


_PARTIALS_NEED_QUEUE = (
    "return_partials needs the plain queue scheduler (padded and "
    "prefix-sharing paths merge heterogeneous partial sets and do not "
    "expose a per-row lse)"
)


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
    min_group: int = 2,
    compute_dtype=None,
    return_partials: bool = False,
):
    """MLA decode over a paged latent cache; returns ``(B, Sq, Hq, Dv)`` fp32.

    Query rows are ``(Sq, Hq)`` flattened, each head repeating its token's
    position: ``kv_len - Sq + arange(Sq)`` by default, ``q_offset +
    arange(Sq)``, or explicit ``q_positions (B, Sq)`` (queue scheduler
    only); ``causal=False`` lifts the causal bound.  ``compute_dtype``
    (default bf16) is the matmul dtype; pages are read in their storage
    dtype and cast per element.

    ``scheduler`` picks the kernel:

    * ``"queue"`` (default): the work-queue kernel (K2) over a schedule
      built host-side from ``kv_len`` unless a precomputed ``schedule`` is
      passed (a ``DecodeSchedule``, or a :class:`DeviceQueue` already on
      the device); requests with more than one block split across up to
      ``num_splits`` slots, merged by the combine kernel (K3), which runs
      on every call.  ``prefix_sharing=True`` (or a ``PrefixSchedule`` as
      ``schedule``) adds the group-batched prefix pass (K2′): requests
      whose tables alias the same leading pages (groups of at least
      ``min_group``) attend their shared blocks once per group over
      stacked queries, and the combine merges prefix and suffix partials.
      A nested ``PrefixSchedule`` (the prefix trie's topology) gives each
      group a window of blocks that may start past block 0, and a request
      one prefix partial per group of its chain: the same two launches
      and one combine over a wider table.
      ``kv_scales`` selects an int8 pool (K2-int8).  ``return_partials``
      (plain queue only; the padded and prefix-sharing paths raise the
      reference's ``ValueError``) returns ``(o, lse (B, Sq, Hq))``, the
      per-row logsumexp of K2's slot lse over each request's live split
      slots (plain torch, as the reference's ``jnp``), so a request whose
      KV lies in two pools merges exactly with
      :func:`repro_torch.core.distributed.combine_shard_partials`; an
      empty request's lse is ``-inf``.
    * ``"padded"``: the ``(B, W)`` baseline (K5), bf16/fp32 pools only.

    Value checks on ``kv_len`` / ``q_positions`` run when they are host data
    (numpy, lists or CPU tensors) and are skipped for CUDA tensors.
    """
    b, sq, hq, dk = q.shape
    dev = q.device
    compute_dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
    _validate_paged_geometry(
        q, kv_pages, block_tables, kv_len, block_k, kv_scales, scheduler
    )
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
    bt = torch.as_tensor(block_tables, device=dev)

    if return_partials and (scheduler != "queue" or prefix_sharing):
        raise ValueError(_PARTIALS_NEED_QUEUE)
    if scheduler == "padded":
        if prefix_sharing:
            raise ValueError(
                "prefix_sharing requires scheduler='queue' (the padded "
                "(B, W) grid walks every request independently and cannot "
                "batch shared-prefix groups)"
            )
        out = _mla_paged.mla_decode_paged_rows(
            q_rows, kv_pages, bt, lens, rows_pos, d_v=d_v, variant=variant,
            scale=scale, softcap=softcap,
        )
        return out.reshape(b, sq, hq, d_v)
    if scheduler != "queue":
        raise ValueError(f"unknown scheduler {scheduler!r}")

    page_size = kv_pages.shape[1]
    if block_k is None:
        block_k = default_paged_block_k(page_size, block_tables.shape[1])
    if isinstance(schedule, _sched.PrefixSchedule):
        prefix_sharing = True
    elif schedule is not None and prefix_sharing:
        raise ValueError(
            "prefix_sharing=True needs a decode_schedule.PrefixSchedule "
            f"(got {type(schedule).__name__}); build one with "
            "build_prefix_schedule or let schedule=None"
        )
    if schedule is not None and schedule.block_k != block_k:
        raise ValueError(
            f"schedule was built for block_k={schedule.block_k}, "
            f"call requested {block_k}"
        )
    kw = dict(d_v=d_v, variant=variant, scale=scale, block_k=block_k, softcap=softcap)
    host_lens = None
    if schedule is None:
        host_lens = _host_values(kv_len)
        if host_lens is None:
            host_lens = lens.cpu().numpy()
    if prefix_sharing:
        if return_partials:
            raise ValueError(_PARTIALS_NEED_QUEUE)
        ps = schedule
        if ps is None:
            host_bt = _host_values(block_tables)
            if host_bt is None:
                host_bt = bt.cpu().numpy()
            ps = _sched.build_prefix_schedule(
                host_lens, host_bt, page_size=page_size, block_k=block_k,
                num_splits=num_splits, min_group=min_group,
            )
        o_suf, lse_suf = _mla_paged.mla_decode_paged_queue_rows(
            q_rows, kv_pages, bt, lens, rows_pos, *_schedule_tensors(ps.suffix, dev).items,
            kv_scales,
            num_dest_slots=ps.suffix.num_dest_slots, **kw,
        )
        o_parts, lse_parts = [o_suf], [lse_suf]
        member, rep, prefix_lens, dest, n_live, *pitems = _prefix_tensors(ps, dev)
        if ps.num_groups:
            o_pref, lse_pref = _mla_paged.mla_decode_paged_group_prefix(
                q_rows, kv_pages, bt, rows_pos, member, rep, prefix_lens,
                *pitems, kv_scales, num_dest_slots=ps.prefix.num_dest_slots, **kw,
            )
            o_parts.append(o_pref)
            lse_parts.append(lse_pref)
        out = _combine.combine_hetero_partials(o_parts, lse_parts, dest, n_live)
        return out.reshape(b, sq, hq, d_v)

    if schedule is None:
        schedule = _sched.build_schedule(
            host_lens, block_k=block_k, num_splits=num_splits
        )
    queue = _schedule_tensors(schedule, dev)
    o_part, lse = _mla_paged.mla_decode_paged_queue_rows(
        q_rows, kv_pages, bt, lens, rows_pos, *queue.items, kv_scales,
        num_dest_slots=queue.num_dest_slots, **kw,
    )
    out = _combine.combine_split_partials(o_part, lse, queue.dest_table, queue.n_splits)
    if return_partials:
        return out.reshape(b, sq, hq, d_v), _rows_lse(lse, queue).reshape(b, sq, hq)
    return out.reshape(b, sq, hq, d_v)


def _rows_lse(lse: torch.Tensor, queue: DeviceQueue) -> torch.Tensor:
    """Each (request, row)'s logsumexp over its live split slots, (B, G):
    the lse of the combined output, in the normalized-partial format
    :func:`repro_torch.core.distributed.combine_shard_partials` merges.
    Columns of ``dest_table`` past ``n_splits`` (which repeat the last live
    slot) weigh 0; a request with no keys gets ``-inf``."""
    per_split = lse.reshape(lse.shape[0], -1)[queue.dest_table.long()]  # (B, S, G)
    cols = torch.arange(queue.dest_table.shape[1], device=lse.device)
    live = cols[None, :] < queue.n_splits[:, None]
    return torch.logsumexp(torch.where(live[..., None], per_split, -torch.inf), dim=1)
