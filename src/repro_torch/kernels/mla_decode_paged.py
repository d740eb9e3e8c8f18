"""Paged MLA decode: AMLA over a block-table KV cache.

Counterpart of ``repro/kernels/mla_decode_paged.py``.  The latents live in
a shared pool of pages ``(num_pages, page_size, 576)``; each request owns
an ordered list of physical page ids (its block table).  Three entry
points, as in the reference:

* :func:`mla_decode_paged_queue_rows` (K2): a host-side schedule
  (:mod:`repro_torch.kernels.decode_schedule`) lists one work item per
  (request, ``block_k``-row KV block); the kernel walks it, runs one AMLA
  state update per block, and writes a normalized partial ``(o, lse)`` per
  destination slot for :mod:`repro_torch.kernels.mla_decode_combine` to
  merge.  With ``kv_scales`` it reads an int8 pool (K2-int8): symmetric
  per-row int8 latents whose fp32 scales multiply the scores and are
  folded into the probabilities.
* :func:`mla_decode_paged_group_prefix` (K2′): shared-prefix attention
  once per group of requests whose tables alias the same leading pages;
  the members' query rows are stacked and K2 runs over the shared blocks.
* :func:`mla_decode_paged_rows` (K5): the padded ``(B, W)`` baseline, one
  AMLA update per page, bf16/fp32 pools only.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/mla_decode_paged.cu``, ``csrc/mla_decode_paged_padded.cu``) and
counts the launch; on a CPU tensor it runs the plain PyTorch version
beside it, which walks the same items in the same order with the same
int32 rescale.  K2 and K2′ with a bf16 ``q`` over a bf16 or an int8 pool,
and K5 with a bf16 ``q`` over a bf16 pool, run the tensor-core row body
(``csrc/mla_rows_mma.cuh``) and count it in their ``mma_launches`` as
well; an fp32 ``q`` or an fp32 pool runs the scalar body
(``csrc/mla_rows.cuh``).  The selection and the geometry checks are
:mod:`repro_torch.kernels.mla_decode`'s, shared with K4.  Under a
counter (:mod:`repro_torch.roofline.op_cost`) each launch charges
:func:`queue_cost` (K2, K2′: from the host work queue) or
:func:`padded_cost` (K5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import numerics
from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels.mla_decode import (
    _check_mma_alignment,
    _check_mma_geometry,
    _takes_mma_body,
)
from repro_torch.roofline import op_cost

DEFAULT_PAGE_SIZE = 128


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Storage layout of a paged latent pool: dtype + scale granularity.

    ``int8`` pools store symmetric per-row int8 latents with a companion
    fp32 scale pool of one scale per page row, which every read path
    dequantizes against (``runtime.kv_cache`` writes both).
    """

    dtype: object = torch.bfloat16
    scale_granularity: str = "row"

    _NAMES = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}

    def __post_init__(self):
        if isinstance(self.dtype, str):
            if self.dtype not in self._NAMES:
                raise ValueError(
                    f"unknown cache dtype {self.dtype!r}; choose from "
                    f"{sorted(self._NAMES)}"
                )
            object.__setattr__(self, "dtype", self._NAMES[self.dtype])
        if self.scale_granularity != "row":
            raise NotImplementedError(
                f"scale_granularity={self.scale_granularity!r}: only 'row' "
                f"(one fp32 scale per page row) is implemented"
            )

    @property
    def quantized(self) -> bool:
        return self.dtype == torch.int8

    def bytes_per_row(self, width: int) -> int:
        """Device-memory bytes one latent row costs, scales included."""
        n = width * torch.empty((), dtype=self.dtype).element_size()
        return n + (4 if self.quantized else 0)

    def bytes_per_page(self, page_size: int, width: int) -> int:
        """Bytes one page read moves (data strip + scale strip)."""
        return page_size * self.bytes_per_row(width)


def clamp_tail_pages(
    block_tables: torch.Tensor,  # (B, W) int32
    kv_len: torch.Tensor,  # (B,) int32
    page_size: int,
    num_pages: int,
) -> torch.Tensor:
    """Point tail block-table entries at the request's own last valid page.

    Entries past ``ceil(kv_len / page_size)`` are padding; requests with
    ``kv_len == 0`` fall back to their (clamped) first entry.  Ids are
    clipped into ``[0, num_pages)``.
    """
    bt = block_tables.to(torch.int32)
    w = bt.shape[1]
    pages_used = -torch.div(-kv_len.to(torch.int64), page_size, rounding_mode="floor")
    last_idx = torch.clamp(pages_used - 1, 0, w - 1)
    last_page = torch.gather(bt, 1, last_idx[:, None])
    col = torch.arange(w, device=bt.device)[None, :]
    bt = torch.where(col < pages_used[:, None], bt, last_page)
    return torch.clamp(bt, 0, num_pages - 1)


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.int64).numpy()


def queue_cost(q, kv_pages, kv_len, q_pos, items, kv_scales, *, d_v, block_k,
               num_dest_slots):
    """K2's charge (K2′'s over its stacked rows), from the host work queue:
    2 * (Dk + Dv) operations per (row, visible key) of each valid item's
    block, and q, the pool rows each item reads below its request's
    ``kv_len`` (their int8 scales too) and the fp32 partials and lse read
    or written once."""
    _, g, d_k = q.shape
    req, blk, _, _, _, valid = (_host(t) for t in items)
    lens, pos = _host(kv_len), _host(q_pos)
    live = valid != 0
    req, start = req[live], blk[live] * block_k
    end = np.minimum(start + block_k, lens[req])
    rows = np.clip(end - start, 0, None)
    vis = np.clip(np.minimum(end[:, None], pos[req] + 1) - start[:, None], 0, None)
    row_bytes = d_k * kv_pages.element_size() + (4 if kv_scales is not None else 0)
    nbytes = (q.numel() * q.element_size() + int(rows.sum()) * row_bytes
              + num_dest_slots * g * (d_v + 1) * 4)
    return 2.0 * (d_k + d_v) * int(vis.sum()), nbytes


def padded_cost(q, kv_pages, block_tables, kv_len, q_pos, *, d_v):
    """K5's charge: 2 * (Dk + Dv) operations per (row, visible key), and q,
    each request's rows below its ``kv_len`` and the fp32 output read or
    written once."""
    b, g, d_k = q.shape
    lens = np.minimum(_host(kv_len), block_tables.shape[1] * kv_pages.shape[1])
    pos = _host(q_pos)
    vis = np.clip(np.minimum(lens[:, None], pos + 1), 0, None)
    nbytes = (q.numel() * q.element_size() + int(lens.sum()) * d_k * kv_pages.element_size()
              + b * g * d_v * 4)
    return 2.0 * (d_k + d_v) * int(vis.sum()), nbytes


def _queue_rows_plain(
    q, kv_pages, block_tables, kv_len, q_pos, items, kv_scales, *,
    d_v, variant, scale, block_k, num_dest_slots, softcap,
):
    """Plain PyTorch version of the queue kernel: the reference's grid
    walk, item by item, with the state of the current destination slot."""
    b, g, d_k = q.shape
    num_pages, page_size, _ = kv_pages.shape
    n_sub = block_k // page_size
    bt = clamp_tail_pages(block_tables, kv_len, page_size, num_pages)
    req_a, blk_a, dst_a, fst_a, lst_a, vld_a = (
        np.asarray(a.cpu()) for a in items
    )
    lens = kv_len.tolist()
    dev = q.device
    o_part = torch.zeros((num_dest_slots, g, d_v), dtype=torch.float32, device=dev)
    lse = torch.full((num_dest_slots, g, 1), -torch.inf, dtype=torch.float32, device=dev)
    st = None
    for t in range(len(req_a)):
        if fst_a[t]:
            st = _mla.init_decode_state(g, d_v, dev)
        if not vld_a[t]:
            continue
        req, blk = int(req_a[t]), int(blk_a[t])
        k_len = lens[req]
        start = blk * block_k
        # Gather the block's pages (and scale strips); pages past kv_len
        # are zero-filled, as the reference does in VMEM, instead of read.
        c_blk = torch.zeros((block_k, d_k), dtype=kv_pages.dtype, device=dev)
        sig = None
        if kv_scales is not None:
            sig = torch.zeros((block_k,), dtype=torch.float32, device=dev)
        for j in range(n_sub):
            if start + j * page_size < k_len:
                pid = bt[req, blk * n_sub + j]
                c_blk[j * page_size : (j + 1) * page_size] = kv_pages[pid]
                if sig is not None:
                    sig[j * page_size : (j + 1) * page_size] = kv_scales[pid]
        s = q[req].to(torch.float32) @ c_blk.to(q.dtype).to(torch.float32).T
        if sig is not None:
            s = s * sig[None, :]  # per-key dequant, before scale/softcap/clamp
        s = s * scale
        if softcap is not None:
            s = numerics.softcap(s, softcap)
        s = torch.clamp(s, -numerics.M_CLAMP, numerics.M_CLAMP)
        k_pos = start + torch.arange(block_k, device=dev)[None, :]
        mask = (k_pos < k_len) & (k_pos <= q_pos[req][:, None])
        s = torch.where(mask, s, -torch.inf)
        _mla.decode_block_update(
            st, s, c_blk, d_v=d_v, variant=variant, mm_dtype=q.dtype,
            kv_scale=None if sig is None else sig[None, :],
        )
        if lst_a[t]:
            dest = int(dst_a[t])
            o_part[dest] = _mla.finalize_decode(st, variant=variant)
            l = st.l
            lse[dest] = torch.where(
                l > 0, st.m + torch.log(torch.where(l > 0, l, 1.0)), -torch.inf
            )
    return o_part, lse


def _check_on(dev, **tensors):
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")


_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _queue_rows_cuda(
    q, kv_pages, block_tables, kv_len, q_pos, items, kv_scales, *,
    d_v, variant, scale, block_k, num_dest_slots, softcap,
):
    """Launch ``csrc/mla_decode_paged.cu`` on the current stream."""
    b, g, d_k = q.shape
    num_pages, page_size, _ = kv_pages.shape
    dev = q.device
    _check_on(dev, kv_pages=kv_pages, block_tables=block_tables, kv_len=kv_len,
              q_pos=q_pos, kv_scales=kv_scales)
    for t in items:
        if t.device != dev:
            raise ValueError(f"work-queue arrays must be on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes bf16 or fp32")
    if kv_pages.dtype not in _POOL_KIND:
        raise TypeError(
            f"kv_pages dtype {kv_pages.dtype}: the kernel takes bf16, fp32 "
            "or int8 (with kv_scales) pools"
        )
    if (kv_pages.dtype == torch.int8) != (kv_scales is not None):
        raise ValueError("kv_scales go with int8 pools, and only with them")
    if kv_scales is not None and (
        kv_scales.dtype != torch.float32 or kv_scales.shape != (num_pages, page_size)
    ):
        raise ValueError(
            f"kv_scales must be fp32 (num_pages={num_pages}, "
            f"page_size={page_size}); got {kv_scales.dtype} {tuple(kv_scales.shape)}"
        )
    if d_v > 512 or d_v > d_k or block_k > 512:
        raise ValueError(
            f"d_v={d_v}, block_k={block_k}: the kernel takes d_v <= min(512, "
            f"d_k) and block_k <= 512"
        )
    if q_pos.shape != (b, g):
        raise ValueError(f"q_pos must be (B={b}, G={g}); got {tuple(q_pos.shape)}")
    mma = _takes_mma_body(q, kv_pages)
    if mma:
        _check_mma_geometry(kv_pages.dtype, num_pages, page_size, d_k, d_v)
    i32 = lambda t: t.to(torch.int32).contiguous()
    bt, lens, pos = i32(block_tables), i32(kv_len), i32(q_pos)
    items = [i32(t) for t in items]
    q, kv_pages = q.contiguous(), kv_pages.contiguous()
    if mma:
        _check_mma_alignment(q=q, kv_pages=kv_pages)
    scales_ptr = None
    if kv_scales is not None:
        kv_scales = kv_scales.contiguous()
        scales_ptr = kv_scales.data_ptr()
    o_part = torch.empty((num_dest_slots, g, d_v), dtype=torch.float32, device=dev)
    lse = torch.empty((num_dest_slots, g, 1), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.amla_mla_decode_paged_queue(
        q.data_ptr(), kv_pages.data_ptr(), scales_ptr, bt.data_ptr(), lens.data_ptr(),
        pos.data_ptr(), *(t.data_ptr() for t in items),
        o_part.data_ptr(), lse.data_ptr(),
        g, d_k, d_v, num_pages, page_size, bt.shape[1], items[0].shape[0],
        num_dest_slots, block_k, float(scale),
        0.0 if softcap is None else float(softcap),
        1 if variant == "amla" else 0,
        1 if q.dtype == torch.bfloat16 else 0,
        _POOL_KIND[kv_pages.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "mla_decode_paged_queue_rows")
    return o_part, lse


def _queue_rows(q, kv_pages, block_tables, kv_len, q_pos, items, kv_scales, **kw):
    """Check the geometry, then run the kernel (CUDA ``q``) or its plain
    version (CPU ``q``); counting the launch is the caller's."""
    num_pages, page_size, _ = kv_pages.shape
    block_k = kw["block_k"]
    if block_k % page_size or block_k < page_size:
        raise ValueError(
            f"block_k={block_k} must be a positive multiple of "
            f"page_size={page_size}"
        )
    if kw["variant"] not in ("amla", "base"):
        raise ValueError(f"unknown variant {kw['variant']!r}; pick 'amla' or 'base'")
    impl = _queue_rows_cuda if q.is_cuda else _queue_rows_plain
    return impl(q, kv_pages, block_tables, kv_len, q_pos, items, kv_scales, **kw)


def mla_decode_paged_queue_rows(
    q: torch.Tensor,  # (B, G, Dk) compute dtype
    kv_pages: torch.Tensor,  # (P, page_size, Dk) page pool
    block_tables: torch.Tensor,  # (B, W) int32
    kv_len: torch.Tensor,  # (B,) int32
    q_pos: torch.Tensor,  # (B, G) int32
    item_req: torch.Tensor,  # (N,) int32 ┐
    item_block: torch.Tensor,  # (N,) int32 │
    item_dest: torch.Tensor,  # (N,) int32 │ flat work queue
    item_first: torch.Tensor,  # (N,) int32 │ (see decode_schedule)
    item_last: torch.Tensor,  # (N,) int32 │
    item_valid: torch.Tensor,  # (N,) int32 ┘
    kv_scales: torch.Tensor | None = None,  # (P, page_size) f32, int8 pools
    *,
    d_v: int = 512,
    variant: str = "amla",
    scale: float,
    block_k: int,
    num_dest_slots: int,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Work-queue paged decode; returns ``(o_part (D, G, Dv), lse (D, G, 1))``
    fp32 normalized partials per destination slot.  Slots without items
    hold zeros and ``lse = -inf``; the combine never reads them.

    With an int8 pool, ``kv_scales`` is its per-row fp32 scale pool.  A
    CUDA ``q`` launches the kernel and counts one launch in
    ``mla_decode_paged_queue_rows.launches`` (bf16/fp32 pools) or
    ``.int8_launches`` (int8 pools), and a launch of the tensor-core body
    (bf16 ``q`` over a bf16 or an int8 pool; ``d_k`` and ``d_v`` whole
    16-byte pieces of a pool row) also in ``.mma_launches``; a CPU ``q``
    runs the plain version.  There is no fallback between the two, nor
    between the two bodies.
    """
    items = (item_req, item_block, item_dest, item_first, item_last, item_valid)
    kw = dict(d_v=d_v, variant=variant, scale=scale, block_k=block_k,
              num_dest_slots=num_dest_slots, softcap=softcap)
    if not op_cost.counting():
        out = _queue_rows(q, kv_pages, block_tables, kv_len, q_pos, items, kv_scales, **kw)
    else:
        cost = lambda: queue_cost(q, kv_pages, kv_len, q_pos, items, kv_scales, d_v=d_v,
                                  block_k=block_k, num_dest_slots=num_dest_slots)
        with op_cost.kernel("mla_decode_paged_queue_rows", cost):
            out = _queue_rows(q, kv_pages, block_tables, kv_len, q_pos, items, kv_scales, **kw)
    if q.is_cuda:
        if kv_scales is None:
            mla_decode_paged_queue_rows.launches += 1
        else:
            mla_decode_paged_queue_rows.int8_launches += 1
        if _takes_mma_body(q, kv_pages):
            mla_decode_paged_queue_rows.mma_launches += 1
    return out


mla_decode_paged_queue_rows.launches = 0
mla_decode_paged_queue_rows.int8_launches = 0
mla_decode_paged_queue_rows.mma_launches = 0


def mla_decode_paged_group_prefix(
    q: torch.Tensor,  # (B, G, Dk) per-request query rows
    kv_pages: torch.Tensor,  # (P, page_size, Dk) page pool
    block_tables: torch.Tensor,  # (B, W) int32
    q_pos: torch.Tensor,  # (B, G) int32 real query positions
    group_member: torch.Tensor,  # (n_groups, gmax) int32 request idx, -1 pad
    group_rep: torch.Tensor,  # (n_groups,) int32 table row per group
    prefix_lens: torch.Tensor,  # (n_groups,) int32 shared rows (block multiple)
    item_req: torch.Tensor,  # ┐
    item_block: torch.Tensor,  # │
    item_dest: torch.Tensor,  # │ prefix work queue: one item per
    item_first: torch.Tensor,  # │ (group, shared kv_block)
    item_last: torch.Tensor,  # │
    item_valid: torch.Tensor,  # ┘
    kv_scales: torch.Tensor | None = None,  # (P, page_size) f32, int8 pools
    *,
    d_v: int = 512,
    variant: str = "amla",
    scale: float,
    block_k: int,
    num_dest_slots: int,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-prefix attention computed once per group over stacked queries.

    Each group is one virtual request for the queue kernel: its query rows
    are every member's ``G`` rows stacked (``gmax * G``; padded member
    slots get ``q_pos = -1``, which masks every key), its block table is
    the representative member's row (the shared pages are aliased, so any
    member's row names them) and its ``kv_len`` the shared-prefix length.
    Returns per-member partials ``(num_dest_slots * gmax, G, Dv)`` /
    ``(..., G, 1)``: row ``dest * gmax + slot`` is member ``slot``'s
    normalized prefix partial; padded member rows are exact zeros with
    ``lse = -inf``.  A CUDA ``q`` launches the queue kernel once and counts
    it in ``mla_decode_paged_group_prefix.launches`` (not in the queue
    kernel's own counts), and in ``.mma_launches`` too when it runs the
    tensor-core body (bf16 ``q`` over a bf16 or an int8 pool).
    """
    items = (item_req, item_block, item_dest, item_first, item_last, item_valid)
    out = _group_prefix(
        _queue_rows, q, kv_pages, block_tables, q_pos, group_member, group_rep,
        prefix_lens, items, kv_scales, d_v=d_v, variant=variant, scale=scale,
        block_k=block_k, num_dest_slots=num_dest_slots, softcap=softcap,
    )
    if q.is_cuda:
        mla_decode_paged_group_prefix.launches += 1
        if _takes_mma_body(q, kv_pages):
            mla_decode_paged_group_prefix.mma_launches += 1
    return out


mla_decode_paged_group_prefix.launches = 0
mla_decode_paged_group_prefix.mma_launches = 0


def _group_prefix(rows_fn, q, kv_pages, block_tables, q_pos, group_member, group_rep,
                  prefix_lens, items, kv_scales, *, num_dest_slots, **kw):
    """Stack each group's member queries, run ``rows_fn`` (the queue
    kernel or its plain version) once over the groups, and reshape the
    outputs per member."""
    b, g, d_k = q.shape
    n_groups, gmax = group_member.shape
    group_member = group_member.to(device=q.device, dtype=torch.long)
    member = torch.clamp(group_member, 0, b - 1)
    live = group_member >= 0
    q_grp = q[member].reshape(n_groups, gmax * g, d_k)
    pos_grp = torch.where(
        live[:, :, None], q_pos.to(torch.int32)[member], -1
    ).reshape(n_groups, gmax * g)
    bt_grp = block_tables[group_rep.to(device=block_tables.device, dtype=torch.long)]
    args = (q_grp, kv_pages, bt_grp, prefix_lens.to(torch.int32), pos_grp, items, kv_scales)
    if not op_cost.counting():
        o_grp, lse_grp = rows_fn(*args, num_dest_slots=num_dest_slots, **kw)
    else:
        cost = lambda: queue_cost(q_grp, kv_pages, prefix_lens, pos_grp, items, kv_scales,
                                  d_v=kw["d_v"], block_k=kw["block_k"],
                                  num_dest_slots=num_dest_slots)
        with op_cost.kernel("mla_decode_paged_group_prefix", cost):
            o_grp, lse_grp = rows_fn(*args, num_dest_slots=num_dest_slots, **kw)
    # (D_pref, gmax*G, .) -> per-member rows (D_pref*gmax, G, .)
    return (
        o_grp.reshape(num_dest_slots * gmax, g, kw["d_v"]),
        lse_grp.reshape(num_dest_slots * gmax, g, 1),
    )


def _group_prefix_plain(*args, **kw):
    """Plain version of K2′ on tensors of any device: the same stacking
    around the queue kernel's plain version."""
    return _group_prefix(_queue_rows_plain, *args, **kw)


def _padded_rows_plain(q, kv_pages, block_tables, kv_len, q_pos, *,
                       d_v, variant, scale, softcap):
    """Plain version of K5: each request walks its ``W`` table slots, one
    AMLA update per page that starts below its ``kv_len`` (the reference's
    skipped tail steps cost no compute)."""
    b, g, _ = q.shape
    num_pages, page_size, _ = kv_pages.shape
    w = block_tables.shape[1]
    bt = clamp_tail_pages(block_tables, kv_len, page_size, num_pages).tolist()
    lens = kv_len.tolist()
    out = torch.zeros((b, g, d_v), dtype=torch.float32, device=q.device)
    for r in range(b):
        st = _mla.init_decode_state(g, d_v, q.device)
        pos = q_pos[r].to(torch.int64)[:, None]
        k_len = lens[r]
        for i in range(w):
            start = i * page_size
            if start >= k_len:
                break
            c_blk = kv_pages[bt[r][i]].to(q.dtype)
            s = _mla.masked_scores(
                q[r], c_blk, start, scale=scale, softcap=softcap,
                visible=lambda k: (k < k_len) & (k <= pos),
            )
            _mla.decode_block_update(st, s, c_blk, d_v=d_v, variant=variant,
                                     mm_dtype=q.dtype)
        out[r] = _mla.finalize_decode(st, variant=variant)
    return out


def _padded_rows_cuda(q, kv_pages, block_tables, kv_len, q_pos, *,
                      d_v, variant, scale, softcap):
    """Launch ``csrc/mla_decode_paged_padded.cu`` on the current stream."""
    b, g, d_k = q.shape
    num_pages, page_size, _ = kv_pages.shape
    dev = q.device
    _check_on(dev, kv_pages=kv_pages, block_tables=block_tables, kv_len=kv_len,
              q_pos=q_pos)
    for name, t in (("q", q), ("kv_pages", kv_pages)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes bf16 or fp32")
    if d_v > 512 or d_v > d_k or page_size > 512:
        raise ValueError(
            f"d_v={d_v}, page_size={page_size}: the kernel takes d_v <= "
            f"min(512, d_k) and page_size <= 512"
        )
    if q_pos.shape != (b, g):
        raise ValueError(f"q_pos must be (B={b}, G={g}); got {tuple(q_pos.shape)}")
    mma = _takes_mma_body(q, kv_pages)
    if mma:
        _check_mma_geometry(kv_pages.dtype, num_pages, page_size, d_k, d_v)
    i32 = lambda t: t.to(torch.int32).contiguous()
    bt, lens, pos = i32(block_tables), i32(kv_len), i32(q_pos)
    q, kv_pages = q.contiguous(), kv_pages.contiguous()
    if mma:
        _check_mma_alignment(q=q, kv_pages=kv_pages)
    out = torch.empty((b, g, d_v), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.amla_mla_decode_paged_padded(
        q.data_ptr(), kv_pages.data_ptr(), bt.data_ptr(), lens.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, g, d_k, d_v, num_pages, page_size,
        bt.shape[1], float(scale), 0.0 if softcap is None else float(softcap),
        1 if variant == "amla" else 0,
        1 if q.dtype == torch.bfloat16 else 0,
        1 if kv_pages.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "mla_decode_paged_rows")
    mla_decode_paged_rows.launches += 1
    mla_decode_paged_rows.mma_launches += mma
    return out


def mla_decode_paged_rows(
    q: torch.Tensor,  # (B, G, Dk)
    kv_pages: torch.Tensor,  # (P, page_size, Dk) page pool (bf16 / fp32)
    block_tables: torch.Tensor,  # (B, W) int32
    kv_len: torch.Tensor,  # (B,) int32
    q_pos: torch.Tensor,  # (B, G) int32
    *,
    d_v: int = 512,
    variant: str = "amla",
    scale: float,
    softcap: float | None = None,
) -> torch.Tensor:
    """Row-level paged decode over the padded ``(B, W)`` grid (K5);
    ``(B, G, Dv)`` fp32.

    Each request walks its ``W`` logical pages with one AMLA update per
    page; tail entries past its last page may hold any in-range ids (they
    are redirected to the request's own last valid page and their compute
    is skipped).  ``kv_len == 0`` yields exact zeros.  A CUDA ``q``
    launches the kernel (one more in ``mla_decode_paged_rows.launches``,
    and in ``.mma_launches`` when a bf16 ``q`` over a bf16 pool runs the
    tensor-core body, whose geometry ``_check_mma_geometry`` holds); a CPU
    ``q`` runs the plain version.  There is no fallback between the two,
    nor between the two bodies.
    """
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables must have at least one page column")
    if variant not in ("amla", "base"):
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")
    impl = _padded_rows_cuda if q.is_cuda else _padded_rows_plain
    kw = dict(d_v=d_v, variant=variant, scale=scale, softcap=softcap)
    if not op_cost.counting():
        return impl(q, kv_pages, block_tables, kv_len, q_pos, **kw)
    with op_cost.kernel("mla_decode_paged_rows",
                        lambda: padded_cost(q, kv_pages, block_tables, kv_len, q_pos, d_v=d_v)):
        return impl(q, kv_pages, block_tables, kv_len, q_pos, **kw)


mla_decode_paged_rows.launches = 0
mla_decode_paged_rows.mma_launches = 0
