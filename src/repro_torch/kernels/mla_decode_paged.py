"""Paged MLA decode: AMLA over a block-table KV cache (work-queue path).

Counterpart of ``repro/kernels/mla_decode_paged.py``.  The latents live in
a shared pool of pages ``(num_pages, page_size, 576)``; each request owns
an ordered list of physical page ids (its block table).  A host-side
schedule (:mod:`repro_torch.kernels.decode_schedule`) lists one work item
per (request, ``block_k``-row KV block); :func:`mla_decode_paged_queue_rows`
walks it, runs one AMLA state update per block, and writes a normalized
partial ``(o, lse)`` per destination slot for
:mod:`repro_torch.kernels.mla_decode_combine` to merge.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/mla_decode_paged.cu``; on a CPU tensor it runs the plain PyTorch
version beside it, which walks the same items in the same order with the
same int32 rescale.  The int8 pool variant and the group-prefix pass of
the reference come in a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import numerics
from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as _mla

DEFAULT_PAGE_SIZE = 128


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Storage layout of a paged latent pool: dtype + scale granularity.

    ``int8`` pools (symmetric per-row quantization with an fp32 scale pool)
    are named here so the serving knobs keep the reference's vocabulary;
    the caches and kernels of this slice take bf16/fp32 pools only.
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


def _queue_rows_plain(
    q, kv_pages, block_tables, kv_len, q_pos, items, *,
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
        # Gather the block's pages; pages past kv_len are zero-filled, as
        # the reference does in VMEM, instead of read.
        c_blk = torch.zeros((block_k, d_k), dtype=kv_pages.dtype, device=dev)
        for j in range(n_sub):
            if start + j * page_size < k_len:
                pid = bt[req, blk * n_sub + j]
                c_blk[j * page_size : (j + 1) * page_size] = kv_pages[pid]
        s = q[req].to(torch.float32) @ c_blk.to(q.dtype).to(torch.float32).T
        s = s * scale
        if softcap is not None:
            s = numerics.softcap(s, softcap)
        s = torch.clamp(s, -numerics.M_CLAMP, numerics.M_CLAMP)
        k_pos = start + torch.arange(block_k, device=dev)[None, :]
        mask = (k_pos < k_len) & (k_pos <= q_pos[req][:, None])
        s = torch.where(mask, s, -torch.inf)
        _mla.decode_block_update(
            st, s, c_blk, d_v=d_v, variant=variant, mm_dtype=q.dtype
        )
        if lst_a[t]:
            dest = int(dst_a[t])
            o_part[dest] = _mla.finalize_decode(st, variant=variant)
            l = st.l
            lse[dest] = torch.where(
                l > 0, st.m + torch.log(torch.where(l > 0, l, 1.0)), -torch.inf
            )
    return o_part, lse


def _queue_rows_cuda(
    q, kv_pages, block_tables, kv_len, q_pos, items, *,
    d_v, variant, scale, block_k, num_dest_slots, softcap,
):
    """Launch ``csrc/mla_decode_paged.cu`` on the current stream."""
    b, g, d_k = q.shape
    num_pages, page_size, _ = kv_pages.shape
    dev = q.device
    for name, t in (("kv_pages", kv_pages), ("block_tables", block_tables),
                    ("kv_len", kv_len), ("q_pos", q_pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for t in items:
        if t.device != dev:
            raise ValueError(f"work-queue arrays must be on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes bf16 or fp32")
    if kv_pages.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"kv_pages dtype {kv_pages.dtype}: the kernel takes bf16 or fp32 "
            "pools (int8 pages come in a later slice)"
        )
    if d_v > 512 or d_v > d_k or block_k > 512:
        raise ValueError(
            f"d_v={d_v}, block_k={block_k}: the kernel takes d_v <= min(512, "
            f"d_k) and block_k <= 512"
        )
    if q_pos.shape != (b, g):
        raise ValueError(f"q_pos must be (B={b}, G={g}); got {tuple(q_pos.shape)}")
    i32 = lambda t: t.to(torch.int32).contiguous()
    bt, lens, pos = i32(block_tables), i32(kv_len), i32(q_pos)
    items = [i32(t) for t in items]
    q, kv_pages = q.contiguous(), kv_pages.contiguous()
    o_part = torch.empty((num_dest_slots, g, d_v), dtype=torch.float32, device=dev)
    lse = torch.empty((num_dest_slots, g, 1), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.amla_mla_decode_paged_queue(
        q.data_ptr(), kv_pages.data_ptr(), bt.data_ptr(), lens.data_ptr(),
        pos.data_ptr(), *(t.data_ptr() for t in items),
        o_part.data_ptr(), lse.data_ptr(),
        g, d_k, d_v, num_pages, page_size, bt.shape[1], items[0].shape[0],
        num_dest_slots, block_k, float(scale),
        0.0 if softcap is None else float(softcap),
        1 if variant == "amla" else 0,
        1 if q.dtype == torch.bfloat16 else 0,
        1 if kv_pages.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "mla_decode_paged_queue_rows")
    mla_decode_paged_queue_rows.launches += 1
    return o_part, lse


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

    A CUDA ``q`` launches the kernel (and counts one launch in
    ``mla_decode_paged_queue_rows.launches``); a CPU ``q`` runs the plain
    version.  There is no fallback between the two.
    """
    num_pages, page_size, _ = kv_pages.shape
    if block_k % page_size or block_k < page_size:
        raise ValueError(
            f"block_k={block_k} must be a positive multiple of "
            f"page_size={page_size}"
        )
    if variant not in ("amla", "base"):
        raise ValueError(f"unknown variant {variant!r}; pick 'amla' or 'base'")
    items = (item_req, item_block, item_dest, item_first, item_last, item_valid)
    impl = _queue_rows_cuda if q.is_cuda else _queue_rows_plain
    return impl(
        q, kv_pages, block_tables, kv_len, q_pos, items,
        d_v=d_v, variant=variant, scale=scale, block_k=block_k,
        num_dest_slots=num_dest_slots, softcap=softcap,
    )


mla_decode_paged_queue_rows.launches = 0
