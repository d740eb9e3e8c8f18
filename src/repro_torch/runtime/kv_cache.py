"""Paged latent-KV cache: fixed-size pages + per-request block tables.

Counterpart of ``repro/runtime/kv_cache.py``.  One device pool holds
``num_pages`` pages of ``page_size`` latent rows (the 576-wide
``[c ; k_rope]`` rows of MLA); requests own ordered lists of physical page
ids, appends grab pages on demand off a FIFO free list, and freeing
returns them.  Pages are refcounted: :meth:`PagedKVCache.fork` aliases a
prefix of one request's pages into another without copying a row, and an
append into a shared (partial) boundary page first gives the writer a
private copy (copy-on-write; for the layered cache one copy covers every
layer).

An int8 :class:`CacheSpec` stores symmetric per-row int8 rows with a
companion fp32 scale pool (``scales``): rows are quantized on write
(:func:`_quantize_rows`, bit for bit the reference's), and page copies move
data and scales together.

Page bookkeeping is host-side Python; only the pools live on the device,
and row writes are in-place ``index_put_`` / slice copies.  Not in this
slice: ``truncate``, ``adopt_pages`` / retention pins and the prefix trie.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.mla_decode_paged import DEFAULT_PAGE_SIZE, CacheSpec

__all__ = ["CacheSpec", "LayeredPagedKVCache", "OutOfPagesError", "PagedKVCache"]


# fp32 1/127.  The reference's cache writes run ``_quantize_rows`` under
# jit, where XLA turns the division by the constant 127 into a multiply by
# its fp32 reciprocal; the scales, and so the pool bytes, follow that form.
_INV_127 = torch.tensor(np.float32(1.0) / np.float32(127.0))


def _quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``q = round(x / σ)`` with ``σ = max|row|/127``
    (computed as ``max|row| * fp32(1/127)``, as the reference's jitted
    writes compute it).

    All-zero rows get ``σ = 1/127``; rows are widened to fp32 first, so
    bf16 inputs quantize as their fp32 values.  Rounding is half to even,
    as ``jnp.round``.  Returns ``(int8 rows, fp32 scales)``, the scales
    shaped like ``rows`` minus the trailing width axis.
    """
    rows = rows.to(torch.float32)
    amax = rows.abs().amax(dim=-1)
    # A CPU scalar tensor enters a CUDA product as a scalar: no copy to the
    # device (which a CUDA graph could not capture).
    scl = torch.where(amax > 0, amax, torch.ones_like(amax)) * _INV_127
    q = torch.clamp(torch.round(rows / scl[..., None]), -127, 127)
    return q.to(torch.int8), scl


class OutOfPagesError(RuntimeError):
    """Raised when an append needs more pages than the pool has free."""


class PagedKVCache:
    """Block-table paged KV pool: alloc / reserve + write / free.

    ``device`` defaults to ``"cuda"`` and raises without CUDA; pass
    ``device="cpu"`` for a CPU pool.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        width: int = 576,
        dtype=torch.bfloat16,
        spec: CacheSpec | None = None,
        device="cuda",
    ):
        if num_pages < 1 or page_size < 1:
            raise ValueError("need at least one page of at least one row")
        self.num_pages = num_pages
        self.page_size = page_size
        self.width = width
        self.spec = spec if spec is not None else CacheSpec(dtype=dtype)
        self.dtype = self.spec.dtype
        self.device = resolve_device(device)
        self.pages = self._make_pool()
        self.scales = self._make_scale_pool() if self.quantized else None
        # FIFO free list: freed pages are reused in release order, so a
        # long-lived session produces fragmented block tables.
        self._free: deque[int] = deque(range(num_pages))
        self._seq_pages: dict[int, list[int]] = {}
        self._seq_len: dict[int, int] = {}
        # Owners per physical page: 0 = on the free list.
        self._ref = np.zeros((num_pages,), np.int32)

    # -- bookkeeping ---------------------------------------------------- #
    @property
    def quantized(self) -> bool:
        """True when the pool stores int8 rows + a per-row scale pool."""
        return self.spec.quantized

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def pages_needed_for_append(self, rid: int | None, n_tokens: int) -> int:
        """New pages an append of ``n_tokens`` to ``rid`` (or a new seq)
        grabs, the copy-on-write page included when the append's first rows
        land in a page another request shares."""
        used = self._seq_len.get(rid, 0) if rid is not None else 0
        have = len(self._seq_pages.get(rid, [])) if rid is not None else 0
        need = self.pages_needed(used + n_tokens) - have
        if (
            rid is not None
            and n_tokens > 0
            and used % self.page_size
            and self._ref[self._seq_pages[rid][used // self.page_size]] > 1
        ):
            need += 1  # COW copy of the shared boundary page
        return need

    def has_room(self, rid: int | None, n_tokens: int) -> bool:
        """Can ``n_tokens`` more rows be appended to ``rid`` (or a new seq)?"""
        return self.pages_needed_for_append(rid, n_tokens) <= self.num_free_pages

    def alloc(self, rid: int) -> None:
        """Register an empty sequence (pages are grabbed lazily)."""
        if rid in self._seq_pages:
            raise KeyError(f"sequence {rid} already allocated")
        self._seq_pages[rid] = []
        self._seq_len[rid] = 0

    def _grab_page(self) -> int:
        pid = self._free.popleft()
        assert self._ref[pid] == 0, f"free-list page {pid} still referenced"
        self._ref[pid] = 1
        return pid

    def _release_page(self, pid: int) -> None:
        self._ref[pid] -= 1
        assert self._ref[pid] >= 0, f"page {pid} refcount underflow"
        if self._ref[pid] == 0:
            self._free.append(pid)

    def free(self, rid: int) -> None:
        """Release ``rid``'s pages; freeing an id that is not live is a no-op."""
        pages = self._seq_pages.pop(rid, None)
        if pages is None:
            return
        for pid in pages:
            self._release_page(pid)
        del self._seq_len[rid]

    def fork(self, src: int, dst: int, prefix_len: int | None = None) -> None:
        """Create ``dst`` sharing ``src``'s first ``prefix_len`` rows (all of
        them by default): every page that intersects the prefix, a partial
        boundary page included, is aliased (refcount bumped), so a fork
        copies no rows.  The next append into a shared boundary page, by
        either side, copies it first (:meth:`reserve`)."""
        if dst in self._seq_pages:
            raise KeyError(f"sequence {dst} already allocated")
        src_len = self._seq_len[src]  # KeyError if src is not live
        if prefix_len is None:
            prefix_len = src_len
        if not 0 <= prefix_len <= src_len:
            raise ValueError(
                f"fork prefix_len={prefix_len} outside [0, {src_len}] "
                f"(seq {src} has {src_len} rows)"
            )
        shared = self._seq_pages[src][: self.pages_needed(prefix_len)]
        for pid in shared:
            self._ref[pid] += 1
        self._seq_pages[dst] = list(shared)
        self._seq_len[dst] = prefix_len

    def seq_len(self, rid: int) -> int:
        return self._seq_len[rid]

    def seq_pages(self, rid: int) -> list[int]:
        return list(self._seq_pages[rid])

    def page_refcount(self, pid: int) -> int:
        """Owners of physical page ``pid`` (0 = on the free list)."""
        return int(self._ref[pid])

    def num_aliased_pages(self) -> int:
        """Physical pages currently shared by more than one request."""
        return int(np.sum(self._ref > 1))

    def refcount_sweep(self) -> dict:
        """Audit the host accounting; raises AssertionError on a leak."""
        expected = np.zeros(self.num_pages, dtype=np.int64)
        for pages in self._seq_pages.values():
            for pid in pages:
                expected[pid] += 1
        bad = np.nonzero(expected != self._ref)[0]
        assert bad.size == 0, (
            f"refcount mismatch on pages {bad.tolist()[:8]}: expected "
            f"{expected[bad].tolist()[:8]} owners from the sequence tables, "
            f"_ref says {self._ref[bad].tolist()[:8]}"
        )
        free = list(self._free)
        free_set = set(free)
        assert len(free) == len(free_set), (
            f"free list holds {len(free) - len(free_set)} duplicate entries"
        )
        should_be_free = {int(p) for p in np.nonzero(expected == 0)[0]}
        assert free_set == should_be_free, (
            f"free list out of sync: {sorted(free_set - should_be_free)[:8]} "
            f"free but owned, {sorted(should_be_free - free_set)[:8]} "
            f"unowned but not free (leaked)"
        )
        return {
            "live_pages": int(np.sum(expected > 0)),
            "free_pages": len(free),
            "aliased_pages": int(np.sum(expected > 1)),
            "live_sequences": len(self._seq_pages),
        }

    # -- data path ------------------------------------------------------ #
    def _make_pool(self) -> torch.Tensor:
        return torch.zeros(
            (self.num_pages, self.page_size, self.width),
            dtype=self.dtype, device=self.device,
        )

    def _make_scale_pool(self) -> torch.Tensor:
        """Per-page-row fp32 dequant scales (quantized pools only)."""
        return torch.zeros(
            (self.num_pages, self.page_size), dtype=torch.float32, device=self.device
        )

    def _page(self, pid: int) -> tuple:
        """Index of page ``pid`` in the pools (every layer of a layered
        pool)."""
        return (pid,)

    def _store(self, index: tuple, rows: torch.Tensor) -> None:
        """Write ``rows`` at ``pages[index]`` in place; an int8 pool
        quantizes them and writes their scales at ``scales[index]``."""
        if self.quantized:
            q, scl = _quantize_rows(rows)
            self.pages[index] = q
            self.scales[index] = scl
        else:
            self.pages[index] = rows.to(self.dtype)

    def _pool_copy_page(self, dst_pid: int, src_pid: int) -> None:
        """Device copy of one page, scales included (the COW fault)."""
        for pool in (self.pages, self.scales):
            if pool is not None:
                pool[self._page(dst_pid)] = pool[self._page(src_pid)]

    @property
    def _row_dtype(self) -> torch.dtype:
        """Dtype appended rows are coerced to: fp32 for a quantized pool
        (quantization happens in the write), else the pool's."""
        return torch.float32 if self.quantized else self.dtype

    def _validate_rows(self, rows) -> torch.Tensor:
        rows = torch.as_tensor(rows, device=self.device).to(self._row_dtype)
        if rows.ndim != 2 or rows.shape[1] != self.width:
            raise ValueError(f"rows must be (n, {self.width}); got {tuple(rows.shape)}")
        return rows

    def append(self, rid: int, rows) -> None:
        """Append ``rows (n, width)`` to sequence ``rid``, allocating pages;
        :class:`OutOfPagesError` leaves the sequence unchanged."""
        rows = self._validate_rows(rows)
        self.write_reserved(self.reserve(rid, rows.shape[-2]), rows)

    def reserve(self, rid: int, n: int) -> list[tuple[int, int, int]]:
        """Claim room for ``n`` more rows: grab pages, copy a shared
        boundary page before it is written (copy-on-write, one device copy
        covering every layer and the scales), advance ``seq_len``, and
        return the write plan as ``(page_id, offset, count)`` chunks.
        Raises :class:`OutOfPagesError` up front, leaving the sequence
        unchanged."""
        if not self.has_room(rid, n):
            raise OutOfPagesError(
                f"append of {n} rows to seq {rid} needs more than the "
                f"{self.num_free_pages} free pages"
            )
        used = self._seq_len[rid]
        page_list = self._seq_pages[rid]
        chunks: list[tuple[int, int, int]] = []
        off = 0
        while off < n:
            pos = used + off
            if pos // self.page_size == len(page_list):
                page_list.append(self._grab_page())
            pid = page_list[pos // self.page_size]
            if self._ref[pid] > 1:
                # Copy-on-write: the page is aliased by a fork; only ever
                # the (partial) boundary page.
                new_pid = self._grab_page()
                self._pool_copy_page(new_pid, pid)
                self._ref[pid] -= 1
                page_list[pos // self.page_size] = new_pid
                pid = new_pid
            in_page = pos % self.page_size
            m = min(self.page_size - in_page, n - off)
            chunks.append((pid, in_page, m))
            off += m
        self._seq_len[rid] = used + n
        return chunks

    def write_reserved(self, chunks, rows: torch.Tensor) -> None:
        """Fill reserved chunks with ``rows (n, width)`` (``(L, n, width)``
        for a layered pool)."""
        off = 0
        for pid, in_page, m in chunks:
            self._store(self._page(pid) + (slice(in_page, in_page + m),),
                        rows[..., off : off + m, :])
            off += m

    def block_table(
        self, rids: list[int], width: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ``(block_tables (B, W) int32, kv_len (B,) int32)``, host
        numpy; rows shorter than ``W`` are padded with page id 0."""
        if width is None:
            width = max([len(self._seq_pages[r]) for r in rids] + [1])
        bt = np.zeros((len(rids), width), np.int32)
        kv = np.zeros((len(rids),), np.int32)
        for i, r in enumerate(rids):
            pages = self._seq_pages[r]
            if len(pages) > width:
                raise ValueError(f"seq {r} has {len(pages)} pages > width {width}")
            bt[i, : len(pages)] = pages
            kv[i] = self._seq_len[r]
        return bt, kv

    def _gather(self, rid: int, pages: torch.Tensor, scales) -> torch.Tensor:
        """``rid``'s rows of ``pages`` (a ``(P, page, W)`` pool) as a
        contiguous ``(len, width)`` tensor, dequantized by ``scales``."""
        pids = self._seq_pages[rid]
        if not pids:
            return torch.zeros((0, self.width), dtype=self._row_dtype, device=self.device)
        out = torch.cat([pages[p] for p in pids])
        if scales is not None:
            out = out.to(torch.float32) * torch.cat([scales[p] for p in pids])[:, None]
        return out[: self._seq_len[rid]]

    def gather_contiguous(self, rid: int) -> torch.Tensor:
        """``rid``'s rows as a contiguous ``(len, width)`` tensor (test
        helper); a quantized pool dequantizes to fp32."""
        return self._gather(rid, self.pages, self.scales)


class LayeredPagedKVCache(PagedKVCache):
    """One block table + refcounts shared by all ``L`` layers of a model.

    The bookkeeping is :class:`PagedKVCache`'s and runs once per request;
    the pool has a leading layer axis ``(L, num_pages, page_size, width)``,
    so page ``p`` names the same slot in every layer.  Appends are two
    phase: :meth:`reserve` once per step, then each layer fills its plane
    with :meth:`write_layer` (chunked prefill) or :meth:`write_layer_tokens`
    (one row per request per decode step); :meth:`write_reserved` fills
    all layers at once.
    """

    def __init__(
        self,
        *,
        num_layers: int,
        num_pages: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        width: int = 576,
        dtype=torch.bfloat16,
        spec: CacheSpec | None = None,
        device="cuda",
    ):
        if num_layers < 1:
            raise ValueError("need at least one layer")
        self.num_layers = num_layers
        super().__init__(
            num_pages=num_pages, page_size=page_size, width=width,
            dtype=dtype, spec=spec, device=device,
        )

    def _make_pool(self) -> torch.Tensor:
        return torch.zeros(
            (self.num_layers, self.num_pages, self.page_size, self.width),
            dtype=self.dtype, device=self.device,
        )

    def _make_scale_pool(self) -> torch.Tensor:
        # Every layer's rows are quantized against their own row maxima.
        return torch.zeros(
            (self.num_layers, self.num_pages, self.page_size),
            dtype=torch.float32, device=self.device,
        )

    def _page(self, pid: int) -> tuple:
        # One COW copy or all-layer write covers every layer.
        return (slice(None), pid)

    def _validate_rows(self, rows) -> torch.Tensor:
        rows = torch.as_tensor(rows, device=self.device).to(self._row_dtype)
        want = (self.num_layers, self.width)
        if rows.ndim != 3 or (rows.shape[0], rows.shape[2]) != want:
            raise ValueError(
                f"rows must be (L={self.num_layers}, n, {self.width}); "
                f"got {tuple(rows.shape)}"
            )
        return rows

    def write_layer(self, layer: int, chunks, rows: torch.Tensor) -> None:
        """Fill one layer's plane of reserved chunks with ``rows (n, W)``."""
        off = 0
        for pid, in_page, m in chunks:
            self._store((layer, pid, slice(in_page, in_page + m)), rows[off : off + m])
            off += m

    def write_layer_tokens(self, layer: int, pids, offs, rows: torch.Tensor) -> None:
        """Scatter ``rows (R, W)`` into one layer at ``(layer, pids[i],
        offs[i])`` in place — one scatter per layer per decode step (and
        one of the scales for an int8 pool).  ``pids``/``offs`` may be host
        arrays or device tensors; given as int64 tensors on the pool's
        device they are used where they lie (no copy, as a CUDA graph of
        the decode walk needs)."""
        pids = torch.as_tensor(pids, device=self.device).long()
        offs = torch.as_tensor(offs, device=self.device).long()
        self._store((layer, pids, offs), rows)

    def layer_pages(self, layer: int) -> torch.Tensor:
        """The ``(num_pages, page_size, width)`` pool of one layer (a view)."""
        return self.pages[layer]

    def layer_scales(self, layer: int) -> torch.Tensor | None:
        """One layer's ``(num_pages, page_size)`` scale pool (None unless
        quantized), passed to the kernels beside :meth:`layer_pages`."""
        return None if self.scales is None else self.scales[layer]

    def gather_contiguous(self, rid: int, layer: int) -> torch.Tensor:
        """``rid``'s rows of one layer as a contiguous ``(len, width)``
        tensor (test helper); a quantized pool dequantizes to fp32."""
        return self._gather(rid, self.pages[layer], self.layer_scales(layer))
