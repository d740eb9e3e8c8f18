"""Paged latent-KV cache: fixed-size pages + per-request block tables.

Counterpart of ``repro/runtime/kv_cache.py`` (bf16/fp32 pools).  One
device pool holds ``num_pages`` pages of ``page_size`` latent rows (the
576-wide ``[c ; k_rope]`` rows of MLA); requests own ordered lists of
physical page ids, appends grab pages on demand off a FIFO free list, and
freeing returns them.  Pages carry refcounts so ``refcount_sweep`` can
audit the bookkeeping.  Page bookkeeping is host-side Python; only the
pool lives on the device, and row writes are in-place ``index_put_`` /
slice copies.

Not in this slice: ``fork`` / copy-on-write, ``truncate``,
``adopt_pages`` / retention pins, the prefix trie and int8 pools.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.mla_decode_paged import DEFAULT_PAGE_SIZE, CacheSpec

__all__ = ["CacheSpec", "LayeredPagedKVCache", "OutOfPagesError", "PagedKVCache"]


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
        if self.spec.quantized:
            raise NotImplementedError(
                "int8 page pools (per-row scales, quantize-on-write) are not "
                "ported yet; they come in a later slice of the port"
            )
        self.dtype = self.spec.dtype
        self.device = resolve_device(device)
        self.pages = self._make_pool()
        # FIFO free list: freed pages are reused in release order, so a
        # long-lived session produces fragmented block tables.
        self._free: deque[int] = deque(range(num_pages))
        self._seq_pages: dict[int, list[int]] = {}
        self._seq_len: dict[int, int] = {}
        # Owners per physical page: 0 = on the free list.
        self._ref = np.zeros((num_pages,), np.int32)

    # -- bookkeeping ---------------------------------------------------- #
    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def pages_needed_for_append(self, rid: int | None, n_tokens: int) -> int:
        """New pages an append of ``n_tokens`` to ``rid`` (or a new seq) grabs."""
        used = self._seq_len.get(rid, 0) if rid is not None else 0
        have = len(self._seq_pages.get(rid, [])) if rid is not None else 0
        return self.pages_needed(used + n_tokens) - have

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

    def seq_len(self, rid: int) -> int:
        return self._seq_len[rid]

    def num_aliased_pages(self) -> int:
        """Physical pages shared by more than one request (0 without fork)."""
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

    def reserve(self, rid: int, n: int) -> list[tuple[int, int, int]]:
        """Claim room for ``n`` more rows: grab pages, advance ``seq_len``,
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
            in_page = pos % self.page_size
            m = min(self.page_size - in_page, n - off)
            chunks.append((pid, in_page, m))
            off += m
        self._seq_len[rid] = used + n
        return chunks

    def write_reserved(self, chunks, rows: torch.Tensor) -> None:
        """Fill reserved chunks with ``rows (n, width)``."""
        off = 0
        for pid, in_page, m in chunks:
            self.pages[pid, in_page : in_page + m] = rows[off : off + m]
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

    def write_reserved(self, chunks, rows: torch.Tensor) -> None:
        """Fill reserved chunks of every layer with ``rows (L, n, width)``."""
        off = 0
        for pid, in_page, m in chunks:
            self.pages[:, pid, in_page : in_page + m] = rows[:, off : off + m]
            off += m

    def write_layer(self, layer: int, chunks, rows: torch.Tensor) -> None:
        """Fill one layer's plane of reserved chunks with ``rows (n, W)``."""
        off = 0
        for pid, in_page, m in chunks:
            self.pages[layer, pid, in_page : in_page + m] = rows[off : off + m]
            off += m

    def write_layer_tokens(self, layer: int, pids, offs, rows: torch.Tensor) -> None:
        """Scatter ``rows (R, W)`` into one layer at ``(layer, pids[i],
        offs[i])`` in place — one device call per layer per decode step.
        ``pids``/``offs`` may be host arrays or device tensors."""
        pids = torch.as_tensor(pids, device=self.device).long()
        offs = torch.as_tensor(offs, device=self.device).long()
        self.pages[layer].index_put_((pids, offs), rows.to(self.dtype))

    def layer_pages(self, layer: int) -> torch.Tensor:
        """The ``(num_pages, page_size, width)`` pool of one layer (a view)."""
        return self.pages[layer]

    def gather_contiguous(self, rid: int, layer: int) -> torch.Tensor:
        """``rid``'s rows of one layer as a contiguous ``(len, width)``
        tensor (test helper)."""
        n = self._seq_len[rid]
        if n == 0:
            return torch.zeros((0, self.width), dtype=self.dtype, device=self.device)
        return torch.cat([self.pages[layer, p] for p in self._seq_pages[rid]])[:n]
