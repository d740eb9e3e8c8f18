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
and row writes are in-place ``index_put_`` / slice copies.  Besides the
sequence owners a page may hold retention pins (:meth:`PagedKVCache.pin_pages`),
taken by :class:`PrefixTrie`, the radix tree over finished prompts' complete
KV blocks that admission matches and adopts (:meth:`PagedKVCache.adopt_pages`);
:meth:`PagedKVCache.truncate` rolls a request back (speculative decoding's
rejected rows); :meth:`PagedKVCache.to_device` moves the pools to another
device (a shard's), leaving the bookkeeping where it is.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.mla_decode_paged import DEFAULT_PAGE_SIZE, CacheSpec

__all__ = [
    "CacheSpec",
    "DoubleFreeError",
    "LayeredPagedKVCache",
    "OutOfPagesError",
    "PagedKVCache",
    "PrefixTrie",
]


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


class DoubleFreeError(RuntimeError):
    """Raised (debug mode only) when a request id is freed twice."""


class PagedKVCache:
    """Block-table paged KV pool: alloc / reserve + write / free.

    ``device`` defaults to ``"cuda"`` and raises without CUDA; pass
    ``device="cpu"`` for a CPU pool.  With ``debug=True`` a double free
    raises :class:`DoubleFreeError` instead of being a no-op.
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
        debug: bool = False,
    ):
        if num_pages < 1 or page_size < 1:
            raise ValueError("need at least one page of at least one row")
        self.num_pages = num_pages
        self.page_size = page_size
        self.width = width
        self.spec = spec if spec is not None else CacheSpec(dtype=dtype)
        self.dtype = self.spec.dtype
        self.debug = debug
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
        # Retention pins per page (a prefix cache's references, not a live
        # sequence's).  Every pin is also counted in ``_ref``, so
        # ``_ref == sequence owners + _pin`` for every page.
        self._pin = np.zeros((num_pages,), np.int32)

    def to_device(self, device) -> "PagedKVCache":
        """Move the pool (and the scale pool) to ``device``; the host
        bookkeeping (free list, refcounts, pins) is untouched.  A no-op when
        ``device`` is None or the pool already lives there.  A move gives
        the pool new addresses: a session's captured decode graphs read the
        old ones, and its :class:`~repro_torch.runtime.step_graph.PagedDecodeStep`
        drops them before its next step (it watches ``pages``)."""
        if device is None:
            return self
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.pages.device == device:
            return self
        self.pages = self.pages.to(device)
        if self.scales is not None:
            self.scales = self.scales.to(device)
        self.device = self.pages.device
        return self

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
        """Release ``rid``'s pages; each returns to the free list when its
        last owner (sequence or pin) lets go.  Freeing an id that is not
        live is a no-op, or raises :class:`DoubleFreeError` with ``debug``."""
        pages = self._seq_pages.pop(rid, None)
        if pages is None:
            if self.debug:
                raise DoubleFreeError(
                    f"free({rid}): request is not live — it was already "
                    f"freed or never allocated"
                )
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

    # -- retention (prefix-cache) references ---------------------------- #
    def pin_pages(self, pids) -> None:
        """Take a retention reference on each of ``pids``: a pinned page
        outlives its sequence owners until :meth:`unpin_pages`.  Pages must
        be live (some owner still holds them), so a free-list page is never
        resurrected."""
        pids = [int(p) for p in pids]
        for pid in pids:
            if self._ref[pid] < 1:
                raise ValueError(
                    f"cannot pin page {pid}: it is on the free list (pin "
                    "pages before their last sequence owner releases them)"
                )
        for pid in pids:
            self._ref[pid] += 1
            self._pin[pid] += 1

    def unpin_pages(self, pids) -> None:
        """Drop retention references; pages whose last owner was the pin
        return to the free list."""
        pids = [int(p) for p in pids]
        for pid in pids:
            if self._pin[pid] < 1:
                raise ValueError(f"page {pid} holds no retention pin")
        for pid in pids:
            self._pin[pid] -= 1
            self._release_page(pid)

    def adopt_pages(self, rid: int, pids, n_rows: int) -> None:
        """Register ``rid`` as a new sequence aliasing ``pids`` (a prefix-
        cache hit): :meth:`fork` from a page list instead of a live parent.
        ``n_rows`` must fill the pages exactly, so the next append starts
        on a fresh page and never copies an adopted one."""
        if rid in self._seq_pages:
            raise KeyError(f"sequence {rid} already allocated")
        pids = [int(p) for p in pids]
        if n_rows != len(pids) * self.page_size:
            raise ValueError(
                f"adopt_pages needs page-aligned rows: {n_rows} rows do "
                f"not fill {len(pids)} pages of {self.page_size}"
            )
        for pid in pids:
            if self._ref[pid] < 1:
                raise ValueError(f"cannot adopt page {pid}: it is on the free list")
        for pid in pids:
            self._ref[pid] += 1
        self._seq_pages[rid] = list(pids)
        self._seq_len[rid] = n_rows

    def pool_occupancy(self) -> dict:
        """Page census: ``live_pages`` some sequence references (pinned or
        not), ``retained_pages`` held only by pins, ``free_pages``; the
        three sum to ``num_pages``."""
        return {
            "live_pages": int(np.sum(self._ref > self._pin)),
            "retained_pages": int(np.sum((self._ref > 0) & (self._ref == self._pin))),
            "free_pages": self.num_free_pages,
            "pinned_pages": int(np.sum(self._pin > 0)),
        }

    def truncate(self, rid: int, n: int) -> None:
        """Roll ``rid`` back to its first ``n`` rows (speculative rollback):
        every page wholly past the new boundary loses this request's
        reference (a page a sibling still aliases keeps its data; a page
        only ``rid`` held returns to the free list).  The boundary page,
        a private copy-on-write copy included, stays; its stale rows are
        masked by ``kv_len`` and overwritten (rows and int8 scales) by the
        next append, so no device data moves.  Truncating to the current
        length is a no-op; ``KeyError`` for a request that is not live,
        ``ValueError`` for ``n`` outside ``[0, seq_len]``."""
        cur = self._seq_len[rid]  # KeyError if rid is not live
        if not 0 <= n <= cur:
            raise ValueError(
                f"truncate({rid}, {n}): new length must be in [0, {cur}] "
                f"(rollback discards tail rows; it cannot extend a request)"
            )
        keep = self.pages_needed(n)
        pages = self._seq_pages[rid]
        for pid in pages[keep:]:
            self._release_page(pid)
        del pages[keep:]
        self._seq_len[rid] = n

    def seq_len(self, rid: int) -> int:
        return self._seq_len[rid]

    def seq_pages(self, rid: int) -> list[int]:
        return list(self._seq_pages[rid])

    def live_sequences(self) -> list[int]:
        return list(self._seq_pages)

    def page_refcount(self, pid: int) -> int:
        """Owners of physical page ``pid`` (0 = on the free list)."""
        return int(self._ref[pid])

    def num_aliased_pages(self) -> int:
        """Physical pages currently shared by more than one request."""
        return int(np.sum(self._ref > 1))

    def refcount_sweep(self) -> dict:
        """Audit the host accounting (``_ref`` = sequence owners + pins,
        the free list exactly the unowned pages); raises AssertionError on
        a leak, a double free or a duplicated free-list entry."""
        seq_owned = np.zeros(self.num_pages, dtype=np.int64)
        for pages in self._seq_pages.values():
            for pid in pages:
                seq_owned[pid] += 1
        expected = seq_owned + self._pin.astype(np.int64)
        bad = np.nonzero(expected != self._ref)[0]
        assert bad.size == 0, (
            f"refcount mismatch on pages {bad.tolist()[:8]}: expected "
            f"{expected[bad].tolist()[:8]} owners from the sequence tables + "
            f"pins, _ref says {self._ref[bad].tolist()[:8]}"
        )
        neg = np.nonzero(self._pin < 0)[0]
        assert neg.size == 0, f"negative pin count on pages {neg.tolist()[:8]}"
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
            "live_pages": int(np.sum(seq_owned > 0)),
            "retained_pages": int(np.sum((seq_owned == 0) & (self._pin > 0))),
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
        debug: bool = False,
    ):
        if num_layers < 1:
            raise ValueError("need at least one layer")
        self.num_layers = num_layers
        super().__init__(
            num_pages=num_pages, page_size=page_size, width=width,
            dtype=dtype, spec=spec, device=device, debug=debug,
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


# --------------------------------------------------------------------------- #
# radix prefix trie: token-keyed retention over block-aligned page runs
# --------------------------------------------------------------------------- #


class _TrieNode:
    """One radix edge: a run of complete KV blocks (``blocks``, each a
    tuple of ``block_tokens`` token ids) and the pages holding their rows
    (``pages_per_block`` per block).  The node holds one retention pin per
    page; children are keyed by their edge's first block."""

    __slots__ = ("blocks", "pages", "children", "parent", "last_used")

    def __init__(self, blocks, pages, parent):
        self.blocks: list[tuple] = list(blocks)
        self.pages: list[int] = list(pages)
        self.children: dict[tuple, _TrieNode] = {}
        self.parent: _TrieNode | None = parent
        self.last_used = 0


class PrefixTrie:
    """Radix tree over cached prompt prefixes, at KV-block granularity.

    Prompts retain their complete-block pages here (one retention pin per
    page, :meth:`PagedKVCache.pin_pages`); admission matches a new prompt
    against the tree (:meth:`match`) and adopts every matched page
    (:meth:`PagedKVCache.adopt_pages`); a leaf-first LRU evictor reclaims
    cold subtrees under pool pressure (:meth:`reclaim`) or the
    ``retain_pages`` budget (:meth:`trim_to_budget`).  Matches are whole
    blocks (``block_tokens``, a multiple of the page size), so adoption is
    page-aligned and a hit is exactly what the nested prefix scheduler
    groups.  ``epoch`` counts topology changes (insert, split, evict); a
    memoizing decode scheduler keys on it.  Host-side Python, O(blocks
    touched) per call.
    """

    def __init__(self, cache: PagedKVCache, *, block_tokens: int,
                 retain_pages: int | None = None):
        if block_tokens < 1 or block_tokens % cache.page_size:
            raise ValueError(
                f"block_tokens={block_tokens} must be a positive multiple "
                f"of the cache page_size={cache.page_size} (trie nodes own "
                "whole pages)"
            )
        if retain_pages is not None and retain_pages < 0:
            raise ValueError(f"retain_pages must be >= 0, got {retain_pages}")
        self.cache = cache
        self.block_tokens = int(block_tokens)
        self.pages_per_block = block_tokens // cache.page_size
        self.retain_pages = retain_pages
        self.root = _TrieNode((), (), None)
        self.epoch = 0
        self._clock = 0
        self.pinned_pages = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_nodes = 0
        self.evicted_nodes = 0
        self.evicted_pages = 0

    # -- structure ------------------------------------------------------- #
    def _blocks_of(self, tokens) -> list[tuple]:
        bt = self.block_tokens
        return [tuple(tokens[i * bt : (i + 1) * bt]) for i in range(len(tokens) // bt)]

    def _nodes(self):
        """Every node but the root, depth first."""
        stack = [self.root]
        while stack:
            for child in stack.pop().children.values():
                yield child
                stack.append(child)

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._nodes())

    def _leaves(self) -> list[_TrieNode]:
        return [n for n in self._nodes() if not n.children]

    def _freeable(self, node: _TrieNode) -> int:
        """Pages of ``node`` held only by pins: unpinning frees them."""
        ref, pin = self.cache._ref, self.cache._pin
        return sum(1 for p in node.pages if ref[p] == pin[p])

    def _any_freeable(self) -> bool:
        ref, pin = self.cache._ref, self.cache._pin
        return bool(np.any((pin > 0) & (ref == pin)))

    def _common(self, child: _TrieNode, blocks, i: int) -> int:
        """How many of ``child``'s blocks equal ``blocks[i:]``'s first."""
        k = 0
        while k < len(child.blocks) and i + k < len(blocks) and child.blocks[k] == blocks[i + k]:
            k += 1
        return k

    # -- lookup ---------------------------------------------------------- #
    def match(self, tokens, *, touch: bool = True, count: bool = True):
        """Longest cached prefix of ``tokens``: ``(matched_rows, pages)``.
        A partial edge match is used as it is (no split).  ``touch``
        refreshes the walked nodes' LRU stamps; ``count`` the hit/miss
        counters."""
        blocks = self._blocks_of(tokens)
        if touch:
            self._clock += 1
        node, pages, i = self.root, [], 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            k = self._common(child, blocks, i)
            if touch:
                child.last_used = self._clock
            pages.extend(child.pages[: k * self.pages_per_block])
            i += k
            if k < len(child.blocks):
                break
            node = child
        matched = i * self.block_tokens
        if count:
            if matched:
                self.hits += 1
                self.hit_tokens += matched
            else:
                self.misses += 1
        return matched, pages

    # -- retention ------------------------------------------------------- #
    def _split(self, node: _TrieNode, k: int) -> _TrieNode:
        """Split ``node``'s edge after ``k`` blocks; returns the new top
        half (the pins stay as they are: the same pages, two nodes)."""
        ppb = self.pages_per_block
        top = _TrieNode(node.blocks[:k], node.pages[: k * ppb], node.parent)
        top.last_used = node.last_used
        node.parent.children[top.blocks[0]] = top
        node.blocks = node.blocks[k:]
        node.pages = node.pages[k * ppb :]
        node.parent = top
        top.children[node.blocks[0]] = node
        self.epoch += 1
        return top

    def insert(self, tokens, pages) -> int:
        """Retain ``tokens``' complete blocks backed by ``pages`` (the
        sequence's leading pages, still live: pins only stack on live
        pages).  Blocks already cached keep their pages; only the uncovered
        tail is pinned.  Returns the pages newly pinned, then enforces the
        ``retain_pages`` budget."""
        ppb = self.pages_per_block
        blocks = self._blocks_of(tokens)
        if len(pages) < len(blocks) * ppb:
            raise ValueError(
                f"insert of {len(blocks)} blocks needs {len(blocks) * ppb} "
                f"pages, got {len(pages)}"
            )
        self._clock += 1
        node, i, pinned = self.root, 0, 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                tail = [int(p) for p in pages[i * ppb : len(blocks) * ppb]]
                self.cache.pin_pages(tail)
                fresh = _TrieNode(blocks[i:], tail, node)
                fresh.last_used = self._clock
                node.children[blocks[i]] = fresh
                self.pinned_pages += len(tail)
                pinned = len(tail)
                self.inserted_nodes += 1
                self.epoch += 1
                break
            k = self._common(child, blocks, i)
            child.last_used = self._clock
            if k < len(child.blocks):
                if i + k == len(blocks):
                    break  # ends inside the edge: already covered
                child = self._split(child, k)
            node = child
            i += k
        if self.retain_pages is not None:
            self.trim_to_budget()
        return pinned

    # -- eviction -------------------------------------------------------- #
    def _evict_node(self, node: _TrieNode) -> int:
        """Unpin one leaf and detach it; returns the pages freed."""
        before = self.cache.num_free_pages
        del node.parent.children[node.blocks[0]]
        self.cache.unpin_pages(node.pages)
        self.pinned_pages -= len(node.pages)
        self.evicted_nodes += 1
        self.evicted_pages += len(node.pages)
        self.epoch += 1
        return self.cache.num_free_pages - before

    def reclaim(self, n_pages: int) -> int:
        """Evict leaves until ``n_pages`` returned to the free list, or
        nothing pinned can free a page: leaves whose pages free first,
        oldest first; a leaf that frees nothing only to reach a freeable
        ancestor.  Pages a live request aliases are never freed.  Returns
        the pages freed."""
        freed = 0
        while freed < int(n_pages) and self._any_freeable():
            leaves = self._leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (self._freeable(n) == 0, n.last_used))
            freed += self._evict_node(victim)
        return freed

    def trim_to_budget(self) -> int:
        """LRU-evict leaves until ``pinned_pages <= retain_pages`` (no-op
        when unbudgeted); returns the pages freed."""
        if self.retain_pages is None:
            return 0
        freed = 0
        while self.pinned_pages > self.retain_pages:
            leaves = self._leaves()
            if not leaves:
                break
            freed += self._evict_node(min(leaves, key=lambda n: n.last_used))
        return freed

    def clear(self) -> int:
        """Evict everything (session teardown); returns the pages freed."""
        freed = 0
        while True:
            leaves = self._leaves()
            if not leaves:
                return freed
            for leaf in leaves:
                freed += self._evict_node(leaf)

    # -- introspection --------------------------------------------------- #
    def stats(self) -> dict:
        return {
            "pinned_pages": self.pinned_pages,
            "num_nodes": self.num_nodes,
            "epoch": self.epoch,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "inserted_nodes": self.inserted_nodes,
            "evicted_nodes": self.evicted_nodes,
            "evicted_pages": self.evicted_pages,
        }
