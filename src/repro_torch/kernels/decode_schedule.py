"""Flat work-queue scheduling for AMLA decode (paper §4.2 + flash-decoding).

Copied from ``repro.kernels.decode_schedule`` (the non-prefix path): plain
host-side numpy, so the schedule arrays are identical to the reference's by
construction.

* one **work item** = one §4.2 KV block (``block_k`` rows = 4 pages of 128)
  of one request — the granularity of one AMLA state update;
* items exist only for blocks that intersect ``[0, kv_len)``;
* long requests are optionally **split flash-decoding style** across
  ``num_splits`` destination slots, merged by the combine kernel;
* the queue is padded to a ``queue_bucket`` multiple with inert items.

Destination-slot layout: request ``r`` split ``j`` accumulates into slot
``r * num_splits + j``, and one trailing slot is the dump for padding items.
A dest slot's items are contiguous and in ascending block order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_QUEUE_BUCKET = 16


@dataclasses.dataclass(frozen=True)
class DecodeSchedule:
    """A compacted decode work queue (all arrays host-side numpy int32)."""

    item_req: np.ndarray  # (N,) request index per item
    item_block: np.ndarray  # (N,) kv-block index within the request
    item_dest: np.ndarray  # (N,) destination partial-state slot
    item_first: np.ndarray  # (N,) 1 on a dest's first item (state init)
    item_last: np.ndarray  # (N,) 1 on a dest's last item (finalize+write)
    item_valid: np.ndarray  # (N,) 0 for queue padding (inert)
    dest_table: np.ndarray  # (B, num_splits) dest slot per request/split
    n_splits: np.ndarray  # (B,) live splits per request (0 if kv_len == 0)
    block_k: int  # rows per work item (§4.2: 512)
    num_splits: int  # max splits per request (static)
    num_items: int  # real items (excludes padding)
    num_requests: int
    # Device copies of the arrays, filled by ``ops.mla_decode_paged`` so a
    # schedule shared by every layer (and memoized across steps) is copied
    # to the device once.  Not part of the schedule's identity.
    device_arrays: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def queue_len(self) -> int:
        return int(self.item_req.shape[0])

    @property
    def num_dest_slots(self) -> int:
        """Partial-output rows: B * num_splits real + 1 padding dump."""
        return self.num_requests * self.num_splits + 1

    def prefetch_arrays(self) -> tuple[np.ndarray, ...]:
        """The six queue arrays in the kernel's argument order."""
        return (
            self.item_req,
            self.item_block,
            self.item_dest,
            self.item_first,
            self.item_last,
            self.item_valid,
        )


def _block_signature(kv_lens: np.ndarray, block_k: int) -> tuple:
    """Per-request block counts — the only thing a schedule depends on."""
    return tuple(-(-int(l) // block_k) for l in kv_lens)


def build_schedule(
    kv_lens,
    *,
    block_k: int = 512,
    num_splits: int = 1,
    queue_bucket: int = DEFAULT_QUEUE_BUCKET,
) -> DecodeSchedule:
    """Compact ``(request, kv_block)`` work items from per-request lengths.

    A request with ``nb`` blocks is divided into ``min(num_splits, nb)``
    contiguous chunks of near-equal size (first chunks one block longer
    when ``nb % splits != 0``).
    """
    if block_k < 1:
        raise ValueError("block_k must be >= 1")
    if num_splits < 1:
        raise ValueError("num_splits must be >= 1")
    kv_lens = np.asarray(kv_lens, np.int64).reshape(-1)
    b = int(kv_lens.shape[0])

    req, blk, dst, fst, lst = [], [], [], [], []
    dest_table = np.zeros((b, num_splits), np.int32)
    n_splits = np.zeros((b,), np.int32)
    for r in range(b):
        nb = max(-(-int(kv_lens[r]) // block_k), 0)
        k = min(num_splits, nb)
        n_splits[r] = k
        # Padding dest entries repeat the request's own last live slot.
        dest_table[r, :] = r * num_splits + max(k - 1, 0)
        base, rem = divmod(nb, max(k, 1))
        next_block = 0
        for j in range(k):
            dest = r * num_splits + j
            dest_table[r, j] = dest
            chunk = base + (1 if j < rem else 0)
            for t in range(chunk):
                req.append(r)
                blk.append(next_block + t)
                dst.append(dest)
                fst.append(1 if t == 0 else 0)
                lst.append(1 if t == chunk - 1 else 0)
            next_block += chunk

    num_items = len(req)
    pad_to = max(queue_bucket, 1)
    n = max(-(-num_items // pad_to) * pad_to, pad_to)
    dump = b * num_splits  # trailing dest slot, never combined
    pad = n - num_items
    arr = lambda xs, fill: np.asarray(xs + [fill] * pad, np.int32)
    return DecodeSchedule(
        item_req=arr(req, 0),
        item_block=arr(blk, 0),
        item_dest=arr(dst, dump),
        item_first=arr(fst, 1),
        item_last=arr(lst, 0),
        item_valid=np.asarray([1] * num_items + [0] * pad, np.int32),
        dest_table=dest_table,
        n_splits=n_splits,
        block_k=block_k,
        num_splits=num_splits,
        num_items=num_items,
        num_requests=b,
    )


class DecodeScheduler:
    """Memoizing schedule factory for a serve loop (non-prefix path).

    A request's block count changes only every ``block_k`` tokens, so one
    schedule serves many consecutive steps; ``schedule()`` rebuilds only
    when the batch's block signature or ``extra_key`` (a batch-identity
    token such as the tuple of live request ids) changes.
    """

    def __init__(
        self,
        *,
        block_k: int = 512,
        num_splits: int = 1,
        queue_bucket: int = DEFAULT_QUEUE_BUCKET,
    ):
        self.block_k = block_k
        self.num_splits = num_splits
        self.queue_bucket = queue_bucket
        self._key: tuple | None = None
        self._cached: DecodeSchedule | None = None
        self.hits = 0
        self.rebuilds = 0

    @property
    def current(self) -> DecodeSchedule | None:
        """The most recently served schedule (for work accounting)."""
        return self._cached

    def schedule(self, kv_lens, extra_key=None) -> DecodeSchedule:
        kv_lens = np.asarray(kv_lens).reshape(-1)
        key = (
            "plain",
            kv_lens.shape[0],
            _block_signature(kv_lens, self.block_k),
            extra_key,
        )
        if key == self._key and self._cached is not None:
            self.hits += 1
            return self._cached
        self.rebuilds += 1
        self._cached = build_schedule(
            kv_lens,
            block_k=self.block_k,
            num_splits=self.num_splits,
            queue_bucket=self.queue_bucket,
        )
        self._key = key
        return self._cached


def queue_grid_items(
    schedule: DecodeSchedule, kv_lens, page_size: int, *, query_rows: int = 1
) -> dict:
    """Work executed by the flat queue on this batch: page reads are issued
    only for pages that intersect ``kv_len``; ``query_rows`` is the number
    of query token rows per request this call carried."""
    kv_lens = np.asarray(kv_lens, np.int64).reshape(-1)
    live_pages = int(sum(-(-int(l) // page_size) for l in kv_lens))
    return {
        "grid_steps": schedule.queue_len,
        "executed_items": schedule.num_items,
        "page_dmas": live_pages,
        "live_pages": live_pages,
        "query_rows": int(kv_lens.shape[0]) * int(query_rows),
        "row_reads": int(kv_lens.sum()) * int(query_rows),
    }
