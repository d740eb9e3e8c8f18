"""Flat work-queue scheduling for AMLA decode (paper §4.2 + flash-decoding).

Copied from ``repro.kernels.decode_schedule`` (the flat work queue, the
flat and nested shared-prefix grouping, the work accounting, the sharded
router and work balance, the prefill-budget planner and the SLA admission
order): plain host-side numpy and Python, so the schedule arrays, routes,
slices and orders are identical to the reference's by construction.

* one **work item** = one §4.2 KV block (``block_k`` rows = 4 pages of 128)
  of one request — the granularity of one AMLA state update;
* items exist only for blocks that intersect ``[0, kv_len)``;
* long requests are optionally **split flash-decoding style** across
  ``num_splits`` destination slots, merged by the combine kernel;
* the queue is padded to a ``queue_bucket`` multiple with inert items;
* requests whose block tables alias the same leading pages (forked
  prefixes) are grouped, and their shared blocks scheduled once per group
  (:func:`build_prefix_schedule`) for the group-prefix kernel; nested
  grouping (the prefix trie's topology) gives every shared run its own
  group over a ``[start, end)`` block window.

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
    start_blocks=None,
) -> DecodeSchedule:
    """Compact ``(request, kv_block)`` work items from per-request lengths.

    A request with ``nb`` blocks is divided into ``min(num_splits, nb)``
    contiguous chunks of near-equal size (first chunks one block longer
    when ``nb % splits != 0``).  ``start_blocks`` (per request, default 0)
    makes this a suffix schedule: request ``r`` only contributes blocks
    ``[start_blocks[r], nb)``; a request whose start is at or past its
    block count gets no items and ``n_splits == 0``.
    """
    if block_k < 1:
        raise ValueError("block_k must be >= 1")
    if num_splits < 1:
        raise ValueError("num_splits must be >= 1")
    kv_lens = np.asarray(kv_lens, np.int64).reshape(-1)
    b = int(kv_lens.shape[0])
    if start_blocks is None:
        start_blocks = np.zeros((b,), np.int64)
    else:
        start_blocks = np.asarray(start_blocks, np.int64).reshape(-1)
        if start_blocks.shape[0] != b:
            raise ValueError("start_blocks must match kv_lens length")

    req, blk, dst, fst, lst = [], [], [], [], []
    dest_table = np.zeros((b, num_splits), np.int32)
    n_splits = np.zeros((b,), np.int32)
    for r in range(b):
        nb = max(-(-int(kv_lens[r]) // block_k) - int(start_blocks[r]), 0)
        k = min(num_splits, nb)
        n_splits[r] = k
        # Padding dest entries repeat the request's own last live slot.
        dest_table[r, :] = r * num_splits + max(k - 1, 0)
        base, rem = divmod(nb, max(k, 1))
        next_block = int(start_blocks[r])
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


def queue_capacity(queue_len: int, queue_bucket: int = DEFAULT_QUEUE_BUCKET) -> int:
    """The queue length a schedule of ``queue_len`` items is padded to
    (:func:`pad_queue`) for a CUDA graph of the decode walk: the bucket
    times the least power of two that holds it.  So the padded queue is at
    most twice the schedule's (every K2 CTA scans the whole queue), and a
    batch whose requests grow passes through few lengths, each one graph."""
    n = max(queue_bucket, 1)
    while n < queue_len:
        n *= 2
    return n


def pad_queue(schedule: DecodeSchedule, n: int) -> DecodeSchedule:
    """``schedule`` with its queue padded to ``n`` items by the inert items
    :func:`build_schedule` pads with (``item_valid = 0``, dest the dump
    slot), so one queue length serves every step of a batch and the kernels
    compute the same partials.  Not in this copy's reference: the CUDA
    graphs of the port's decode walk keep their arrays' shapes with it."""
    pad = n - schedule.queue_len
    if pad < 0:
        raise ValueError(f"a queue of {schedule.queue_len} items does not fit in {n}")
    dump = schedule.num_requests * schedule.num_splits
    grow = lambda a, fill: np.concatenate([a, np.full((pad,), fill, np.int32)])
    return dataclasses.replace(
        schedule,
        item_req=grow(schedule.item_req, 0),
        item_block=grow(schedule.item_block, 0),
        item_dest=grow(schedule.item_dest, dump),
        item_first=grow(schedule.item_first, 1),
        item_last=grow(schedule.item_last, 0),
        item_valid=grow(schedule.item_valid, 0),
        device_arrays={},
    )


# --------------------------------------------------------------------------- #
# shared-prefix grouping (group-batched prefix attention)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class PrefixGroups:
    """Requests grouped by aliased (refcount-shared) prefix page runs.

    Two requests belong together only when their block tables name the
    same physical pages for a leading run of complete ``block_k`` blocks —
    under ``PagedKVCache.fork`` or trie adoption, exactly "they share a
    prefix".  Equal content without aliasing never groups.  Group ``g``
    covers blocks ``[start_of_group(g), shared_blocks[g])``: flat grouping
    starts every group at 0; nested grouping gives each trie node its own
    window, and a request combines one prefix partial per group of its
    chain (:meth:`chain_of_req`).
    """

    group_member: np.ndarray  # (n_groups, gmax) request index, -1 padding
    group_size: np.ndarray  # (n_groups,)
    group_rep: np.ndarray  # (n_groups,) representative request (table row)
    shared_blocks: np.ndarray  # (n_groups,) exclusive END block of the run
    group_of_req: np.ndarray  # (B,) deepest group id, -1 for ungrouped
    slot_of_req: np.ndarray  # (B,) member slot within that group, -1
    gmax: int  # max members over groups (stacked-query width)
    num_groups: int
    group_start: np.ndarray | None = None  # (n_groups,) first block covered
    req_chains: tuple | None = None  # (B,) of ((g, slot), ...), outermost first

    def chain_of_req(self, r: int) -> tuple:
        """``((group, slot), ...)`` covering request ``r``, outermost
        first (the single flat group when chains are absent)."""
        if self.req_chains is not None:
            return self.req_chains[r]
        g = int(self.group_of_req[r])
        return () if g < 0 else ((g, int(self.slot_of_req[r])),)

    def start_of_group(self, g: int) -> int:
        return 0 if self.group_start is None else int(self.group_start[g])


def _common_run(sigs, members, rep, start: int) -> int:
    """Exclusive end of the longest block run all ``members`` share with
    ``rep`` given they already agree on ``[0, start)``."""
    n = len(sigs[rep])
    for m in members:
        if m == rep:
            continue
        k = start
        mlim = min(n, len(sigs[m]))
        while k < mlim and sigs[m][k] == sigs[rep][k]:
            k += 1
        n = min(n, k)
    return n


def _nested_group_list(sigs, min_group: int) -> list[tuple]:
    """Trie-topology grouping, ``(members, start, end)`` per inner node:
    a bucket of requests sharing block ``start`` is one group over its
    common run ``[start, end)``, then split by block ``end`` into deeper
    buckets; every level honours ``min_group``.  Outer groups first."""
    floor = max(min_group, 2)
    out: list[tuple] = []
    by_first: dict[tuple, list[int]] = {}
    for r, sig in enumerate(sigs):
        if sig:
            by_first.setdefault(sig[0], []).append(r)
    stack = [(members, 0) for members in by_first.values() if len(members) >= floor]
    while stack:
        members, start = stack.pop()
        end = _common_run(sigs, members, members[0], start)
        if end > start:
            out.append((members, start, end))
        sub: dict[tuple, list[int]] = {}
        for m in members:
            if len(sigs[m]) > end:
                sub.setdefault(sigs[m][end], []).append(m)
        for bucket in sub.values():
            if len(bucket) >= floor:
                stack.append((bucket, end))
    out.sort(key=lambda t: (t[1], t[0]))
    return out


def find_prefix_groups(
    block_tables,
    kv_lens,
    *,
    page_size: int,
    block_k: int,
    min_group: int = 2,
    nested: bool = False,
) -> PrefixGroups:
    """Group requests whose tables alias the same leading KV-block pages.

    A block is shared by a group when every member's table points at the
    identical page-id tuple for it and the block is complete for every
    member (``(j+1) * block_k <= kv_len``).  Flat grouping: members joining
    on block 0 but diverging later share only the common run; requests
    with no complete first block, or whose first block fewer than
    ``min_group`` requests alias, stay ungrouped.  ``nested=True`` recurses
    past each divergence (:func:`_nested_group_list`) and records each
    request's chain of groups.
    """
    if block_k % page_size or block_k < page_size:
        raise ValueError(
            f"block_k={block_k} must be a positive multiple of "
            f"page_size={page_size}"
        )
    bt = np.asarray(block_tables)
    kv = np.asarray(kv_lens, np.int64).reshape(-1)
    b = int(kv.shape[0])
    n_sub = block_k // page_size
    sigs: list[list[tuple]] = []
    for r in range(b):
        nb_full = min(int(kv[r]) // block_k, bt.shape[1] // n_sub)
        sigs.append(
            [
                tuple(bt[r, j * n_sub : (j + 1) * n_sub].tolist())
                for j in range(nb_full)
            ]
        )
    if nested:
        group_list = _nested_group_list(sigs, min_group)
    else:
        by_first: dict[tuple, list[int]] = {}
        for r in range(b):
            if sigs[r]:
                by_first.setdefault(sigs[r][0], []).append(r)
        group_list = []
        for members in by_first.values():
            if len(members) < max(min_group, 2):
                continue
            n = _common_run(sigs, members, members[0], 0)
            if n >= 1:
                group_list.append((members, 0, n))

    num_groups = len(group_list)
    gmax = max((len(m) for m, _, _ in group_list), default=0)
    group_member = np.full((num_groups, max(gmax, 1)), -1, np.int32)
    group_size = np.zeros((num_groups,), np.int32)
    group_rep = np.zeros((num_groups,), np.int32)
    shared_blocks = np.zeros((num_groups,), np.int32)
    group_start = np.zeros((num_groups,), np.int32)
    group_of_req = np.full((b,), -1, np.int32)
    slot_of_req = np.full((b,), -1, np.int32)
    chains: list[list[tuple]] = [[] for _ in range(b)]
    for g, (members, start, end) in enumerate(group_list):
        group_size[g] = len(members)
        group_rep[g] = members[0]
        shared_blocks[g] = end
        group_start[g] = start
        for i, r in enumerate(members):
            group_member[g, i] = r
            # the deepest covering group: groups come start-ascending
            group_of_req[r] = g
            slot_of_req[r] = i
            chains[r].append((g, i))
    return PrefixGroups(
        group_member=group_member,
        group_size=group_size,
        group_rep=group_rep,
        shared_blocks=shared_blocks,
        group_of_req=group_of_req,
        slot_of_req=slot_of_req,
        gmax=gmax,
        num_groups=num_groups,
        group_start=group_start,
        req_chains=tuple(tuple(c) for c in chains),
    )


@dataclasses.dataclass(frozen=True)
class PrefixSchedule:
    """Two-pass decode schedule: group-batched prefix + per-request suffix.

    ``prefix`` treats each group as a virtual request of ``gmax * G``
    stacked query rows over its window of the shared prefix (items from
    ``start_of_group(g)`` to ``shared_blocks[g]``, through the
    representative member's table row), one item per ``(group,
    kv_block)``; ``suffix`` is a plain :func:`build_schedule` whose
    ``start_blocks`` skip each grouped request past its deepest group.
    :meth:`hetero_dest_tables` merges both passes' partials in the combine
    kernel.
    """

    suffix: DecodeSchedule
    prefix: DecodeSchedule | None  # over groups; None when num_groups == 0
    groups: PrefixGroups
    start_blocks: np.ndarray  # (B,) suffix start block per request
    prefix_lens: np.ndarray  # (n_groups,) end row of each group's window
    block_k: int
    # Device copies of the prefix pass's arrays (see DecodeSchedule).
    device_arrays: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def num_groups(self) -> int:
        return self.groups.num_groups

    def hetero_dest_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Combine tables over the concatenated partial array ``[suffix
        slots ; prefix member rows]``: suffix partials occupy slots ``[0,
        suffix.num_dest_slots)``, prefix member rows follow at
        ``suffix.num_dest_slots + group * gmax + slot`` (the prefix pass
        has one dest slot per group).  Returns ``(dest_table (B,
        num_splits + max chain length), n_splits (B,))``: a request merges
        its suffix splits and one prefix partial per group of its chain."""
        suf = self.suffix
        b = suf.num_requests
        d_suf = suf.num_dest_slots
        gmax = max(self.groups.gmax, 1)
        max_chain = max((len(self.groups.chain_of_req(r)) for r in range(b)), default=0)
        s_ext = suf.num_splits + max(max_chain, 1)
        dest = np.zeros((b, s_ext), np.int32)
        n_ext = np.zeros((b,), np.int32)
        for r in range(b):
            slots = [
                int(suf.dest_table[r, j]) for j in range(int(suf.n_splits[r]))
            ]
            for g, slot in self.groups.chain_of_req(r):
                if self.groups.shared_blocks[g] > self.groups.start_of_group(g):
                    slots.append(d_suf + g * gmax + int(slot))
            n_ext[r] = len(slots)
            if not slots:  # kv_len == 0: gated off, fetch warm slot 0
                slots = [0]
            dest[r] = np.asarray(
                (slots + [slots[-1]] * s_ext)[:s_ext], np.int32
            )
        return dest, n_ext


def build_prefix_schedule(
    kv_lens,
    block_tables,
    *,
    page_size: int,
    block_k: int = 512,
    num_splits: int = 1,
    queue_bucket: int = DEFAULT_QUEUE_BUCKET,
    min_group: int = 2,
    nested: bool = False,
) -> PrefixSchedule:
    """Group-batched shared-prefix schedule over ``(kv_lens,
    block_tables)``.  With no aliased prefixes it degenerates to the plain
    schedule (empty prefix pass, suffix pass == :func:`build_schedule`).
    With ``nested`` each group's prefix items cover only its own window
    and each suffix starts past its request's deepest group, so the
    partials of a request's chain and suffix tile ``[0, kv_len)`` once."""
    kv = np.asarray(kv_lens, np.int64).reshape(-1)
    groups = find_prefix_groups(
        block_tables,
        kv,
        page_size=page_size,
        block_k=block_k,
        min_group=min_group,
        nested=nested,
    )
    start_blocks = np.zeros((kv.shape[0],), np.int64)
    for g in range(groups.num_groups):
        for i in range(int(groups.group_size[g])):
            r = int(groups.group_member[g, i])
            start_blocks[r] = max(start_blocks[r], int(groups.shared_blocks[g]))
    suffix = build_schedule(
        kv,
        block_k=block_k,
        num_splits=num_splits,
        queue_bucket=queue_bucket,
        start_blocks=start_blocks,
    )
    prefix_lens = groups.shared_blocks.astype(np.int64) * block_k
    prefix = None
    if groups.num_groups:
        # Prefix items never split: one dest slot per group.  Group g's
        # virtual request has kv_len = end * block_k and starts at its
        # window's first block.
        prefix = build_schedule(
            prefix_lens,
            block_k=block_k,
            num_splits=1,
            queue_bucket=queue_bucket,
            start_blocks=groups.group_start.astype(np.int64),
        )
    return PrefixSchedule(
        suffix=suffix,
        prefix=prefix,
        groups=groups,
        start_blocks=start_blocks,
        prefix_lens=prefix_lens,
        block_k=block_k,
    )


class DecodeScheduler:
    """Memoizing schedule factory for a serve loop.

    A request's block count changes only every ``block_k`` tokens, so one
    schedule serves many consecutive steps; ``schedule()`` rebuilds only
    when the batch's block signature or ``extra_key`` (a batch-identity
    token such as the tuple of live request ids) changes.
    ``schedule_prefix()`` additionally keys on the page ids that grouping
    inspects, so copy-on-write and pool churn never serve a stale group
    structure; ``nested`` selects the trie-topology grouping.
    """

    def __init__(
        self,
        *,
        block_k: int = 512,
        num_splits: int = 1,
        queue_bucket: int = DEFAULT_QUEUE_BUCKET,
        min_group: int = 2,
        nested: bool = False,
    ):
        self.block_k = block_k
        self.num_splits = num_splits
        self.queue_bucket = queue_bucket
        self.min_group = min_group
        self.nested = nested
        self._key: tuple | None = None
        self._cached: DecodeSchedule | PrefixSchedule | None = None
        self.hits = 0
        self.rebuilds = 0

    @property
    def current(self) -> DecodeSchedule | PrefixSchedule | None:
        """The most recently served schedule (for work accounting)."""
        return self._cached

    def _lookup(self, key, build):
        if key == self._key and self._cached is not None:
            self.hits += 1
            return self._cached
        self.rebuilds += 1
        self._cached = build()
        self._key = key
        return self._cached

    def schedule(self, kv_lens, extra_key=None) -> DecodeSchedule:
        kv_lens = np.asarray(kv_lens).reshape(-1)
        key = (
            "plain",
            kv_lens.shape[0],
            _block_signature(kv_lens, self.block_k),
            extra_key,
        )
        return self._lookup(
            key,
            lambda: build_schedule(
                kv_lens,
                block_k=self.block_k,
                num_splits=self.num_splits,
                queue_bucket=self.queue_bucket,
            ),
        )

    def schedule_prefix(
        self, kv_lens, block_tables, *, page_size: int, extra_key=None
    ) -> PrefixSchedule:
        """Memoized :func:`build_prefix_schedule`: valid while block counts
        and the page ids of each request's complete blocks are unchanged."""
        kv_lens = np.asarray(kv_lens).reshape(-1)
        bt = np.asarray(block_tables)
        n_sub = max(self.block_k // page_size, 1)
        page_sig = tuple(
            bt[r, : (int(kv_lens[r]) // self.block_k) * n_sub].tobytes()
            for r in range(kv_lens.shape[0])
        )
        key = (
            "prefix",
            self.nested,
            kv_lens.shape[0],
            _block_signature(kv_lens, self.block_k),
            page_sig,
            extra_key,
        )
        return self._lookup(
            key,
            lambda: build_prefix_schedule(
                kv_lens,
                bt,
                page_size=page_size,
                block_k=self.block_k,
                num_splits=self.num_splits,
                queue_bucket=self.queue_bucket,
                min_group=self.min_group,
                nested=self.nested,
            ),
        )


def padded_grid_items(kv_lens, table_width: int, page_size: int) -> dict:
    """Work executed by the padded ``(B, W)`` grid on this batch: every
    request walks all ``W`` table slots; a request pays its live pages plus
    at most one extra (clamped) tail fetch."""
    kv_lens = np.asarray(kv_lens, np.int64).reshape(-1)
    b = int(kv_lens.shape[0])
    pages = [-(-int(l) // page_size) for l in kv_lens]
    live_pages = int(sum(pages))
    page_dmas = int(sum(p + (1 if p < table_width else 0) for p in pages))
    return {
        "grid_steps": b * table_width,
        "page_slots": b * table_width,
        "page_dmas": page_dmas,
        "live_pages": live_pages,
    }


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


def prefix_queue_grid_items(
    ps: PrefixSchedule, kv_lens, page_size: int, *, query_rows: int = 1
) -> dict:
    """Work executed by the two-pass shared-prefix schedule on this batch:
    ``prefix_page_dmas`` is paid once per group, against
    ``unshared_prefix_page_dmas`` (the same pages times the group size)
    that the plain queue would read."""
    kv_lens = np.asarray(kv_lens, np.int64).reshape(-1)
    n_sub = max(ps.block_k // page_size, 1)
    live_pages = int(sum(-(-int(l) // page_size) for l in kv_lens))
    suffix_pages = int(
        sum(
            max(-(-int(l) // page_size) - int(s) * n_sub, 0)
            for l, s in zip(kv_lens, ps.start_blocks)
        )
    )
    # Each group reads only its own window: ancestors in a nested chain
    # cover [0, start); flat groups start at 0.
    gs = ps.groups.group_start
    if gs is None:
        gs = np.zeros_like(ps.groups.shared_blocks)
    span = ps.groups.shared_blocks - gs
    prefix_pages = int(np.sum(span)) * n_sub
    unshared_prefix_pages = int(np.sum(span * ps.groups.group_size)) * n_sub
    grid_steps = ps.suffix.queue_len + (
        ps.prefix.queue_len if ps.prefix is not None else 0
    )
    executed = ps.suffix.num_items + (
        ps.prefix.num_items if ps.prefix is not None else 0
    )
    return {
        "grid_steps": grid_steps,
        "executed_items": executed,
        "page_dmas": suffix_pages + prefix_pages,
        "live_pages": live_pages,
        "prefix_page_dmas": prefix_pages,
        "unshared_prefix_page_dmas": unshared_prefix_pages,
        "num_groups": ps.num_groups,
        "grouped_requests": int(np.sum(ps.groups.group_of_req >= 0)),
        "query_rows": int(kv_lens.shape[0]) * int(query_rows),
        "row_reads": int(kv_lens.sum()) * int(query_rows),
    }


# --------------------------------------------------------------------------- #
# sharded-serving routing (data-parallel page pools)
# --------------------------------------------------------------------------- #


def route_request(
    shard_live_blocks,
    shard_free_pages,
    pages_needed: int,
    shard_ok=None,
    shard_hit_pages=None,
):
    """Pick the data shard to admit a new request onto.

    ``shard_live_blocks[i]`` is shard i's current decode work proxy (sum of
    live §4.2 KV blocks across its requests — one queue item each per decode
    step), ``shard_free_pages[i]`` its free pool pages.  Among shards that
    can hold ``pages_needed`` pages, pick the least-loaded by live block
    count; break ties toward more free pages, then the lowest index (so
    an empty fleet fills deterministically shard 0, 1, ...).

    ``shard_hit_pages[i]`` (optional) is the prefix-trie hit for this
    request on shard i, in pages.  Hit pages are aliased rather than
    allocated, so eligibility needs only ``pages_needed - hit`` free pages,
    and ties in live blocks break toward the *longest hit* first — prefix
    locality beats free-pool slack because the hit pages are DMA and
    prefill the shard never pays.  Tries are shard-local, so this is the
    only place cross-shard hit lengths compete.

    ``shard_ok[i]`` (optional) masks admissibility: draining shards finish
    their live requests but take no new ones, dead shards take nothing —
    the shard lifecycle passes ``health == "healthy"`` here.

    Returns the shard index, or None when no shard has room (caller evicts
    or defers).
    """
    best = None
    for i, (blocks, free) in enumerate(zip(shard_live_blocks, shard_free_pages)):
        if shard_ok is not None and not shard_ok[i]:
            continue
        hit = int(shard_hit_pages[i]) if shard_hit_pages is not None else 0
        if free < max(pages_needed - hit, 0):
            continue
        key = (int(blocks), -hit, -int(free), i)
        if best is None or key < best[0]:
            best = (key, i)
    return None if best is None else best[1]


def shard_work_balance(per_shard_items) -> dict:
    """max/mean imbalance of a per-shard work proxy (queue items, page DMAs).

    ``imbalance`` is 1.0 for a perfectly even split and rises as one shard
    hoards the work (the reference's sharded `[MODEL-SERVE]` benchmark row
    gates on <= 2.0 for the ragged stream).  Empty fleets report 0.0 work and imbalance 1.0.
    """
    items = [float(x) for x in per_shard_items]
    total = sum(items)
    mean = total / len(items) if items else 0.0
    peak = max(items) if items else 0.0
    return {
        "per_shard": items,
        "total": total,
        "max": peak,
        "mean": mean,
        "imbalance": (peak / mean) if mean > 0 else 1.0,
    }


def plan_prefill_slices(remaining, budget: int, chunk: int) -> list:
    """Split a per-step prefill token budget over pending prompts.

    ``remaining[i]`` is pending prompt i's unprefilled token count, in
    arrival (FIFO) order.  Returns ``slices`` with ``slices[i]`` tokens to
    prefill this step.  Every slice is a multiple of ``chunk`` except a
    prompt's final tail, so repeated budgeted slices land on exactly the
    chunk boundaries one monolithic prefill would (bit-identical rows).

    Policy (deterministic): the oldest pending prompt claims up to one
    chunk first (no starvation of a long prompt by short arrivals); the
    rest of the budget goes shortest-remaining-first, ties toward older
    arrivals.
    """
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    rem = [int(r) for r in remaining]
    slices = [0] * len(rem)
    left = int(budget)

    def grant(i: int, amount: int) -> int:
        r = rem[i] - slices[i]
        take = r if r <= amount else (amount // chunk) * chunk
        slices[i] += take
        return take

    if not rem or left <= 0:
        return slices
    left -= grant(0, min(chunk, left))
    for i in sorted(range(len(rem)), key=lambda j: (rem[j] - slices[j], j)):
        if left <= 0:
            break
        if rem[i] - slices[i] > 0:
            left -= grant(i, left)
    return slices


def admission_order(items) -> list:
    """SLA-aware admission order of queued submissions.

    ``items`` is an iterable of ``(idx, priority, slack)``: submission
    index, priority class (higher = more urgent) and deadline slack in
    steps (None = no deadline).  Returns the indices highest priority
    first, then least slack, then submission index.
    """
    def key(item):
        idx, priority, slack = item
        return (-int(priority), float("inf") if slack is None else float(slack), int(idx))

    return [int(item[0]) for item in sorted(items, key=key)]
