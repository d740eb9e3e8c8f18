"""Serving sessions (counterpart of ``repro/runtime/serve_loop.py``'s
``ServingSession`` and the core of its ``PagedServingSession``).

:class:`ServingSession` is the dense backend: a fixed batch of decode
slots, each with ``max_len`` rows of every layer's cache; a new request is
prefilled into a free slot and every ``step`` advances all slots one
greedy token.  GQA layers attend through K6/K7, MLA layers through K4.

:class:`PagedServingSession` has the same greedy ``add_request`` /
``step`` / ``finish`` surface over a
:class:`~repro_torch.runtime.kv_cache.LayeredPagedKVCache` — one block
table shared by all L layers — with decode through ``ops.mla_decode_paged``
via ``models.transformer.lm_decode_step_paged``:

* admission is by free-page count; a prompt prefills **into pages** in
  fixed chunks of ``prefill_chunk`` tokens before ``add_request`` returns
  (phased admission) and emits the request's first token;
* each ``step`` decodes every live request by one greedy token with one
  schedule shared by all layers, memoized across steps by a
  :class:`~repro_torch.kernels.decode_schedule.DecodeScheduler`
  (``scheduler_stats`` counts steps, not layers);
* ``fork`` / ``admit_with_prefix`` branch a live request by page aliasing
  (copy-on-write at the next append); with ``prefix_sharing`` the family's
  shared blocks are attended once per group in every layer;
* ``prefix_cache="trie"`` reuses prefixes automatically: a
  :class:`~repro_torch.runtime.kv_cache.PrefixTrie` retains every prompt's
  complete ``block_k`` blocks, admission adopts the longest match and
  prefills only the rest, and decode groups the aliased blocks by the
  trie's topology (nested groups);
* ``speculate="ngram"`` makes each step a draft-verify step: an
  :class:`NGramProposer` drafts ``draft_k - 1`` tokens per request, one
  ``draft_k``-row decode verifies them, the longest draft prefix equal to
  the model's greedy picks is accepted and the rejected rows are rolled
  back (``cache.truncate``): the tokens are those of ``speculate="off"``;
* ``kv_dtype="int8"`` stores the latent pages as int8 with per-row scales;
* ``work_stats`` reports the reference's deterministic work counters.

:class:`PagedDecodeSession` is the attention-level session over one
:class:`~repro_torch.runtime.kv_cache.PagedKVCache`: callers bring absorbed
queries and latent rows; it decodes through the queue kernel (K2, int8 and
shared prefixes included) or the padded ``(B, W)`` kernel (K5).

``prefill_budget`` interleaving, suspend/resume and sharding
(``head_shards > 1``) belong to the next slices of the port and raise
``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import numpy as np
import torch


class ServingSession:
    """Single-host batched serving with slot reuse (continuous-batching-lite).

    A fixed batch of decode slots; each new request is prefilled into a
    free slot (ragged lengths handled by per-slot cache_len), every
    ``step()`` advances all slots one token (free slots decode a dummy
    token into their own rows, which the next prefill there clears), and
    finished requests free their slot for the next queued prompt.  Greedy
    sampling.

    On a CUDA device the decode step replays a CUDA graph
    (:class:`~repro_torch.runtime.step_graph.DenseDecodeStep`,
    ``step_graph``; one capture, at the first step: the batch is fixed):
    the reference jits ``decode_step``.  Prefill runs eagerly.
    """

    def __init__(self, model, params, *, batch_size: int, max_len: int):
        from repro_torch.runtime.step_graph import DenseDecodeStep

        self.model = model
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.device = params["embed"]["table"].device
        self.cache = model.init_cache(params, batch_size, max_len)
        self.cache_len = np.zeros((batch_size,), np.int32)
        self.last_token = np.zeros((batch_size,), np.int32)
        self.slot_rid: list[int | None] = [None] * batch_size
        self.outputs: dict[int, list[int]] = {}
        self._next_id = 0
        # Bucketed prefill: prompts are right-padded to the next power of
        # two, so a stream of ragged prompt lengths runs O(log max_len)
        # prefill shapes (the reference's compile count).  Only attention
        # stacks tolerate right-padding: causal masking keeps pad tokens
        # invisible to real positions.
        kinds = model.cfg.layer_kinds()
        self._bucket_prompts = bool(kinds) and all(k in ("global", "local") for k in kinds)
        self._prefill_shapes: set[int] = set()
        self.step_graph = DenseDecodeStep(model, params, self.cache, batch_size)

    @property
    def active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.slot_rid])

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run (the reference's jit compiles)."""
        return len(self._prefill_shapes)

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured of the decode step (0 where none is)."""
        return self.step_graph.graphs.captures

    def _bucket_len(self, plen: int) -> int:
        if not self._bucket_prompts:
            return plen
        blen = 1 << max(plen - 1, 0).bit_length()
        return max(min(blen, self.max_len), plen)

    def add_request(self, prompt_tokens) -> int | None:
        """Prefill a prompt into a free slot; returns request id or None."""
        prompt_tokens = list(map(int, prompt_tokens))
        plen = len(prompt_tokens)
        if plen < 1:
            raise ValueError(
                "add_request needs at least one prompt token (an empty "
                "prompt has no prefill position to decode from)"
            )
        if plen > self.max_len:
            raise ValueError(
                f"prompt of {plen} tokens exceeds this session's "
                f"max_len={self.max_len}; raise max_len or truncate the "
                "prompt (slots reserve exactly max_len cache rows)"
            )
        if None not in self.slot_rid:
            return None
        slot = self.slot_rid.index(None)
        # Recycled-slot invariant: finish() zeroes the slot's decode state,
        # so a reused slot must look factory-fresh here — decoding from a
        # stale cache_len/last_token would splice the previous request's
        # context into this one.
        assert self.cache_len[slot] == 0 and self.last_token[slot] == 0, (
            f"slot {slot} reused with stale state: cache_len="
            f"{self.cache_len[slot]}, last_token={self.last_token[slot]}"
        )
        rid = self._next_id
        self._next_id += 1
        blen = self._bucket_len(plen)
        padded = prompt_tokens + [0] * (blen - plen)
        prompt = torch.tensor([padded], dtype=torch.int64, device=self.device)
        # The prefill writes the slot's rows of every layer's cache in place,
        # through batch-1 views, cleared first: the reference prefills a
        # fresh zeroed batch-1 cache and copies it into the slot
        # (_write_slot).  Pad rows beyond plen are causally invisible and
        # overwritten by the first decode steps (cache_len = plen masks them
        # meanwhile).
        slot_cache = [{k: t[slot : slot + 1] for k, t in c.items()} for c in self.cache]
        for c in slot_cache:
            for t in c.values():
                t.zero_()
        self._prefill_shapes.add(blen)
        logits, _ = self.model.prefill(
            self.params, slot_cache, prompt, cache_len=0, last_pos=plen - 1
        )
        self.cache_len[slot] = plen
        first = int(torch.argmax(logits[0, -1]))
        self.last_token[slot] = first
        self.slot_rid[slot] = rid
        self.outputs[rid] = [first]
        return rid

    def step(self) -> None:
        """One decode step for every slot (tokens kept for active ones)."""
        if not self.active_mask.any():
            return
        logits = self.step_graph(self.last_token, self.cache_len)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(np.int32)
        act = self.active_mask
        for slot, rid in enumerate(self.slot_rid):
            if rid is not None:
                self.outputs[rid].append(int(nxt[slot]))
                self.last_token[slot] = nxt[slot]
        self.cache_len = self.cache_len + act.astype(np.int32)

    def finish(self, rid: int) -> list[int]:
        slot = self.slot_rid.index(rid)
        self.slot_rid[slot] = None
        self.cache_len[slot] = 0
        # A reused slot must never decode from the previous request's token.
        self.last_token[slot] = 0
        return self.outputs.pop(rid)


def _not_ported(what: str, when: str = "a later slice of the port"):
    raise NotImplementedError(f"{what} is not ported yet; it comes in {when}")


_NEXT_SLICE = ("a later slice of the port: the next one, with suspend/resume and "
               "prefill_budget interleaving")


class NGramProposer:
    """Self-speculative n-gram drafter over a request's own token history.

    ``propose(history, k)`` returns ``k`` draft tokens: for the longest
    n-gram suffix of ``history`` (``max_n`` down to ``min_n``) it finds the
    most recent earlier occurrence with a full ``k``-token continuation and
    proposes it; failing that, the longest continuation found, padded with
    its own last token; with no match at all, the last history token
    repeated.  Drafts cost no model call and only cost acceptance when
    wrong: the verify step keeps greedy decoding exact.  Any object with
    the same ``propose(history, k)`` can replace it.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got min_n={min_n} max_n={max_n}"
            )
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, history, k: int) -> list[int]:
        if k < 1:
            raise ValueError(f"propose needs k >= 1 draft tokens, got {k}")
        hist = list(map(int, history))
        if not hist:
            return [0] * k
        best: list[int] = []
        for n in range(min(self.max_n, len(hist) - 1), self.min_n - 1, -1):
            suffix = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):  # most recent first
                if hist[i : i + n] == suffix:
                    cont = hist[i + n : i + n + k]
                    if len(cont) == k:
                        return cont
                    if len(cont) > len(best):
                        best = cont
        if best:
            return best + [best[-1]] * (k - len(best))
        return [hist[-1]] * k


class PagedServingSession:
    """Full-model greedy serving over the paged cache backend.

    On a CUDA device the plain-queue decode step (``prefix_sharing`` off,
    ``speculate="off"``) replays a CUDA graph per live batch size and
    queue capacity (:class:`~repro_torch.runtime.step_graph.PagedDecodeStep`,
    ``step_graph``; ``graph_captures`` counts them), over bf16 or int8
    pages: the reference jits the halves of each layer.  Prefill chunks,
    the shared-prefix step (``prefix_sharing``, forced on by
    ``prefix_cache="trie"``) and the multi-row verify step
    (``speculate="ngram"``) run eagerly.
    """

    def __init__(
        self,
        model,
        params,
        *,
        num_pages: int,
        page_size: int | None = None,
        block_k: int | None = None,
        num_splits: int = 1,
        prefix_sharing: bool = False,
        min_group: int = 2,
        prefill_chunk: int = 32,
        max_batch: int | None = None,
        dtype=None,
        kv_dtype=None,
        head_shards: int = 1,
        speculate: str = "off",
        draft_k: int = 4,
        draft_proposer=None,
        prefix_cache: str = "off",
        retain_pages: int | None = None,
        prefill_budget: int | None = None,
    ):
        from repro_torch.kernels import ops
        from repro_torch.kernels.decode_schedule import DecodeScheduler
        from repro_torch.models import transformer as _tf
        from repro_torch.runtime.kv_cache import CacheSpec, PrefixTrie
        from repro_torch.runtime.step_graph import PagedDecodeStep

        _tf.check_paged_compatible(model.cfg)
        if head_shards != 1:
            _not_ported("head_shards > 1 (tensor-parallel head groups)")
        if prefill_budget is not None:
            _not_ported("prefill_budget (chunked-prefill/decode interleaving)", _NEXT_SLICE)
        if prefix_cache not in ("off", "trie"):
            raise ValueError(
                f"prefix_cache={prefix_cache!r} is not a cache policy; "
                "pick 'off' or 'trie'"
            )
        if speculate not in ("off", "ngram"):
            raise ValueError(
                f"speculate={speculate!r} is not a draft policy; pick 'off' "
                "or 'ngram' (or pass a custom draft_proposer with ngram)"
            )
        if speculate != "off" and draft_k < 2:
            raise ValueError(
                f"draft_k={draft_k} buys nothing: a speculative step "
                "verifies 1 pending + (draft_k - 1) draft rows, so "
                "draft_k >= 2 is the smallest step that amortizes anything "
                "(use speculate='off' for plain 1-row decode)"
            )
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.dtype = dtype or model.dtype
        self.cache_spec = (
            kv_dtype
            if isinstance(kv_dtype, CacheSpec)
            else CacheSpec(dtype=self.dtype if kv_dtype is None else kv_dtype)
        )
        self.cache = model.init_paged_cache(
            params, num_pages=num_pages, page_size=page_size, spec=self.cache_spec
        )
        # Fixed block-table width: stable kernel input shapes across admits,
        # evicts and page-boundary growth.
        self.table_width = num_pages
        self.block_k = block_k or ops.default_paged_block_k(
            self.cache.page_size, self.table_width
        )
        self.num_splits = num_splits
        self.prefix_sharing = prefix_sharing
        self.prefill_chunk = prefill_chunk
        self.max_batch = max_batch
        self.prefix_cache = prefix_cache
        self.trie = None
        if prefix_cache == "trie":
            # A trie hit aliases complete blocks, so a warm suffix prefill
            # starts on a block boundary; with the chunk dividing block_k it
            # is a cold prefill's chunk boundary too (bit-identical rows).
            if self.block_k % prefill_chunk:
                raise ValueError(
                    f"prefix_cache='trie' needs prefill_chunk "
                    f"({prefill_chunk}) to divide block_k ({self.block_k}) "
                    "so warm suffix prefills land on the same chunk "
                    "boundaries as cold ones (bit-identical outputs)"
                )
            # Hits pay off only when decode groups the aliased blocks.
            self.prefix_sharing = True
            self.trie = PrefixTrie(self.cache, block_tokens=self.block_k,
                                   retain_pages=retain_pages)
        # fp32 models keep fp32 kernel precision (bit-comparable greedy
        # outputs with the reference); bf16 serving uses bf16 kernels.
        self.compute_dtype = torch.float32 if self.dtype == torch.float32 else None
        self._scheduler = DecodeScheduler(
            block_k=self.block_k, num_splits=num_splits, min_group=min_group,
            nested=self.trie is not None,
        )
        self.step_graph = PagedDecodeStep(
            params, self.cache, cfg=self.cfg, scheduler=self._scheduler,
            table_width=self.table_width, block_k=self.block_k, num_splits=num_splits,
            compute_dtype=self.compute_dtype,
        )
        self._layers = model.layer_params(params)
        self.speculate = speculate
        self.draft_k = int(draft_k)
        self._proposer = draft_proposer or (NGramProposer() if speculate != "off" else None)
        # Token history per request (prompt + emitted) feeds the drafter;
        # kept with speculation off too, so forked children inherit it.
        self._prompt: dict[int, list[int]] = {}
        # A forked child's (parent rid, shared rows): the alias point.
        self._family: dict[int, tuple[int, int]] = {}
        self._ballast: set[int] = set()
        self._next_ballast = 0
        self.trie_admissions = 0
        self.active: list[int] = []
        self.outputs: dict[int, list[int]] = {}
        self.last_token: dict[int, int] = {}
        self._next_id = 0
        self._prefill_shapes: set[tuple] = set()
        self._decode_shapes: set[int] = set()
        # Deterministic work counters (the reference's regression proxies).
        self.decode_steps = 0
        self.request_steps = 0
        self.query_rows = 0
        self.accepted_tokens = 0
        self.page_dmas = 0
        self.rows_attended = 0
        # Virtual work clock: one unit = one decode launch or one padded
        # prefill chunk.
        self.work_units = 0
        self.prefill_chunks = 0
        self.prefill_stall_steps = 0
        self.first_tokens = 0
        self.ttft_units_total = 0
        self.max_inter_token_units = 0
        self._lat: dict[int, dict] = {}

    # -- introspection ------------------------------------------------- #
    @property
    def scheduler_stats(self) -> dict:
        """Schedule build/reuse counters; ``hits + rebuilds`` equals the
        number of decode steps — one schedule per step, never per layer."""
        return {"hits": self._scheduler.hits, "rebuilds": self._scheduler.rebuilds}

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill chunk shapes (fixed chunking => 1)."""
        return len(self._prefill_shapes)

    @property
    def decode_compiles(self) -> int:
        """Distinct live-batch sizes decoded."""
        return len(self._decode_shapes)

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured of the decode step: one per (live batch
        size, queue capacity) decoded on a CUDA device
        (``step_graph.shapes``), else 0."""
        return self.step_graph.graphs.captures

    def work_stats(self) -> dict:
        """Deterministic decode-work proxies accumulated across steps
        (the reference's keys for the features ported so far).
        ``page_dma_bytes`` is dtype-aware: int8 pages count their scale
        strips; with prefix sharing a shared block counts once per group.
        Under speculation ``query_rows`` counts every verify row and
        ``accepted_tokens`` only the rows that became output."""
        page_dma_bytes = self.page_dmas * self.cache_spec.bytes_per_page(
            self.cache.page_size, self.cache.width
        )
        occ = self.cache.pool_occupancy()
        if self.trie is not None:
            ts = self.trie.stats()
            trie_hits, trie_misses = ts["hits"], ts["misses"]
            reused, evicted = ts["hit_tokens"], ts["evicted_pages"]
        else:
            trie_hits = trie_misses = reused = evicted = 0
        return {
            "decode_steps": self.decode_steps,
            "request_steps": self.request_steps,
            "query_rows": self.query_rows,
            "accepted_tokens": self.accepted_tokens,
            "accepted_tokens_per_step": self.accepted_tokens / max(self.request_steps, 1),
            "page_dmas": self.page_dmas,
            "page_dma_bytes": page_dma_bytes,
            "page_dma_bytes_per_accepted_token": page_dma_bytes
            / max(self.accepted_tokens, 1),
            "rows_attended": self.rows_attended,
            "aliased_pages": self.cache.num_aliased_pages(),
            "free_pages": self.cache.num_free_pages,
            # Pool occupancy and trie reuse (zeros with the trie off).
            "live_pages": occ["live_pages"],
            "retained_pages": occ["retained_pages"],
            "trie_hits": trie_hits,
            "trie_misses": trie_misses,
            "trie_admissions": self.trie_admissions,
            "trie_hit_rate": trie_hits / max(trie_hits + trie_misses, 1),
            "prefix_tokens_reused": reused,
            "prefix_tokens_reused_per_admission": reused / max(self.trie_admissions, 1),
            "trie_evicted_pages": evicted,
            "work_units": self.work_units,
            "prefill_chunks": self.prefill_chunks,
            "prefill_stall_steps": self.prefill_stall_steps,
            "first_tokens": self.first_tokens,
            "ttft_units_total": self.ttft_units_total,
            "max_inter_token_units": self.max_inter_token_units,
        }

    # -- latency / work accounting -------------------------------------- #
    def _count_prefill(self, n_tokens: int) -> None:
        chunks = -(-n_tokens // self.prefill_chunk)
        self.prefill_chunks += chunks
        self.work_units += chunks
        if self.active:
            # Synchronous prefill with live decoders stalls them.
            self.prefill_stall_steps += chunks

    def _note_admit(self, rid: int) -> None:
        vt = self.work_units
        self._lat.setdefault(rid, {"admit": vt, "first": None, "last": vt})

    def _note_emit(self, rid: int) -> None:
        vt = self.work_units
        rec = self._lat.setdefault(rid, {"admit": vt, "first": None, "last": vt})
        if rec["first"] is None:
            rec["first"] = vt
            self.first_tokens += 1
            self.ttft_units_total += vt - rec["admit"]
        else:
            self.max_inter_token_units = max(self.max_inter_token_units, vt - rec["last"])
        rec["last"] = vt

    # -- admission -------------------------------------------------------- #
    def _admit(self, rid: int, first_token: int) -> int:
        self.active.append(rid)
        self.outputs.setdefault(rid, []).append(first_token)
        self.last_token[rid] = first_token
        self._note_emit(rid)
        return rid

    def add_request(self, prompt_tokens) -> int | None:
        """Chunk-prefill a prompt into fresh pages; its rid, or None when
        the pool lacks pages or the batch is full (the caller retries).

        With ``prefix_cache="trie"`` the prompt's complete blocks before
        its last token are matched against the trie, the matched pages
        adopted (no copy, every layer), and only the rest prefilled; cold
        retained subtrees are reclaimed before admission fails."""
        from repro_torch.models import transformer as _tf

        prompt = list(map(int, prompt_tokens))
        if len(prompt) < 1:
            raise ValueError(
                "add_request needs at least one prompt token (an empty "
                "prompt has no prefill position to decode from)"
            )
        need = -(-len(prompt) // self.cache.page_size)
        if need > self.cache.num_pages:
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs {need} pages but the "
                f"pool only has {self.cache.num_pages} total; grow "
                "num_pages/page_size or truncate the prompt (it can never "
                "be admitted, even into an empty pool)"
            )
        if self.max_batch is not None and len(self.active) >= self.max_batch:
            return None
        matched, tpages = 0, []
        if self.trie is None:
            if not self.cache.has_room(None, len(prompt)):
                return None
        else:
            # The last prompt position must run through prefill (it gives
            # the first logits row): only whole blocks before it are reused.
            usable = ((len(prompt) - 1) // self.block_k) * self.block_k
            matched, tpages = self.trie.match(prompt[:usable])
            self.trie_admissions += 1
        rid = self._next_id
        self._next_id += 1
        # Adopt before any reclaim: the adoption's references keep the
        # matched pages off the evictor's freeable list.
        if matched:
            self.cache.adopt_pages(rid, tpages, matched)
        else:
            self.cache.alloc(rid)
        deficit = need - len(tpages) - self.cache.num_free_pages
        if deficit > 0 and self.trie is not None:
            self.trie.reclaim(deficit)
        if need - len(tpages) > self.cache.num_free_pages:
            self.cache.free(rid)  # the adoption's references drop; pins stay
            return None
        self._prompt[rid] = prompt
        self._note_admit(rid)
        self._prefill_shapes.add((1, self.prefill_chunk))
        logits = _tf.lm_prefill_paged(
            self.params,
            prompt[matched:],
            cfg=self.cfg,
            cache=self.cache,
            rid=rid,
            start_pos=matched,
            chunk=self.prefill_chunk,
            table_width=self.table_width,
            block_k=self.block_k,
            compute_dtype=self.compute_dtype,
        )
        self._count_prefill(len(prompt) - matched)
        if self.trie is not None:
            # Publish the live prefix at once, so concurrent same-template
            # admissions alias it without waiting for this request to end.
            self._retain_prompt(rid)
        return self._admit(rid, int(torch.argmax(logits[0])))

    def _retain_prompt(self, rid: int) -> None:
        """Pin ``rid``'s complete prompt blocks into the trie (blocks
        already covered add nothing).  Only :meth:`add_request` prompts
        qualify: their rows were all prefill-written at chunk boundaries a
        cold prefill shares; fork / admit_with_prefix children are not
        retained."""
        prompt = self._prompt.get(rid, [])
        n_blocks = len(prompt) // self.block_k
        if not n_blocks:
            return
        ppb = self.block_k // self.cache.page_size
        self.trie.insert(prompt[: n_blocks * self.block_k],
                         self.cache.seq_pages(rid)[: n_blocks * ppb])

    # -- decode ----------------------------------------------------------- #
    def step(self) -> None:
        """One greedy decode step for every live request (one schedule):
        a graph replay on a CUDA device unless ``prefix_sharing`` is on or
        the step verifies drafts.

        With ``speculate="ngram"`` each request feeds ``[pending, d_1 ..
        d_{k-1}]`` (drafts from the proposer) through one ``k``-row decode;
        the longest draft prefix equal to the model's greedy picks is
        accepted, so 1 to ``k`` tokens are emitted, exactly those of 1-row
        decoding (row i attends only rows < i), and the rejected rows are
        rolled back by ``cache.truncate``."""
        from repro_torch.kernels.decode_schedule import (
            PrefixSchedule,
            prefix_queue_grid_items,
            queue_grid_items,
        )
        from repro_torch.models import transformer as _tf

        rids = list(self.active)
        if not rids:
            return
        s = self.draft_k if self.speculate != "off" else 1
        drafts = [[] for _ in rids]
        if s > 1:
            drafts = [self._proposer.propose(self._prompt[r] + self.outputs[r], s - 1)
                      for r in rids]
        tokens = np.asarray([[self.last_token[r]] + [int(t) for t in d]
                             for r, d in zip(rids, drafts)], np.int64)
        # Pre-append lengths: the rollback targets and the accounting.
        pre = {r: self.cache.seq_len(r) for r in rids}
        if self.prefix_sharing or s > 1:
            logits = _tf.lm_decode_step_paged(
                self.params,
                tokens,
                cfg=self.cfg,
                cache=self.cache,
                rids=rids,
                scheduler=self._scheduler,
                prefix_sharing=self.prefix_sharing,
                # The trie epoch changes with every insert, split and
                # eviction: aliasing can change under an unchanged live set.
                extra_key=(tuple(rids), self.trie.epoch) if self.trie is not None
                else tuple(rids),
                table_width=self.table_width,
                block_k=self.block_k,
                num_splits=self.num_splits,
                compute_dtype=self.compute_dtype,
            )
        else:
            logits = self.step_graph(tokens, rids)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()  # (B, s)
        self.work_units += 1  # one fused decode launch
        for i, r in enumerate(rids):
            # Accept drafts while each equals the greedy pick before it;
            # the first greedy pick is always emitted.
            m = 0
            while m < s - 1 and int(drafts[i][m]) == int(greedy[i, m]):
                m += 1
            emitted = [int(t) for t in greedy[i, : m + 1]]
            self.outputs[r].extend(emitted)
            self.last_token[r] = emitted[-1]
            self._note_emit(r)
            if m + 1 < s:
                # keep the pending token's row and the m accepted drafts'
                self.cache.truncate(r, pre[r] + 1 + m)
            self.accepted_tokens += m + 1
        # Work accounting: the step's schedule, replayed by all L layers,
        # at the schedule's lengths (rollback refunds pages, not reads).
        self.decode_steps += 1
        self.request_steps += len(rids)
        self.query_rows += len(rids) * s
        self._decode_shapes.add(len(rids))
        kv = np.asarray([pre[r] + s for r in rids], np.int64)
        sched = self._scheduler.current
        grid_items = (
            prefix_queue_grid_items if isinstance(sched, PrefixSchedule) else queue_grid_items
        )
        acct = grid_items(sched, kv, self.cache.page_size, query_rows=s)
        self.page_dmas += int(acct["page_dmas"]) * self.cfg.n_layers
        self.rows_attended += int(kv.sum()) * s * self.cfg.n_layers

    def finish(self, rid: int) -> list[int]:
        """Retire ``rid``: its pages return to the pool (aliased pages when
        their last owner goes; with the trie on, its prompt blocks stay
        retained, pinned at admission); returns its tokens."""
        if rid not in self.active:
            raise KeyError(f"request {rid} is not live")
        self.active.remove(rid)
        self.cache.free(rid)
        self.last_token.pop(rid, None)
        self._prompt.pop(rid, None)
        self._family.pop(rid, None)
        return self.outputs.pop(rid)

    def fork(self, rid: int, prefix_len: int | None = None) -> int:
        """Branch a live request at its full history: the child aliases
        every page (all L layers, one refcount bump) and continues with the
        parent's pending token — greedy twins until copy-on-write
        divergence.  To branch earlier with new tokens, use
        :meth:`admit_with_prefix`."""
        if rid not in self.active:
            raise KeyError(f"request {rid} is not live")
        if prefix_len is not None and prefix_len != self.cache.seq_len(rid):
            raise ValueError(
                "model-level fork shares the whole history (the pending "
                "token is only defined there); use admit_with_prefix("
                "parent, suffix_tokens, prefix_len) to branch earlier"
            )
        child = self._next_id
        self._next_id += 1
        self.cache.fork(rid, child)
        self.active.append(child)
        self.outputs[child] = list(self.outputs[rid])
        self.last_token[child] = self.last_token[rid]
        self._prompt[child] = list(self._prompt[rid])
        self._family[child] = (rid, self.cache.seq_len(child))
        vt = self.work_units
        self._lat[child] = {"admit": vt, "first": vt, "last": vt}
        return child

    def admit_with_prefix(
        self, parent_rid: int, suffix_tokens, prefix_len: int | None = None
    ) -> int | None:
        """Admit a request as ``fork(parent, prefix_len) + prefill(suffix)``
        (the shared-system-prompt / n-best entry point): the prefix pages
        are aliased and only the suffix runs through the model, attending
        over them.  Returns None (nothing allocated) when the pool lacks
        pages for the suffix or the batch is full."""
        from repro_torch.models import transformer as _tf

        if parent_rid not in self.active:
            raise KeyError(f"request {parent_rid} is not live")
        suffix = list(map(int, suffix_tokens))
        if not suffix:
            raise ValueError(
                "admit_with_prefix needs at least one suffix token "
                "(use fork() for a zero-copy full branch)"
            )
        if self.max_batch is not None and len(self.active) >= self.max_batch:
            return None
        child = self._next_id
        self._next_id += 1
        self.cache.fork(parent_rid, child, prefix_len)
        if not self.cache.has_room(child, len(suffix)):
            self.cache.free(child)
            return None
        start = self.cache.seq_len(child)
        # The child's history: the parent's cached rows (prompt +
        # outputs[:-1]; the last output is not a row yet) up to the prefix,
        # then its suffix.
        ctx = (self._prompt[parent_rid] + self.outputs[parent_rid])[:-1]
        self._prompt[child] = ctx[:start] + suffix
        self._family[child] = (parent_rid, start)
        self._note_admit(child)
        self._prefill_shapes.add((1, self.prefill_chunk))
        logits = _tf.lm_prefill_paged(
            self.params,
            suffix,
            cfg=self.cfg,
            cache=self.cache,
            rid=child,
            start_pos=start,
            chunk=self.prefill_chunk,
            table_width=self.table_width,
            block_k=self.block_k,
            compute_dtype=self.compute_dtype,
        )
        self._count_prefill(len(suffix))
        return self._admit(child, int(torch.argmax(logits[0])))

    def suspend(self, rid: int):
        _not_ported("suspend/resume (recoverable eviction by replay)", _NEXT_SLICE)

    # -- pool pressure and the prefix cache ------------------------------ #
    def hold_pages(self, n: int) -> int:
        """Seize up to ``n`` free pages as ballast (pool-pressure fault
        injection) under an internal negative rid; returns its handle for
        :meth:`release_pages`."""
        n = min(int(n), self.cache.num_free_pages)
        self._next_ballast -= 1
        handle = self._next_ballast  # negative: never a request's rid
        self.cache.alloc(handle)
        if n > 0:
            self.cache.reserve(handle, n * self.cache.page_size)
        self._ballast.add(handle)
        return handle

    def release_pages(self, handle: int) -> None:
        """Return a :meth:`hold_pages` ballast's pages to the free list."""
        if handle not in self._ballast:
            raise KeyError(f"{handle} is not a held ballast handle")
        self._ballast.discard(handle)
        self.cache.free(handle)

    def reclaim_retained(self, n_pages: int) -> int:
        """Evict cold retained trie subtrees to free ``>= n_pages`` pages
        (best effort, leaf-first LRU); the pages freed, 0 with the trie
        off."""
        if self.trie is None:
            return 0
        return self.trie.reclaim(n_pages)

    def close(self) -> dict:
        """Finish every live request, release ballast, clear the trie and
        audit the pool; a leaked page fails here.  Returns the sweep
        report."""
        for rid in list(self.active):
            self.finish(rid)
        for handle in list(self._ballast):
            self.release_pages(handle)
        if self.trie is not None:
            self.trie.clear()
        report = self.cache.refcount_sweep()
        assert report["free_pages"] == self.cache.num_pages, (
            f"page leak at teardown: {report}"
        )
        return report


class PagedDecodeSession:
    """Continuous batching over a paged latent cache, at the attention level.

    One page pool is shared by every live request: admission is by
    free-page count, eviction returns pages at once, and a request's
    context grows until the pool is full.  Callers bring absorbed queries
    ``(G, d_k)`` and each new token's latent row (a full model server gets
    them from the layer stack; examples and tests use synthetic latents).
    :meth:`attend` is the read path; :meth:`step` appends, then attends
    (the new token attends to itself).

    ``scheduler="queue"`` decodes through the work-queue kernel (K2; int8
    pools through K2-int8, forked families through K2′ with
    ``prefix_sharing``), ``scheduler="padded"`` through the padded
    ``(B, W)`` kernel (K5, bf16/fp32 pools only).  ``device`` defaults to
    ``"cuda"`` and raises without CUDA; ``"cpu"`` runs the plain versions.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        page_size: int | None = None,
        d_k: int = 576,
        d_v: int = 512,
        scale: float,
        variant: str = "amla",
        dtype=torch.bfloat16,
        cache_spec=None,
        scheduler: str = "queue",
        num_splits: int = 1,
        block_k: int | None = None,
        prefix_sharing: bool = False,
        min_group: int = 2,
        device="cuda",
    ):
        from repro_torch.kernels import ops
        from repro_torch.kernels.decode_schedule import DecodeScheduler
        from repro_torch.kernels.mla_decode_paged import DEFAULT_PAGE_SIZE
        from repro_torch.runtime.kv_cache import PagedKVCache

        self.kv = PagedKVCache(
            num_pages=num_pages,
            page_size=page_size or DEFAULT_PAGE_SIZE,
            width=d_k,
            dtype=dtype,
            spec=cache_spec,
            device=device,
        )
        if self.kv.quantized and scheduler != "queue":
            raise ValueError(
                "int8 cache_spec needs scheduler='queue' (the padded grid "
                "has no fused dequant path)"
            )
        self.d_k, self.d_v = d_k, d_v
        self.scale, self.variant = scale, variant
        # Fixed table width (one request may own the whole pool): stable
        # kernel input shapes across admits, evicts and growth.
        self.table_width = num_pages
        self.scheduler = scheduler
        self.prefix_sharing = prefix_sharing and scheduler == "queue"
        self.block_k = block_k or ops.default_paged_block_k(
            self.kv.page_size, self.table_width
        )
        # One memoizing scheduler; the live-rid tuple is the identity key,
        # so a recycled slot with an identical block count rebuilds.
        self._scheduler = DecodeScheduler(
            block_k=self.block_k, num_splits=num_splits, min_group=min_group
        )
        self.active: list[int] = []
        self._next_id = 0

    @property
    def scheduler_stats(self) -> dict:
        """Schedule reuse counters (see decode_schedule.DecodeScheduler)."""
        return {"hits": self._scheduler.hits, "rebuilds": self._scheduler.rebuilds}

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(rows, device=self.kv.device)

    def admit(self, latent_prompt) -> int | None:
        """Admit a request whose prompt latents are ``(S, d_k)``; its id, or
        None when the pool lacks pages (the caller retries after an
        eviction)."""
        latent_prompt = self._rows(latent_prompt)
        if not self.kv.has_room(None, latent_prompt.shape[0]):
            return None
        rid = self._next_id
        self._next_id += 1
        self.kv.alloc(rid)
        self.kv.append(rid, latent_prompt)
        self.active.append(rid)
        return rid

    def evict(self, rid: int) -> None:
        """Finish or cancel ``rid``: its pages return to the pool (pages
        aliased by forked siblings stay until their last owner goes)."""
        if rid not in self.active:
            raise KeyError(f"request {rid} is not live")
        self.active.remove(rid)
        self.kv.free(rid)

    def fork(self, rid: int, prefix_len: int | None = None) -> int:
        """Branch a live request: the child shares ``rid``'s first
        ``prefix_len`` rows (all by default) by page aliasing; the shared
        boundary page is copied at the first append that writes into it."""
        if rid not in self.active:
            raise KeyError(f"request {rid} is not live")
        child = self._next_id
        self._next_id += 1
        self.kv.fork(rid, child, prefix_len)
        self.active.append(child)
        return child

    def admit_with_prefix(
        self, parent_rid: int, latent_suffix, prefix_len: int | None = None
    ) -> int | None:
        """Admit a request as ``fork(parent) + append(suffix)``;
        ``latent_suffix`` is its own ``(S, d_k)`` rows (may be empty).
        Returns None, with nothing left allocated, when the pool lacks
        pages for the suffix and the boundary copy."""
        latent_suffix = self._rows(latent_suffix)
        if latent_suffix.ndim == 1 and latent_suffix.shape[0]:
            latent_suffix = latent_suffix[None]  # a single (d_k,) row
        n = int(latent_suffix.shape[0]) if latent_suffix.ndim >= 2 else 0
        child = self.fork(parent_rid, prefix_len)
        if n:
            if not self.kv.has_room(child, n):
                self.evict(child)
                return None
            self.kv.append(child, latent_suffix)
        return child

    def attend(self, queries: dict) -> dict:
        """Batched paged attention for ``{rid: (G, d_k)}`` absorbed queries;
        returns ``{rid: (G, d_v)}`` fp32.  Every queried rid must be live."""
        from repro_torch.kernels import ops

        unknown = set(queries) - set(self.active)
        if unknown:
            raise KeyError(f"requests not live: {sorted(unknown)}")
        rids = [r for r in self.active if r in queries]
        if not rids:
            return {}
        bt, kv_len = self.kv.block_table(rids, width=self.table_width)
        q = torch.stack([self._rows(queries[r]) for r in rids])[:, None]
        schedule = None
        if self.scheduler == "queue":
            if self.prefix_sharing:
                schedule = self._scheduler.schedule_prefix(
                    kv_len, bt, page_size=self.kv.page_size, extra_key=tuple(rids)
                )
            else:
                schedule = self._scheduler.schedule(kv_len, extra_key=tuple(rids))
        out = ops.mla_decode_paged(
            q,
            self.kv.pages,
            torch.as_tensor(bt, device=self.kv.device),
            kv_len,
            kv_scales=self.kv.scales,
            d_v=self.d_v,
            variant=self.variant,
            scale=self.scale,
            scheduler=self.scheduler,
            block_k=self.block_k if self.scheduler == "queue" else None,
            schedule=schedule,
        )  # (B, 1, G, d_v)
        return {r: out[i, 0] for i, r in enumerate(rids)}

    def step(self, queries: dict, new_latents: dict | None = None) -> dict:
        """One decode step: append each request's new latent row, then
        attend.  The appends are atomic: if the pool cannot hold all of
        them, :class:`OutOfPagesError` is raised before any row lands."""
        if new_latents:
            from repro_torch.runtime.kv_cache import OutOfPagesError

            rows = {}
            for rid, r in new_latents.items():
                r = self._rows(r)
                rows[rid] = r[None] if r.ndim == 1 else r
            need = sum(
                self.kv.pages_needed_for_append(rid, r.shape[0])
                for rid, r in rows.items()
            )
            if need > self.kv.num_free_pages:
                raise OutOfPagesError(
                    f"step needs {need} new pages for {len(rows)} appends; "
                    f"only {self.kv.num_free_pages} free — evict and retry"
                )
            for rid, r in rows.items():
                self.kv.append(rid, r)
        return self.attend(queries)
