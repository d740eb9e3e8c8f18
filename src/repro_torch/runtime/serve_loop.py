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
* ``work_stats`` reports the reference's deterministic work counters.

Speculation, the prefix trie, ``prefill_budget`` interleaving,
suspend/resume, fork and sharding belong to later slices of the port and
raise ``NotImplementedError`` when asked for.
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
    """

    def __init__(self, model, params, *, batch_size: int, max_len: int):
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

    @property
    def active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.slot_rid])

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run (the reference's jit compiles)."""
        return len(self._prefill_shapes)

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
        tokens = torch.as_tensor(self.last_token, device=self.device).to(torch.int64)
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, tokens[:, None], self.cache_len.copy()
        )
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


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet; it comes in a later slice of the port"
    )


class PagedServingSession:
    """Full-model greedy serving over the paged cache backend."""

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
        prefill_chunk: int = 32,
        max_batch: int | None = None,
        dtype=None,
        kv_dtype=None,
        head_shards: int = 1,
        speculate: str = "off",
        prefix_cache: str = "off",
        prefill_budget: int | None = None,
    ):
        from repro_torch.kernels import ops
        from repro_torch.kernels.decode_schedule import DecodeScheduler
        from repro_torch.models import transformer as _tf
        from repro_torch.runtime.kv_cache import CacheSpec

        _tf.check_paged_compatible(model.cfg)
        if prefix_sharing:
            _not_ported("prefix_sharing (group-batched shared-prefix attention)")
        if head_shards != 1:
            _not_ported("head_shards > 1 (tensor-parallel head groups)")
        if speculate != "off":
            _not_ported(f"speculate={speculate!r} (draft-verify decode)")
        if prefix_cache != "off":
            _not_ported(f"prefix_cache={prefix_cache!r} (the radix prefix trie)")
        if prefill_budget is not None:
            _not_ported("prefill_budget (chunked-prefill/decode interleaving)")
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
        self.prefill_chunk = prefill_chunk
        self.max_batch = max_batch
        # fp32 models keep fp32 kernel precision (bit-comparable greedy
        # outputs with the reference); bf16 serving uses bf16 kernels.
        self.compute_dtype = torch.float32 if self.dtype == torch.float32 else None
        self._scheduler = DecodeScheduler(block_k=self.block_k, num_splits=num_splits)
        self._layers = model.layer_params(params)
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

    def work_stats(self) -> dict:
        """Deterministic decode-work proxies accumulated across steps
        (the reference's keys for the features this slice serves)."""
        page_dma_bytes = self.page_dmas * self.cache_spec.bytes_per_page(
            self.cache.page_size, self.cache.width
        )
        sweep = self.cache.refcount_sweep()
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
            "live_pages": sweep["live_pages"],
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
        the pool lacks pages or the batch is full (the caller retries)."""
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
        if not self.cache.has_room(None, len(prompt)):
            return None
        rid = self._next_id
        self._next_id += 1
        self.cache.alloc(rid)
        self._note_admit(rid)
        self._prefill_shapes.add((1, self.prefill_chunk))
        logits = _tf.lm_prefill_paged(
            self.params,
            prompt,
            cfg=self.cfg,
            cache=self.cache,
            rid=rid,
            chunk=self.prefill_chunk,
            table_width=self.table_width,
            block_k=self.block_k,
            compute_dtype=self.compute_dtype,
        )
        self._count_prefill(len(prompt))
        return self._admit(rid, int(torch.argmax(logits[0])))

    # -- decode ----------------------------------------------------------- #
    def step(self) -> None:
        """One greedy decode step for every live request (one schedule)."""
        from repro_torch.kernels.decode_schedule import queue_grid_items
        from repro_torch.models import transformer as _tf

        rids = list(self.active)
        if not rids:
            return
        tokens = np.asarray([self.last_token[r] for r in rids], np.int64)[:, None]
        pre = {r: self.cache.seq_len(r) for r in rids}
        logits = _tf.lm_decode_step_paged(
            self.params,
            tokens,
            cfg=self.cfg,
            cache=self.cache,
            rids=rids,
            scheduler=self._scheduler,
            extra_key=tuple(rids),
            table_width=self.table_width,
            block_k=self.block_k,
            num_splits=self.num_splits,
            compute_dtype=self.compute_dtype,
        )
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()  # (B, 1)
        self.work_units += 1  # one fused decode launch
        for i, r in enumerate(rids):
            tok = int(greedy[i, 0])
            self.outputs[r].append(tok)
            self.last_token[r] = tok
            self._note_emit(r)
            self.accepted_tokens += 1
        # Work accounting: the step's schedule, replayed by all L layers.
        self.decode_steps += 1
        self.request_steps += len(rids)
        self.query_rows += len(rids)
        self._decode_shapes.add(len(rids))
        kv = np.asarray([pre[r] + 1 for r in rids], np.int64)
        acct = queue_grid_items(self._scheduler.current, kv, self.cache.page_size)
        self.page_dmas += int(acct["page_dmas"]) * self.cfg.n_layers
        self.rows_attended += int(kv.sum()) * self.cfg.n_layers

    def finish(self, rid: int) -> list[int]:
        """Retire ``rid``: its pages return to the pool; returns its tokens."""
        if rid not in self.active:
            raise KeyError(f"request {rid} is not live")
        self.active.remove(rid)
        self.cache.free(rid)
        self.last_token.pop(rid, None)
        return self.outputs.pop(rid)

    def fork(self, rid: int, prefix_len: int | None = None) -> int:
        _not_ported("fork (page aliasing with copy-on-write)")

    def admit_with_prefix(self, parent_rid: int, suffix_tokens, prefix_len=None):
        _not_ported("admit_with_prefix (page aliasing with copy-on-write)")

    def suspend(self, rid: int):
        _not_ported("suspend/resume (recoverable eviction by replay)")

    def close(self) -> dict:
        """Finish every live request and audit the pool; a leaked page
        fails here.  Returns the sweep report."""
        for rid in list(self.active):
            self.finish(rid)
        report = self.cache.refcount_sweep()
        assert report["free_pages"] == self.cache.num_pages, (
            f"page leak at teardown: {report}"
        )
        return report
