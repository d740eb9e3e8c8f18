"""Paged serving session (counterpart of the core of
``repro/runtime/serve_loop.PagedServingSession``).

The same greedy ``add_request`` / ``step`` / ``finish`` surface as the
reference, over a :class:`~repro_torch.runtime.kv_cache.LayeredPagedKVCache`
— one block table shared by all L layers — with decode through
``ops.mla_decode_paged`` via ``models.transformer.lm_decode_step_paged``:

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
