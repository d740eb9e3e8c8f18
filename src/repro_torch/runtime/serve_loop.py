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
* ``prefill_budget=N`` interleaves prefill with decode: ``add_request``
  only enqueues the prompt, and every ``step`` decodes the live batch,
  then spends up to ``N`` prompt tokens on chunk-aligned slices of the
  pending prompts (:func:`~repro_torch.kernels.decode_schedule
  .plan_prefill_slices`), so a long prompt never stalls live decoders;
* ``suspend`` / ``resume`` evict a request recoverably: its pages free at
  once, the prompt and emitted tokens stay on the host
  (:class:`SuspendedRequest`), and resume rebuilds the rows by replaying
  them through the chunked prefill (re-aliasing a live fork parent's
  prefix first);
* ``work_stats`` reports the reference's deterministic work counters.

:class:`ServeSupervisor` drives one session under deterministic chaos
(:class:`~repro_torch.runtime.fault_injection.FaultPlan`): SLA-ordered
admission with skip-ahead and backoff, deadlines, suspension of an SLA
victim when the pool runs out, and latency percentiles on the session's
work clock (:func:`latency_percentile`).

:class:`PagedDecodeSession` is the attention-level session over one
:class:`~repro_torch.runtime.kv_cache.PagedKVCache`: callers bring absorbed
queries and latent rows; it decodes through the queue kernel (K2, int8 and
shared prefixes included) or the padded ``(B, W)`` kernel (K5).

:class:`ShardedPagedServingSession` splits the pool over ``data`` shards,
each a :class:`PagedServingSession` holding its own requests (routing,
fork pinning, drain / fail / attach), with ``head_shards`` query-head
chunks within a shard; on one card the shards are logical and share one
parameter set.

:func:`jit_serve_fns` is the reference's sharded prefill / decode factory
around ``model.prefill`` and ``model.decode_step``: the parameter, cache
and token shardings over a mesh, and functions that place their inputs by
them and run on the local shards, on a one-rank mesh or rank-locally on a
mesh of processes.  Under ``mesh_ctx(mesh, "seqkv")`` the decode step
takes the attention layer's split-KV branch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import tree as _tree
from repro_torch.core.distributed import all_gather_dim, take_shard
from repro_torch.runtime import mesh_ctx, sharding


def jit_serve_fns(model, mesh, params_like, cache_like, *, multi_pod=False,
                  policy="tp_fsdp"):
    """Returns ``(compile_prefill, compile_decode, shardings)``;
    ``shardings`` has keys ``params`` and ``cache``.  ``compile_decode
    (tokens_like)`` gives ``decode(params, cache, tokens, cache_len) ->
    (logits, cache)`` and ``compile_prefill(tokens_like)`` gives
    ``prefill(params, cache, tokens, **kw) -> (logits, cache)``: each
    places its parameters, cache and tokens by the shardings and calls the
    model on the local shards (on a one-rank mesh the tensors themselves,
    so the cache is written in place, as the model writes it).  ``cache_len``
    is the replicated host value and passes as it is.  ``params_like`` and
    ``cache_like`` are read for their shapes only.  The model's method is
    read when the compiled function is called: an encoder-decoder (whose
    ``init_cache`` the caller runs over the source frames) gets a working
    ``compile_decode``, and its prefill raises at use
    (:func:`_model_call`).

    On a mesh of several ranks every rank calls the function with the
    same arguments, each leaf a full value or a placed ``DTensor``, and
    the call runs rank-locally (:func:`_serve_on_ranks`): it returns what
    the one-process call returns, the whole batch's logits on every rank,
    and writes the cache's updated rows into each rank's own shard.  Under
    ``tp`` and ``tp_fsdp`` with several ``model`` ranks it splits the
    compute by ``model`` (:func:`~repro_torch.runtime.sharding.tp_plan`)."""
    pfn = sharding.param_spec_fn(mesh, multi_pod=multi_pod, policy=policy, cfg=model.cfg)
    cfn = sharding.cache_spec_fn(mesh, multi_pod=multi_pod, policy=policy)
    bfn = sharding.batch_spec_fn(mesh, multi_pod=multi_pod, policy=policy)
    param_sh = sharding.make_shardings(mesh, params_like, pfn)
    cache_sh = sharding.make_shardings(mesh, cache_like, cfn)

    def compiler(name):
        def compile_for(tokens_like):
            shs = (param_sh, cache_sh, sharding.make_shardings(mesh, tokens_like, bfn))

            def run(params, cache, tokens, *args, **kw):
                call = _model_call(model, name)
                if mesh.device_mesh().size() > 1:
                    return _serve_on_ranks(call, model.cfg, mesh, policy, multi_pod, shs,
                                           (params, cache, tokens), args, kw)
                p, c, t = sharding.local_run(mesh, (params, cache, tokens), shs)
                return call(p, c, t, *args, **kw)

            return run

        return compile_for

    return (compiler("prefill"), compiler("decode_step"),
            {"params": param_sh, "cache": cache_sh})


def _model_call(model, name):
    """``model``'s method ``name``, read when a compiled function is
    called (as the reference's ``prefill_fn`` reads ``model.prefill`` only
    when traced): an encoder-decoder has no ``prefill``, so its
    ``compile_prefill`` raises at use and its ``compile_decode`` works."""
    call = getattr(model, name, None)
    if call is None:
        raise ValueError(
            f"{model.cfg.name!r} has no {name}: an encoder-decoder is served through "
            "EncDecModel.init_cache(params, src_embeds, max_len) (the encoder and every "
            "layer's cross K/V) and EncDecModel.decode_step (the target prompt at "
            "cache_len 0, then one token a step)")
    return call


def _serve_on_ranks(call, cfg, mesh, policy, multi_pod, shardings, inputs, args, kw):
    """One rank's share of a sharded prefill / decode call.

    * The model receives this rank's shards of the parameters and
      gathers each layer's leaves, and each table, just before it uses
      them, dropping them after
      (:class:`~repro_torch.runtime.sharding.ParamGather` in
      ``mesh_ctx``): a rank holds its shards and about one layer.  A leaf
      the caller hands as a plain tensor (the full value on every rank)
      is used as it is, and not gathered
      (:func:`~repro_torch.runtime.sharding.rank_params`).  Under
      a tensor-parallel plan (:func:`~repro_torch.runtime.sharding.tp_plan`:
      ``tp`` / ``tp_fsdp`` with several ``model`` ranks) the attention
      layers, dense MLPs and embedding tables keep this rank's ``model``
      shard (gathered over the data axes only) and compute only its
      heads, columns and vocabulary (so do the Mamba-2 and RG-LRU
      blocks and MoE experts); any other leaf is gathered whole.
    * Tokens, and a per-row ``cache_len``, are this rank's batch rows, by
      the tokens' batch spec (its axes ``rows``).
    * Cache leaves are this rank's rows; their other sharded dims are
      gathered (the ``tp_fsdp`` width: every step gathers the cache, the
      reference's naive baseline), except the ``seqkv`` sequence, which
      stays this rank's slice, and a split GQA layer's K/V, of which only
      the rank's kv heads are gathered (one all-to-all for every layer,
      :meth:`~repro_torch.runtime.sharding.TPPlan.kv_head_caches`).  The
      rows the call writes go back into this rank's shard in place; a split GQA layer's new rows of
      every kv head are all-gathered over ``model`` (one call for all
      layers) and written into it, so that a replica or a width slice of
      the cache is what the one-process call leaves there.  A split
      Mamba-2 or RG-LRU block's state is the rank's heads or channels
      (:class:`~repro_torch.runtime.sharding.BlockStates`), put back
      after the call.  A split encoder-decoder's cross-attention K/V
      (precomputed by the caller's ``init_cache``, read-only) are the
      rank's heads (:meth:`~repro_torch.runtime.sharding.TPPlan.cross_caches`:
      views of a replica, or one all-to-all for every layer under
      ``tp_fsdp``), neither gathered whole nor written back.
    * The logits are all-gathered over ``rows``: every rank returns the
      whole batch's, as the reference returns its global array.
    """
    param_sh, cache_sh, tok_sh = shardings
    params, cache, tokens = inputs
    rows = sharding.spec_axes(tok_sh.spec[0]) if tok_sh.spec else ()
    b = tokens.shape[0]

    def own_rows(x):  # a per-row host array or tensor: this rank's rows
        if isinstance(x, np.ndarray) and x.ndim >= 1 and x.shape[0] == b:
            return take_shard(torch.from_numpy(x), 0, rows, mesh=mesh).numpy()
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == b:
            return take_shard(x, 0, rows, mesh=mesh)
        return x

    plan = sharding.tp_plan(cfg, mesh, policy, param_sh, cache_sh, rows)
    p_local, whole = sharding.rank_params(params, param_sh, plan)
    c_local = sharding.local_shards(sharding.place(cache, cache_sh))
    flat_sh = dict(_tree.leaves_with_paths(cache_sh))
    seq_local = {"model"} if policy == "seqkv" else set()
    work = {}
    flat_local = dict(_tree.leaves_with_paths(c_local))
    kv = [p for p in flat_local if plan is not None and plan.splits_cache(p)]
    kv_work = dict(zip(kv, plan.kv_head_caches([(flat_local[p], flat_sh[p]) for p in kv])
                       if kv else []))
    states = [p for p in flat_local if plan is not None and plan.splits_state(p)]
    block_states = (plan.state_caches([(p, flat_local[p], flat_sh[p]) for p in states])
                    if states else None)
    kv_work.update(zip(states, block_states.work if states else []))
    # a split cross-attention's K/V: read-only, this rank's heads, never written back
    cross = [p for p in flat_local if plan is not None and plan.splits_cross(p)]
    if cross:
        kv_work.update(zip(cross, plan.cross_caches([(flat_local[p], flat_sh[p])
                                                     for p in cross])))

    def to_work(path, local):
        if path in kv_work:
            return kv_work[path]
        sh = flat_sh[path]
        same_rows = sharding.spec_axes(sh.spec[0]) == rows
        keep = (set(rows) if same_rows else set()) | seq_local
        t = sharding.gather_one(local, sh, keep)
        if not same_rows:
            t = take_shard(t, 0, rows, mesh=mesh)
        work[path] = (local, t, keep, same_rows)
        return t

    c_work = _tree.map_with_paths(to_work, c_local)
    tok = take_shard(tokens, 0, rows, mesh=mesh)
    args = tuple(own_rows(a) for a in args)
    if "cache_len" in kw:
        kw = dict(kw, cache_len=own_rows(kw["cache_len"]))
    with mesh_ctx.mesh_ctx(mesh, policy, multi_pod, rank_rows=rows, tp_local=plan,
                           gather=sharding.param_gather(param_sh, plan, rows, whole)):
        logits, _ = call(p_local, c_work, tok, *args, **kw)
    for path, (local, t, keep, same_rows) in work.items():
        if t is local:  # written in place
            continue
        full_rows = t if same_rows else all_gather_dim(t, 0, rows, mesh=mesh)
        local.copy_(sharding.shard_one(full_rows, flat_sh[path], keep))
    if kv:
        cache_len = kw.get("cache_len", args[0] if args else None)
        _write_kv_heads(plan, [(flat_local[p], kv_work[p], flat_sh[p]) for p in kv],
                        0 if cache_len is None else cache_len, tok.shape[1])
    if states:
        block_states.write_back()
    return all_gather_dim(logits, 0, rows, mesh=mesh), cache


def _write_kv_heads(plan, leaves, cache_len, s):
    """After a split step: every rank's new K/V rows of its kv heads (read
    from each ``(local shard, working cache, sharding)`` of ``leaves`` at
    ``cache_len``), all-gathered over ``model`` in one call, and every kv
    head's rows (from the first rank holding it) written into this rank's
    shard: the width slice its spec gives (``tp_fsdp``), or the whole row
    (``tp``, a replica)."""
    from repro_torch.models.attention_layer import read_rows, update_rows

    new = torch.stack([read_rows(t.transpose(1, 2), cache_len, s) for _, t, _ in leaves])
    parts = plan.gather(new[None], 0)  # (m, leaves, B, s, kv heads of a rank, Dh)
    owner = [next(r for r in range(plan.m) if j < plan.kv_heads_of(r)[1])
             for j in range(plan.n_kv_heads)]
    heads = [j - plan.kv_heads_of(r)[0] for j, r in enumerate(owner)]
    rows = parts[torch.tensor(owner), :, :, :, torch.tensor(heads)]  # (Hkv, leaves, B, s, Dh)
    for (local, _, sh), r in zip(leaves, rows.permute(1, 2, 3, 0, 4)):
        width = sh.spec[3] if len(sh.spec) > 3 else None
        if width is not None:
            r = take_shard(r, -1, sharding.spec_axes(width), mesh=sh.mesh)
        update_rows(local.transpose(1, 2), r, cache_len)


def check_session_servable(cfg) -> None:
    """The serving sessions hold decoder-only models; an encoder-decoder
    has no session, in the reference either (its ``init_cache`` takes the
    source frames, not a batch size)."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name!r} is an encoder-decoder: the serving sessions hold "
            "decoder-only models. Serve it as the reference does, through "
            "EncDecModel.init_cache(params, src_embeds, max_len) (the encoder "
            "and every layer's cross K/V, once per request batch) and "
            "EncDecModel.decode_step (the target prompt at cache_len 0, then "
            "one token a step)"
        )


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
    the reference jits ``decode_step``.  Prefill runs eagerly.  A vlm is
    served text-only, as the reference serves it (M-RoPE with t = h = w).
    An encoder-decoder model raises ``ValueError``
    (:func:`check_session_servable`).
    """

    def __init__(self, model, params, *, batch_size: int, max_len: int):
        from repro_torch.runtime.step_graph import DenseDecodeStep

        check_session_servable(model.cfg)
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
        # invisible to real positions (a MoE MLP still routes them, and
        # they take expert capacity, as in the reference); recurrent/SSM
        # state would ingest the pads, so those stacks prefill at exact
        # length.
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
        # The prefill writes the slot's rows of every layer's cache (K/V or
        # latent rows, recurrent/SSM state) in place, through batch-1
        # views, cleared first: the reference prefills a fresh zeroed
        # batch-1 cache and copies it into the slot (_write_slot).  Pad rows
        # beyond plen are causally invisible and overwritten by the first
        # decode steps (cache_len = plen masks them meanwhile).
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


@dataclasses.dataclass
class SuspendedRequest:
    """What :meth:`PagedServingSession.resume` needs to rebuild a
    suspended request by replay: the prompt, the emitted tokens (the
    request's live output list, not a copy) and, for a forked child, its
    parent and the rows their shared prefix covered."""

    prompt: list[int]
    outputs: list[int]
    parent: int | None = None
    prefix_len: int = 0

    @property
    def tokens(self) -> list[int]:
        """The cache rows replay must rebuild: prompt + emitted tokens but
        the pending last one (between steps a session's rows are always
        ``prompt + outputs[:-1]``)."""
        return self.prompt + self.outputs[:-1]


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
        if model.cfg.n_heads % head_shards:
            raise ValueError(
                f"head_shards={head_shards} must divide "
                f"n_heads={model.cfg.n_heads} (tensor-parallel head groups "
                "split the query head axis evenly)"
            )
        if prefill_budget is not None and prefill_budget < prefill_chunk:
            raise ValueError(
                f"prefill_budget={prefill_budget} is below prefill_chunk="
                f"{prefill_chunk}: a budgeted step spends whole chunks "
                "(padded model invocations), so a smaller budget could "
                "never advance any pending prompt"
            )
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
        self.head_shards = head_shards
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
        self.prefill_budget = None if prefill_budget is None else int(prefill_budget)
        # Admitted prompts not yet fully prefilled (budgeted interleaving),
        # FIFO: {"rid", "prompt", "done"}, ``done`` counting the rows written
        # (trie-adopted blocks included).
        self._pending: list[dict] = []
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
            compute_dtype=self.compute_dtype, head_shards=head_shards,
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
        # Recoverable eviction (suspend / resume by replay).
        self.suspended: dict[int, SuspendedRequest] = {}
        self.suspends = 0
        self.resumes = 0
        self.replay_prefill_tokens = 0
        self.replay_mismatches = 0

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
        (the reference's keys).
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
            "suspends": self.suspends,
            "resumes": self.resumes,
            "suspended": len(self.suspended),
            "replay_prefill_tokens": self.replay_prefill_tokens,
            "replay_mismatches": self.replay_mismatches,
            # Interleaving and latency proxies (the virtual work clock).
            "work_units": self.work_units,
            "prefill_chunks": self.prefill_chunks,
            "prefill_stall_steps": self.prefill_stall_steps,
            "prefill_pending": len(self._pending),
            "prefill_backlog_tokens": sum(len(p["prompt"]) - p["done"] for p in self._pending),
            "first_tokens": self.first_tokens,
            "ttft_units_total": self.ttft_units_total,
            "max_inter_token_units": self.max_inter_token_units,
        }

    @property
    def prefill_pending(self) -> int:
        """Admitted prompts still waiting in the pending queue."""
        return len(self._pending)

    def resident_rids(self) -> list[int]:
        """Every rid holding pool pages: live decoders + pending prompts."""
        return list(self.active) + [p["rid"] for p in self._pending]

    # -- latency / work accounting -------------------------------------- #
    def _count_prefill(self, n_tokens: int, interleaved: bool = False) -> None:
        chunks = -(-n_tokens // self.prefill_chunk)
        self.prefill_chunks += chunks
        self.work_units += chunks
        if not interleaved and self.active:
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
        # The list may exist since enqueue (budgeted interleaving); a
        # supervisor or a suspended record may hold that very object.
        self.outputs.setdefault(rid, []).append(first_token)
        self.last_token[rid] = first_token
        self._note_emit(rid)
        return rid

    def add_request(self, prompt_tokens) -> int | None:
        """Chunk-prefill a prompt into fresh pages; its rid, or None when
        the pool lacks pages or the batch is full (the caller retries).
        With ``prefill_budget`` set the prompt is only enqueued (after the
        same checks): :meth:`step` prefills it in budgeted slices and its
        first token arrives there.

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
        if self.prefill_budget is not None:
            # The matched pages are adopted already; step() prefills the rest.
            self.outputs[rid] = []
            self._pending.append({"rid": rid, "prompt": prompt, "done": matched})
            return rid
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
            head_shards=self.head_shards,
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
        the step verifies drafts.  With ``prefill_budget`` set, the decode
        is followed by this step's budgeted prefill slices; a prompt whose
        last slice lands joins the live batch with its first token.

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
            if self.prefill_budget is not None and self._pending:
                self._advance_prefill()
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
                head_shards=self.head_shards,
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
        if self.prefill_budget is not None and self._pending:
            self._advance_prefill()

    def _advance_prefill(self) -> None:
        """Spend one step's prefill budget on the pending prompts, in the
        slices :func:`~repro_torch.kernels.decode_schedule.plan_prefill_slices`
        plans.  Each slice runs ``lm_prefill_paged`` from the rows already
        written, so its chunk boundaries are a monolithic prefill's
        (bit-identical rows); only a prompt's last slice computes logits.
        A slice whose pages are not free now is skipped and retried at the
        next step."""
        from repro_torch.kernels.decode_schedule import plan_prefill_slices
        from repro_torch.models import transformer as _tf

        pending = list(self._pending)
        slices = plan_prefill_slices([len(p["prompt"]) - p["done"] for p in pending],
                                     self.prefill_budget, self.prefill_chunk)
        for ent, take in zip(pending, slices):
            if take <= 0:
                continue
            rid, prompt = ent["rid"], ent["prompt"]
            if not self.cache.has_room(rid, take):
                continue
            final = ent["done"] + take == len(prompt)
            self._prefill_shapes.add((1, self.prefill_chunk))
            logits = _tf.lm_prefill_paged(
                self.params,
                prompt[ent["done"] : ent["done"] + take],
                cfg=self.cfg,
                cache=self.cache,
                rid=rid,
                start_pos=ent["done"],
                chunk=self.prefill_chunk,
                table_width=self.table_width,
                block_k=self.block_k,
                compute_dtype=self.compute_dtype,
                head_shards=self.head_shards,
                need_logits=final,
            )
            self._count_prefill(take, interleaved=True)
            ent["done"] += take
            if final:
                self._pending.remove(ent)
                if self.trie is not None:
                    self._retain_prompt(rid)
                self._admit(rid, int(torch.argmax(logits[0])))

    def _drop(self, rid: int) -> list[int]:
        """Free ``rid``'s pages and host state; returns its output list."""
        self.cache.free(rid)
        self.last_token.pop(rid, None)
        self._prompt.pop(rid, None)
        self._family.pop(rid, None)
        return self.outputs.pop(rid)

    def _pending_entry(self, rid: int) -> dict | None:
        return next((p for p in self._pending if p["rid"] == rid), None)

    def finish(self, rid: int) -> list[int]:
        """Retire ``rid``: its pages return to the pool (aliased pages when
        their last owner goes; with the trie on, its prompt blocks stay
        retained, pinned at admission); returns its tokens.  A request
        still mid-prefill retires with no tokens."""
        if rid not in self.active:
            pend = self._pending_entry(rid)
            if pend is None:
                raise KeyError(f"request {rid} is not live")
            self._pending.remove(pend)
            return self._drop(rid)
        self.active.remove(rid)
        return self._drop(rid)

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
            head_shards=self.head_shards,
        )
        self._count_prefill(len(suffix))
        return self._admit(child, int(torch.argmax(logits[0])))

    # -- recoverable eviction by replay ---------------------------------- #
    def suspend(self, rid: int) -> SuspendedRequest:
        """Evict ``rid`` recoverably: its pages free now (an aliased page
        just loses one owner), the prompt and emitted tokens stay on the
        host.  Between steps the rows are ``prompt + outputs[:-1]`` (a
        verify step's rollback restores that), so the pending token and the
        history are the whole decode state; :meth:`resume` replays it.  A
        request still mid-prefill suspends too, with no tokens: its resume
        restarts the prompt."""
        pend = self._pending_entry(rid)
        if pend is not None:
            self._pending.remove(pend)
            parent, prefix_rows = None, 0
        elif rid in self.active:
            self.active.remove(rid)
            parent, prefix_rows = self._family.get(rid, (None, 0))
        else:
            raise KeyError(f"request {rid} is not live")
        rec = SuspendedRequest(prompt=list(self._prompt[rid]), outputs=self.outputs[rid],
                               parent=parent, prefix_len=prefix_rows)
        self._drop(rid)
        self.suspended[rid] = rec
        self.suspends += 1
        return rec

    def resume(self, rid: int) -> bool:
        """Re-admit a suspended request under its rid by replaying its rows
        through the chunked prefill (a live fork parent's prefix is
        re-aliased first, so only the suffix is recomputed); decoding goes
        on from the same pending token.  False, with nothing allocated,
        when the pool lacks pages.  Resume bypasses ``max_batch``."""
        rec = self.suspended.get(rid)
        if rec is None:
            raise KeyError(f"request {rid} is not suspended")
        if not self._replay(rid, rec, rec.parent):
            return False
        del self.suspended[rid]
        return True

    def resume_pending(self) -> list[int]:
        """Resume every suspended request the pool has room for, in
        ascending rid (fork parents before their children); returns the
        rids that came back."""
        return [rid for rid in sorted(self.suspended) if self.resume(rid)]

    def adopt_suspended(self, rec: SuspendedRequest, parent: int | None = None) -> int | None:
        """Admit another session's suspended record under a new rid;
        ``parent`` names the prefix parent's rid in this session (None
        replays the whole history).  Returns the rid, or None (nothing
        allocated) when the pool lacks room."""
        rid = self._next_id
        self._next_id += 1
        if not self._replay(rid, rec, parent):
            return None
        return rid

    def discard_suspended(self, rid: int) -> list[int]:
        """Drop a suspended request for good; returns its output so far."""
        return self.suspended.pop(rid).outputs

    def _replay(self, rid: int, rec: SuspendedRequest, parent: int | None) -> bool:
        from repro_torch.models import transformer as _tf

        kw = dict(cfg=self.cfg, cache=self.cache, rid=rid, chunk=self.prefill_chunk,
                  table_width=self.table_width, block_k=self.block_k,
                  compute_dtype=self.compute_dtype, head_shards=self.head_shards)
        if not rec.outputs:
            # Suspended mid-prefill: nothing was emitted, so the prompt
            # restarts (re-enqueued under a budget, prefilled now otherwise).
            prompt = list(rec.prompt)
            if not self.cache.has_room(None, len(prompt)):
                return False
            self.cache.alloc(rid)
            self._prompt[rid] = prompt
            self.outputs[rid] = rec.outputs
            self._note_admit(rid)
            self.resumes += 1
            if self.prefill_budget is not None:
                self._pending.append({"rid": rid, "prompt": prompt, "done": 0})
                return True
            self._prefill_shapes.add((1, self.prefill_chunk))
            logits = _tf.lm_prefill_paged(self.params, prompt, start_pos=0, **kw)
            self._count_prefill(len(prompt))
            self.replay_prefill_tokens += len(prompt)
            if self.trie is not None:
                self._retain_prompt(rid)
            self._admit(rid, int(torch.argmax(logits[0])))
            return True
        tokens = rec.tokens
        use_parent = parent is not None and parent in self.active
        prefix = (min(rec.prefix_len, len(tokens), self.cache.seq_len(parent))
                  if use_parent else 0)
        suffix = tokens[prefix:]
        if use_parent:
            self.cache.fork(parent, rid, prefix)
            if suffix and not self.cache.has_room(rid, len(suffix)):
                self.cache.free(rid)
                return False
        else:
            if not self.cache.has_room(None, len(suffix)):
                return False
            self.cache.alloc(rid)
        if suffix:
            self._prefill_shapes.add((1, self.prefill_chunk))
            logits = _tf.lm_prefill_paged(self.params, suffix, start_pos=prefix, **kw)
            # Replay-integrity probe: the replayed rows must re-derive the
            # pending token the original run emitted from them.  Counted,
            # not raised: the stream stays serviceable.
            if int(torch.argmax(logits[0])) != int(rec.outputs[-1]):
                self.replay_mismatches += 1
            self.replay_prefill_tokens += len(suffix)
            self._count_prefill(len(suffix))
        self.active.append(rid)
        self._prompt[rid] = list(rec.prompt)
        self.outputs[rid] = rec.outputs
        self.last_token[rid] = int(rec.outputs[-1])
        if use_parent:
            self._family[rid] = (parent, prefix)
        self.resumes += 1
        return True

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
        """Finish every pending and live request, release ballast, drop
        suspended records, clear the trie and audit the pool; a leaked page
        fails here.  Returns the sweep report."""
        for rid in self.resident_rids():
            self.finish(rid)
        for handle in list(self._ballast):
            self.release_pages(handle)
        self.suspended.clear()
        if self.trie is not None:
            self.trie.clear()
        report = self.cache.refcount_sweep()
        assert report["free_pages"] == self.cache.num_pages, (
            f"page leak at teardown: {report}"
        )
        return report


class ShardedPagedServingSession:
    """Sharded paged serving: the page pool and the decode work queue split
    over ``data`` shards with request routing, and tensor-parallel head
    groups within a shard (counterpart of the reference's
    ``ShardedPagedServingSession``).

    Each ``data`` shard owns one :class:`PagedServingSession`: a
    :class:`~repro_torch.runtime.kv_cache.LayeredPagedKVCache` slice of the
    global pool, its own memoizing
    :class:`~repro_torch.kernels.decode_schedule.DecodeScheduler` and
    decode graphs, and the parameters on its device.  A request's pages
    and its queue items live on one shard:

    * **admission** routes through
      :func:`~repro_torch.kernels.decode_schedule.route_request`: least
      live KV blocks wins, ties toward the longest prefix-trie hit
      (probed read-only), then more free pages, then the lowest index;
    * **fork / admit_with_prefix** pin the child to the parent's shard:
      page aliasing is pool-local, so a family never straddles shards;
    * **decode** runs each shard's own schedule over its own requests
      and its own K2 and K3 launches; ``head_shards`` chunks the query
      heads within a shard (one K2 and one K3 per chunk).  Each row's
      math does not depend on its batch, so at fp32 compute the greedy
      tokens equal one session's (a bf16 product computed at another
      batch size may round differently on the card);
    * **lifecycle**: ``drain_shard`` stops a shard's admissions,
      ``fail_shard`` suspends its requests and re-routes them (family
      roots first), ``attach_shard`` adds an empty pool slice.

    ``mesh=None, shards=N`` runs N logical shards on the parameters'
    device, sharing one parameter set: what one card runs.  A ``mesh``
    (:func:`repro_torch.launch.mesh.make_serving_mesh`) places shard
    ``i``'s parameters and pool on the mesh's ``data`` row ``i``, its
    ``model`` columns setting ``head_shards``.
    """

    def __init__(
        self,
        model,
        params,
        *,
        num_pages: int,
        mesh=None,
        shards: int | None = None,
        head_shards: int | None = None,
        page_size: int | None = None,
        block_k: int | None = None,
        num_splits: int = 1,
        prefix_sharing: bool = False,
        min_group: int = 2,
        prefill_chunk: int = 32,
        max_batch: int | None = None,
        dtype=None,
        kv_dtype=None,
        speculate: str = "off",
        draft_k: int = 4,
        draft_proposer=None,
        prefix_cache: str = "off",
        retain_pages: int | None = None,
        prefill_budget: int | None = None,
    ):
        from repro_torch.runtime.sharding import serving_shard_devices

        if mesh is not None and shards is not None:
            raise ValueError("pass mesh= or shards=, not both")
        if mesh is not None:
            devices = serving_shard_devices(mesh)
            n_data = len(devices)
            n_model = int(np.prod(mesh.devices.shape)) // n_data
        else:
            n_data = int(shards or 1)
            n_model = 1
            devices = [None] * n_data
        if n_data < 1:
            raise ValueError(f"need at least one data shard, got {n_data}")
        if num_pages % n_data:
            raise ValueError(
                f"num_pages={num_pages} must split evenly over {n_data} "
                f"data shards (use a multiple of {n_data})"
            )
        self.mesh = mesh
        self.num_shards = n_data
        self.head_shards = int(head_shards or n_model)
        self.max_batch = max_batch
        self._model = model
        self._params = params
        self._pages_per_shard = num_pages // n_data
        self._shard_kwargs = dict(
            page_size=page_size,
            block_k=block_k,
            num_splits=num_splits,
            prefix_sharing=prefix_sharing,
            min_group=min_group,
            prefill_chunk=prefill_chunk,
            dtype=dtype,
            kv_dtype=kv_dtype,
            head_shards=self.head_shards,
            # Speculation is shard-local: each shard drafts, verifies and
            # rolls back its own requests.
            speculate=speculate,
            draft_k=draft_k,
            draft_proposer=draft_proposer,
            # The trie is shard-local (pages cannot alias across pools);
            # the retention budget splits evenly, as the pool does.
            prefix_cache=prefix_cache,
            retain_pages=None if retain_pages is None else retain_pages // n_data,
            # The budget is per shard per step.
            prefill_budget=prefill_budget,
        )
        self.shards = [self._new_shard(dev) for dev in devices]
        self.block_k = self.shards[0].block_k
        self._page_size = self.shards[0].cache.page_size
        # global rid -> (shard index, shard-local rid)
        self._where: dict[int, tuple[int, int]] = {}
        self.active: list[int] = []
        self.outputs: dict[int, list[int]] = {}
        self._next_id = 0
        # Shard lifecycle: healthy shards admit, draining shards only
        # finish what they hold, dead shards are gone.
        self._health: list[str] = ["healthy"] * n_data
        # Suspended records live at this level: a resume must not depend
        # on a (possibly dead) origin shard's bookkeeping.
        self.suspended: dict[int, SuspendedRequest] = {}
        # child gid -> (parent gid, shared rows): family pinning for resume.
        self._gfamily: dict[int, tuple[int, int]] = {}

    def _new_shard(self, device) -> "PagedServingSession":
        """One shard's session: a pool slice on ``device``'s replica of the
        parameters (the same tensors when they live there already); the
        pool is made where the replica lies."""
        from repro_torch.runtime.elastic import serving_params_replica

        return PagedServingSession(
            self._model, serving_params_replica(self._params, device),
            num_pages=self._pages_per_shard, **self._shard_kwargs)

    # -- routing -------------------------------------------------------- #
    def _live_blocks(self, shard: PagedServingSession) -> int:
        # Pending (mid-prefill) rids count the blocks they already hold:
        # their rows are queue work the moment they go live.
        return sum(-(-shard.cache.seq_len(r) // self.block_k) for r in shard.resident_rids())

    def _route(self, pages: int, hit_pages=None) -> int | None:
        from repro_torch.kernels.decode_schedule import route_request

        return route_request(
            [self._live_blocks(s) for s in self.shards],
            [s.cache.num_free_pages for s in self.shards],
            pages,
            shard_ok=[h == "healthy" for h in self._health],
            shard_hit_pages=hit_pages,
        )

    def shard_of(self, rid: int) -> int:
        """Which data shard holds ``rid``'s pages and queue items."""
        return self._where[rid][0]

    def _register(self, shard_idx: int, local_rid: int) -> int:
        gid = self._next_id
        self._next_id += 1
        self._where[gid] = (shard_idx, local_rid)
        self.active.append(gid)
        # The shard's own list object: it appends generated tokens in
        # place, so this view stays current without a copy.
        self.outputs[gid] = self.shards[shard_idx].outputs[local_rid]
        return gid

    # -- admission / branching ------------------------------------------ #
    def add_request(self, prompt_tokens) -> int | None:
        """Route a prompt to the least-loaded shard and admit it there;
        returns a global rid, or None when no shard has room."""
        prompt = list(map(int, prompt_tokens))
        if len(prompt) < 1:
            raise ValueError(
                "add_request needs at least one prompt token (an empty "
                "prompt has no prefill position to decode from)"
            )
        pages = -(-len(prompt) // self._page_size)
        if pages > self._pages_per_shard:
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs {pages} pages but "
                f"each of the {self.num_shards} shard pools only has "
                f"{self._pages_per_shard}; a request lives on ONE shard — "
                "grow num_pages or truncate the prompt"
            )
        if self.max_batch is not None and len(self.active) >= self.max_batch:
            return None
        # Probe each shard's trie read-only (no LRU touch, no hit/miss
        # count: only the winning shard's admission counts).
        hit_pages = None
        if any(s.trie is not None for s in self.shards):
            usable = ((len(prompt) - 1) // self.block_k) * self.block_k
            hit_pages = [
                len(s.trie.match(prompt[:usable], touch=False, count=False)[1])
                if s.trie is not None else 0
                for s in self.shards
            ]
        idx = self._route(pages, hit_pages)
        if idx is None:
            return None
        local = self.shards[idx].add_request(prompt)
        if local is None:
            return None
        return self._register(idx, local)

    def fork(self, rid: int, prefix_len: int | None = None) -> int:
        """Branch at full history on the parent's shard (even a draining
        one: the family stays together)."""
        idx, local = self._where[rid]
        child_local = self.shards[idx].fork(local, prefix_len)
        gid = self._register(idx, child_local)
        self._gfamily[gid] = (rid, self.shards[idx].cache.seq_len(child_local))
        return gid

    def admit_with_prefix(self, parent_rid: int, suffix_tokens,
                          prefix_len: int | None = None) -> int | None:
        """Branch and prefill the suffix on the parent's shard; None when
        that shard lacks pages (prefix pages cannot alias across pools, so
        there is no other shard to try)."""
        idx, local = self._where[parent_rid]
        child_local = self.shards[idx].admit_with_prefix(local, suffix_tokens, prefix_len)
        if child_local is None:
            return None
        gid = self._register(idx, child_local)
        self._gfamily[gid] = (parent_rid, self.shards[idx]._family[child_local][1])
        return gid

    # -- decode ---------------------------------------------------------- #
    def step(self) -> None:
        """One greedy decode step on every shard with live or pending work
        (a shard with only pending prompts steps too: its budgeted prefill
        slices advance)."""
        for shard in self.shards:
            if shard.active or shard.prefill_pending:
                shard.step()

    def finish(self, rid: int) -> list[int]:
        idx, local = self._where.pop(rid)
        self.active.remove(rid)
        self.outputs.pop(rid)
        self._gfamily.pop(rid, None)
        return self.shards[idx].finish(local)

    # -- recoverable eviction / shard lifecycle -------------------------- #
    @property
    def shard_health(self) -> list[str]:
        """Per-shard lifecycle state: healthy / draining / dead."""
        return list(self._health)

    def suspend(self, gid: int) -> SuspendedRequest:
        """Suspend ``gid`` wherever it lives: its shard frees the pages and
        the replay record moves up to this level, so a resume may land on
        any shard (``outputs[gid]`` keeps aliasing the record's list)."""
        if gid not in self.active:
            raise KeyError(f"request {gid} is not live")
        idx, local = self._where.pop(gid)
        rec = self.shards[idx].suspend(local)
        self.shards[idx].suspended.pop(local, None)
        self.active.remove(gid)
        self.suspended[gid] = rec
        return rec

    def resume(self, gid: int) -> bool:
        """Re-route and replay one suspended request: onto its fork
        parent's shard, re-aliasing the prefix, while the parent is live;
        else where :func:`route_request` sends it.  False when no eligible
        shard has room yet."""
        rec = self.suspended.get(gid)
        if rec is None:
            raise KeyError(f"request {gid} is not suspended")
        parent_gid, _rows = self._gfamily.get(gid, (None, 0))
        if parent_gid is not None and parent_gid in self.active:
            idx, parent_local = self._where[parent_gid]
            local = self.shards[idx].adopt_suspended(rec, parent=parent_local)
        else:
            idx = self._route(-(-len(rec.tokens) // self._page_size))
            if idx is None:
                return False
            local = self.shards[idx].adopt_suspended(rec, parent=None)
        if local is None:
            return False
        del self.suspended[gid]
        self._where[gid] = (idx, local)
        self.active.append(gid)
        self.outputs[gid] = self.shards[idx].outputs[local]
        return True

    def resume_pending(self) -> list[int]:
        """Resume every suspended request that fits, ascending gid (a fork
        parent before its children); returns the gids that came back."""
        return [gid for gid in sorted(self.suspended) if self.resume(gid)]

    def discard_suspended(self, gid: int) -> list[int]:
        """Drop a suspended request for good; returns its output so far."""
        rec = self.suspended.pop(gid)
        self.outputs.pop(gid, None)
        self._gfamily.pop(gid, None)
        return rec.outputs

    def drain_shard(self, idx: int) -> int:
        """Stop admitting onto shard ``idx``; its live requests decode to
        completion.  Returns how many are still draining (a dead shard
        stays dead)."""
        if self._health[idx] != "dead":
            self._health[idx] = "draining"
        return len(self.shards[idx].active)

    def fail_shard(self, idx: int) -> dict:
        """Shard loss: mark ``idx`` dead, suspend every live request it
        held (the prompts and outputs survive on the host), then re-route
        them at once through :meth:`resume_pending`; those that do not fit
        stay suspended.  Returns ``{"suspended": [...], "resumed": [...]}``."""
        if self._health[idx] == "dead":
            return {"suspended": [], "resumed": []}
        self._health[idx] = "dead"
        victims = [g for g in list(self.active) if self._where[g][0] == idx]
        for gid in victims:
            self.suspend(gid)
        return {"suspended": victims, "resumed": self.resume_pending()}

    def attach_shard(self, device=None) -> int:
        """Grow the fleet: an empty pool slice of every shard's size, on
        ``device``'s replica of the parameters
        (:func:`repro_torch.runtime.elastic.serving_params_replica`: the
        same tensors on their own device, so a logical shard copies no
        weight), open for routing.  Returns its index; being empty, it
        takes the next admissions."""
        self.shards.append(self._new_shard(device))
        self._health.append("healthy")
        self.num_shards += 1
        return len(self.shards) - 1

    # -- chaos hooks ------------------------------------------------------ #
    def hold_pages(self, n: int, shard: int = 0) -> tuple[int, int]:
        """Pool-pressure ballast on one shard
        (:meth:`PagedServingSession.hold_pages`)."""
        return shard, self.shards[shard].hold_pages(n)

    def release_pages(self, handle: tuple[int, int]) -> None:
        shard, h = handle
        self.shards[shard].release_pages(h)

    # -- introspection --------------------------------------------------- #
    @property
    def scheduler_stats(self) -> dict:
        """Summed schedule build/reuse counters across shards."""
        return {k: sum(s.scheduler_stats[k] for s in self.shards) for k in ("hits", "rebuilds")}

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill chunk shapes across shards (1 with fixed chunks)."""
        return len(set().union(*(s._prefill_shapes for s in self.shards)))

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured across shards (each shard keys its own)."""
        return sum(s.graph_captures for s in self.shards)

    @property
    def work_units(self) -> int:
        """Summed virtual work clock (decode launches + prefill chunks)."""
        return sum(s.work_units for s in self.shards)

    @property
    def prefill_pending(self) -> int:
        """Admitted prompts not yet prefilled, across shards."""
        return sum(s.prefill_pending for s in self.shards)

    _SUMMED = (
        "decode_steps", "request_steps", "query_rows", "accepted_tokens", "page_dmas",
        "page_dma_bytes", "rows_attended", "aliased_pages", "free_pages", "live_pages",
        "retained_pages", "trie_hits", "trie_misses", "trie_admissions",
        "prefix_tokens_reused", "trie_evicted_pages", "suspends", "resumes",
        "replay_prefill_tokens", "replay_mismatches", "work_units", "prefill_chunks",
        "prefill_stall_steps", "prefill_pending", "prefill_backlog_tokens", "first_tokens",
        "ttft_units_total",
    )

    def work_stats(self) -> dict:
        """The shards' work counters summed, ``per_shard``, and ``balance``
        (:func:`~repro_torch.kernels.decode_schedule.shard_work_balance`
        over per-shard page DMAs).  Ratios are recomputed from the summed
        counters (a mean of per-shard ratios would weigh an idle shard as
        much as a busy one)."""
        from repro_torch.kernels.decode_schedule import shard_work_balance

        per_shard = [s.work_stats() for s in self.shards]
        agg = {k: sum(st[k] for st in per_shard) for k in self._SUMMED}
        agg["max_inter_token_units"] = max(st["max_inter_token_units"] for st in per_shard)
        # Suspended records wait at this level, held by no shard.
        agg["suspended"] = len(self.suspended)
        agg["shard_health"] = self.shard_health
        agg["accepted_tokens_per_step"] = agg["accepted_tokens"] / max(agg["request_steps"], 1)
        agg["page_dma_bytes_per_accepted_token"] = (
            agg["page_dma_bytes"] / max(agg["accepted_tokens"], 1))
        agg["trie_hit_rate"] = agg["trie_hits"] / max(agg["trie_hits"] + agg["trie_misses"], 1)
        agg["prefix_tokens_reused_per_admission"] = (
            agg["prefix_tokens_reused"] / max(agg["trie_admissions"], 1))
        agg["per_shard"] = per_shard
        agg["balance"] = shard_work_balance([st["page_dmas"] for st in per_shard])
        return agg

    def reclaim_retained(self, n_pages: int) -> int:
        """Evict cold retained trie subtrees across shards, fullest pool
        first, until ``n_pages`` are freed or nothing is freeable; returns
        the pages freed."""
        freed = 0
        for shard in sorted(self.shards, key=lambda s: s.cache.num_free_pages):
            if freed >= n_pages:
                break
            freed += shard.reclaim_retained(n_pages - freed)
        return freed

    def close(self) -> dict:
        """Every shard's teardown audit (:meth:`PagedServingSession.close`):
        each pool must come back fully free."""
        self.suspended.clear()
        reports = [s.close() for s in self.shards]
        self.active.clear()
        self.outputs.clear()
        self._where.clear()
        self._gfamily.clear()
        return {"free_pages": sum(r["free_pages"] for r in reports), "per_shard": reports}


def latency_percentile(samples, q: float) -> float:
    """Nearest-rank percentile (inclusive) of a list of latency samples:
    p99 of 10 samples is the largest, never a blend.  Empty input: 0.0."""
    if not 0 <= q <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {q}")
    xs = sorted(float(x) for x in samples)
    if not xs:
        return 0.0
    rank = max(1, int(np.ceil(q / 100.0 * len(xs))))
    return xs[rank - 1]


class ServeSupervisor:
    """Supervised continuous-batching serve loop over a
    :class:`PagedServingSession` or a :class:`ShardedPagedServingSession`,
    with deterministic chaos.

    Runs until every submitted request has ``gen_len`` tokens past its
    first or was abandoned.  Between decode steps it:

    * applies the due events of a
      :class:`~repro_torch.runtime.fault_injection.FaultPlan` (shard loss,
      which fails a healthy shard of a sharded session and re-routes its
      requests but never takes the last healthy one: on one session it is
      skipped and counted in ``faults_skipped``; slow shard; pool-pressure
      ballast on the event's shard; abandon);
    * resumes suspended requests, after a backoff for those it evicted;
    * admits arrived prompts in
      :func:`~repro_torch.kernels.decode_schedule.admission_order`
      (priority class, then deadline slack, then submission index), with
      exponential backoff after a rejection and skip-ahead past prompts
      that do not fit or are backing off;
    * abandons requests past their deadline (steps since admission) with
      their partial output, also while still mid-prefill;
    * stamps per-request latency on the session's work clock and feeds
      the host time of each step to a
      :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor`;
    * on :class:`~repro_torch.runtime.kv_cache.OutOfPagesError` reclaims
      retained trie pages, else suspends an SLA victim, and retries.

    :meth:`run` returns results keyed by submission index.
    """

    def __init__(
        self,
        sess,
        *,
        gen_len: int,
        deadline: int | None = None,
        plan=None,
        max_steps: int | None = None,
        backoff_base: int = 1,
        backoff_cap: int = 16,
        deadline_guard: int = 2,
        arrival_unit: str = "steps",
    ):
        from repro_torch.runtime.fault_tolerance import StragglerMonitor

        if not hasattr(sess, "suspended"):
            raise ValueError(
                "ServeSupervisor needs a paged session (suspend/resume "
                "rides the paged pool's refcounted free/replay; dense "
                "slot sessions have neither)"
            )
        if gen_len < 1:
            raise ValueError(f"gen_len must be >= 1, got {gen_len}")
        if deadline is not None and deadline < 1:
            raise ValueError(f"deadline must be >= 1 steps, got {deadline}")
        if deadline_guard < 0:
            raise ValueError(f"deadline_guard must be >= 0 steps, got {deadline_guard}")
        if arrival_unit not in ("steps", "work_units"):
            raise ValueError(
                f"arrival_unit={arrival_unit!r} is not a clock; pick "
                "'steps' (supervisor loop iterations) or 'work_units' "
                "(the session's virtual work clock — a synchronous prefill "
                "visibly delays later arrivals, like wall time would)"
            )
        self.sess = sess
        self.gen_len = int(gen_len)
        self.deadline = deadline
        self.plan = plan
        self.max_steps = max_steps
        self.backoff_base = max(1, int(backoff_base))
        self.backoff_cap = max(self.backoff_base, int(backoff_cap))
        self.deadline_guard = int(deadline_guard)
        self.arrival_unit = arrival_unit
        # Idle ticks advance the work-unit arrival clock by this skew:
        # waiting for a later arrival does no session work.
        self._clock_skew = 0
        self.straggler = StragglerMonitor()
        self._submitted: list[list[int]] = []
        self._meta: list[dict] = []  # priority, deadline, arrival per submission
        self._lat: list[dict] = []  # latency marks per submission
        self._queue: list[list[int]] = []  # [submission index, not_before, backoff]
        self._live: dict[int, dict] = {}  # rid -> idx, remaining, admitted, priority, deadline
        self._results: dict[int, list[int]] = {}
        self.abandoned_idx: set[int] = set()
        self._ballast: list[tuple[int, int]] = []  # (release step, handle)
        self._slow: tuple[int, float] | None = None  # (until step, factor)
        self._resume_hold: dict[int, list[int]] = {}  # rid -> [step, backoff]
        self._plan_applied: set[int] = set()
        self.steps = 0
        self.completed = 0
        self.abandoned = 0
        self.tokens_out = 0
        self.admission_retries = 0
        self.evictions = 0
        self.reclaims = 0
        self.faults_applied = 0
        self.faults_skipped = 0
        self.events: list[str] = []

    def submit(self, prompt_tokens, *, priority: int = 0, deadline: int | None = None,
               arrival: int = 0) -> int:
        """Queue a prompt; returns its submission index (the results key).
        ``priority`` is its class (higher admits first), ``deadline``
        overrides the supervisor's (steps since admission), ``arrival`` is
        when it enters the queue, on the ``arrival_unit`` clock."""
        if deadline is not None and deadline < 1:
            raise ValueError(f"deadline must be >= 1 steps, got {deadline}")
        if arrival < 0:
            raise ValueError(f"arrival step must be >= 0, got {arrival}")
        idx = len(self._submitted)
        self._submitted.append(list(map(int, prompt_tokens)))
        self._meta.append({"priority": int(priority),
                           "deadline": None if deadline is None else int(deadline),
                           "arrival": int(arrival)})
        self._lat.append({"submit_vt": None, "submit_step": None, "admit_vt": None,
                          "admit_step": None, "first_vt": None, "first_step": None,
                          "last_vt": None, "gaps": []})
        self._queue.append([idx, 0, self.backoff_base])
        return idx

    def _vt(self) -> int:
        """The session's virtual work clock (decode launches + prefill chunks)."""
        return int(self.sess.work_units)

    def _now(self, step: int) -> int:
        """The arrival clock: supervisor steps, or the work clock plus idle skew."""
        return step if self.arrival_unit == "steps" else self._vt() + self._clock_skew

    def _lat_clock(self) -> int:
        """The clock latency marks are stamped on (comparable with arrivals)."""
        return self._vt() if self.arrival_unit == "steps" else self._vt() + self._clock_skew

    def _effective_deadline(self, info: dict) -> int | None:
        return self.deadline if info.get("deadline") is None else info["deadline"]

    def _slack(self, rid: int, step: int) -> float:
        """Steps until ``rid``'s deadline expires (inf without one)."""
        info = self._live[rid]
        ddl = self._effective_deadline(info)
        return float("inf") if ddl is None else (info["admitted"] + ddl) - step

    # -- the loop -------------------------------------------------------- #
    def run(self) -> dict[int, list[int]]:
        """Serve until every submission completed or was abandoned; returns
        ``{submission index: tokens}``.  Raises RuntimeError when the stream
        cannot make progress or passes the step limit."""
        from repro_torch.runtime.kv_cache import OutOfPagesError

        sess = self.sess
        limit = self.max_steps
        if limit is None:
            limit = (self.gen_len + 8) * (len(self._submitted) + 4) * 4
        while self._queue or self._live:
            step = self.steps
            if step >= limit:
                raise RuntimeError(
                    f"supervised serve stalled after {step} steps with "
                    f"{len(self._live)} live and {len(self._queue)} queued requests"
                )
            self._apply_plan(step)
            self._tick_ballast(step)
            self._try_resume(step)
            self._admit(step)
            steppable = [r for r in self._live if r not in sess.suspended]
            if not steppable:
                self._idle_tick(step)
                continue
            before = {r: len(sess.outputs[r]) for r in steppable}
            t0 = time.perf_counter()
            oom = False
            try:
                # On the card the step ends in a host copy of the greedy
                # picks, so this time includes the device's work.
                sess.step()
            except OutOfPagesError:
                # Appends are atomic: every request emitted or none did.
                oom = True
            dt = time.perf_counter() - t0
            if not oom:
                if self._slow is not None:
                    until, factor = self._slow
                    if step < until:
                        # Injected straggle: inflate the observation against
                        # the monitor's own baseline (no real sleep).
                        if self.straggler.ewma is not None:
                            dt += factor * self.straggler.ewma
                    else:
                        self._slow = None
                self.straggler.observe(step, dt)
            for rid in list(self._live):
                info = self._live[rid]
                if rid in before:
                    emitted = len(sess.outputs[rid]) - before[rid]
                    if emitted:
                        self.tokens_out += emitted
                        info["remaining"] -= emitted
                        lat = self._lat[info["idx"]]
                        vt = self._lat_clock()
                        if lat["first_vt"] is None:
                            lat["first_vt"] = vt
                            lat["first_step"] = step
                        else:
                            lat["gaps"].append(vt - lat["last_vt"])
                        if emitted > 1:  # a verify step's extra tokens land at once
                            lat["gaps"].extend([0] * (emitted - 1))
                        lat["last_vt"] = vt
                    if info["remaining"] <= 0:
                        self._results[info["idx"]] = sess.finish(rid)
                        self.completed += 1
                        del self._live[rid]
                        continue
                ddl = self._effective_deadline(info)
                if ddl is not None and step - info["admitted"] >= ddl:
                    # Steps count whether or not the request emitted: a
                    # prompt still mid-prefill can expire with no tokens.
                    self._abandon(rid)
            if oom:
                # Retained prefix pages are the cheapest to give back; only
                # when none are freeable is a live victim suspended.
                reclaimed = sess.reclaim_retained(max(len(steppable), 1))
                if reclaimed > 0:
                    self.reclaims += 1
                    self.events.append(f"step {self.steps}: pool full — reclaimed "
                                       f"{reclaimed} retained page(s)")
                else:
                    victims = [r for r in steppable
                               if r in self._live and r not in sess.suspended]
                    if victims:
                        self._suspend_victim(victims)
            self.steps += 1
        for _, handle in self._ballast:
            sess.release_pages(handle)
        self._ballast.clear()
        return dict(self._results)

    def latency_records(self) -> list[dict]:
        """Per-submission latency records (work-clock marks + gaps)."""
        return [dict(r, gaps=list(r["gaps"])) for r in self._lat]

    def stats(self) -> dict:
        """Supervision counters, the session's suspend/replay work and
        nearest-rank latency percentiles on the work clock: ``ttft_units``
        submit to first token, ``tpot_units`` the gaps between emissions."""
        work = self.sess.work_stats()
        ttft = [r["first_vt"] - r["submit_vt"] for r in self._lat
                if r["first_vt"] is not None and r["submit_vt"] is not None]
        ttft_steps = [r["first_step"] - r["submit_step"] for r in self._lat
                      if r["first_step"] is not None and r["submit_step"] is not None]
        gaps = [g for r in self._lat for g in r["gaps"]]
        return {
            "steps": self.steps,
            "completed": self.completed,
            "abandoned": self.abandoned,
            "tokens_out": self.tokens_out,
            "admission_retries": self.admission_retries,
            "evictions": self.evictions,
            "reclaims": self.reclaims,
            "faults_applied": self.faults_applied,
            "faults_skipped": self.faults_skipped,
            "straggler_events": len(self.straggler.events),
            "suspends": work["suspends"],
            "resumes": work["resumes"],
            "replay_prefill_tokens": work["replay_prefill_tokens"],
            "replay_mismatches": work["replay_mismatches"],
            "work_units": self._vt(),
            "prefill_chunks": work["prefill_chunks"],
            "prefill_stall_steps": work["prefill_stall_steps"],
            "first_tokens": len(ttft),
            "ttft_units_p50": latency_percentile(ttft, 50),
            "ttft_units_p99": latency_percentile(ttft, 99),
            "ttft_steps_p50": latency_percentile(ttft_steps, 50),
            "ttft_steps_p99": latency_percentile(ttft_steps, 99),
            "tpot_units_p50": latency_percentile(gaps, 50),
            "tpot_units_p99": latency_percentile(gaps, 99),
        }

    # -- internals ------------------------------------------------------- #
    def _admit(self, step: int, force: bool = False) -> bool:
        from repro_torch.kernels.decode_schedule import admission_order

        admitted = False
        now = self._now(step)
        arrived = [it for it in self._queue if self._meta[it[0]]["arrival"] <= now]
        # Stamp queue entry once, before any admission work: TTFT starts at
        # arrival (on the work-unit clock, the arrival itself).
        for it in arrived:
            lat = self._lat[it[0]]
            if lat["submit_vt"] is None:
                lat["submit_vt"] = (self._lat_clock() if self.arrival_unit == "steps"
                                    else self._meta[it[0]]["arrival"])
                lat["submit_step"] = step
        order = admission_order(
            # queued slack is the deadline window itself: tighter first
            (it[0], self._meta[it[0]]["priority"],
             self._meta[it[0]]["deadline"] if self._meta[it[0]]["deadline"] is not None
             else self.deadline)
            for it in arrived
        )
        by_idx = {it[0]: it for it in arrived}
        for idx in order:
            item = by_idx[idx]
            if not force and item[1] > step:
                continue  # backing off: skip ahead
            rid = self.sess.add_request(self._submitted[idx])
            if rid is None:
                item[1] = step + item[2]
                item[2] = min(item[2] * 2, self.backoff_cap)
                self.admission_retries += 1
                continue  # skip ahead: a later prompt may still fit
            self._queue.remove(item)
            meta = self._meta[idx]
            synchronous = bool(self.sess.outputs[rid])  # first token emitted already
            self._live[rid] = {
                "idx": idx,
                # gen_len tokens past the first, which a budgeted session
                # emits later as a step's delta
                "remaining": self.gen_len + (0 if synchronous else 1),
                "admitted": step,
                "priority": meta["priority"],
                "deadline": meta["deadline"],
            }
            lat = self._lat[idx]
            lat["admit_vt"] = self._lat_clock()
            lat["admit_step"] = step
            if synchronous:
                # stamped after the prefill: its chunks are part of its TTFT
                lat["first_vt"] = self._lat_clock()
                lat["first_step"] = step
                lat["last_vt"] = lat["first_vt"]
            admitted = True
            force = False
        return admitted

    def _try_resume(self, step: int) -> None:
        sess = self.sess
        # Ascending rid: fork parents before children.  Requests this
        # supervisor evicted sit out their backoff first, so they are not
        # resumed straight into the pressure that evicted them.
        for rid in sorted(sess.suspended):
            hold = self._resume_hold.get(rid)
            if hold is not None and hold[0] > step:
                continue
            if sess.resume(rid):
                self._resume_hold.pop(rid, None)

    def _idle_tick(self, step: int) -> None:
        # Nothing steppable: wait for a ballast release, a backoff or a
        # later arrival, else fail instead of spinning.
        if self._ballast:
            self.steps += 1
            return
        if self._live:
            if any(self._resume_hold.get(r, [0])[0] > step for r in self._live):
                self.steps += 1
                return
            raise RuntimeError(
                f"{len(self._live)} suspended request(s) cannot be resumed "
                "— no eligible shard has room and nothing live could free pages"
            )
        if self._queue:
            arrived = [it for it in self._queue
                       if self._meta[it[0]]["arrival"] <= self._now(step)]
            if not arrived:
                self._clock_skew += 1  # a stream gap: idle time passes
                self.steps += 1
                return
            if self._admit(step, force=True):
                return
            raise RuntimeError(
                f"request of {len(self._submitted[arrived[0][0]])} tokens cannot be "
                "admitted even with an idle session — grow the pool or truncate the prompt"
            )

    def _suspend_victim(self, steppable: list[int]) -> None:
        # Evict from the fullest pool (a sharded session's shards each have
        # their own), by SLA: lowest priority class, then most deadline
        # slack, then most complete, then newest.  A request within
        # ``deadline_guard`` steps of its deadline is spared while any other
        # candidate exists.
        sess, step = self.sess, self.steps
        if hasattr(sess, "shards"):
            free = lambda r: sess.shards[sess.shard_of(r)].cache.num_free_pages
        else:
            free = lambda r: sess.cache.num_free_pages
        candidates = [r for r in steppable if self._slack(r, step) > self.deadline_guard]
        victim = max(candidates or steppable, key=lambda r: (
            -free(r), -self._live[r]["priority"], self._slack(r, step),
            len(sess.outputs[r]), -r))
        sess.suspend(victim)
        hold = self._resume_hold.setdefault(victim, [0, self.backoff_base])
        hold[1] = min(hold[1] * 2, 32)
        hold[0] = self.steps + hold[1]
        self.evictions += 1
        self.events.append(f"step {self.steps}: pool full — suspended request {victim}")

    def _abandon(self, rid: int) -> None:
        info = self._live.pop(rid)
        sess = self.sess
        out = sess.discard_suspended(rid) if rid in sess.suspended else sess.finish(rid)
        self._results[info["idx"]] = out
        self.abandoned_idx.add(info["idx"])
        self.abandoned += 1
        self.events.append(f"step {self.steps}: abandoned request {rid} "
                           f"(submission {info['idx']}) with {len(out)} tokens")

    def _apply_plan(self, step: int) -> None:
        # A step index re-enters after an eviction retry; events fire once.
        if self.plan is None or step in self._plan_applied:
            return
        self._plan_applied.add(step)
        sess = self.sess
        for ev in self.plan.events_at(step):
            if ev.kind == "shard_loss":
                healthy = [i for i, h in enumerate(getattr(sess, "shard_health", []))
                           if h == "healthy"]
                if len(healthy) < 2:
                    # Never kill the last healthy shard (one session has no
                    # other to re-route to): the skip is counted.
                    self.faults_skipped += 1
                    continue
                target = ev.shard if ev.shard in healthy else healthy[ev.shard % len(healthy)]
                res = sess.fail_shard(target)
                self.faults_applied += 1
                self.events.append(f"step {step}: shard {target} lost — "
                                   f"{len(res['suspended'])} suspended, "
                                   f"{len(res['resumed'])} re-routed immediately")
            elif ev.kind == "slow_shard":
                self._slow = (step + max(1, ev.duration), ev.factor)
                self.faults_applied += 1
                self.events.append(f"step {step}: slow shard x{ev.factor:g} for "
                                   f"{max(1, ev.duration)} steps")
            elif ev.kind == "pool_pressure":
                if hasattr(sess, "shards"):
                    shard = ev.shard % sess.num_shards
                    if sess.shard_health[shard] != "healthy":
                        self.faults_skipped += 1
                        continue
                    handle = sess.hold_pages(ev.pages, shard=shard)
                else:
                    handle = sess.hold_pages(ev.pages)
                self._ballast.append((step + max(1, ev.duration), handle))
                self.faults_applied += 1
                self.events.append(f"step {step}: pool pressure — {ev.pages} pages held "
                                   f"for {max(1, ev.duration)} steps")
            elif ev.kind == "abandon":
                if not self._live:
                    self.faults_skipped += 1
                    continue
                self.faults_applied += 1
                self._abandon(min(self._live, key=lambda r: self._live[r]["idx"]))

    def _tick_ballast(self, step: int) -> None:
        keep = []
        for due, handle in self._ballast:
            if due <= step:
                self.sess.release_pages(handle)
            else:
                keep.append((due, handle))
        self._ballast = keep


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
