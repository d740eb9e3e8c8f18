"""CUDA graphs of the serving sessions' decode steps: the port's
counterpart of the reference's ``jax.jit`` of its decode walk (the jitted
halves of a paged layer in ``repro/models/transformer.py``, the jitted
dense ``decode_step`` in ``repro/runtime/serve_loop.py``).

A decode step is split in two:

* **staging** (host): the checks, the page reservation, each appended
  row's ``(page, offset)``, the block table, ``kv_len``, the positions and
  the schedule (:func:`repro_torch.models.transformer.stage_decode_step_paged`),
  or the dense slots' last tokens and lengths, copied into tensors that
  keep their addresses for the life of the graph (one set per graph key);
* **walk** (device): the embed, the layer loop and the logits, reading only
  those tensors, the weights and the caches.

On a CUDA device :class:`StepGraphs` captures the walk once per key into a
``torch.cuda.CUDAGraph`` and replays it every step.  Before the capture
the walk runs twice on a side stream: once to do the lazy set-up (the
kernel library's build, each kernel's shared-memory attribute, cuBLAS's
handles, K6's combine tables), once under
``torch.cuda.set_sync_debug_mode("error")``, which fails on any host value
the walk would still read or copy.  Every capture of a session draws its
memory from one pool (``torch.cuda.graph_pool_handle()``); the graphs are
replayed one at a time, on the current stream.  A failed capture or replay
raises: there is no eager path on the card that an error falls back to.
The eager walk runs on the card only when asked for, by
``StepGraphs.run(..., eager=True)`` for one step (the counterpart of
``jax.disable_jit``); on the CPU the same walk runs over the same tensors,
uncaptured.

The kernel wrappers count their launches in Python (``.launches``,
``.int8_launches``, ``.mma_launches``), when the walk runs, not when a graph
replays.  So the increments of the warm-ups and of the capture are taken
back, the capture's are kept with its graph, and every replay adds them:
the counts read layers x steps, as in the eager walk.

Graph keys: a paged step is keyed by its live batch ``B`` (what
``PagedServingSession.decode_compiles`` counts) and its work queue's
capacity: the queue is padded with inert items to the bucket times the
least power of two that holds it
(:func:`repro_torch.kernels.decode_schedule.queue_capacity`, ``pad_queue``),
so a schedule rebuild (a request crossing a KV block) mostly replays the
same graph over new queue contents, and the padded queue, which every K2
CTA scans, is at most twice the schedule's.  A dense step has one key: its
batch is fixed, and free slots decode a dummy token.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import decode_schedule as _sched
from repro_torch.kernels import flash_prefill as _prefill
from repro_torch.kernels import gqa_decode as _gqa
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import mla_decode_combine as _combine
from repro_torch.kernels import mla_decode_paged as _paged
from repro_torch.kernels import ops
from repro_torch.models import transformer as _tf

# Every kernel wrapper's launch counters: (module, wrapper name, counters).
_COUNTERS = (
    (_paged, "mla_decode_paged_queue_rows", ("launches", "int8_launches", "mma_launches")),
    (_paged, "mla_decode_paged_group_prefix", ("launches", "mma_launches")),
    (_paged, "mla_decode_paged_rows", ("launches", "mma_launches")),
    (_combine, "combine_split_partials", ("launches",)),
    (_mla, "mla_decode_rows", ("launches", "mma_launches")),
    (_gqa, "gqa_decode_rows", ("launches", "mma_launches")),
    (_prefill, "flash_prefill", ("launches", "mma_launches")),
)


def launch_counts() -> dict[tuple[str, str], int]:
    """Every kernel wrapper's launch counters, ``{(wrapper, counter): n}``."""
    return {
        (name, c): getattr(getattr(mod, name), c, 0)
        for mod, name, counters in _COUNTERS
        for c in counters
    }


def set_launch_counts(counts: dict[tuple[str, str], int]) -> None:
    """Set the counters to ``counts`` (as :func:`launch_counts` returns)."""
    for mod, name, counters in _COUNTERS:
        for c in counters:
            setattr(getattr(mod, name), c, counts[name, c])


def add_launch_counts(delta: dict[tuple[str, str], int]) -> None:
    set_launch_counts({k: v + delta[k] for k, v in launch_counts().items()})


class StepGraphs:
    """One CUDA graph per key of a session's decode walk, captured at the
    key's first step and replayed at every later one (see the module
    docstring).  ``captures`` counts them.  On a CPU device (``enabled``
    false) :meth:`run` runs the walk eagerly.  ``state`` lists tensors the
    walk advances in place (a recurrent or SSM layer's state): they are
    saved before the capture's warm-ups and put back after them."""

    def __init__(self, device, state=()):
        self.device = torch.device(device)
        self.enabled = self.device.type == "cuda"
        self.state = list(state)
        self._graphs: dict = {}
        self._pool = None

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def run(self, key, walk, *, eager: bool = False) -> torch.Tensor:
        """The output of ``walk()`` (a tensor the walk allocates): replayed
        from the graph of ``key`` (captured now if it is new), or run
        eagerly where the graphs are off or ``eager`` is set.  A replay
        returns the same tensor every time, overwritten in place."""
        if eager or not self.enabled:
            return walk()
        if key not in self._graphs:
            self._graphs[key] = self._capture(walk)
        graph, out, delta = self._graphs[key]
        graph.replay()
        add_launch_counts(delta)
        return out

    def _capture(self, walk):
        before = launch_counts()
        # the warm-ups run the step: state that a step advances (a
        # recurrent or SSM layer's) is put back before the capture, so the
        # step's first replay advances it once
        saved = [t.clone() for t in self.state]
        try:
            with torch.cuda.device(self.device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    walk()
                    mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        walk()
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
                torch.cuda.current_stream().wait_stream(side)
                for t, v in zip(self.state, saved):
                    t.copy_(v)
                del saved
                set_launch_counts(before)
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool):
                    out = walk()
            after = launch_counts()
        finally:
            set_launch_counts(before)
        return graph, out, {k: after[k] - before[k] for k in before}


class PagedDecodeStep:
    """The plain-queue decode step of a
    :class:`~repro_torch.runtime.serve_loop.PagedServingSession` (one new
    token per live request, over bf16, fp32 or int8 pages): host staging
    into one set of tensors per key (live batch ``B``, queue capacity),
    then the walk, replayed from a CUDA graph per key on a CUDA device
    (:class:`StepGraphs`).  Under ``head_shards = h`` the walk attends each
    of the h chunks of heads with its own K2 and K3 launch, so a graph
    replays h of each per layer, as the eager walk launches them."""

    def __init__(self, params, cache, *, cfg, scheduler, table_width: int, block_k: int,
                 num_splits: int, compute_dtype=None, head_shards: int = 1):
        self.params, self.cache, self.cfg = params, cache, cfg
        self.scheduler = scheduler
        self.table_width, self.block_k, self.num_splits = table_width, block_k, num_splits
        self.compute_dtype = compute_dtype
        self.head_shards = head_shards
        self._reset()

    def _reset(self) -> None:
        """No graphs and no staged tensors, on the cache's device (at
        construction, and after ``cache.to_device`` moved the pool: the
        graphs captured its old addresses)."""
        self._pool = self.cache.pages
        self.graphs = StepGraphs(self.cache.device)
        self._staged: dict[tuple[int, int], tuple] = {}  # key -> (inputs, queue, schedule)

    @property
    def shapes(self) -> list[tuple[int, int]]:
        """The keys staged so far, ``(B, queue capacity)``: one graph each
        on a CUDA device."""
        return list(self._staged)

    def _buffers(self, plan, key):
        if key not in self._staged:
            dev = self.cache.device
            (b, cap), i32 = key, lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
            queue = ops.DeviceQueue(
                tuple(i32(cap) for _ in range(6)), i32(b, self.num_splits), i32(b),
                self.block_k, b * self.num_splits + 1,
            )
            self._staged[key] = (_tf.PagedStepInputs.like(plan, dev), queue, None)
        return self._staged[key]

    def __call__(self, tokens, rids: list[int]) -> torch.Tensor:
        """Stage and walk one step of ``tokens (B, 1)`` for ``rids``;
        returns the logits ``(B, 1, vocab)`` (a graph's output tensor,
        overwritten by its next replay)."""
        if np.shape(tokens)[1:] != (1,):
            raise ValueError(
                f"a graphed paged step takes one token per request, (B, 1); got "
                f"{np.shape(tokens)} (multi-row steps run lm_decode_step_paged)"
            )
        if self.cache.pages is not self._pool:
            self._reset()
        plan = _tf.stage_decode_step_paged(
            tokens, cfg=self.cfg, cache=self.cache, rids=rids, scheduler=self.scheduler,
            extra_key=tuple(rids), table_width=self.table_width, block_k=self.block_k,
            num_splits=self.num_splits,
        )
        key = (len(rids), _sched.queue_capacity(plan.schedule.queue_len,
                                                self.scheduler.queue_bucket))
        inputs, queue, staged = self._buffers(plan, key)
        inputs.fill(plan)
        if staged is not plan.schedule:  # a rebuilt schedule: copy its queue in
            padded = _sched.pad_queue(plan.schedule, key[1])
            for t, a in zip((*queue.items, queue.dest_table, queue.n_splits),
                            (*padded.prefetch_arrays(), padded.dest_table, padded.n_splits)):
                t.copy_(torch.from_numpy(a))
            self._staged[key] = (inputs, queue, plan.schedule)

        def walk():
            return _tf.decode_walk_paged(
                self.params, inputs, cfg=self.cfg, cache=self.cache, schedule=queue,
                block_k=self.block_k, num_splits=self.num_splits,
                compute_dtype=self.compute_dtype, head_shards=self.head_shards,
            )

        return self.graphs.run(key, walk)


class DenseDecodeStep:
    """The decode step of a
    :class:`~repro_torch.runtime.serve_loop.ServingSession`: every slot's
    last token and cache length staged into two tensors, then
    ``model.decode_step`` over them and the dense caches, replayed from one
    CUDA graph on a CUDA device (:class:`StepGraphs`).  A vlm's M-RoPE
    positions are built in the walk from the staged ``cache_len`` tensor
    (``vlm.mrope_positions(offset=)`` reads nothing back to the host)."""

    def __init__(self, model, params, cache: list, batch: int):
        self.model, self.params, self.cache = model, params, cache
        dev = params["embed"]["table"].device
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.cache_len = torch.zeros((batch,), dtype=torch.int32, device=dev)
        # the recurrent and SSM layers' state: a step advances it (a K/V
        # row is rewritten with the same values), so it is restored around
        # the capture's warm-ups
        self.state = [t for c, kind in zip(cache, model.cfg.layer_kinds())
                      if kind in ("recurrent", "ssm") for t in c.values()]
        self.graphs = StepGraphs(dev, self.state)

    def __call__(self, last_token, cache_len) -> torch.Tensor:
        """Stage ``last_token (B,)`` and ``cache_len (B,)`` (host arrays)
        and walk; returns the logits ``(B, 1, vocab)``."""
        self.tokens.copy_(torch.from_numpy(np.asarray(last_token, np.int64)[:, None]))
        self.cache_len.copy_(torch.from_numpy(np.asarray(cache_len, np.int32)))

        def walk():
            logits, _ = self.model.decode_step(self.params, self.cache, self.tokens,
                                               self.cache_len)
            return logits

        return self.graphs.run("decode", walk)
