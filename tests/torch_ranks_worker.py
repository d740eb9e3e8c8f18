"""The rank side of ``test_torch_ranks.py``: cases that run in every rank
of a gloo process group on the CPU, and :func:`run_ranks`, which spawns
the ranks and collects what each case returns.

This module imports no JAX (the ranks are spawned processes that import
it, and the port must run without JAX): the test module computes the JAX
references in its own process and holds the ranks' results against them.
Every case runs on every rank in the same order (the collectives pair up
across ranks) and returns plain numbers, bools and numpy arrays.
"""

from __future__ import annotations

import os
import queue
import time
import traceback

import numpy as np
import torch

JOIN_TIMEOUT = 110.0  # seconds for a whole spawn; a hung collective fails the test


def run_ranks(world: int, cases: list, store_dir: str, timeout: float = JOIN_TIMEOUT) -> dict:
    """Spawn ``world`` ranks that each run ``cases`` (``(name, kwargs)``,
    in order) in a gloo group on a ``FileStore`` under ``store_dir`` (no
    port opened).  Returns ``{name: [rank 0's result, rank 1's, ...]}``;
    raises with the rank's traceback if a case raised, and kills every
    rank and raises if the ranks have not finished within ``timeout``."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    path = os.path.join(store_dir, f"store-{world}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, path, cases, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {name: [None] * world for name, _ in cases}
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world * len(cases)):
            try:
                rank, name, ok, value = out.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(
                    f"{world} ranks did not finish {[n for n, _ in cases]} within {timeout} s; "
                    "killed (a rank may wait in a collective its peer never reached)") from None
            if not ok:
                raise RuntimeError(f"rank {rank}, case {name!r} raised:\n{value}")
            results[name][rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                raise TimeoutError(f"rank {p.name} did not exit within {timeout} s")
            if p.exitcode != 0:
                raise RuntimeError(f"rank {p.name} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return results


def _rank_main(rank, world, path, cases, out):
    os.dup2(2, 1)  # nothing a rank prints reaches the parent's stdout
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    init_process_group("gloo", rank=rank, world_size=world,
                       store=dist.FileStore(path, world), device="cpu")
    try:
        for name, kw in cases:
            try:
                out.put((rank, name, True, CASES[kw.pop("case", name)](**kw)))
            except Exception:  # reported to the parent, which fails the test
                out.put((rank, name, False, traceback.format_exc()))
                return
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _leaf_rel(a, b) -> float:
    """max |a - b| over max |b| of one leaf."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def _max_err(a, b) -> float:
    """max |a - b| over max(1, max |b|): ``test_torch_model.py``'s measure."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _mesh(spec):
    from repro_torch.launch.mesh import rank_mesh

    return rank_mesh(spec, "cpu")


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #
def serve_case(*, arch, params, spec, policy, prompt, tokens, max_len, cfg_changes=None,
               whole=(), placed=True):
    """Prefill ``prompt`` and decode ``tokens`` (teacher-forced, one column
    a step, at per-row lengths) through ``jit_serve_fns`` on a ``spec``
    mesh of ranks, the parameters (unless not ``placed``: the whole
    tensors, which the step uses as they are) and the cache placed as
    ``DTensor``s.
    Held in the rank:

    * ``seqkv``: the logits of every call and this rank's cache shard bit
      for bit against the one-process run under the logical ``1 x M`` mesh
      over this rank's rows (the same K6 slices and merge);
    * other policies: against the one-process run without a mesh, by
      ``test_torch_model.py``'s measure.

    Returns the gathered logits of each call (for the JAX reference),
    those comparisons, the split counts (``mesh_ctx.TP_COUNTS``), what
    the model was handed and what it computed on (:func:`_held_params`;
    the modules in ``whole`` are expected whole), its per-layer
    gathers (:class:`_Gathers`) and, for a MoE model, each MoE call's
    routing and output against one process's (:class:`_MoECalls`).
    ``cfg_changes`` replaces config fields (the parameters must match)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.distributed import COLLECTIVES, axis_index
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import mesh_ctx as ctx_mod
    from repro_torch.runtime import serve_loop, sharding
    from repro_torch.runtime.mesh_ctx import mesh_ctx

    cfg = dataclasses.replace(get_config(arch, smoke=True), **(cfg_changes or {}))
    model = build_model(cfg)
    mesh = _mesh(spec)
    prompt, tokens = torch.as_tensor(prompt), torch.as_tensor(tokens)
    b, p_len = prompt.shape
    cache = model.init_cache(params, b, max_len)
    held = []
    for name in ("prefill", "decode_step"):  # record the tree each call computes on
        setattr(model, name, _recording(getattr(model, name), held))
    compile_prefill, compile_decode, sh = serve_loop.jit_serve_fns(
        model, mesh, model.init(None, "meta"), cache, policy=policy)
    placed_p = sharding.place(params, sh["params"]) if placed else params
    placed_c = sharding.place(cache, sh["cache"])
    got = []
    ctx_mod.TP_COUNTS.clear()
    n_coll = sum(COLLECTIVES.values())
    with mesh_ctx(mesh, policy), _Gathers() as gathers, _MoECalls() as moe_calls:
        logits, ret = compile_prefill(prompt)(placed_p, placed_c, prompt)
        got.append(logits)
        for i in range(tokens.shape[1]):
            tok = tokens[:, i:i + 1]
            lens = np.full((b,), p_len + i, np.int32)  # per row: each rank takes its own
            logits, ret = compile_decode(tok)(placed_p, placed_c, tok, lens)
            got.append(logits)
    counts = dict(ctx_mod.TP_COUNTS, collectives=sum(COLLECTIVES.values()) - n_coll)
    model = build_model(cfg)

    # the one-process run: seqkv over this rank's data rows on the logical
    # 1 x M mesh, otherwise the whole batch without a mesh
    sel, ctx = slice(0, b), mesh_ctx(None)
    if policy == "seqkv":
        rows = sharding.batch_spec_fn(mesh, multi_pod=False, policy=policy)(("tokens",), prompt)
        idx, n = axis_index(sharding.spec_axes(rows[0]), mesh)
        sel = slice(idx * b // n, (idx + 1) * b // n)
        ctx = mesh_ctx(logical_mesh({"data": 1, "model": mesh.shape["model"]}, "cpu"), "seqkv")
    one = model.init_cache(params, sel.stop - sel.start, max_len)
    want = []
    with ctx:
        want.append(model.prefill(params, one, prompt[sel])[0])
        for i in range(tokens.shape[1]):
            want.append(model.decode_step(params, one, tokens[sel, i:i + 1],
                                          np.int32(p_len + i))[0])
    # this rank's cache shard against its slice of the one-process cache
    # (rows outside ``sel`` zero: a seqkv rank's shard holds only its rows)
    one_full = model.init_cache(params, b, max_len)
    for c_full, c_one in zip(one_full, one):
        for k in c_full:
            c_full[k][sel] = c_one[k]
    flat_sh = dict(tree.leaves_with_paths(sh["cache"]))
    flat_one = dict(tree.leaves_with_paths(one_full))
    pairs = [(d.to_local(), sharding.shard_one(flat_one[path], flat_sh[path]))
             for path, d in tree.leaves_with_paths(placed_c)]
    return dict(
        logits=[g.numpy() for g in got],
        logits_equal=all(torch.equal(g[sel], w) for g, w in zip(got, want)),
        logits_err=max(_max_err(g[sel], w) for g, w in zip(got, want)),
        tokens_equal=all(torch.equal(g[sel].argmax(-1), w.argmax(-1)) for g, w in zip(got, want)),
        cache_equal=all(torch.equal(a, w) for a, w in pairs),
        cache_err=max(_max_err(a, w) for a, w in pairs),
        returned_cache=ret is placed_c, counts=counts,
        **_held_params(params, held, sh["params"], mesh, cfg, policy, whole, gathers,
                       handed_whole=not placed),
        **gathers.summary(cfg), **moe_calls.against_one_process(params, cfg))


ENCODER = ("enc_layers/", "enc_norm/")  # what an encoder-decoder's decode step never runs


def encdec_serve_case(*, params, spec, policy, src, prompt, tokens, max_len, cfg_changes=None,
                      whole=()):
    """Smoke seamless-m4t-medium in the reference's serving form on a
    ``spec`` mesh of ranks: the caller's ``init_cache`` over the source
    frames ``src`` (whole, in every rank), then ``jit_serve_fns``'
    decode of the target ``prompt`` at ``cache_len`` 0 and of ``tokens``
    (teacher-forced, one column a step, at per-row lengths), the
    parameters and the cache placed as ``DTensor``s.  Held in the rank
    against the one-process run without a mesh by ``test_torch_model.py``'s
    measure: logits, greedy tokens, this rank's shard of the self cache
    (and of the cross K/V, which the step never writes: bit for bit).
    Returns the gathered logits of each call, those comparisons, the
    gathered self cache, the split
    counts, what the model was handed and computed on
    (:func:`_held_params`; the modules in ``whole`` are expected whole)
    and its per-layer gathers (:class:`_Gathers`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.distributed import COLLECTIVES
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import mesh_ctx as ctx_mod
    from repro_torch.runtime import serve_loop, sharding
    from repro_torch.runtime.mesh_ctx import mesh_ctx

    cfg = dataclasses.replace(get_config("seamless-m4t-medium", smoke=True),
                              **(cfg_changes or {}))
    model = build_model(cfg)
    mesh = _mesh(spec)
    src, prompt, tokens = (torch.as_tensor(x) for x in (src, prompt, tokens))
    b, p_len = prompt.shape
    cache = model.init_cache(params, src, max_len)  # the caller's: the encoder, whole
    held = []
    model.decode_step = _recording(model.decode_step, held)
    _, compile_decode, sh = serve_loop.jit_serve_fns(model, mesh, model.init(None, "meta"),
                                                     cache, policy=policy)
    placed_p = sharding.place(params, sh["params"])
    placed_c = sharding.place(cache, sh["cache"])
    got = []
    ctx_mod.TP_COUNTS.clear()
    n_coll = sum(COLLECTIVES.values())
    with mesh_ctx(mesh, policy), _Gathers() as gathers:
        logits, ret = compile_decode(prompt)(placed_p, placed_c, prompt, np.zeros((b,), np.int32))
        got.append(logits)
        for i in range(tokens.shape[1]):
            tok = tokens[:, i:i + 1]
            logits, ret = compile_decode(tok)(placed_p, placed_c, tok,
                                              np.full((b,), p_len + i, np.int32))
            got.append(logits)
    counts = dict(ctx_mod.TP_COUNTS, collectives=sum(COLLECTIVES.values()) - n_coll)
    model = build_model(cfg)
    one = model.init_cache(params, src, max_len)
    want = [model.decode_step(params, one, prompt, np.zeros((b,), np.int32))[0]]
    for i in range(tokens.shape[1]):
        want.append(model.decode_step(params, one, tokens[:, i:i + 1],
                                      np.full((b,), p_len + i, np.int32))[0])
    flat_sh = dict(tree.leaves_with_paths(sh["cache"]))
    flat_one = dict(tree.leaves_with_paths(one))
    pairs = {path: (d.to_local(), sharding.shard_one(flat_one[path], flat_sh[path]))
             for path, d in tree.leaves_with_paths(placed_c)}
    self_cache = [{k: sharding.full_value(c[k]).numpy() for k in c} for c in placed_c["self"]]
    return dict(
        self_cache=self_cache,
        logits=[g.numpy() for g in got],
        logits_err=max(_max_err(g, w) for g, w in zip(got, want)),
        tokens_equal=all(torch.equal(g.argmax(-1), w.argmax(-1)) for g, w in zip(got, want)),
        cache_err=max(_max_err(a, w) for p, (a, w) in pairs.items() if p[0] == "self"),
        cross_equal=all(torch.equal(a, w) for p, (a, w) in pairs.items() if p[0] == "cross"),
        returned_cache=ret is placed_c, counts=counts,
        **_held_params(params, held, sh["params"], mesh, cfg, policy, whole, gathers,
                       unused=ENCODER),
        **gathers.summary(cfg))


class _MoECalls:
    """Inside the ``with``: every call of ``moe.moe_tokens`` (the MoE MLP
    of a call's whole batch: this rank's working leaves, the gathered
    tokens, the plan) and the routing it computed (``moe.route``), in
    call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self.routes = [], []
        self._orig = orig_tokens, orig_route = moe.moe_tokens, moe.route

        def tokens(params, xf, **kw):
            out = orig_tokens(params, xf, **kw)
            tp = kw.get("tp")
            ep = tp is not None and tp.moe == "ep"
            self.calls.append(dict(shapes={n: tuple(params[n].shape) for n in params},
                                   xf=xf.detach().clone(), out=out[0].detach().clone(),
                                   dtype=kw["dtype"], mode=None if tp is None else tp.moe,
                                   cap=moe.slot_axes(self.routes[-1].capacity, tp) if ep else ()))
            return out

        def route(*a, **kw):
            r = orig_route(*a, **kw)
            self.routes.append(r)
            return r

        moe.moe_tokens, moe.route = tokens, route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_tokens, moe.route = self._orig
        return False

    def against_one_process(self, params, cfg) -> dict:
        """Each call's routing and output against ``moe_tokens`` of the
        same tokens in one process (no mesh, no plan, the whole layer's
        leaves; call ``i`` is MoE layer ``i mod`` their count): the
        routing's every field equal (``routing_equal``), the tokens
        dropped, the output's largest error over its largest
        (``moe_out_err``), the plan's mode, the axes an ``"ep"`` rank split
        the capacity over, and the expert stacks' shapes the rank computed
        on.  Empty without MoE calls."""
        from repro_torch.models import moe
        from repro_torch.runtime.mesh_ctx import mesh_ctx

        if not self.calls:
            return {}
        layers = [l for l, p in enumerate(params["layers"]) if "router" in p.get("mlp", {})]
        equal, errs, drops = True, [], []
        with mesh_ctx(None):
            for i, (call, r) in enumerate(zip(self.calls, self.routes, strict=True)):
                p = params["layers"][layers[i % len(layers)]]["mlp"]
                one = moe.route(p["router"], call["xf"], cfg=cfg, dtype=call["dtype"])
                equal = equal and r.capacity == one.capacity and all(
                    torch.equal(a, b) for a, b in zip(r, one) if isinstance(a, torch.Tensor))
                out = moe.moe_tokens(p, call["xf"], cfg=cfg, dtype=call["dtype"])[0]
                errs.append(_leaf_rel(call["out"], out))
                drops.append(int((~r.keep).sum()))
        return dict(moe_calls=len(self.calls), routing_equal=equal, moe_out_err=max(errs),
                    moe_drops=drops,
                    moe_modes=sorted({c["mode"] for c in self.calls}, key=str),
                    moe_cap_axes=[c["cap"] for c in self.calls],
                    expert_shapes=sorted({tuple(sorted(c["shapes"].items()))
                                          for c in self.calls}))


def _recording(fn, held):
    def call(params, *a, **k):
        held.append(params)
        return fn(params, *a, **k)

    return call


class _Gathers:
    """Inside each ``with``: every call of ``mesh_ctx.working`` in a
    rank-local step (its prefix, the elements and bytes of each leaf it
    returned, the leaves the model computed on, and the bytes of those it
    gathered) and the most bytes of gathered leaves alive at once
    (``core/distributed.GATHERED``, its peak reset at the start), all
    ``with`` blocks together; ``live``, the gathered bytes alive after the
    last."""

    def __init__(self):
        self.calls, self.peak, self.live = [], 0, None

    def __enter__(self):
        from repro_torch.core import distributed, tree
        from repro_torch.runtime import mesh_ctx, sharding

        self._orig = orig = mesh_ctx.working

        def spy(sub, prefix):
            out = orig(sub, prefix)
            if mesh_ctx._CURRENT["gather"] is not None:
                pairs = [(sharding.path_str(tuple(prefix) + p), t, t_in) for (p, t), t_in in zip(
                    tree.leaves_with_paths(out), tree.leaves(sub), strict=True)]
                self.calls.append(("/".join(map(str, prefix)),
                                   {name: (t.numel(), t.nbytes) for name, t, _ in pairs},
                                   {name: t.nbytes for name, t, t_in in pairs if t is not t_in}))
            return out

        mesh_ctx.working = spy
        distributed.reset_gathered_peak()
        return self

    def __exit__(self, *exc):
        import gc

        from repro_torch.core import distributed
        from repro_torch.runtime import mesh_ctx

        mesh_ctx.working = self._orig
        self.peak = max(self.peak, distributed.GATHERED["peak"])
        gc.collect()
        self.live = distributed.GATHERED["live"]
        return False

    def summary(self, cfg) -> dict:
        """The layers' gathers in call order (their indices), the peak of
        gathered bytes alive at once against what the step gathers: its
        largest layer's gathered leaves plus its largest gathered leaf
        outside the layers (a table), at the size they were gathered to;
        and the gathered bytes still alive after."""
        layer = table = 0
        for prefix, _, gathered in self.calls:
            if _is_layer(prefix):
                layer = max(layer, sum(gathered.values()))
            else:
                table = max(table, *gathered.values(), 0)
        experts = sum(b for _, _, gathered in self.calls for name, b in gathered.items()
                      if _is_expert(name))
        return dict(layer_gathers=[int(k.split("/")[1]) for k, _, _ in self.calls
                                   if _is_layer(k)],
                    gathered_peak=self.peak, gather_bound=layer + table,
                    gathered_live=self.live, n_layers=cfg.n_layers, expert_gathered=experts)


def _is_layer(prefix) -> bool:
    """A layer's prefix: ``layers/<l>`` (decoder-only), ``enc_layers/<i>``
    or ``dec_layers/<l>`` (encoder-decoder)."""
    return prefix.split("/")[0] in ("layers", "enc_layers", "dec_layers") and "/" in prefix


def _is_expert(name) -> bool:
    """A MoE layer's expert stack: ``layers/<l>/mlp/gate|up|down`` (a
    dense MLP's leaves end in ``/w``)."""
    parts = name.split("/")
    return len(parts) == 4 and parts[2] == "mlp" and parts[3] in ("gate", "up", "down")


def _held_params(params, held, shardings, mesh, cfg, policy, whole, gathers,
                 handed_whole=False, unused=()) -> dict:
    """What each call was handed and what it computed on, against the
    whole parameters.  Handed: every leaf this rank's shard under its
    spec (no parameter tree is made whole at the call); with
    ``handed_whole`` (the caller's whole tensors) every leaf as it
    computes on it, each whole or, where a split keeps it local, its
    ``model`` slice.  Computed on (the
    leaves ``mesh_ctx.working`` returned, :class:`_Gathers`): every leaf
    of the model, the leaves a split keeps local (the spec names
    ``model``; an attention layer, a dense MLP, a MoE layer's expert
    stacks or an embedding table) ``1 / m`` of their whole elements and
    every other leaf whole; every leaf computed on but those under the
    prefixes ``unused`` (an encoder-decoder's decode step runs no
    encoder).  Returns
    that check, the count of local leaves and the largest share of the
    whole model's bytes one call of ``working`` computed on."""
    from repro_torch.core import tree
    from repro_torch.runtime import sharding

    m = mesh.shape["model"] if policy in ("tp", "tp_fsdp") else 1
    flat_sh = {sharding.path_str(p): sh for p, sh in tree.leaves_with_paths(shardings)}
    specs = {name: sh.spec for name, sh in flat_sh.items()}
    full = {sharding.path_str(p): t for p, t in tree.leaves_with_paths(params)}

    modules = {"attn": "attn", "self_attn": "attn", "cross_attn": "cross", "mlp": "mlp",
               "ssm": "ssm", "rec": "rec"}

    def local(name):
        parts = name.split("/")
        module = modules.get(parts[2]) if _is_layer(name) else None
        split_module = parts[0] in ("embed", "unembed") or (
            module is not None and module not in whole
            and (module != "mlp" or not cfg.n_experts or _is_expert(name)))
        return (m > 1 and split_module
                and "model" in {a for e in specs[name] for a in sharding.spec_axes(e)})

    ok = bool(held) and bool(gathers.calls)
    for tree_ in held:
        got = {sharding.path_str(p): t for p, t in tree.leaves_with_paths(tree_)}
        ok = ok and got.keys() == full.keys() and all(
            t.numel() == (full[n].numel() // (m if local(n) else 1) if handed_whole
                          else sharding.shard_one(full[n], flat_sh[n]).numel())
            for n, t in got.items())
    seen = set()
    for _, leaves, _ in gathers.calls:
        for name, (numel, _) in leaves.items():
            seen.add(name)
            ok = ok and numel == full[name].numel() // (m if local(name) else 1)
    share = max(sum(b for _, b in leaves.values()) for _, leaves, _ in gathers.calls) / sum(
        t.nbytes for t in full.values())
    used = {n for n in full if not n.startswith(tuple(unused))}
    return dict(held_ok=ok and seen == used, local_leaves=sum(map(local, full)),
                held_share=share)


def count_case(*, arch, params, spec, policy, max_len):
    """One ``tp`` decode step on a ``spec`` mesh of ranks (a batch of 2,
    every cache row below ``max_len - 1`` live; an encoder-decoder's cross
    K/V over 8 frames) counted by ``OpCounter``
    in this rank, and the dry run's count of the same step: the model at
    ``launch/dryrun.local_config``'s widths on meta stand-ins, its Mamba-2
    and RG-LRU blocks on the card's share (``dryrun.card_share``).
    Returns both counts' flops, bytes, products' flops, ops and
    collectives."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import card_context, card_leaves, card_share, local_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.runtime import serve_loop, sharding
    from repro_torch.runtime.mesh_ctx import mesh_ctx

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    mesh = _mesh(spec)
    b, pos = 2, max_len - 1
    encdec = cfg.family == "encdec"
    # an encoder-decoder's cache: the caller's init_cache over 8 frames
    src = torch.randn((b, 8, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.02
    cache = model.init_cache(params, src if encdec else b, max_len)
    tok = torch.full((b, 1), 7, dtype=torch.int64)
    _, compile_decode, sh = serve_loop.jit_serve_fns(model, mesh, model.init(None, "meta"), cache,
                                                     policy=policy)
    placed = sharding.place((params, cache), (sh["params"], sh["cache"]))
    decode = compile_decode(tok)
    with mesh_ctx(mesh, policy), OpCounter() as ranks:
        decode(*placed, tok, np.full((b,), pos, np.int32))
    lmodel = build_model(local_config(cfg, mesh.shape["model"]))
    card = card_share(cfg, model.init(None, "meta"), mesh, policy)
    lparams = card_leaves(lmodel.init(None, "meta", dtype=torch.float32), card)
    lcache = card_leaves(lmodel.init_cache(lparams, src.to("meta") if encdec else b, max_len),
                         card, state=True)
    with card_context(card), OpCounter() as dry:
        lmodel.decode_step(lparams, lcache, tok.to("meta"), pos)
    return {k: dict(flops=c.cost.flops, bytes=c.cost.bytes, products=c.products.flops,
                    ops=c.n_ops, coll=dict(c.cost.coll), coll_counts=dict(c.cost.coll_counts))
            for k, c in (("ranks", ranks), ("dry", dry))}


def moe_dispatch_case(*, params, spec, prompt, tokens, max_len):
    """Smoke qwen3-moe on a ``spec`` mesh of ranks (tp_fsdp): every expert
    product's dispatched tokens (``expert_products``' first argument) in
    the rank run against the one-rank run's: the same capacity, the same
    slots filled, the values within 1e-5 of the largest; and the logits
    against the one-rank run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve_loop, sharding
    from repro_torch.runtime.mesh_ctx import mesh_ctx

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    model = build_model(cfg)
    mesh = _mesh(spec)
    prompt, tokens = torch.as_tensor(prompt), torch.as_tensor(tokens)
    b, p_len = prompt.shape
    seen = {"ranks": [], "one": []}
    orig = moe.expert_products
    where = ["ranks"]

    def spy(a, w):
        if a.shape[1] and w.shape[-1] == cfg.d_ff_expert:  # the gate product: the dispatch
            seen[where[0]].append(a.detach().clone())
        return orig(a, w)

    moe.expert_products = spy
    try:
        cache = model.init_cache(params, b, max_len)
        compile_prefill, compile_decode, sh = serve_loop.jit_serve_fns(
            model, mesh, model.init(None, "meta"), cache, policy="tp_fsdp")
        got = []
        with mesh_ctx(mesh, "tp_fsdp"):
            got.append(compile_prefill(prompt)(params, cache, prompt)[0])
            tok = tokens[:, :1]
            got.append(compile_decode(tok)(params, cache, tok, np.int32(p_len))[0])
        where[0] = "one"
        one = model.init_cache(params, b, max_len)
        want = [model.prefill(params, one, prompt)[0],
                model.decode_step(params, one, tokens[:, :1], np.int32(p_len))[0]]
    finally:
        moe.expert_products = orig
    pairs = list(zip(seen["ranks"], seen["one"], strict=True))
    return dict(
        calls=len(pairs),
        same_capacity=all(a.shape == c.shape for a, c in pairs),
        same_slots=all(torch.equal(a.abs().sum(-1) > 0, c.abs().sum(-1) > 0) for a, c in pairs),
        dispatch_err=max(_leaf_rel(a, c) for a, c in pairs),
        logits=[g.numpy() for g in got],
        logits_err=max(_max_err(g, w) for g, w in zip(got, want)))


def train_case(*, params, batches, spec, policy, compression, grad_accum, remat=False,
               arch="qwen1.5-0.5b", cfg_changes=None, whole=(), f32_products=False):
    """Two steps of the smoke ``arch`` through ``jit_train_step`` on a
    ``spec`` mesh of ranks against ``make_train_step``'s on one rank, from
    the same state and batches.  Returns the first step's loss and
    ``grad_norm`` relative errors, the first moment's (0.1 x the clipped
    gradient) worst leaf error, the parameters' errors by
    ``test_torch_train_loop.py``'s rule (where the one-rank gradient
    exceeds 2^-8 of its leaf's largest, and everywhere against 2 lr),
    the second step's metrics (against one rank's second step, and
    against one rank's step from the rank's own state), whether every
    returned shard is its
    rank's slice of the gathered value, the split counts
    (``mesh_ctx.TP_COUNTS``), what the loss was handed and computed on
    (:func:`_held_params`; the modules in ``whole`` are expected whole)
    and its per-layer gathers (:class:`_Gathers`, the rank steps only).
    ``cfg_changes`` replaces config fields (the parameters must match).
    ``f32_products``: the blockwise attention (the backward of every
    attention call) multiplies fp32 inputs, not bf16-rounded ones, in
    both runs."""
    if f32_products:
        from repro_torch.core import amla, flash

        saved = flash.matmul, amla.matmul
        flash.matmul = amla.matmul = lambda a, b, matmul_dtype: torch.matmul(a.float(), b.float())
        try:
            return train_case(params=params, batches=batches, spec=spec, policy=policy,
                              compression=compression, grad_accum=grad_accum, remat=remat,
                              arch=arch, cfg_changes=cfg_changes, whole=whole)
        finally:
            flash.matmul, amla.matmul = saved
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.compression import compression_init
    from repro_torch.runtime import mesh_ctx, sharding, train_loop

    cfg = dataclasses.replace(get_config(arch, smoke=True), **(cfg_changes or {}))
    model = build_model(cfg)
    held = []
    model.loss = _recording(model.loss, held)
    mesh = _mesh(spec)
    tc = train_loop.TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=20, remat=remat,
                                compression=compression, grad_accum=grad_accum)
    compile_for, sh = train_loop.jit_train_step(
        model, tc, mesh, model.init(None, "meta", dtype=torch.float32), policy=policy)
    state = (params, adamw_init(params), compression_init(params, compression))
    one = (params, adamw_init(params), compression_init(params, compression))
    ref = train_loop.make_train_step(build_model(cfg), tc)
    mesh_ctx.TP_COUNTS.clear()
    out = {}
    gathers = _Gathers()
    for i, batch in enumerate(batches):
        before = tree.tree_map(sharding.full_value, tuple(state))  # the rank state, gathered
        with gathers:
            *state, m = compile_for(batch)(*state, batch, 3 + i)
        *one, m_one = ref(*one, batch, 3 + i)
        out[f"metrics{i}"] = {k: (float(m[k]), float(m_one[k]))
                              for k in ("loss", "grad_norm", "lr")}
        if i:  # one rank's step from the same state
            m_held = ref(*before, batch, 3 + i)[-1]
            out[f"held{i}"] = {k: (float(m[k]), float(m_held[k])) for k in ("loss", "grad_norm")}
        if i == 0:
            gathered = [sharding.full_value(x) for x in tree.leaves(state[:3])]
            out["shards_are_slices"] = _shards_are_slices(state[:3], sh, gathered)
            mu = [sharding.full_value(x) for x in tree.leaves(state[1].mu)]
            out["mu_err"] = max(_leaf_rel(a, b) for a, b in zip(mu, tree.leaves(one[1].mu)))
            out["mu_norm_err"] = _rel(torch.cat([a.reshape(-1) for a in mu]), torch.cat(
                [b.reshape(-1) for b in tree.leaves(one[1].mu)]))
            lr = float(m_one["lr"])
            resolved_err, step_err = 0.0, 0.0
            for a, b, g in zip(tree.leaves(state[0]), tree.leaves(one[0]),
                               tree.leaves(one[1].mu), strict=True):
                d = (sharding.full_value(a) - b).abs()
                resolved = g.abs() > 2.0**-8 * g.abs().max()
                if resolved.any():
                    resolved_err = max(resolved_err, float(d[resolved].max() / b.abs().max()))
                step_err = max(step_err, float(d.max()) / (2 * lr))
            out.update(param_resolved_err=resolved_err, param_step_err=step_err)
            if compression != "none":
                out.update(_int8_flips(cfg, params, state, one, m, m_one, tc.clip_norm))
    out["is_dtensor"] = all(hasattr(x, "to_local") for x in tree.leaves(state[:3]))
    out["counts"] = dict(mesh_ctx.TP_COUNTS)
    out.update(_held_params(params, held, sh["params"], mesh, cfg, policy, whole, gathers))
    out.update(gathers.summary(cfg))
    return out


def _int8_flips(cfg, params, state, one, m, m_one, clip) -> dict:
    """Int8 compression of gradients a rounding apart: the error-feedback
    input ``e = residual + compressed`` (the all-reduced gradient; after
    the first step ``compressed = mu / (0.1 x clip scale)``) of the ranks
    against one rank's, and the first moments' differences in units of
    the int8 step of each element's reference leaf (``max |e| / 127``
    over the stacked leaf): a stochastic rounding that lands the other
    way moves one element by one step."""
    from repro_torch.core import tree
    from repro_torch.optim.adamw import reference_leaves
    from repro_torch.runtime import sharding

    def e_of(st, metrics):
        scale = min(1.0, clip / float(metrics["grad_norm"]))
        mu = {p: sharding.full_value(x) for p, x in tree.leaves_with_paths(st[1].mu)}
        res = {p: sharding.full_value(x) for p, x in tree.leaves_with_paths(st[2].residual)}
        return mu, {p: res[p] + mu[p] / (0.1 * scale) for p in mu}, scale

    mu_r, e_r, _ = e_of(state, m)
    mu_o, e_o, scale = e_of(one, m_one)
    flat = lambda d: torch.cat([d[p].reshape(-1) for p in sorted(d, key=str)])
    steps, flips, total = 0.0, 0, 0
    for ref in reference_leaves(params, cfg):
        step = max(float(e_o[p].abs().max()) for p in ref.paths) / 127 * 0.1 * scale
        for p in ref.paths:
            d = (mu_r[p] - mu_o[p]).abs()
            steps = max(steps, float(d.max()) / step)
            flips += int((d > 1e-3 * step).sum())
            total += d.numel()
    return dict(e_err=_rel(flat(e_r), flat(e_o)), flip_steps=steps, flip_share=flips / total)


def _shards_are_slices(state, sh, gathered) -> bool:
    """Every leaf's local shard equal to its spec slice of the gathered
    value (the parameters', the moments' and the residuals' shardings)."""
    from repro_torch.core import tree
    from repro_torch.runtime import sharding

    specs = [sh["params"], sh["opt"], sh["comp"]]
    flat = []
    for s, t in zip(specs, state):
        if t is not None:
            flat += [x for _, x in tree.leaves_with_paths(s)]
    return all(torch.equal(x.to_local(), sharding.shard_one(g, s))
               for x, g, s in zip(tree.leaves(state), gathered, flat, strict=True))


def reshard_case(*, params, old, new):
    """The initial train state placed on the ``old`` mesh of ranks,
    resharded onto ``new``: every leaf's gathered value bit-equal to the
    original, and each rank's shard the new spec's slice."""
    from repro_torch.core import tree
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import elastic, sharding

    mesh_a, mesh_b = _mesh(old), _mesh(new)
    opt = adamw_init(params)
    opt = opt._replace(mu=tree.tree_map(lambda p: p * 0.5 + 1.0, params))
    pfn = sharding.param_spec_fn(mesh_a, multi_pod=False)
    placed = sharding.place((params, opt.mu), sharding.make_shardings(mesh_a, (params, opt.mu),
                                                                        pfn))
    p2, o2 = elastic.reshard_train_state(placed[0], opt._replace(mu=placed[1]), mesh_a, mesh_b)
    pfn_b = sharding.param_spec_fn(mesh_b, multi_pod=False)
    equal = all(torch.equal(sharding.full_value(b), a)
                for a, b in zip(tree.leaves((params, opt)), tree.leaves((p2, o2)), strict=True))
    slices = all(
        torch.equal(b.to_local(), sharding.shard_one(
            a, sharding.NamedSharding(mesh_b, pfn_b(path, a))))
        for (path, a), b in zip(tree.leaves_with_paths(params), tree.leaves(p2), strict=True))
    moved = sum(int(b.to_local().numel() < a.numel())
                for a, b in zip(tree.leaves(params), tree.leaves(p2)))
    return dict(equal=equal, slices=slices, sharded_leaves=moved,
                mesh=tuple(p2["embed"]["table"].device_mesh.shape))


def launch_train_case(*, steps=2, batch=4, seq=32):
    """``launch/train`` under the group: each rank's data is its shard
    (``num_shards=world``, ``shard_id=rank``); the losses against
    ``make_train_step`` on one rank over the concatenated shards."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.train_loop import TrainConfig, init_train_state, make_train_step

    world, rank = dist.get_world_size(), dist.get_rank()
    seen = []
    orig = SyntheticLMData.__init__

    def spy(self, **kw):
        orig(self, **kw)
        seen.append((kw.get("num_shards"), kw.get("shard_id")))

    SyntheticLMData.__init__ = spy
    try:
        history = train.main(["--device", "cpu", "--smoke", "--steps", str(steps), "--batch",
                              str(batch), "--seq", str(seq), "--log-every", "100"])
    finally:
        SyntheticLMData.__init__ = orig
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    model = build_model(cfg)
    shards = [SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                              seed=0, num_shards=world, shard_id=r) for r in range(world)]
    tc = TrainConfig(peak_lr=3e-3, warmup_steps=max(steps // 20, 1), total_steps=steps,
                     remat=False)
    state = init_train_state(model, torch.Generator("cpu").manual_seed(0), "cpu")
    step = make_train_step(model, tc)
    want = []
    for s in range(steps):
        glob = {k: np.concatenate([d.batch_at(s)[k] for d in shards]) for k in ("tokens", "labels")}
        *state, m = step(*state, glob, s)
        want.append(float(m["loss"]))
    return dict(data_split=seen, losses=[float(m["loss"]) for _, m in history], want=want,
                rank=rank, own=shards[rank].batch_at(0)["tokens"])


def _train_setup(spec, policy, compression, params):
    """Smoke qwen1.5-0.5b's sharded step on the ``spec`` mesh of ranks, its
    shardings and its whole initial state ``{"params", "opt", "comp"}``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.compression import compression_init
    from repro_torch.runtime import train_loop

    model = build_model(get_config("qwen1.5-0.5b", smoke=True))
    tc = train_loop.TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=20, remat=False,
                                compression=compression)
    compile_for, sh = train_loop.jit_train_step(
        model, tc, _mesh(spec), model.init(None, "meta", dtype=torch.float32), policy=policy)
    whole = {"params": params, "opt": adamw_init(params),
             "comp": compression_init(params, compression)}
    return compile_for, sh, whole


def _equal(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _same_shards(a, b) -> bool:
    """Two trees' leaves bit-equal: each ``DTensor`` in its local shard,
    placements, global shape and mesh, each plain tensor whole."""
    from repro_torch.core import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if hasattr(x, "to_local") != hasattr(y, "to_local") or x.shape != y.shape:
            return False
        if hasattr(x, "to_local"):
            if (x.placements != y.placements or x.device_mesh is not y.device_mesh
                    or x.to_local().dtype != y.to_local().dtype
                    or not torch.equal(x.to_local(), y.to_local())):
                return False
        elif x.dtype != y.dtype or not torch.equal(x, y):
            return False
    return True


def ckpt_case(*, params, batches, spec, policy, compression, directory):
    """A checkpoint of the train state after one sharded step on the
    ``spec`` mesh of ranks (``async_save``, every rank its own shards), and
    the second step from what a fresh manager restores against the second
    step from the state in memory.  Returns whether the restored trees
    (from a ``DTensor`` like-tree and from the whole initial state) equal
    the saved one shard by shard and in their placements and meshes,
    whether the resumed step's metrics, parameters, moments and residuals
    are bit-equal to the uninterrupted step's, the step directory's files,
    this rank's saved local shards (numpy, in flattening order) and the
    directory."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import tree

    compile_for, _, whole = _train_setup(spec, policy, compression, params)
    step = compile_for(batches[0])
    p, o, c, _ = step(whole["params"], whole["opt"], whole["comp"], batches[0], 3)
    # a plain tensor too: each rank writes it whole and gets it back so
    saved = {"params": p, "opt": o, "comp": c, "step": torch.tensor(1, dtype=torch.int32)}
    whole["step"] = torch.tensor(0, dtype=torch.int32)
    *want, m_want = step(p, o, c, batches[1], 4)
    mgr = CheckpointManager(directory, async_save=True)
    mgr.save(1, saved)
    mgr.wait()
    from_dtensors = CheckpointManager(directory).restore_latest(saved)
    step_no, got = CheckpointManager(directory).restore_latest(whole)
    *resumed, m = step(got["params"], got["opt"], got["comp"], batches[1], 4)
    return dict(
        step=step_no, saved_by_dtensors=_same_shards(from_dtensors[1], saved),
        saved_by_whole=_same_shards(got, saved),
        metrics_equal=all(_equal(m[k], m_want[k]) for k in ("loss", "grad_norm", "lr")),
        resumed_equal=_same_shards(tuple(resumed), tuple(want)),
        files=sorted(os.listdir(os.path.join(directory, "step_00000001"))),
        local=[getattr(x, "to_local", lambda: x)().numpy() for x in tree.leaves(saved)],
        directory=directory)


def ckpt_faults_case(*, params, batches, directory, other):
    """On 2 x 1 ``fsdp``: steps 1, 2, 3 and 4 saved by a manager with
    ``keep=2`` where rank 1 cannot write step 3 (its writer raises before
    its shard is on disk).  Returns what each rank's ``wait()`` raised at
    step 3, the committed steps each rank sees after step 3 and after
    step 4, the step ``restore_latest`` gives after step 3, and what
    restoring the 2 x 1 checkpoint onto the ``other`` mesh (a ``DTensor``
    like-tree placed there) raises."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import tree
    from repro_torch.runtime import sharding

    compile_for, _, whole = _train_setup("2x1", "fsdp", "none", params)
    p, o, c, _ = compile_for(batches[0])(whole["params"], whole["opt"], None, batches[0], 3)
    state = {"params": p, "opt": o, "comp": c}
    rank = dist.get_rank()

    class Failing(CheckpointManager):
        def _write(self, step, host, process_index, meta):
            if step == 3 and rank == 1:
                raise OSError("rank 1 cannot write step 3")
            return super()._write(step, host, process_index, meta)

    mgr = Failing(directory, keep=2, async_save=True)
    mgr.commit_timeout = 2.0  # rank 0 stops waiting for rank 1's shard
    out = {}
    for s in (1, 2, 3):
        mgr.save(s, state)
        try:
            mgr.wait()
        except Exception as e:
            out["raised"] = type(e).__name__
    out["after3"] = mgr.committed_steps()
    out["latest"], _ = mgr.restore_latest(whole)
    mgr.save(4, state)
    mgr.wait()
    out["after4"] = mgr.committed_steps()
    _, sh, _ = _train_setup(other, "fsdp", "none", params)
    placed = sharding.place((whole["params"], whole["opt"]), (sh["params"], sh["opt"]))
    try:
        mgr.restore(4, {"params": placed[0], "opt": placed[1], "comp": None})
        out["other_mesh"] = None
    except ValueError as e:
        out["other_mesh"] = str(e)
    out["stale"] = sorted(n for n in os.listdir(directory) if n.endswith(".tmp"))
    out["leaves"] = len(tree.leaves(state))
    return out


def supervisor_case(*, params, batches, directory, steps=6, fail_at=3, every=2):
    """``TrainingSupervisor`` over the sharded step on 2 x 1 ``fsdp`` with
    ``ckpt_every=every`` and a failure on every rank the first time step
    ``fail_at`` comes (a job-wide failure), against ``steps`` uninterrupted
    steps from the same state: the history's steps, whether its metrics
    and the final state are bit-equal, and the restarts."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.runtime.fault_tolerance import TrainingSupervisor

    compile_for, _, whole = _train_setup("2x1", "fsdp", "none", params)
    step = compile_for(batches[0])

    class Data:
        def batch_at(self, s):
            return batches[s % len(batches)]

    def step_fn(state, batch, s):
        p, o, c, m = step(state["params"], state["opt"], state["comp"], batch, s)
        return {"params": p, "opt": o, "comp": c}, m

    want, state = [], whole
    for s in range(steps):
        state, m = step_fn(state, Data().batch_at(s), s)
        want.append(m)
    failed = []

    def hook(s):
        if s == fail_at and not failed:
            failed.append(s)
            raise RuntimeError(f"injected failure at step {s}")

    sup = TrainingSupervisor(ckpt_manager=CheckpointManager(directory, async_save=True),
                             data=Data(), ckpt_every=every, failure_hook=hook)
    got, last, history = sup.run(step_fn, whole, start_step=0, num_steps=steps)
    return dict(steps=[s for s, _ in history], last=last, restarts=sup.restarts,
                metrics_equal=all(_equal(m[k], w[k]) for (_, m), w in zip(history, want)
                                  for k in ("loss", "grad_norm", "lr")),
                state_equal=_same_shards(got, state))


def launch_ckpt_case(*, directory, steps=4, every=2, more=2):
    """``launch/train --ckpt-dir DIR --ckpt-every every`` under the group,
    ``steps`` steps, then again with ``--steps more``: the second run's
    steps and what each run printed (a rank other than 0 prints
    nothing), the committed steps and each one's files."""
    import contextlib
    import io

    from repro_torch.launch import train

    argv = ["--device", "cpu", "--smoke", "--batch", "4", "--seq", "32", "--log-every", "100",
            "--ckpt-dir", directory, "--ckpt-every", str(every)]
    runs, printed = [], []
    for n in (steps, more):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runs.append([s for s, _ in train.main(argv + ["--steps", str(n)])])
        printed.append(buf.getvalue())
    committed = sorted(n for n in os.listdir(directory) if n.startswith("step_"))
    return dict(runs=runs, printed=printed,
                files={n: sorted(os.listdir(os.path.join(directory, n))) for n in committed})


SPECS = [("data", "model"), (("data", "model"), None), (None, None), ("model", None),
         ("model", None, None), (None, "data", "model"), ("data", None, "model", None)]


def round_trip_case(*, spec):
    """``gather_tree`` / ``shard_tree`` / ``full_value`` on the ``spec``
    mesh of ranks for every spec shape: exact round trips."""
    from repro_torch.runtime import sharding

    mesh = _mesh(spec)
    gen = torch.Generator().manual_seed(7)
    ok = {}
    for s in SPECS:
        shape = (8, 12, 4, 6)[:len(s)]
        t = torch.randn(shape, generator=gen)
        sh = sharding.NamedSharding(mesh, sharding.P(*s))
        d = sharding.place_one(t, sh)
        local = d.to_local()
        tree_sh = {"a": sh}
        ok[repr(s)] = (
            torch.equal(sharding.shard_one(t, sh), local)
            and torch.equal(sharding.gather_tree({"a": local}, tree_sh)["a"], t)
            and torch.equal(sharding.shard_tree({"a": t}, tree_sh)["a"], local)
            and torch.equal(sharding.full_value(d), t)
            and torch.equal(sharding.whole_tree({"a": d}, tree_sh)["a"], t)
            and sharding.whole_tree({"a": t}, tree_sh)["a"] is t
            and torch.equal(sharding.shard_one(
                sharding.gather_one(local, sh, keep=("data",)), sh, keep=("data",)), local))
    return dict(round_trips=ok, adjoint=_gather_rows_adjoint(mesh),
                model_adjoints=_model_adjoints(mesh), vocab_loss=_vocab_parallel_loss(mesh),
                leaf_adjoints=_gather_leaf_adjoints(mesh),
                slots_adjoint=_gather_slots_adjoint(mesh))


def _gather_slots_adjoint(mesh) -> dict:
    """``moe.gather_slots`` (an ``"ep"`` rank's expert outputs gathered
    back to ``(E, C, d)``) with the capacity split over ``data`` or not:
    the gathered value is the whole, and, each rank's loss weighing it by
    integer weights that depend on its ``data`` coordinate only (its
    rows: the ranks along ``model`` hold the same rows and the same
    cotangent), the gradient of this rank's piece is its slice of the sum
    of the weights over the ``data`` ranks where the capacity is split
    (each rank's cotangent its own rows' terms), of its own weights where
    it is not (the data ranks hold the same piece; the sum over them comes
    after, as for any replicated input), exactly.  Returns ``{"cap": bool,
    "whole": bool}``."""
    from repro_torch.core.distributed import axis_index
    from repro_torch.models.moe import gather_slots
    from repro_torch.runtime.sharding import TPPlan

    idx, m = axis_index(("model",), mesh)
    row, n = axis_index(("data",), mesh)
    ints = lambda seed, shape: torch.randint(-4, 5, shape, generator=torch.Generator()
                                             .manual_seed(seed)).float()
    plan = TPPlan(mesh=mesh, m=m, idx=idx, kinds=(), n_heads=1, n_kv_heads=1, mla=False,
                  attn=False, mlp=False, vocab=False, kv_local=False, moe="ep")
    e, c, d = 4 * m, 3 * n, 5
    whole = ints(1, (e, c, d))
    experts = slice(idx * e // m, (idx + 1) * e // m)
    out = {}
    for name, cap in (("cap", ("data",)), ("whole", ())):
        cols = slice(row * c // n, (row + 1) * c // n) if cap else slice(0, c)
        x = whole[experts, cols].clone().requires_grad_()
        y = gather_slots(x, cap, plan)
        (y * ints(100 + row, (e, c, d))).sum().backward()
        weights = sum(ints(100 + j, (e, c, d)) for j in range(n)) if cap else ints(100 + row,
                                                                                   (e, c, d))
        out[name] = torch.equal(y.detach(), whole) and torch.equal(x.grad,
                                                                   weights[experts, cols])
    return out


def _gather_leaf_adjoints(mesh) -> dict:
    """``ParamGather``'s gather of one leaf (``core/distributed.gather_leaf``)
    for every spec shape of ``SPECS``, with the batch rows over ``data``
    (``tp_fsdp``) or over ``data`` and ``model`` (``fsdp``), and with a
    plan keeping ``model`` or not: the gathered value is the whole leaf
    (its ``model`` shard where kept), and, each rank's loss weighing it by
    integer weights that depend on the rank's rows coordinates only (the
    ranks along any other axis compute the same), the gradient of this
    rank's shard is its slice of the sum of those weights over the ranks
    the adjoint sums over, exactly.  Returns ``{"rows | keep | spec":
    bool}``."""
    import itertools
    import types

    import torch.distributed as dist

    from repro_torch.runtime import sharding

    names = mesh.axis_names
    sizes = tuple(mesh.shape[a] for a in names)
    me = tuple(int(c) for c in np.unravel_index(dist.get_rank(), sizes))
    ints = lambda seed, shape: torch.randint(-4, 5, shape, generator=torch.Generator()
                                             .manual_seed(seed)).float()
    ok = {}
    for rows in (("data",), ("data", "model")):
        for keep in (False, True):
            plan = types.SimpleNamespace(keeps=lambda name, spec, keep=keep: keep)
            for s in SPECS:
                shape = (8, 12, 4, 6)[:len(s)]
                sh = sharding.NamedSharding(mesh, sharding.P(*s))
                kept = ("model",) if keep else ()
                t = ints(5, shape)
                g = sharding.param_gather({"a": sh}, plan, rows)

                def w(c):  # the weights of the rank at coordinates c: by its rows coordinates
                    return ints(100 + sum(c[names.index(a)] * 7**j for j, a in enumerate(rows)),
                                shape)

                # what the gather gives: whole but along the dims it keeps
                part = sharding.NamedSharding(mesh, sharding.P(*[
                    e if e is not None and set(sharding.spec_axes(e)) <= set(kept) else None
                    for e in s]))
                x = sharding.shard_one(t, sh).clone().requires_grad_()
                y = g.leaf(("a",), x)
                (y * sharding.shard_one(w(me), part)).sum().backward()
                summed = g.leaves[("a",)][1]
                group = [c for c in itertools.product(*map(range, sizes))
                         if all(c[i] == me[i] for i, a in enumerate(names) if a not in summed)]
                want = sharding.shard_one(sum(w(c) for c in group), sh)
                ok[f"{rows} | {keep} | {s}"] = (torch.equal(y.detach(),
                                                            sharding.shard_one(t, part))
                                               and torch.equal(x.grad, want))
    return ok


def _gather_rows_adjoint(mesh) -> bool:
    """Rank r weighs the gathered rows of ``gather_rows`` over ``data`` by
    ``(r + 1) x (row index + 1)``; the gradient of its own rows must be
    the sum of every rank's weights there (integers: exact)."""
    import torch.distributed as dist

    from repro_torch.core.distributed import axis_index, gather_rows

    rank, world = dist.get_rank(), dist.get_world_size()
    idx, n = axis_index(("data",), mesh)
    x = torch.full((3, 2), float(rank), requires_grad=True)
    y = gather_rows(x, ("data",), mesh=mesh)
    rows = torch.arange(y.shape[0], dtype=torch.float32)[:, None] + 1
    (y * rows * (rank + 1)).sum().backward()
    # the ranks sharing this rank's data group: same model coordinate
    peers = [r for r in range(world) if r % (world // n) == rank % (world // n)]
    want = rows[idx * 3:(idx + 1) * 3] * sum(r + 1 for r in peers)
    return y.shape[0] == 3 * n and torch.equal(x.grad, want.expand(3, 2))


def _model_adjoints(mesh) -> dict:
    """``copy_to_model``, ``gather_from_model`` and ``reduce_from_model``
    on every rank against autograd of the same function in one process,
    on integer values (exact).  Every rank builds every rank's inputs (rank
    ``j`` of ``model`` draws from seed ``j``); the cotangents are weights
    of the rank (``copy``: each rank's own, as a product over its columns
    gives it) or the same on every rank (``gather`` / ``reduce``: of a
    replicated output).  Returns, per function, whether the gradient of
    this rank's input equals the one-process gradient's part of it."""
    from repro_torch.core.distributed import (
        axis_index, copy_to_model, gather_from_model, reduce_from_model)

    idx, m = axis_index(("model",), mesh)
    ints = lambda seed, shape: torch.randint(-4, 5, shape, generator=torch.Generator()
                                             .manual_seed(seed)).float()
    shared, weights = ints(100, (3, 4)), [ints(200 + j, (3, 4)) for j in range(m)]
    pieces = [ints(j, (3, 4)) for j in range(m)]
    out = {}

    # copy: y = x on every rank, rank j's loss sum(w_j * y); one process
    # sums every rank's loss
    x = shared.clone().requires_grad_()
    (copy_to_model(x, mesh=mesh) * weights[idx]).sum().backward()
    x1 = shared.clone().requires_grad_()
    sum((x1 * w).sum() for w in weights).backward()
    out["copy"] = torch.equal(x.grad, x1.grad)

    # gather: y = cat(x_0 .. x_{m-1}) on every rank, the loss sum(W * y)
    wide = ints(300, (3, 4 * m))
    x = pieces[idx].clone().requires_grad_()
    y = gather_from_model(x, -1, mesh=mesh)
    (y * wide).sum().backward()
    xs = [p.clone().requires_grad_() for p in pieces]
    (torch.cat(xs, -1) * wide).sum().backward()
    out["gather"] = torch.equal(y.detach(), torch.cat(pieces, -1)) and torch.equal(
        x.grad, xs[idx].grad)

    # reduce: y = x_0 + ... + x_{m-1} on every rank, the loss sum(W * y)
    x = pieces[idx].clone().requires_grad_()
    y = reduce_from_model(x, mesh=mesh)
    (y * shared).sum().backward()
    xs = [p.clone().requires_grad_() for p in pieces]
    (sum(xs) * shared).sum().backward()
    out["reduce"] = torch.equal(y.detach(), sum(pieces)) and torch.equal(x.grad, xs[idx].grad)
    return out


def _vocab_parallel_loss(mesh) -> dict:
    """``chunked_cross_entropy`` under a plan splitting the vocabulary
    over ``model`` (this rank's table rows) against the whole-vocabulary
    loss in one process, fp32, with softcap and ignored labels: the
    loss's relative error and the largest errors of its gradients with
    respect to ``hidden`` and this rank's table rows (each over the
    one-process gradient's largest)."""
    from repro_torch.core.distributed import axis_index
    from repro_torch.models.layers import chunked_cross_entropy
    from repro_torch.runtime.sharding import TPPlan

    idx, m = axis_index(("model",), mesh)
    gen = torch.Generator().manual_seed(11)
    vocab, d = 64, 16
    table = torch.randn((vocab, d), generator=gen)
    hidden = torch.randn((2, 8, d), generator=gen) * 2
    labels = torch.randint(0, vocab, (2, 8), generator=gen)
    labels[0, 3] = labels[1, 0] = -1
    plan = TPPlan(mesh=mesh, m=m, idx=idx, kinds=(), n_heads=1, n_kv_heads=1, mla=False,
                  attn=False, mlp=False, vocab=True, kv_local=False)
    rows = slice(idx * vocab // m, (idx + 1) * vocab // m)
    kw = dict(n_chunks=2, softcap=5.0, dtype=torch.float32)

    t, h = table[rows].clone().requires_grad_(), hidden.clone().requires_grad_()
    loss = chunked_cross_entropy({"table": t}, h, labels, tp=plan, **kw)
    loss.backward()
    t1, h1 = table.clone().requires_grad_(), hidden.clone().requires_grad_()
    want = chunked_cross_entropy({"table": t1}, h1, labels, **kw)
    want.backward()
    loss, want = float(loss.detach()), float(want.detach())
    return dict(loss=abs(loss - want) / abs(want),
                hidden=_leaf_rel(h.grad, h1.grad), table=_leaf_rel(t.grad, t1.grad[rows]))


def train_count_case(*, arch, params, batch, spec, policy):
    """One split train step (``jit_train_step`` under ``policy`` on a
    ``spec`` mesh of ranks) counted by ``OpCounter`` in this rank, and the
    dry run's count of the same step: ``make_train_step`` at
    ``launch/dryrun.local_config``'s widths on meta stand-ins.  Returns
    both counts' flops, bytes, products' flops, ops and collectives, and
    the process-group calls the rank step made
    (``core/distributed.COLLECTIVES``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import COLLECTIVES
    from repro_torch.launch.dryrun import local_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.runtime import train_loop

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    mesh = _mesh(spec)
    tc = train_loop.TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=20, remat=False)
    compile_for, _ = train_loop.jit_train_step(
        model, tc, mesh, model.init(None, "meta", dtype=torch.float32), policy=policy)
    step = compile_for(batch)
    n0 = dict(COLLECTIVES)
    with OpCounter() as ranks:
        step(params, adamw_init(params), None, batch, 3)
    calls = {k: COLLECTIVES[k] - n0[k] for k in n0}
    lmodel = build_model(local_config(cfg, mesh.shape["model"]))
    lparams = lmodel.init(None, "meta", dtype=torch.float32)
    meta = {k: torch.as_tensor(v).to("meta") for k, v in batch.items()}
    with OpCounter() as dry:
        train_loop.make_train_step(lmodel, tc)(lparams, adamw_init(lparams), None, meta, 3)
    out = {k: dict(flops=c.cost.flops, bytes=c.cost.bytes, products=c.products.flops,
                   ops=c.n_ops, coll=dict(c.cost.coll), coll_counts=dict(c.cost.coll_counts))
           for k, c in (("ranks", ranks), ("dry", dry))}
    out["calls"] = calls
    return out


def block_case(*, arch, kind, params, x, h0, conv):
    """One Mamba-2 (``kind="ssm"``) or RG-LRU (``"rec"``) block of the
    smoke ``arch`` at fp32 split over ``model`` on a 1 x ``world`` mesh:
    each rank computes on its shares of the block's leaves (every 2-D
    leaf's last dim) from its part of the state (``h0``, ``conv``) through
    ``TPPlan``'s collectives.  Returns the output (whole on every rank),
    this rank's part of the new state, and both against the one-process
    block on the whole leaves and state (largest error over largest)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.distributed import axis_index
    from repro_torch.models import recurrent, ssm
    from repro_torch.runtime.sharding import TPPlan, path_str

    cfg = get_config(arch, smoke=True)
    mesh = _mesh(f"1x{dist.get_world_size()}")
    idx, m = axis_index(("model",), mesh)
    layer = {"ssm": "ssm", "rec": "recurrent"}[kind]
    plan = TPPlan(mesh=mesh, m=m, idx=idx, kinds=(layer,), n_heads=1, n_kv_heads=1, mla=False,
                  attn=False, mlp=False, vocab=False, kv_local=False, ssm=kind == "ssm",
                  rec=kind == "rec")
    apply = {"ssm": ssm.mamba2_block_apply, "rec": recurrent.rglru_block_apply}[kind]
    own = tree.tree_map(lambda t: t.narrow(1, *_span(plan, t.shape[1])) if t.ndim == 2 else t,
                        params)
    whole = {"h": torch.as_tensor(h0), "conv": torch.as_tensor(conv)}
    part = {k: t.narrow(plan.state_dim((0, k), t.ndim),
                        *_span(plan, t.shape[plan.state_dim((0, k), t.ndim)])).clone()
            for k, t in whole.items()}
    x = torch.as_tensor(x)
    y, _ = apply(own, x, cfg=cfg, cache=part, dtype=torch.float32, tp=plan)
    one = {k: t.clone() for k, t in whole.items()}
    y1, _ = apply(params, x, cfg=cfg, cache=one, dtype=torch.float32)
    want = {k: t.narrow(plan.state_dim((0, k), t.ndim),
                        *_span(plan, t.shape[plan.state_dim((0, k), t.ndim)]))
            for k, t in one.items()}
    return dict(y=y.numpy(), state={k: t.numpy() for k, t in part.items()},
                own_shapes=sorted((path_str(p), tuple(t.shape))
                                  for p, t in tree.leaves_with_paths(own)),
                y_err=_leaf_rel(y, y1), state_err=max(_leaf_rel(part[k], want[k]) for k in part))


def _span(plan, n):
    """``(start, length)`` of this rank's part of ``n``."""
    lo, hi = plan.part(n)
    return lo, hi - lo


CASES = {
    "block": block_case,
    "serve": serve_case,
    "encdec_serve": encdec_serve_case,
    "count": count_case,
    "train_count": train_count_case,
    "moe": moe_dispatch_case,
    "train": train_case,
    "reshard": reshard_case,
    "launch_train": launch_train_case,
    "ckpt": ckpt_case,
    "ckpt_faults": ckpt_faults_case,
    "supervisor": supervisor_case,
    "launch_ckpt": launch_ckpt_case,
    "round_trip": round_trip_case,
}
