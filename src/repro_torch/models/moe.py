"""Mixture-of-Experts MLP (counterpart of ``repro/models/moe.py``): top-k
routing, capacity, sort/gather dispatch, experts batched over E.

Semantics are the reference's, token-dropping at capacity:

* a softmax router in fp32 (bf16 inputs, fp32 product), ``top_k``, the
  weights renormalized;
* capacity ``ceil(n * k / E * capacity_factor)`` from the call's own token
  count ``n`` (so a right-padded prefill's pad tokens and a decode step's
  idle slots take capacity as real tokens do, as in the reference);
* a *stable* sort by expert: inside an expert tokens rank in token order
  and the ones past capacity are dropped;
* the expert MLPs as ``(E, C, d) x (E, d, ff)`` products (``torch.bmm``)
  with fp32 outputs from bf16 inputs, as the reference's, which read
  every expert's weights whatever the routing;
* the weighted combine, each token's kept expert outputs summed in
  increasing expert order from zero: the reference's order of additions
  on one device, and deterministic (no float atomics), so a CUDA graph's
  replay equals the eager walk bit for bit.

Nothing here reads a value back to the host (capacity comes from the
shapes), so a decode step that runs it can be captured as a CUDA graph.

Under ``mesh_ctx(mesh, "tp_fsdp")`` with the experts divisible by
``mesh.shape["model"]`` the dispatched tokens, the expert outputs and the
combined tokens take the reference's expert-parallel placements
(:func:`repro_torch.runtime.sharding.with_sharding_constraint`), where the
reference's stand.  They change no value; on the plain tensors the steps
hand the model they move nothing: inside a step run rank-locally the
split below is what makes each rank compute only its part.

Capacity and drops are taken over the call's tokens, so inside a step run
rank-locally with the batch rows split over ranks
(:func:`repro_torch.runtime.mesh_ctx.rank_rows`) the layer all-gathers
its input over those axes before routing (differentiably:
:func:`repro_torch.core.distributed.gather_rows`), routes every token as
one process does (the router is read whole, so every rank computes the
same probabilities, slots and drops, with no collective), and keeps this
rank's rows after the combine.  Under a tensor-parallel plan
(``tp=``, :class:`~repro_torch.runtime.sharding.TPPlan`) the experts'
compute is split by ``model`` as the reference's specs lay the expert
stacks out (:func:`expert_outputs`): ``"ep"``, each rank multiplies its
``E / m`` experts' slots (and, under ``tp_fsdp``, its share of the
capacity over the data axes) and the outputs are gathered back to ``(E,
C, d)``; ``"ff"``, each rank multiplies its d_ff columns of every
expert and the fp32 partials of ``down`` are summed over ``model``.  The
combine then runs on the whole ``(E, C, d)`` as one process's does.
Where the reference exchanges data-sharded tokens for expert-sharded
slots in one all-to-all, the rows gather above plays that part here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distributed import gather_rows, take_shard
from repro_torch.models import layers
from repro_torch.runtime import mesh_ctx, sharding


def moe_init(gen, cfg, *, device, dtype):
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    kw = dict(device=device, dtype=dtype)
    s = 1.0 / math.sqrt(d)
    return {
        "router": layers.truncnorm(gen, (d, e), s, **kw),
        "gate": layers.truncnorm(gen, (e, d, ff), s, **kw),
        "up": layers.truncnorm(gen, (e, d, ff), s, **kw),
        "down": layers.truncnorm(gen, (e, ff, d), 1.0 / math.sqrt(ff), **kw),
    }


class _WideProducts(torch.autograd.Function):
    """``bmm`` of low-precision inputs with fp32 output, differentiable:
    PyTorch has no derivative for ``bmm(..., out_dtype=)``.  The gradient
    is the widened product's (``bmm(a.float(), b.float())``): fp32 products
    of the fp32 cotangent, rounded to each input's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":  # no CPU kernel for out_dtype
            return torch.bmm(a.float(), b.float())
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def expert_products(a, b):
    """``(E, C, x) x (E, x, y)`` products of ``a.dtype`` inputs, fp32 out:
    the reference's ``preferred_element_type=float32``, so that g, u and
    the expert outputs reach ``silu(g) * u`` and the combine unrounded.  On
    a CUDA tensor cuBLAS writes fp32 from bf16 inputs (``out_dtype``, through
    :class:`_WideProducts` for its gradient), and a meta one (the dry run)
    takes the same path; on the CPU the inputs are widened first, which
    rounds nothing."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type != "cpu":
        return _WideProducts.apply(a, b)
    return torch.bmm(a.float(), b.float())


class Routing(NamedTuple):
    """One call's routing of its ``N`` tokens (:func:`route`)."""

    probs: torch.Tensor  # (N, E) fp32
    top_w: torch.Tensor  # (N, k) renormalized weights
    top_i: torch.Tensor  # (N, k) expert ids
    capacity: int
    order: torch.Tensor  # (N * k,) the stable sort by expert
    keep: torch.Tensor  # (N * k,) in sorted order: within capacity
    slot: torch.Tensor  # (N * k,) in sorted order: expert * C + rank, E * C where dropped
    token_for_slot: torch.Tensor  # (E * C,) -1 where empty
    w_for_slot: torch.Tensor  # (E * C,) fp32


def route(router, xf, *, cfg, dtype) -> Routing:
    """The reference's routing of ``xf (N, d)``: a softmax router in fp32
    (bf16 inputs, fp32 product), ``top_k`` renormalized, capacity from
    ``N``, a stable sort by expert, the ones past capacity dropped, and the
    slot tables (one scatter each; the tail entry absorbs the drops)."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_active
    dev = xf.device
    logits = torch.matmul(xf.to(dtype).float(), router.to(dtype).float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    capacity = max(int(math.ceil(n * k / e * cfg.capacity_factor)), 1)

    flat_expert = top_i.reshape(-1)  # (N*k,)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sw = flat_expert[order], order // k, top_w.reshape(-1)[order]
    seg_start = torch.searchsorted(se, torch.arange(e, dtype=se.dtype, device=dev))
    rank = torch.arange(n * k, device=dev) - seg_start[se]
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, e * capacity)  # drop -> tail
    token_for_slot = torch.full((e * capacity + 1,), -1, dtype=torch.int64,
                                device=dev).scatter_(0, slot, st)[:-1]
    w_for_slot = torch.zeros((e * capacity + 1,), dtype=torch.float32,
                             device=dev).scatter_(0, slot, sw)[:-1]
    return Routing(probs=probs, top_w=top_w, top_i=top_i, capacity=capacity, order=order,
                   keep=keep, slot=slot, token_for_slot=token_for_slot, w_for_slot=w_for_slot)


def expert_mlp(xe_c, gate, up, down, dtype):
    """``silu(xe gate) * (xe up)`` then ``down``, batched over the experts
    of ``xe_c`` (its rows its slots): fp32 products, ``h`` rounded to
    ``dtype``; ``(E, C, d)`` fp32."""
    g = expert_products(xe_c, gate.to(dtype))
    u = expert_products(xe_c, up.to(dtype))
    h = (torch.nn.functional.silu(g) * u).to(dtype)
    return expert_products(h, down.to(dtype))


def slot_axes(capacity: int, tp) -> tuple:
    """The batch rows' axes over which an ``"ep"`` rank also splits the
    capacity: under ``tp_fsdp`` the data axes the rows lie over, where
    their ranks divide ``capacity`` (the reference's ``cap_ax``); else
    none."""
    rows = mesh_ctx.rank_rows()
    if mesh_ctx.current_policy() != "tp_fsdp" or not rows:
        return ()
    return rows if capacity % math.prod(tp.mesh.shape[a] for a in rows) == 0 else ()


def gather_slots(ye, cap, tp):
    """This rank's expert outputs ``(E / m, C / n, d)`` (its experts, its
    share of the capacity over the axes ``cap``) gathered back to ``(E, C,
    d)``: over ``cap`` first (backward: the cotangent summed over them,
    where each rank's holds only its own rows' terms, then sliced), then
    over ``model`` (backward: the slice, the ranks' cotangents being the
    same)."""
    if cap:
        ye = gather_rows(ye, cap, mesh=tp.mesh, dim=1)
    return tp.gather(ye, 0)


def expert_outputs(params, xe, *, cfg, dtype, tp=None):
    """The expert MLPs of the dispatched slots ``xe (E, C, d)``: ``(E, C,
    d)`` fp32.  Whole without a plan, or split by ``model`` under ``tp``'s
    ``moe``:

    * ``"ep"``: the stacks hold this rank's ``E / m`` experts; the rank
      takes their slots of ``xe`` behind ``tp.copy`` (a replicated input:
      its cotangent is summed over ``model``), and its share of the
      capacity over :func:`slot_axes`, multiplies them and gathers the
      outputs (:func:`gather_slots`);
    * ``"ff"``: ``gate`` / ``up`` hold this rank's d_ff columns of every
      expert (column-parallel, through ``tp.products``), ``down`` its rows
      of them (row-parallel): ``h`` stays local and the fp32 partials are
      summed over ``model``.

    The stacks are never made whole here; a shard of another width
    raises."""
    gate, up, down = params["gate"], params["up"], params["down"]
    mode = None if tp is None else tp.moe
    if mode is None:
        return expert_mlp(xe.to(dtype), gate, up, down, dtype)
    e, c, _ = xe.shape
    if mode == "ep":
        lo, hi = tp.part(e)
        if gate.shape[0] != hi - lo:
            raise ValueError(f"an expert-parallel rank holds {gate.shape[0]} experts; "
                             f"its part of {e} is {hi - lo}")
        cap = slot_axes(c, tp)
        xe = tp.copy(xe)[lo:hi]
        if cap:
            xe = take_shard(xe, 1, cap, mesh=tp.mesh)
        return gather_slots(expert_mlp(xe.to(dtype), gate, up, down, dtype), cap, tp)
    lo, hi = tp.part(cfg.d_ff_expert)
    if gate.shape[-1] != hi - lo or down.shape[1] != hi - lo:
        raise ValueError(f"a d_ff-parallel rank holds {gate.shape[-1]} / {down.shape[1]} "
                         f"columns of each expert; its part is {hi - lo}")
    g, u = tp.products(xe.to(dtype), [gate.to(dtype), up.to(dtype)], product=expert_products)
    h = (torch.nn.functional.silu(g) * u).to(dtype)
    return tp.sum(expert_products(h, down.to(dtype)))


def moe_tokens(params, xf, *, cfg, dtype=torch.bfloat16, tp=None):
    """The MoE MLP of the call's tokens ``xf (N, d)``: ``((N, d) fp32, the
    load-balancing aux loss)``."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    dev = xf.device
    r = route(params["router"], xf, cfg=cfg, dtype=dtype)
    capacity = r.capacity

    # Load-balancing auxiliary loss (Switch-style).
    me = r.probs.mean(0)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).scatter_add_(
        0, r.top_i.reshape(-1), torch.ones((n * k,), dtype=torch.float32, device=dev)
    ) / (n * k)
    aux_loss = e * torch.sum(me * ce)

    valid = r.token_for_slot >= 0
    xe = xf[torch.clamp_min(r.token_for_slot, 0)].reshape(e, capacity, d)
    xe = torch.where(valid.reshape(e, capacity, 1), xe, 0.0)

    # Expert parallelism: EP over "model" x capacity-DP over the data axes.
    mesh = mesh_ctx.current_mesh()
    ep = (mesh is not None and mesh_ctx.current_policy() == "tp_fsdp"
          and e % mesh.shape["model"] == 0)
    if ep:
        cap_ax = mesh_ctx.data_axes_in_ctx()
        if capacity % max(1, math.prod(mesh.shape[a] for a in cap_ax)):
            cap_ax = None
        ep_sh = sharding.NamedSharding(mesh, sharding.P("model", cap_ax, None))
        xe = sharding.with_sharding_constraint(xe, ep_sh)

    ye = expert_outputs(params, xe, cfg=cfg, dtype=dtype, tp=tp)  # (E, C, d) fp32
    if ep:
        ye = sharding.with_sharding_constraint(ye, ep_sh)

    # ---- weighted combine, in increasing expert order per token ----
    yw = ye.reshape(e * capacity, d) * r.w_for_slot[:, None]
    # each (token, choice)'s slot, -1 where dropped; sorted, a token's
    # slots run in increasing expert id (slot = expert * C + rank)
    slot_of = torch.full((n * k,), -1, dtype=torch.int64, device=dev).scatter_(
        0, r.order, torch.where(r.keep, r.slot, -1))
    slots = torch.sort(slot_of.reshape(n, k), dim=1).values
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for j in range(k):
        sj = slots[:, j]
        out = out + torch.where((sj >= 0)[:, None], yw[torch.clamp_min(sj, 0)], 0.0)
    if ep:  # the combined tokens back on the data axes
        out = sharding.with_sharding_constraint(
            out, sharding.NamedSharding(mesh, sharding.P(mesh_ctx.data_axes_in_ctx(), None)))
    return out, aux_loss


def moe_apply(params, x, *, cfg, dtype=torch.bfloat16, tp=None):
    """x: (B, S, d) -> ((B, S, d), the load-balancing aux loss); ``tp``
    the plan splitting the experts by ``model`` (:func:`expert_outputs`)."""
    rows = mesh_ctx.rank_rows()
    if rows:  # route the whole batch, as one process does
        x = gather_rows(x, rows, mesh=mesh_ctx.current_mesh())
    b, s, d = x.shape
    out, aux_loss = moe_tokens(params, x.reshape(b * s, d), cfg=cfg, dtype=dtype, tp=tp)
    out = out.reshape(b, s, d).to(x.dtype)
    if rows:
        out = take_shard(out, 0, rows, mesh=mesh_ctx.current_mesh())
    return out, aux_loss
