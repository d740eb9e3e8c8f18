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
(:func:`repro_torch.runtime.sharding.with_sharding_constraint`): a
constraint changes no value, and on the plain tensors the model computes
on it moves nothing, so the expert math is one path with or without a
mesh.  No path gives the model a ``DTensor`` (``jit_train_step`` and
``jit_serve_fns`` run it on plain tensors, since the kernels read
``data_ptr()``), so these constraints act on nothing; they stand where
the reference's do.

Capacity and drops are taken over the call's tokens, so inside a step run
rank-locally with the batch rows split over ranks
(:func:`repro_torch.runtime.mesh_ctx.rank_rows`) the layer all-gathers
its input over those axes before routing (differentiably:
:func:`repro_torch.core.distributed.gather_rows`), routes and computes
every token as one process would, and keeps this rank's rows after the
combine.  The experts' compute is replicated across ranks.
"""

from __future__ import annotations

import math

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


def moe_apply(params, x, *, cfg, dtype=torch.bfloat16):
    """x: (B, S, d) -> ((B, S, d), the load-balancing aux loss)."""
    rows = mesh_ctx.rank_rows()
    if rows:  # route the whole batch, as one process does
        x = gather_rows(x, rows, mesh=mesh_ctx.current_mesh())
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    n = b * s
    dev = x.device
    xf = x.reshape(n, d)

    # bf16 inputs, fp32 product: the reference's preferred_element_type
    logits = torch.matmul(xf.to(dtype).float(), params["router"].to(dtype).float())
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    top_w, top_i = torch.topk(probs, k, dim=-1)  # (N, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # Load-balancing auxiliary loss (Switch-style).
    me = probs.mean(0)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).scatter_add_(
        0, top_i.reshape(-1), torch.ones((n * k,), dtype=torch.float32, device=dev)
    ) / (n * k)
    aux_loss = e * torch.sum(me * ce)

    capacity = max(int(math.ceil(n * k / e * cfg.capacity_factor)), 1)

    # ---- sort-based dispatch ----
    flat_expert = top_i.reshape(-1)  # (N*k,)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sw = flat_expert[order], order // k, flat_w[order]
    seg_start = torch.searchsorted(se, torch.arange(e, dtype=se.dtype, device=dev))
    rank = torch.arange(n * k, device=dev) - seg_start[se]
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, e * capacity)  # drop -> tail

    # slot tables (one scatter each; the tail entry absorbs the drops)
    token_for_slot = torch.full((e * capacity + 1,), -1, dtype=torch.int64,
                                device=dev).scatter_(0, slot, st)[:-1]
    w_for_slot = torch.zeros((e * capacity + 1,), dtype=torch.float32,
                             device=dev).scatter_(0, slot, sw)[:-1]
    valid = token_for_slot >= 0
    gather_idx = torch.clamp_min(token_for_slot, 0)

    xe = xf[gather_idx].reshape(e, capacity, d)
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

    # ---- expert MLPs (batched over E) ----
    xe_c = xe.to(dtype)
    g = expert_products(xe_c, params["gate"].to(dtype))
    u = expert_products(xe_c, params["up"].to(dtype))
    h = (torch.nn.functional.silu(g) * u).to(dtype)
    ye = expert_products(h, params["down"].to(dtype))  # (E, C, d) fp32
    if ep:
        ye = sharding.with_sharding_constraint(ye, ep_sh)

    # ---- weighted combine, in increasing expert order per token ----
    yw = ye.reshape(e * capacity, d) * w_for_slot[:, None]
    # each (token, choice)'s slot, -1 where dropped; sorted, a token's
    # slots run in increasing expert id (slot = expert * C + rank)
    slot_of = torch.full((n * k,), -1, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.where(keep, slot, -1))
    slots = torch.sort(slot_of.reshape(n, k), dim=1).values
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for j in range(k):
        sj = slots[:, j]
        out = out + torch.where((sj >= 0)[:, None], yw[torch.clamp_min(sj, 0)], 0.0)
    if ep:  # the combined tokens back on the data axes
        out = sharding.with_sharding_constraint(
            out, sharding.NamedSharding(mesh, sharding.P(mesh_ctx.data_axes_in_ctx(), None)))
    out = out.reshape(b, s, d).to(x.dtype)
    if rows:
        out = take_shard(out, 0, rows, mesh=mesh_ctx.current_mesh())
    return out, aux_loss
