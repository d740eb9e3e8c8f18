"""Distributed attention (counterpart of ``repro/core/distributed.py``):
sequence-parallel (split-KV) decode over a mesh axis, and the merges of
attention partials across shards.

For long contexts the KV cache is sharded along its *sequence* axis.  Each
shard runs the decode kernel (K6, :func:`repro_torch.kernels.gqa_decode
.gqa_decode_rows` with ``return_partials=True``) over its local keys and
returns normalized partials and their log-sum-exp; one merge reconciles
them:

    M = max_s lse_s
    O = sum_s exp(lse_s - M) * o_s  /  sum_s exp(lse_s - M)

This is the distributed form of the paper's online softmax: the per-shard
inner loop keeps AMLA's MUL-by-ADD rescaling, while the one-shot merge uses
exact FP (it happens once per decode step, so the per-block traffic
argument does not apply to it).  The merge runs outside any kernel, in
plain torch, as the reference's does in ``jnp``.

The decodes run in one of two ways.  Single-controller, like JAX's
``shard_map``: one body per entry of the sequence axis (and per batch
block over ``batch_axes``), each on its entry's device, the partials
gathered to the query's device and merged once; entries may repeat one
device (logical shards on one card, or on the CPU, where K6's plain
version runs).  Or rank-local (``ranks=True``, one process per mesh entry
in a ``torch.distributed`` group): each rank holds only its own slice of
the sequence, runs K6 once on it, and the partials are all-gathered over
the sequence axis in coordinate order, so the merge sees what the
single-controller walk concatenates and gives the same bits.

The collectives (:func:`all_gather_dim`, :func:`all_reduce_sum`) run over
the per-axis groups of the mesh's ``DeviceMesh``; each call into the
process group (of more than one rank) adds one to :data:`COLLECTIVES`
and its result's bytes to :data:`COLLECTIVE_BYTES`.
:func:`copy_to_model` (and :func:`products_from_model`, the same in
front of products whose partial cotangents it keeps in fp32),
:func:`gather_from_model` and :func:`reduce_from_model` are their
differentiable forms over ``model`` that a tensor-parallel train step
computes through.  :func:`gather_leaf` is the FSDP gather of one
parameter leaf at its use (its backward the cotangent summed over the
data-parallel axes it gathered, then this rank's slice); :data:`GATHERED`
keeps the bytes of the gathered leaves still alive and the most alive at
once.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from repro_torch.kernels.gqa_decode import DEFAULT_BLOCK_K, gqa_decode_rows

# An lse at or below this marks a shard that saw no valid key (the
# kernels' BIG_NEG, about -3e38, or -inf).
EMPTY_LSE = -1.0e38

# process-group calls made by this process: {"all_gather": n, "all_reduce": n, ...},
# and the bytes of their results (an all-gather's gathered tensor, an
# all-reduce's or an all-to-all's tensor)
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "all_to_all": 0}
COLLECTIVE_BYTES = {"all_gather": 0, "all_reduce": 0, "all_to_all": 0}


# the bytes of the storages of gathered parameter leaves (:func:`gather_leaf`)
# alive in this process, and the most alive at once since the last
# :func:`reset_gathered_peak`; a storage is alive until its last reference goes
GATHERED = {"live": 0, "peak": 0}
_GATHERED_LIVE: dict[int, int] = {}


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += nbytes


def _release_gathered(key: int) -> None:
    GATHERED["live"] -= _GATHERED_LIVE.pop(key, 0)


def _track_gathered(t: torch.Tensor) -> None:
    st = t.untyped_storage()
    key = st._cdata
    if key not in _GATHERED_LIVE:
        n = st.nbytes()
        _GATHERED_LIVE[key] = n
        GATHERED["live"] += n
        weakref.finalize(st, _release_gathered, key)
    GATHERED["peak"] = max(GATHERED["peak"], GATHERED["live"])


def reset_gathered_peak() -> None:
    """Start :data:`GATHERED`'s peak again from the bytes alive now."""
    GATHERED["peak"] = GATHERED["live"]


def combine_partials(acc, m, l) -> torch.Tensor:
    """LSE-combine un-normalised residuals along a leading shard axis.

    acc: (S, G, Dv), m: (S, G), l: (S, G)  ->  (G, Dv) normalised output
    (zero where no shard saw a key)."""
    m_star = torch.amax(m, dim=0)
    w = torch.exp(m - m_star[None])  # (S, G)
    num = torch.sum(acc * w[..., None], dim=0)
    den = torch.sum(l * w, dim=0)
    safe = torch.where(den > 0, den, 1.0)
    return torch.where(den[:, None] > 0, num / safe[:, None], 0.0)


def combine_shard_partials(o_parts, lse_parts) -> torch.Tensor:
    """Merge *normalized* per-shard partials, the paged queue kernel's
    format (``o_s = acc_s / l_s``, ``lse_s = m_s + log l_s``;
    :func:`repro_torch.kernels.ops.mla_decode_paged` with
    ``return_partials=True``).

    o_parts: (S, ..., Dv), lse_parts: (S, ...) -> (..., Dv) fp32.  A shard
    whose lse is at or below ``EMPTY_LSE`` (BIG_NEG or ``-inf``) weighs 0
    whatever its ``o`` holds, and a row where every shard is empty is
    exact zeros.  The mask reads the raw lse: after the max shift an
    all-empty row would weigh each shard ``exp(0) = 1`` (BIG_NEG) or NaN
    (``-inf - -inf``), and both are replaced, not multiplied, so no NaN
    passes the ``where``."""
    o_parts = torch.as_tensor(o_parts).float()
    lse_parts = torch.as_tensor(lse_parts).float()
    valid = lse_parts > EMPTY_LSE
    m_star = torch.amax(lse_parts, dim=0)
    w = torch.where(valid, torch.exp(lse_parts - m_star[None]), 0.0)
    num = torch.sum(torch.where(valid[..., None], o_parts * w[..., None], 0.0), dim=0)
    den = torch.sum(w, dim=0)
    safe = torch.where(den > 0, den, 1.0)
    return torch.where(den[..., None] > 0, num / safe[..., None], 0.0)


def axis_index(axes, mesh) -> tuple[int, int]:
    """This rank's position among the ranks that ``axes`` (mesh axis
    names, major to minor) span, and their count: the flattened
    coordinate, row-major, as ``torch.chunk`` over each axis in turn
    places a shard."""
    dm = mesh.device_mesh()
    coord = dm.get_coordinate()
    idx, n = 0, 1
    for ax in spec_axes(axes):
        i = mesh.axis_names.index(ax)
        idx, n = idx * dm.size(i) + coord[i], n * dm.size(i)
    return idx, n


def spec_axes(entry) -> tuple:
    """A partition-spec entry's mesh axes as a tuple (a bare name, a
    tuple of names, or ``None`` for none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def gather_group(t, dim, group):
    """``t``'s pieces from every rank of ``group`` concatenated along
    ``dim`` in group-rank order (a ``DeviceMesh`` axis group's ranks are in
    coordinate order).  A gloo group takes CUDA tensors here too (checked
    on the card with torch 2.11, though torch's table lists only
    ``broadcast`` and ``all_reduce`` for them) and moves them through host
    memory."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _count("all_gather", n * t.nbytes)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_dim(t: torch.Tensor, dim: int, axes, *, mesh) -> torch.Tensor:
    """``t``'s pieces from every rank along ``axes`` (mesh axis names,
    major to minor) concatenated along ``dim`` in coordinate order: the
    inverse of ``torch.chunk`` over each axis in turn
    (:func:`repro_torch.runtime.sharding.place_one`'s order), so the
    minor axis is gathered first.  Not differentiable
    (:func:`gather_rows` and :func:`gather_from_model` are)."""
    for ax in reversed(spec_axes(axes)):
        t = gather_group(t, dim, mesh.device_mesh().get_group(ax))
    return t


def all_to_all(t: torch.Tensor, axis: str, *, mesh) -> torch.Tensor:
    """``t (n, ...)``'s piece ``i`` sent to the rank at coordinate ``i``
    along ``axis`` (``n`` ranks); returns ``(n, ...)``, piece ``i`` from
    that rank."""
    import torch.distributed as dist

    group = mesh.device_mesh().get_group(axis)
    if dist.get_world_size(group) == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    _count("all_to_all", t.nbytes)
    dist.all_to_all_single(out, t, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes`` (a new tensor, the
    same bits on every rank of a group)."""
    import torch.distributed as dist

    t = t.clone()
    for ax in spec_axes(axes):
        group = mesh.device_mesh().get_group(ax)
        if dist.get_world_size(group) > 1:
            _count("all_reduce", t.nbytes)
            dist.all_reduce(t, group=group)
    return t


def take_shard(t: torch.Tensor, dim: int, axes, *, mesh) -> torch.Tensor:
    """This rank's piece of ``t`` along ``dim`` over ``axes`` (a view):
    what :func:`all_gather_dim` puts back together."""
    idx, n = axis_index(axes, mesh)
    return torch.chunk(t, n, dim=dim)[idx] if n > 1 else t


class _GatherRows(torch.autograd.Function):
    """:func:`all_gather_dim` along ``dim`` whose backward is the adjoint:
    the cotangent summed over the ranks, this rank's piece kept."""

    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather_dim(x, dim, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous(), ctx.axes, mesh=ctx.mesh)
        return take_shard(g, ctx.dim, ctx.axes, mesh=ctx.mesh), None, None, None


def gather_rows(x: torch.Tensor, axes, *, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``axes`` (on ``dim``, default the
    batch's), differentiable for a value each rank's own rows weigh in: a
    layer that must see the whole batch (the MoE dispatch) runs on this
    and keeps its own rows after (:func:`take_shard`), and its backward
    sums the ranks' cotangents."""
    return _GatherRows.apply(x, spec_axes(axes), mesh, dim)


class _GatherLeaf(torch.autograd.Function):
    """A parameter leaf's shard gathered along each ``(dim, axes)`` of
    ``dims``; the backward is the adjoint: the cotangent summed over
    ``summed`` (the gathered axes the batch rows are split over, where each
    rank's cotangent is its own rows' term), then this rank's slice along
    every gathered dim (over an axis that is not summed the ranks compute
    the same and the cotangent is replicated: sliced only)."""

    @staticmethod
    def forward(ctx, x, dims, summed, mesh):
        ctx.dims, ctx.summed, ctx.mesh = dims, summed, mesh
        for dim, axes in dims:
            x = all_gather_dim(x, dim, axes, mesh=mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous(), ctx.summed, mesh=ctx.mesh)
        for dim, axes in ctx.dims:
            g = take_shard(g, dim, axes, mesh=ctx.mesh)
        return g.contiguous(), None, None, None


def gather_leaf(x: torch.Tensor, dims, summed, *, mesh) -> torch.Tensor:
    """``x`` (this rank's shard of a parameter leaf) all-gathered along
    each ``(dim, axes)`` of ``dims`` in turn (groups of one rank left
    out: ``x`` itself where none is left), differentiable
    (:class:`_GatherLeaf`: the cotangent summed over the axes ``summed``,
    then sliced: an all-reduce and a slice where a reduce-scatter would
    do).  The result's bytes count in :data:`GATHERED` while it lives."""
    dims = [(d, a) for d, a in ((d, tuple(ax for ax in spec_axes(a) if mesh.shape[ax] > 1))
                                for d, a in dims) if a]
    if not dims:
        return x
    summed = tuple(a for a in spec_axes(summed) if mesh.shape[a] > 1)
    out = _GatherLeaf.apply(x, tuple(dims), summed, mesh)
    _track_gathered(out)
    return out


def all_reduce_max(t: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks along ``axes`` (a
    new tensor; no gradient)."""
    import torch.distributed as dist

    t = t.detach().clone()
    for ax in spec_axes(axes):
        group = mesh.device_mesh().get_group(ax)
        if dist.get_world_size(group) > 1:
            _count("all_reduce", t.nbytes)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _sum_fp32(g: torch.Tensor, mesh) -> torch.Tensor:
    """``g`` summed over ``model`` in fp32 and cast back to its dtype: the
    ranks' partial cotangents are added once, as one rank's fp32
    accumulation adds them, and rounded once."""
    return all_reduce_sum(g.float(), ("model",), mesh=mesh).to(g.dtype)


# Megatron's f and g operators over ``model``.  Every rank holds the same
# replicated residual stream; a rank's product over its own columns sees a
# replicated input, so its input cotangent is a partial sum (f: summed in
# the backward); a gathered output is replicated and its cotangent is the
# same on every rank (its adjoint keeps the rank's slice, no sum).
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather_dim(x, dim, ("model",), mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return take_shard(g, ctx.dim, ("model",), mesh=ctx.mesh).contiguous(), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, ("model",), mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ProductsFromModel(torch.autograd.Function):
    """``ys`` (the products ``x @ w`` for each of ``ws``, computed from a
    detached ``x``, so that autograd gives each weight its gradient) as
    they are, with the backward of ``copy_to_model(x)`` in front of them
    all: each product's input cotangent ``g @ w^T`` (batched for 3-D
    ``ws``) written in fp32, the partials added and summed over ``model``
    in fp32, and rounded to ``x``'s dtype once, as one rank's product over
    every column rounds its own once."""

    @staticmethod
    def forward(ctx, x, mesh, n, *tensors):
        ctx.mesh, ctx.n, ctx.dtype = mesh, n, x.dtype
        ctx.save_for_backward(*tensors[:n])
        return tuple(y.view_as(y) for y in tensors[n:])

    @staticmethod
    def backward(ctx, *gs):
        ws = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            for g, w in zip(gs, ws):
                if w.ndim == 3:  # (E, C, y) x (E, x, y)^T: the expert products' fp32 cotangents
                    part = torch.bmm(g.float(), w.float().transpose(1, 2))
                else:
                    g2 = g.reshape(-1, g.shape[-1])
                    if g.dtype == torch.float32:
                        part = g2 @ w.t()
                    elif g.device.type == "cpu":  # no CPU kernel for out_dtype; exact products
                        part = g2.float() @ w.float().t()
                    else:
                        part = torch.mm(g2, w.t(), out_dtype=torch.float32)
                    part = part.reshape(*g.shape[:-1], part.shape[-1])
                dx = part if dx is None else dx + part
            dx = all_reduce_sum(dx, ("model",), mesh=ctx.mesh).to(ctx.dtype)
        return (dx, None, None, *([None] * ctx.n), *gs)


def products_from_model(x: torch.Tensor, ws, *, mesh, product=torch.matmul) -> list:
    """``[product(x, w) for w in ws]`` (default ``x @ w``), each ``w`` this
    rank's columns (2-D, or 3-D: a batch of matrices, ``x`` batched alike)
    and ``x`` replicated over ``model``: :func:`copy_to_model` in front of
    the products, with each rank's partial input cotangent kept in fp32
    until the sum over ``model`` (:class:`_ProductsFromModel`)."""
    ys = [product(x.detach(), w) for w in ws]
    return list(_ProductsFromModel.apply(x, mesh, len(ws), *ws, *ys))


def copy_to_model(x: torch.Tensor, *, mesh) -> torch.Tensor:
    """``x`` (replicated over ``model``) as it is; the backward sums the
    cotangent over ``model`` (fp32).  Put in front of a product over this
    rank's columns."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, *, mesh) -> torch.Tensor:
    """The ranks' pieces of ``x`` along ``model`` concatenated on ``dim``;
    the backward keeps this rank's slice of the (replicated) cotangent."""
    return _GatherFromModel.apply(x, dim, mesh)


def reduce_from_model(x: torch.Tensor, *, mesh) -> torch.Tensor:
    """``x`` summed over ``model``; the backward passes the cotangent as it
    is (every rank's term gets the sum's cotangent)."""
    return _ReduceFromModel.apply(x, mesh)


def _entry_device(mesh, index: dict[str, int]) -> torch.device:
    """The device of the mesh entry at ``index`` (axis name -> position;
    axes it does not name at 0)."""
    return mesh.devices[tuple(index.get(a, 0) for a in mesh.axis_names)]


def _split_kv_rows(q, k, v, kv_len, q_pos, *, mesh, seq_axis, batch_axes, variant, scale,
                   window, softcap, block_size, ranks=False):
    """Rows ``q (B, H, G, D)`` against ``k (B, H, S, D)``, ``v (B, H, S,
    Dv)`` with S sharded over ``seq_axis`` and B over ``batch_axes``;
    ``kv_len (B,)`` and ``q_pos (B, G)`` in global positions.  Returns the
    merged ``(B, H, G, Dv)`` fp32 on ``q``'s device.  With ``ranks``,
    ``k`` and ``v`` are this rank's slice of the sequence (``S`` its
    length) and ``q`` this rank's rows; ``batch_axes`` is not read."""
    if ranks:
        return _split_kv_rank(q, k, v, kv_len, q_pos, mesh=mesh, seq_axis=seq_axis,
                              variant=variant, scale=scale, window=window, softcap=softcap,
                              block_size=block_size)
    b = q.shape[0]
    s_total = k.shape[2]
    n_shards = mesh.shape[seq_axis]
    if s_total % n_shards:
        raise ValueError(f"a sequence of {s_total} keys does not split over {n_shards} shards")
    s_local = s_total // n_shards
    batch_sizes = [mesh.shape[a] for a in batch_axes]
    n_blocks = math.prod(batch_sizes)
    if b % n_blocks:
        raise ValueError(f"a batch of {b} does not split over {n_blocks} blocks of {batch_axes}")
    bl = b // n_blocks
    dev = q.device
    kv_len = torch.as_tensor(kv_len, device=dev).to(torch.int64).reshape(b)
    q_pos = torch.as_tensor(q_pos, device=dev).to(torch.int64)
    out = []
    for blk in range(n_blocks):
        rows = slice(blk * bl, (blk + 1) * bl)
        where = dict(zip(batch_axes, np.unravel_index(blk, batch_sizes) if batch_axes else ()))
        o_parts, lse_parts = [], []
        for j in range(n_shards):
            shard_dev = _entry_device(mesh, {**where, seq_axis: j})
            start = j * s_local
            keys = slice(start, start + s_local)
            # global positions shifted into this shard's frame
            local_len = torch.clamp(kv_len[rows] - start, 0, s_local).to(torch.int32)
            o, lse = gqa_decode_rows(
                q[rows].to(shard_dev), k[rows, :, keys].to(shard_dev),
                v[rows, :, keys].to(shard_dev), local_len.to(shard_dev),
                (q_pos[rows] - start).to(torch.int32).to(shard_dev), variant=variant,
                scale=scale, block_k=block_size, softcap=softcap, window=window,
                return_partials=True)
            o_parts.append(o.to(dev))
            lse_parts.append(lse.to(dev))
        out.append(combine_shard_partials(torch.cat(o_parts), torch.cat(lse_parts)))
    return torch.cat(out)


def _split_kv_rank(q, k, v, kv_len, q_pos, *, mesh, seq_axis, variant, scale, window, softcap,
                   block_size):
    """One rank's part of :func:`_split_kv_rows`: K6 once over its slice
    (``start = coordinate x S_local``), at the frame and lengths the
    single-controller walk gives that shard, the partials all-gathered
    over ``seq_axis`` and merged by the same call."""
    s_local = k.shape[2]
    start = axis_index((seq_axis,), mesh)[0] * s_local
    dev = q.device
    kv_len = torch.as_tensor(kv_len, device=dev).to(torch.int64).reshape(q.shape[0])
    q_pos = torch.as_tensor(q_pos, device=dev).to(torch.int64)
    o, lse = gqa_decode_rows(
        q, k, v, torch.clamp(kv_len - start, 0, s_local).to(torch.int32),
        (q_pos - start).to(torch.int32), variant=variant, scale=scale, block_k=block_size,
        softcap=softcap, window=window, return_partials=True)
    return combine_shard_partials(all_gather_dim(o, 0, (seq_axis,), mesh=mesh),
                                  all_gather_dim(lse, 0, (seq_axis,), mesh=mesh))


def gqa_split_kv_decode(
    q: torch.Tensor,  # (B, Sq, Hq, Dh) decode queries
    k: torch.Tensor,  # (B, S, Hkv, Dh), or (B, Hkv, S, Dh) with kv_layout="bhsd"
    v: torch.Tensor,
    *,
    mesh,
    seq_axis: str = "model",
    batch_axes=("data",),
    variant: str = "amla",
    scale: float,
    kv_len,  # (B,) global valid keys
    q_offset,  # (B,) global position of q[:, 0]
    window: int | None = None,
    softcap: float | None = None,
    block_size: int = DEFAULT_BLOCK_K,
    kv_layout: str = "bshd",
    ranks: bool = False,
) -> torch.Tensor:
    """Split-KV GQA decode over a mesh axis with one LSE merge; returns
    ``(B, Sq, Hq, Dh)`` in ``q``'s dtype.  With ``ranks`` the mesh is one
    of processes and ``k`` / ``v`` hold this rank's sequence slice only
    (:func:`_split_kv_rank`).

    The cache's sequence is cut into ``mesh.shape[seq_axis]`` slices (views:
    a ``bhsd`` cache is read where it lies); each shard runs K6 over its
    slice with the window and softcap, at its keys' own frame (positions
    ``q_pos - start``, ``local_len = clip(kv_len - start, 0, S / n)``), so a
    shard no query reaches weighs 0 in the merge, and a row no shard sees
    comes out as exact zeros.  ``q``, ``k`` and ``v`` go to K6 in their
    dtype (bf16 or fp32 throughout)."""
    b, sq, hq, dh = q.shape
    if kv_layout == "bhsd":
        kr, vr = k, v
    else:
        kr, vr = k.transpose(1, 2), v.transpose(1, 2)  # (B, Hkv, S, Dh) views
    hkv = kr.shape[1]
    group = hq // hkv
    qr = q.reshape(b, sq, hkv, group, dh).transpose(1, 2).reshape(b, hkv, sq * group, dh)
    offs = torch.as_tensor(q_offset, device=q.device).to(torch.int64).reshape(b)
    q_pos = offs[:, None] + torch.arange(sq, device=q.device)[None, :]
    out = _split_kv_rows(
        qr, kr, vr, kv_len, torch.repeat_interleave(q_pos, group, dim=1), mesh=mesh,
        seq_axis=seq_axis, batch_axes=tuple(batch_axes or ()), variant=variant, scale=scale,
        window=window, softcap=softcap, block_size=block_size, ranks=ranks)
    dv = vr.shape[-1]
    out = out.reshape(b, hkv, sq, group, dv).transpose(1, 2)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def seq_parallel_decode_batched(
    q: torch.Tensor,  # (B, G, Dk)
    k: torch.Tensor,  # (B, S_total, Dk), S sharded along axis_name
    v: torch.Tensor,  # (B, S_total, Dv)
    *,
    mesh,
    axis_name: str = "data",
    variant: str = "amla",
    scale: float,
    kv_len=None,  # (B,)
    block_size: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Split-KV decode of ``G`` rows per request against one head's keys,
    every key below ``kv_len`` visible (non-causal: the rows' position is
    the sequence length, as ``ops.gqa_attention`` gives it); returns ``(B,
    G, Dv)`` fp32.  Through K6 with one kv head, which takes ``Dk == Dv``:
    other widths raise ``ValueError`` on CUDA (the CPU's plain version
    takes them)."""
    b, g, _ = q.shape
    s_total = k.shape[1]
    if kv_len is None:
        kv_len = torch.full((b,), s_total, dtype=torch.int64, device=q.device)
    q_pos = torch.full((b, g), s_total, dtype=torch.int64, device=q.device)
    out = _split_kv_rows(
        q[:, None], k[:, None], v[:, None], kv_len, q_pos, mesh=mesh, seq_axis=axis_name,
        batch_axes=(), variant=variant, scale=scale, window=None, softcap=None,
        block_size=block_size)
    return out[:, 0]


def seq_parallel_decode(
    q: torch.Tensor,  # (G, Dk) decode queries of one kv-head group
    k: torch.Tensor,  # (S_total, Dk) sharded along axis_name
    v: torch.Tensor,  # (S_total, Dv)
    *,
    mesh,
    axis_name: str = "data",
    variant: str = "amla",
    scale: float,
    kv_len=None,  # scalar total valid keys
    block_size: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """:func:`seq_parallel_decode_batched` of one request: ``(G, Dv)``."""
    lens = None if kv_len is None else torch.as_tensor(kv_len).reshape(1)
    return seq_parallel_decode_batched(
        q[None], k[None], v[None], mesh=mesh, axis_name=axis_name, variant=variant,
        scale=scale, kv_len=lens, block_size=block_size)[0]
