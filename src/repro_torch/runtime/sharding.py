"""Sharding policy (counterpart of ``repro/runtime/sharding.py``): DP
(pod) x FSDP (data) x TP/EP (model) + the split-KV fallbacks, as partition
specs over a :class:`~repro_torch.launch.mesh.Mesh`, and the serving-shard
placement of sharded paged serving.

Every parameter / optimizer / cache / batch leaf maps to a
:class:`PartitionSpec` over the production mesh:

    single-pod:  (data=16, model=16)          = 256 cards
    multi-pod:   (pod=2, data=16, model=16)   = 512 cards

Rules (the reference's):
  * 2-D weights (d_in, d_out): FSDP on d_in over ``data``, TP on d_out over
    ``model``, each only where the dim divides the axis;
  * embedding tables (vocab, d): vocab TP over ``model``, FSDP over ``data``;
  * MoE experts (E, d, ff): EP over ``model`` when E divides it, else
    TP-within-expert on ff;
  * MLA projections: head-dim TP when n_heads divides ``model``;
  * KV caches: batch over ``data`` when divisible, else the *sequence* over
    ``data``; under ``seqkv`` the sequence over ``model`` (split-KV decode);
  * ``pod`` carries pure DP: parameters replicated across pods.

The reference stacks the layers of each scanned group (and the
encoder-decoder's layers, and its caches) on a leading axis and applies
each rule to the trailing dims.  The port keeps one tree entry per layer
(``layers/3/attn/wq/w``, a per-layer cache list), so its leaves are never
stacked: each gets the spec of the reference leaf that holds it with the
stacking axis dropped, the rule applied to the leaf's own shape (a path
holding ``layers`` is not read as stacked here, as it is there).

:func:`place` maps a spec onto a ``torch.distributed.DeviceMesh``'s
placements (``Shard(i)`` for each mesh axis that names tensor dim ``i``,
else ``Replicate()``), which exists for a mesh as large as the process
group: a 1 x 1 mesh on one rank, or a mesh of several ranks (one process
each, :func:`repro_torch.launch.mesh.rank_mesh`).  Rank ``r`` sits at
``np.unravel_index(r, mesh shape)``.  On several ranks the sharded steps
run rank-locally: the model receives this rank's shards of the
parameters and gathers each layer's leaves, and each table, at its use
(:class:`ParamGather`, through ``mesh_ctx.working``: the reference's
FSDP gather inside its scanned, remat'd layer group); the gathers are
differentiable, so the train step's gradients come back as this rank's
shards; a serve step uses a leaf its caller hands whole as it is
(:func:`rank_params`).  A rank computes its own batch rows; what it needs whole besides
(the cache's gathered dims, the compression residual) goes through
:func:`gather_one` / :func:`gather_tree`, the exact inverse of
:func:`place_one`'s ``torch.chunk`` order, and back through
:func:`shard_tree`.

Under ``tp`` and ``tp_fsdp`` on a ``model`` axis of several ranks the
rank-local serve and train steps split their compute as the specs lay
the weights out (:func:`tp_plan`, :class:`TPPlan`): the attention layers
(an encoder-decoder's cross-attention too),
the dense MLPs and the embedding tables keep this rank's ``model`` shard
of every leaf whose spec names ``model`` (gathered over the data axes
only), and compute only its heads, d_ff columns, d_model columns and
vocabulary.

Sharded paged serving routes each request (its pages and queue items) to
ONE ``data`` shard; pools never straddle shards, so that placement is a
copy of a whole tree onto the shard's anchor device
(:func:`serving_shard_devices`, :func:`shard_put`), not a sharding.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.core import tree as _tree
from repro_torch.core.distributed import (
    all_gather_dim,
    all_reduce_max,
    all_to_all,
    axis_index,
    copy_to_model,
    gather_from_model,
    gather_group,
    gather_leaf,
    products_from_model,
    reduce_from_model,
    spec_axes,
    take_shard,
)


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of names (the dim split over those axes, in order).  A one-name
    tuple is kept as the bare name and an empty one as ``None``, as JAX's
    ``PartitionSpec`` reads them."""

    def __new__(cls, *entries):
        norm = [(e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
                for e in entries]
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: PartitionSpec


def data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _shardable(dim: int, axis_size: int) -> bool:
    # exact divisibility only, as the reference's jit argument shardings
    return dim % axis_size == 0


def path_str(path) -> str:
    """A port tree path as a ``/``-joined name (NamedTuple fields by name)."""
    return "/".join(str(k[1] if isinstance(k, tuple) else k) for k in path)


def param_spec_fn(mesh, *, multi_pod: bool, fsdp: bool = True, policy: str = "tp_fsdp",
                  cfg=None):
    """Returns ``fn(path, leaf) -> PartitionSpec`` (``leaf``: anything with
    a ``.shape``).  ``policy`` selects the layout:

      tp_fsdp   TP over "model" + FSDP over "data"          (baseline)
      fsdp      no TP; FSDP over "data" only; "model" becomes extra DP
      fsdp2d    no TP; FSDP over the flattened ("data", "model") axes
      dp        fully replicated parameters
      tp, seqkv serving layouts: TP weights, no FSDP
    """
    model_n = mesh.shape["model"]
    data_n = mesh.shape["data"]
    if policy == "dp":
        return lambda path, leaf: P(*((None,) * len(leaf.shape)))
    if policy == "fsdp2d":
        flat_n = data_n * model_n

        def rule2d(path, leaf):
            dims = tuple(leaf.shape)
            spec = [None] * len(dims)
            # shard the largest shardable dim over the flattened axes
            for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
                if dims[i] % flat_n == 0:
                    spec[i] = ("data", "model")
                    break
                if dims[i] % data_n == 0 and spec[i] is None:
                    spec[i] = "data"
                    break
            return P(*spec)

        return rule2d
    if policy == "fsdp":
        fsdp, use_tp = True, False
    elif policy in ("tp", "seqkv"):
        # parameters stay resident per card instead of being re-gathered
        # every decode step
        fsdp, use_tp = False, True
    else:
        use_tp = True
    dspec = "data" if fsdp else None
    if not use_tp:
        model_n = 10**9  # nothing divides this => no "model" sharding

    def rule(path, leaf):
        name = path_str(path)
        dims = tuple(leaf.shape)
        nd = len(dims)
        if nd in (0, 1):
            spec: tuple = (None,) * nd
        elif nd == 2:
            d0, d1 = dims
            if "table" in name:  # embedding: vocab TP + FSDP(d)
                if _shardable(d0, model_n):
                    spec = ("model", dspec if fsdp and _shardable(d1, data_n) else None)
                elif _shardable(d1, model_n * data_n) and fsdp:
                    # awkward vocab: the model dim over both axes instead
                    spec = (None, ("data", "model"))
                else:
                    spec = (None, "model" if _shardable(d1, model_n) else None)
            else:
                tp_ok = _shardable(d1, model_n)
                # Megatron GQA rule: K/V projections shard over heads only
                # when kv-heads divide the TP axis (slicing inside a head
                # would reduce the scores every KV block)
                if (tp_ok and cfg is not None and re.search(r"/w[kv]($|/)", name)
                        and cfg.n_kv_heads % model_n != 0):
                    tp_ok = False
                spec = (dspec if fsdp and _shardable(d0, data_n) else None,
                        "model" if tp_ok else None)
        elif nd == 3:
            d0, d1, d2 = dims
            if any(k in name for k in ("mlp/gate", "mlp/up", "mlp/down")):
                # MoE experts (E, din, dout)
                if d0 % model_n == 0:
                    spec = ("model", None, None)  # EP only: d/ff are contraction dims
                elif "down" in name:  # TP within each expert; (E, ff, d)
                    spec = (None, "model" if _shardable(d1, model_n) else None,
                            dspec if fsdp and _shardable(d2, data_n) else None)
                else:  # gate/up: (E, d, ff)
                    spec = (None, dspec if fsdp and _shardable(d1, data_n) else None,
                            "model" if _shardable(d2, model_n) else None)
            elif "wq_nope" in name or "wq_rope" in name:
                spec = (dspec if fsdp and _shardable(d0, data_n) else None,
                        "model" if d1 % model_n == 0 else None, None)
            elif "w_uk" in name or "w_uv" in name:
                spec = ("model" if d0 % model_n == 0 else None, None, None)
            else:
                spec = (dspec if fsdp and _shardable(d0, data_n) else None, None,
                        "model" if _shardable(d2, model_n) else None)
        else:
            spec = (None,) * nd
        return P(*spec)

    return rule


def batch_spec_fn(mesh, *, multi_pod: bool, policy: str = "tp_fsdp"):
    """Input batches: leading batch dim over the data-parallel axes (and
    over "model" too under the non-TP policies, where it carries DP)."""
    dax = data_axes(multi_pod)
    if policy in ("fsdp", "fsdp2d", "dp"):
        dax = dax + ("model",)
    total = 1
    for a in dax:
        total *= mesh.shape[a]

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        b = shape[0]
        first = dax if b % total == 0 else None
        if first is None and b % (total // mesh.shape[dax[-1]]) == 0:
            first = dax[:-1]  # fall back to fewer axes
        return P(first, *([None] * (len(shape) - 1)))

    return rule


def cache_spec_fn(mesh, *, multi_pod: bool, policy: str = "tp_fsdp"):
    """KV / recurrent / SSM caches (per layer here).

    Policies:
      tp_fsdp  batch over data; head/latent width over model (forces the
               decode attention to gather the whole cache every step: the
               paper-faithful naive baseline).
      seqkv    batch over data; the cache SEQUENCE over model (split-KV:
               each card attends to S / n keys, reconciled by one LSE merge
               of the softmax partials).
      fsdp/fsdp2d/dp   batch over (data, model) when divisible.

    The sequence axis is the largest non-terminal dim past the batch, so
    the rule holds for ``(B, Hkv, S, Dh)`` and ``(B, S, D)`` alike.
    """
    dax = data_axes(multi_pod)
    if policy in ("fsdp", "fsdp2d", "dp"):
        dax = dax + ("model",)
    total = 1
    for a in dax:
        total *= mesh.shape[a]
    model_n = mesh.shape["model"] if policy == "tp_fsdp" else 10**9

    def rule(path, leaf):
        name = path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd < 1:
            return P(*spec)
        batch_shardable = shape[0] % total == 0
        if batch_shardable:
            spec[0] = dax
        if shape[-1] % model_n == 0 and shape[-1] >= model_n:
            spec[-1] = "model"  # width
        elif nd >= 3 and shape[1] % model_n == 0 and "h" in name:
            spec[1] = "model"  # ssm heads
        if nd >= 3:
            seq_axis = max(range(1, nd - 1), key=lambda i: shape[i])
            # sequence-parallel fallback over data when the batch is not
            if not batch_shardable and shape[seq_axis] % total == 0 and spec[seq_axis] is None:
                spec[seq_axis] = dax
            if policy == "seqkv":
                mdl = mesh.shape["model"]
                if shape[seq_axis] % mdl == 0 and spec[seq_axis] is None:
                    spec[seq_axis] = "model"
        return P(*spec)

    return rule


def tree_specs(tree, spec_fn):
    return _tree.map_with_paths(spec_fn, tree)


def tree_shardings(tree, mesh, spec_fn):
    return _tree.map_with_paths(lambda path, leaf: NamedSharding(mesh, spec_fn(path, leaf)), tree)


def make_shardings(mesh, tree, spec_fn):
    return tree_shardings(tree, mesh, spec_fn)


def placements(spec: PartitionSpec, axis_names) -> list:
    """DTensor placements of ``spec`` over a mesh with ``axis_names``:
    ``Shard(i)`` for each mesh axis that tensor dim ``i`` names, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax in axis_names:
        dims = [i for i, e in enumerate(spec) if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def full_value(t):
    """A ``DTensor``'s full value, gathered by its own placements (the
    inverse of :func:`place_one`'s chunks: the minor mesh axis first; on
    one rank its local tensor itself), or ``t`` itself."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    dm, local = t.device_mesh, t.to_local()
    for axis in reversed(range(dm.ndim)):
        p = t.placements[axis]
        if isinstance(p, Shard):
            local = gather_group(local, p.dim, dm.get_group(axis))
    return local


def place_one(t: torch.Tensor, sh: NamedSharding, _where=None):
    """``t`` (the full value, on every rank) as a DTensor of ``sh``: this
    rank's shard taken as a view (no copy, no communication); a DTensor
    already placed so is returned as it is (as JAX's ``device_put`` of a
    placed array moves nothing).  ``_where``: the mesh's ``(DeviceMesh,
    this rank's coordinate)`` when known."""
    from torch.distributed.tensor import DTensor, Shard

    dm, coord = _where or _mesh_where(sh.mesh)
    pl = placements(sh.spec, sh.mesh.axis_names)
    if isinstance(t, DTensor) and t.device_mesh is dm and list(t.placements) == pl:
        return t
    t = full_value(t)
    local = t
    for axis, p in enumerate(pl):
        if isinstance(p, Shard):
            local = torch.chunk(local, dm.size(axis), dim=p.dim)[coord[axis]]
    return DTensor.from_local(local, dm, pl, run_check=False, shape=t.shape, stride=t.stride())


def _mesh_where(mesh):
    dm = mesh.device_mesh()
    return dm, dm.get_coordinate()


def place(tree, shardings):
    """Every tensor of ``tree`` as a ``DTensor`` placed by the matching
    :class:`NamedSharding` of ``shardings`` (a tree of the same structure);
    raises unless the mesh is as large as the process group."""
    flat = dict(_tree.leaves_with_paths(shardings))
    where = {}

    def one(path, t):
        sh = flat[path]
        if id(sh.mesh) not in where:
            where[id(sh.mesh)] = _mesh_where(sh.mesh)
        return place_one(t, sh, where[id(sh.mesh)])

    return _tree.map_with_paths(one, tree)


def with_sharding_constraint(t, sh: NamedSharding):
    """``t`` placed as ``sh`` asks, values unchanged: a ``DTensor`` is
    redistributed to ``sh``'s placements; a plain tensor (the whole value
    on its device, what the model computes on) needs no move and is
    returned as it is."""
    if not hasattr(t, "redistribute"):
        return t
    return t.redistribute(sh.mesh.device_mesh(), placements(sh.spec, sh.mesh.axis_names))


def local_shards(tree):
    """The local tensor of every ``DTensor`` in ``tree``."""
    return _tree.tree_map(lambda d: d.to_local(), tree)


def local_run(mesh, args, shardings):
    """``args`` placed by ``shardings`` on ``mesh`` (on this rank's device
    of it) and read back as their local shards: on a one-rank mesh the
    tensors themselves (views, no copy); on several ranks this rank's
    slices (views of a full value, or a placed ``DTensor``'s own shard),
    which the step gathers where it needs them whole.  ``RuntimeError``
    unless the process group's world size equals the mesh's size."""
    return local_shards(place(args, shardings))


def _kept(entry, keep) -> bool:
    """A dim stays as it is when every axis that shards it is in ``keep``."""
    return set(spec_axes(entry)) <= set(keep)


def gather_one(local: torch.Tensor, sh: NamedSharding, keep=()) -> torch.Tensor:
    """``local`` (this rank's shard under ``sh``) made whole along every
    sharded dim, except a dim whose axes all lie in ``keep``."""
    for dim, entry in enumerate(sh.spec):
        if entry is not None and not _kept(entry, keep):
            local = all_gather_dim(local, dim, spec_axes(entry), mesh=sh.mesh)
    return local


def shard_one(full: torch.Tensor, sh: NamedSharding, keep=()) -> torch.Tensor:
    """This rank's slice of ``full`` under ``sh`` (a view; the same as
    :func:`place_one`'s local shard), dims whose axes lie in ``keep`` left
    as they are: the inverse of :func:`gather_one` with that ``keep``."""
    for dim, entry in enumerate(sh.spec):
        if entry is not None and not _kept(entry, keep):
            full = take_shard(full, dim, spec_axes(entry), mesh=sh.mesh)
    return full


def gather_tree(local, shardings, keep=()):
    """Every leaf of ``local`` (this rank's shards) whole along every
    sharded dim except those over the axes in ``keep`` (the batch axes,
    which stay this rank's rows)."""
    flat = dict(_tree.leaves_with_paths(shardings))
    return _tree.map_with_paths(lambda p, t: gather_one(t, flat[p], keep), local)


def shard_tree(full, shardings, keep=()):
    """This rank's slices of every leaf of ``full`` (views), as
    :func:`place` would hold them; dims over the axes in ``keep`` are
    left as they are."""
    flat = dict(_tree.leaves_with_paths(shardings))
    return _tree.map_with_paths(lambda p, t: shard_one(t, flat[p], keep), full)


def whole_tree(tree, shardings):
    """The full values of a caller's ``tree`` that a rank-local step needs
    whole (the compression residual): a placed ``DTensor``'s shard
    gathered (:func:`gather_one`), a plain tensor (the full value on
    every rank, as :func:`place_one` reads it) as it is, without moving
    it.  The parameters are never made whole: the model gathers each
    layer at its use (:class:`ParamGather`)."""
    from torch.distributed.tensor import DTensor

    flat = dict(_tree.leaves_with_paths(shardings))

    def one(path, t):
        return gather_one(t.to_local(), flat[path]) if isinstance(t, DTensor) else t

    return _tree.map_with_paths(one, tree)


@dataclasses.dataclass(frozen=True)
class ParamGather:
    """How a rank-local step's model gathers its parameters at their use
    (set into ``mesh_ctx`` as ``gather``): for each leaf's path, the
    ``(dim, axes)`` its shard is all-gathered along (every sharded dim
    but those over the axes it keeps: ``model`` for a leaf a
    :class:`TPPlan` keeps this rank's shard) and the axes its adjoint sums
    the cotangent over (the gathered axes among the batch rows' axes,
    ``rows``: there each rank's cotangent is its own rows' term).  A
    gradient through it comes back as this rank's shard, summed over
    those axes; :meth:`rest` names the rows' axes it is still to be
    summed over.  A leaf the caller handed whole (:func:`rank_params`)
    has no dims: it is used as it is."""

    mesh: object
    rows: tuple
    leaves: dict  # path -> (((dim, axes), ...), summed axes)

    def working(self, tree, prefix):
        """The leaves of ``tree``, the subtree at path ``prefix``,
        gathered (:func:`~repro_torch.core.distributed.gather_leaf`)."""
        return _tree.map_with_paths(lambda p, t: self.leaf(prefix + p, t), tree)

    def leaf(self, path, t: torch.Tensor) -> torch.Tensor:
        dims, summed = self.leaves[path]
        return gather_leaf(t, dims, summed, mesh=self.mesh)

    def rest(self, path) -> tuple:
        """The axes of ``rows`` (of more than one rank) over which the
        gradient of the leaf at ``path`` has not been summed yet."""
        summed = self.leaves[path][1]
        return tuple(a for a in self.rows if a not in summed and self.mesh.shape[a] > 1)


def rank_params(tree, shardings, plan=None):
    """The parameters a rank-local serve step hands its model, from its
    caller's ``tree``, and the paths of the leaves it hands whole: a placed
    ``DTensor``'s local shard (gathered at its use, :class:`ParamGather`);
    a plain tensor (the full value on every rank, as :func:`place_one`
    reads it) as it is, without moving it, or its ``model`` slice (a
    view) where ``plan`` (a :class:`TPPlan`) keeps the leaf local.  Nothing
    is gathered for a leaf the caller already holds whole."""
    from torch.distributed.tensor import DTensor

    flat = dict(_tree.leaves_with_paths(shardings))
    whole = set()

    def one(path, t):
        if isinstance(t, DTensor):
            return t.to_local()
        whole.add(path)
        sh = flat[path]
        if plan is not None and plan.keeps(path_str(path), sh.spec):
            return shard_one(t, sh, tuple(a for a in sh.mesh.axis_names if a != "model"))
        return t

    return _tree.map_with_paths(one, tree), frozenset(whole)


def param_gather(shardings, plan=None, rows=(), whole=()) -> ParamGather:
    """The :class:`ParamGather` of the parameters placed by ``shardings``
    in a step whose batch rows are split over ``rows`` under ``plan`` (a
    :class:`TPPlan` or ``None``); the leaves at the paths in ``whole``
    were handed whole (:func:`rank_params`) and are not gathered."""
    leaves, mesh = {}, None
    for path, sh in _tree.leaves_with_paths(shardings):
        mesh = sh.mesh
        if path in whole:
            leaves[path] = ((), ())
            continue
        keep = ("model",) if plan is not None and plan.keeps(path_str(path), sh.spec) else ()
        dims = tuple((d, spec_axes(e)) for d, e in enumerate(sh.spec)
                     if e is not None and not _kept(e, keep))
        gathered = {a for _, axes in dims for a in axes if sh.mesh.shape[a] > 1}
        leaves[path] = (dims, tuple(a for a in rows if a in gathered))
    return ParamGather(mesh=mesh, rows=tuple(rows), leaves=leaves)


# a MoE layer's expert stacks: (E, d, ff), (E, d, ff), (E, ff, d)
EXPERT_LEAVES = ("gate", "up", "down")
# a Mamba-2 / RG-LRU block's subtree name -> its layer kind
BLOCK_KINDS = {"ssm": "ssm", "rec": "recurrent"}
# the whole 1-D leaves of a split block that a rank reads only at its heads
# or channels (their gradients are partial over ``model``)
BLOCK_PARTIAL = {"ssm": ("conv_b", "a_log", "dt_bias", "d_skip"), "rec": ("conv_b", "lam")}
# the per-layer parameter lists: a decoder-only stack's, an encoder-decoder's
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")
# a layer's subtree name -> the module (``TPPlan.splits``) it belongs to
SUBLAYERS = {"attn": "attn", "self_attn": "attn", "cross_attn": "cross", "mlp": "mlp",
             "ssm": "ssm", "rec": "rec"}


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """How one rank splits a serve or train step over the ``model`` axis
    (:func:`tp_plan`): ``m`` ranks along it, this rank at ``idx``; which
    modules split (``attn``: every attention layer, ``mlp``: every dense
    MLP, ``vocab``: the embedding lookup and the logits or the loss,
    ``moe``: every MoE layer's experts, ``"ep"`` by expert or ``"ff"``
    within each expert by d_ff, else ``None``);
    ``kv_local``: the GQA ``wk`` / ``wv`` hold this rank's kv heads (else
    they are whole, the Megatron rule, and the rank slices the kv heads
    its query heads read); ``ssm`` / ``rec``: every Mamba-2 block computes
    its ``nh / m`` heads, every RG-LRU block its ``d_inner / m`` channels
    (their state too: :meth:`state_caches`); ``cross``: every
    encoder-decoder cross-attention layer its ``n_heads / m`` heads (its
    precomputed K/V too: :meth:`cross_caches`).  ``attn`` covers an
    encoder-decoder's encoder and decoder self-attention.  Set into
    ``mesh_ctx`` (``tp_local``) for the call.

    Its collectives are differentiable (Megatron's operators,
    :mod:`repro_torch.core.distributed`): :meth:`copy` (or
    :meth:`products`) in front of a product over this rank's columns whose
    input is replicated (the backward sums the cotangent over ``model``),
    :meth:`gather` of the ranks' columns (the backward keeps this rank's
    slice), :meth:`sum` (the backward passes the cotangent on)."""

    mesh: object
    m: int
    idx: int
    kinds: tuple
    n_heads: int
    n_kv_heads: int
    mla: bool
    attn: bool
    mlp: bool
    vocab: bool
    kv_local: bool
    moe: str | None = None
    ssm: bool = False
    rec: bool = False
    cross: bool = False

    def splits(self, module: str) -> bool:
        return {"attn": self.attn, "mlp": self.mlp, "embed": self.vocab, "logits": self.vocab,
                "moe": self.moe is not None, "ssm": self.ssm, "rec": self.rec,
                "cross": self.cross}[module]

    def part(self, n: int, idx: int | None = None) -> tuple[int, int]:
        """Rank ``idx``'s (default this rank's) ``[lo, hi)`` of ``n`` split
        in ``m`` equal parts in coordinate order."""
        i = self.idx if idx is None else idx
        return i * n // self.m, (i + 1) * n // self.m

    def kv_heads_of(self, idx: int) -> tuple[int, int]:
        """The ``[lo, hi)`` kv heads rank ``idx``'s query heads read."""
        group = self.n_heads // self.n_kv_heads
        lo, hi = self.part(self.n_heads, idx)
        return lo // group, (hi - 1) // group + 1

    @property
    def kv_heads(self) -> tuple[int, int]:
        return self.kv_heads_of(self.idx)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' pieces of ``t`` along ``model``, concatenated on ``dim``."""
        return gather_from_model(t, dim, mesh=self.mesh)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (replicated) as it is, its cotangent summed over ``model``."""
        return copy_to_model(t, mesh=self.mesh)

    def products(self, x: torch.Tensor, ws, product=torch.matmul) -> list:
        """``product(x, w)`` (default ``x @ w``) for each of ``ws`` (this
        rank's columns; 3-D: a batch of them), ``x`` replicated: :meth:`copy`
        in front of them, the partial cotangents summed in fp32
        (:func:`~repro_torch.core.distributed.products_from_model`)."""
        return products_from_model(x, ws, mesh=self.mesh, product=product)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ``model`` (no gradient)."""
        return all_reduce_max(t, ("model",), mesh=self.mesh)

    def gather_last(self, *ts):
        """:meth:`gather` on the last dim of each of ``ts`` in one call."""
        widths = [t.shape[-1] for t in ts]
        parts = self.gather(torch.cat(ts, dim=-1)[None], 0)  # (m, ..., sum of widths)
        return tuple(p.movedim(0, -2).reshape(*p.shape[1:-1], self.m * w)
                     for p, w in zip(torch.split(parts, widths, dim=-1), widths))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(t, mesh=self.mesh)

    def kv_head_caches(self, leaves) -> list:
        """The working caches of split GQA layers: for each ``(local
        shard, sharding)`` of a ``(B, Hkv, S, Dh)`` ``k`` / ``v`` leaf,
        its rows of this rank's kv heads, whole (:meth:`_head_caches`)."""
        return self._head_caches(leaves, 1, self.kv_heads_of)

    def cross_caches(self, leaves) -> list:
        """The working K/V of split cross-attention layers: for each
        ``(local shard, sharding)`` of a ``(B, Ss, H, Dh)`` ``k`` / ``v``
        leaf, this rank's ``n_heads / m`` heads over every frame
        (:meth:`_head_caches`).  Read-only: nothing goes back."""
        return self._head_caches(leaves, 2, lambda r: self.part(self.n_heads, r))

    def _head_caches(self, leaves, dim: int, heads_of) -> list:
        """Each leaf's heads ``heads_of(this rank)`` (on ``dim``), whole.
        A replica (``tp``) gives views of its own heads; a cache whose
        width (its last dim) is over ``model`` (``tp_fsdp``) trades slices
        in one all-to-all for every leaf: each rank sends every rank its
        width slice of that rank's heads."""
        def span(r):  # (start, length) of rank r's heads
            lo, hi = heads_of(r)
            return lo, hi - lo

        if all(len(sh.spec) < 4 or sh.spec[3] is None for _, sh in leaves):
            return [t.narrow(dim, *span(self.idx)) for t, _ in leaves]
        send = torch.stack([torch.stack([t.narrow(dim, *span(r)) for t, _ in leaves])
                            for r in range(self.m)])  # (m, leaves, B, ..., width / m)
        got = all_to_all(send, "model", mesh=self.mesh)
        # each rank's width slice next to the others': (leaves, B, ..., m, width / m)
        return list(got.movedim(0, -2).reshape(*got.shape[1:-1], self.m * got.shape[-1]))

    def keeps(self, name: str, spec) -> bool:
        """Whether the parameter at ``name`` stays this rank's ``model``
        shard: its spec names ``model`` and its module splits (of a split
        MoE layer, the expert stacks; its router is read whole)."""
        if "model" not in {a for e in spec for a in spec_axes(e)}:
            return False
        parts = name.split("/")
        if parts[0] in ("embed", "unembed"):
            return self.vocab
        if parts[0] in LAYER_STACKS and len(parts) > 2:
            if parts[2] == "mlp" and self.moe is not None:
                return parts[3] in EXPERT_LEAVES
            return parts[2] in SUBLAYERS and self.splits(SUBLAYERS[parts[2]])
        return False

    def partial(self, name: str, spec) -> bool:
        """Whether the whole (not kept) parameter at ``name`` is read only
        in part by this rank under the split, so that its gradient here is
        this rank's term of a sum over ``model``: a split attention
        layer's every other leaf (the q / k / v biases and a whole ``wk`` /
        ``wv`` sliced to the rank's heads, the QK-norm scales applied to
        them; an encoder-decoder's layers have none of these); a split
        Mamba-2 block's ``conv_b`` (at its conv channels), ``a_log``, ``dt_bias`` and ``d_skip`` (at its heads), a split
        RG-LRU block's ``conv_b`` and ``lam`` (at its channels).  A
        Mamba-2 block's norm scale is applied to the gathered output on
        every rank alike, so its gradient is whole."""
        parts = name.split("/")
        if parts[0] not in LAYER_STACKS or len(parts) < 4:
            return False
        if parts[2] in BLOCK_PARTIAL:
            return self.splits(parts[2]) and parts[3] in BLOCK_PARTIAL[parts[2]]
        module = SUBLAYERS.get(parts[2])
        return (module in ("attn", "cross") and self.splits(module)
                and not self.keeps(name, spec))

    def splits_cache(self, path) -> bool:
        """Whether the cache leaf at ``path`` is a split GQA layer's ``k``
        or ``v`` (a decoder-only layer's, or an encoder-decoder's
        ``("self", l, ...)``): its working cache holds this rank's kv
        heads only."""
        if path[0] == "cross":
            return False
        layer = path[1] if path[0] == "self" else path[0]
        return (self.attn and not self.mla and self.kinds[layer] in ("global", "local")
                and path[-1] in ("k", "v"))

    def splits_cross(self, path) -> bool:
        """Whether the cache leaf at ``path`` is a split cross-attention
        layer's ``k`` or ``v`` (``("cross", l, ...)``, :meth:`cross_caches`)."""
        return self.cross and path[0] == "cross" and path[-1] in ("k", "v")

    def splits_state(self, path) -> bool:
        """Whether the cache leaf at ``path`` is a split Mamba-2 or RG-LRU
        block's ``h`` or ``conv``: its working state holds this rank's
        heads or channels only (:meth:`state_caches`)."""
        if path[0] in ("self", "cross"):
            return False
        kind = self.kinds[path[0]]
        return (((self.ssm and kind == "ssm") or (self.rec and kind == "recurrent"))
                and path[-1] in ("h", "conv"))

    def state_dim(self, path, ndim: int) -> int:
        """The dim of the state leaf at ``path`` that the split divides: a
        Mamba-2 ``h`` ``(B, nh, hd, ds)`` by heads, every other leaf by
        its last (channels)."""
        return 1 if self.kinds[path[0]] == "ssm" and path[-1] == "h" else ndim - 1

    def state_caches(self, leaves) -> "BlockStates":
        """The working states of split Mamba-2 / RG-LRU blocks, for each
        ``(path, local shard, sharding)`` of an ``h`` / ``conv`` leaf
        (:class:`BlockStates`)."""
        return BlockStates(self, leaves)

    def trade(self, ts, split: int, cat: int, out=None) -> list:
        """One all-to-all over ``model`` for all of ``ts`` (one shape):
        each cut in ``m`` parts along ``split``, part ``r`` sent to rank
        ``r``; what each rank sent back concatenated along ``cat`` in
        coordinate order, into new tensors or, given ``out`` (one a
        leaf), written into those in place."""
        n = ts[0].shape[split]
        send = torch.stack([torch.stack([t.narrow(split, *self._span(n, r)) for t in ts])
                            for r in range(self.m)])  # (m, leaves, ...)
        got = all_to_all(send, "model", mesh=self.mesh)
        if out is None:
            return list(torch.cat(list(got), dim=cat + 1).unbind(0))
        for r, pieces in enumerate(got):
            for t, x in zip(out, pieces):
                t.narrow(cat, *self._span(t.shape[cat], r)).copy_(x)
        return out

    def _span(self, n: int, idx: int | None = None) -> tuple[int, int]:
        lo, hi = self.part(n, idx)
        return lo, hi - lo


class BlockStates:
    """The working states of split Mamba-2 / RG-LRU blocks, and their way
    back after the call.  ``work`` holds, for each ``(path, local shard,
    sharding)`` of ``leaves``, this rank's heads or channels
    (:meth:`TPPlan.state_dim`) with their whole other dims; the block
    writes its new state into them in place.  Each leaf is one of:

    * ``"shard"``: the split dim is on ``model`` (``tp_fsdp``): the shard
      is the rank's part, worked on and written in place;
    * ``"replica"`` (``tp``): a view of the rank's part; :meth:`write_back`
      all-gathers every rank's part over ``model`` (one call for every
      such leaf) and writes the others', so that each replica is what the
      one-process call leaves;
    * ``"swap"``: a Mamba-2 ``h`` whose state dim ``ds`` is on ``model``
      (``tp_fsdp``): one all-to-all for every such leaf each way
      (:meth:`TPPlan.trade`), heads to ``ds`` slices and back."""

    def __init__(self, plan: TPPlan, leaves):
        self.plan, self.leaves, self.work, swap = plan, [], [], []
        for path, t, sh in leaves:
            dim = plan.state_dim(path, t.ndim)
            kind = ("shard" if sh.spec[dim] == "model" else "swap" if "model" in sh.spec
                    else "replica")
            self.leaves.append((kind, dim, t))
            self.work.append(t.narrow(dim, *plan._span(t.shape[dim])) if kind == "replica"
                             else t)
            if kind == "swap":
                swap.append(len(self.work) - 1)
        if swap:
            for i, x in zip(swap, plan.trade([self.work[i] for i in swap], 1, 3)):
                self.work[i] = x

    def write_back(self) -> None:
        """Put the new states where the shards keep them (the class
        docstring)."""
        plan = self.plan
        rep = [(dim, t, w) for (kind, dim, t), w in zip(self.leaves, self.work)
               if kind == "replica"]
        swap = [(t, w) for (kind, _, t), w in zip(self.leaves, self.work) if kind == "swap"]
        if rep:
            parts = plan.gather(torch.cat([w.reshape(-1) for _, _, w in rep])[None], 0)
            for r, part in enumerate(parts):
                if r == plan.idx:
                    continue
                for (dim, t, w), flat in zip(rep, torch.split(part, [w.numel() for *_, w
                                                                     in rep])):
                    t.narrow(dim, *plan._span(t.shape[dim], r)).copy_(flat.view(w.shape))
        if swap:
            plan.trade([w for _, w in swap], 3, 1, out=[t for t, _ in swap])


def _on_model(specs, name: str, dim: int) -> bool:
    """Whether the parameter leaf ``name``'s spec puts ``dim`` on ``model``."""
    spec = specs.get(name)
    return spec is not None and len(spec) > dim and spec[dim] == "model"


def block_splits(cfg, m: int, specs, cspecs=None, rows=()) -> tuple[bool, bool]:
    """Whether the Mamba-2 and the RG-LRU blocks split over ``m``
    ``model`` ranks (:func:`tp_plan`'s rule for them), from ``specs`` (the
    parameter leaves' specs by name) and ``cspecs`` (the cache's by
    ``(layer, leaf)``; ``None``: no cache, as in a train step): a Mamba-2
    block with ``nh % m == 0`` and ``in_proj``, ``conv_w`` and ``out_proj``
    on ``model`` by their last dim; an RG-LRU block with ``d_inner % m ==
    0`` and ``w_gate``, ``w_main``, ``w_r``, ``w_i``, ``w_out`` and
    ``conv_w`` so; for both, the ``h`` / ``conv`` state's batch over
    ``rows`` and its other dims whole or over ``model`` (a Mamba-2 ``h`` by
    its heads or its state dim, not both).  The launch's dry run reads the
    same rule (``launch/dryrun.card_share``)."""
    kinds = tuple(cfg.layer_kinds())

    def state_ok(l, kind):
        if cspecs is None:
            return True
        for leaf in ("h", "conv"):
            c = cspecs[(l, leaf)]
            split = {i for i, e in enumerate(c) if i and e is not None}
            where = {1, 3} if (kind, leaf) == ("ssm", "h") else {len(c) - 1}
            if (spec_axes(c[0]) != tuple(rows) or len(split) > 1 or not split <= where
                    or any(c[i] != "model" for i in split)):
                return False
        return True

    def block(kind, leaves, divides):
        ls = [l for l, k in enumerate(kinds) if k == BLOCK_KINDS[kind]]
        return bool(ls) and divides and all(
            _on_model(specs, f"layers/{l}/{kind}/{n}", 1) and state_ok(l, kind)
            for l in ls for n in leaves)

    nh = cfg.d_inner // cfg.ssm_head_dim if cfg.ssm_head_dim else 0
    return (block("ssm", ("in_proj/w", "conv_w", "out_proj/w"), nh > 0 and nh % m == 0),
            block("rec", ("w_gate/w", "w_main/w", "w_r/w", "w_i/w", "w_out/w", "conv_w"),
                  cfg.d_inner > 0 and cfg.d_inner % m == 0))


def tp_plan(cfg, mesh, policy, param_sh, cache_sh=None, rows=()) -> TPPlan | None:
    """The tensor-parallel split of a rank-local serve step (``cache_sh``
    its cache's shardings) or train step (no cache), or ``None``
    (every module whole) off ``tp`` / ``tp_fsdp`` or where ``model`` has
    one rank.  A module splits where the specs give it the layout the
    split computes on, checked leaf by leaf:

    * GQA attention: ``n_heads % m == 0`` (``wq``'s columns fall on head
      boundaries), ``wq`` and ``wo`` on ``model`` by their output dim;
      ``wk`` / ``wv`` on ``model`` with ``n_kv_heads % m == 0``, or whole
      with the rank's query heads reading whole kv groups (``H/m`` a
      multiple or a divisor of ``n_heads / n_kv_heads``); the ``k`` /
      ``v`` cache's heads and sequence not sharded, its width whole or over
      ``model``, its batch over the tokens' ``rows`` (a train step has no
      cache);
    * MLA: ``n_heads % m == 0``, ``wq_nope`` / ``wq_rope`` / ``w_uk`` /
      ``w_uv`` on ``model`` by heads, ``wkv_down`` / ``wk_rope`` / ``wo``
      by their output dim;
    * the MLP: dense, ``gate`` / ``up`` / ``down`` on ``model`` by their
      output dim;
    * the MoE experts, the same layout in every MoE layer: ``"ep"`` where
      the ``(E, d, ff)`` / ``(E, ff, d)`` stacks are on ``model`` by
      expert (dim 0), each rank multiplying its ``E / m`` experts' slots;
      ``"ff"`` where ``gate`` / ``up`` are on ``model`` by their last dim
      and ``down`` by its dim 1, each rank multiplying its d_ff columns of
      every expert (the router is read whole either way);
    * the vocabulary: every embedding table on ``model`` by its rows;
    * Mamba-2 and RG-LRU blocks: whole heads or channels a rank, their
      leaves and state laid out as :func:`block_splits` checks;
    * an encoder-decoder: ``attn`` by the GQA rule in every encoder layer
      (``enc_layers/<i>/attn``, no cache) and every decoder self-attention
      (``dec_layers/<l>/self_attn``, its cache ``("self", l, "k" | "v")``
      ``(B, H, S, Dh)``), the dense MLP rule in both stacks, the tied
      table by its rows; ``cross`` where every cross-attention
      (``dec_layers/<l>/cross_attn``) has ``n_heads % m == 0`` and ``wq``
      / ``wk`` / ``wv`` / ``wo`` on ``model`` by their output dim, and its
      precomputed K/V ``("cross", l, "k" | "v")`` ``(B, Ss, H, Dh)`` the
      cache rule's layout (frames and heads not sharded, the width whole
      or over ``model``, the batch over ``rows``).  seamless-m4t-medium's
      256 206 rows split over ``model`` 2 but not 4: there the specs put
      the table on its columns, and the lookup and the logits run whole.

    A module that fails its rule runs whole after the gather, counted as
    such (``mesh_ctx.TP_COUNTS``)."""
    m = mesh.shape["model"]
    if policy not in ("tp", "tp_fsdp") or m < 2:
        return None
    specs = {path_str(p): sh.spec for p, sh in _tree.leaves_with_paths(param_sh)}
    cspecs = {} if cache_sh is None else dict(
        (p, sh.spec) for p, sh in _tree.leaves_with_paths(cache_sh))

    def on(name, dim):
        return _on_model(specs, name, dim)

    kinds = tuple(cfg.layer_kinds())
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    encdec = cfg.family == "encdec"
    # each self-attention layer's parameter prefix and its cache's key (None: no cache)
    if encdec:
        attn_layers = ([(f"enc_layers/{i}/attn/", None) for i in range(cfg.encoder_layers)]
                       + [(f"dec_layers/{l}/self_attn/", ("self", l))
                          for l in range(cfg.n_layers)])
    else:
        attn_layers = [(f"layers/{l}/attn/", (l,)) for l, k in enumerate(kinds)
                       if k in ("global", "local")]

    def laid_out(key):  # a k / v cache the split computes on, or no cache
        return cache_sh is None or key is None or all(
            c[1] is None and c[2] is None and c[3] in (None, "model")
            and spec_axes(c[0]) == tuple(rows)
            for c in (cspecs[key + ("k",)], cspecs[key + ("v",)]))

    def gqa(a, key):
        kv = {on(a + "wk/w", 1), on(a + "wv/w", 1)}
        group, per = hq // hkv, hq // m
        kv_ok = (kv == {True} and hkv % m == 0) or (kv == {False} and (
            per % group == 0 or group % per == 0))
        return on(a + "wq/w", 1) and on(a + "wo/w", 1) and kv_ok and laid_out(key)

    def mla(a, key):
        return (all(on(a + n, 1) for n in ("wq_nope", "wq_rope", "wkv_down/w", "wk_rope/w",
                                            "wo/w"))
                and all(on(a + n, 0) for n in ("w_uk", "w_uv")))

    attn = bool(attn_layers) and hq % m == 0 and all(
        (mla if cfg.mla else gqa)(a, key) for a, key in attn_layers)
    cross = encdec and hq % m == 0 and all(
        all(on(f"dec_layers/{l}/cross_attn/{n}/w", 1) for n in ("wq", "wk", "wv", "wo"))
        and laid_out(("cross", l)) for l in range(cfg.n_layers))
    mlp_layers = [n[:-len("gate/w")] for n in specs if n.endswith("/mlp/gate/w")]
    mlp = (not cfg.n_experts and bool(mlp_layers) and all(
        on(f"{a}{n}/w", 1) for a in mlp_layers for n in ("gate", "up", "down")))
    moe_layers = [l for l in range(len(kinds)) if f"layers/{l}/mlp/router" in specs]
    moe = None
    if moe_layers and all(on(f"layers/{l}/mlp/{n}", 0) for l in moe_layers
                          for n in EXPERT_LEAVES):
        moe = "ep"
    elif moe_layers and all(on(f"layers/{l}/mlp/gate", 2) and on(f"layers/{l}/mlp/up", 2)
                            and on(f"layers/{l}/mlp/down", 1) for l in moe_layers):
        moe = "ff"
    tables = [n for n in ("embed/table", "unembed/table") if n in specs]
    kv_local = attn and not cfg.mla and on(attn_layers[0][0] + "wk/w", 1)

    ssm, rec = block_splits(cfg, m, specs, None if cache_sh is None else cspecs, rows)
    return TPPlan(mesh=mesh, m=m, idx=axis_index(("model",), mesh)[0], kinds=kinds,
                  n_heads=hq, n_kv_heads=hkv, mla=cfg.mla is not None, attn=attn, mlp=mlp,
                  vocab=all(on(n, 0) for n in tables), kv_local=kv_local, moe=moe, ssm=ssm,
                  rec=rec, cross=cross)


def from_local(local: torch.Tensor, sh: NamedSharding, shape):
    """``local`` (this rank's shard of a value of ``shape`` under ``sh``)
    as a ``DTensor``: no copy, no communication."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sh.mesh.device_mesh(),
                              placements(sh.spec, sh.mesh.axis_names), run_check=False,
                              shape=shape, stride=stride)


# --------------------------------------------------------------------------- #
# serving-shard placement (data-parallel paged pools)
# --------------------------------------------------------------------------- #


def serving_shard_devices(mesh) -> list:
    """One anchor device per ``data`` shard (the shard's first model column)."""
    if mesh is None:
        raise ValueError("serving_shard_devices needs a mesh; got None")
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} lack 'data'")
    devs = mesh.devices.reshape(mesh.shape["data"], -1)
    return [devs[i, 0] for i in range(devs.shape[0])]


def shard_put(tree, device):
    """``tree`` on ``device``: the same tensors where a leaf already lives
    there (``Tensor.to`` copies nothing then), so a full-width parameter set
    is never duplicated on its own card; ``device=None`` returns ``tree``."""
    if device is None:
        return tree
    device = torch.device(device)
    return _tree.tree_map(lambda t: t.to(device), tree)
