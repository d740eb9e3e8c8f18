"""Process-global mesh and policy context for sharding decisions made
inside the model (counterpart of ``repro/runtime/mesh_ctx.py``).

Model code (the attention layer's split-KV branch, the MoE dispatch's
expert-parallel placement) sometimes needs the concrete mesh; threading it
through every config would contaminate pure-model signatures, so the
launch factories and callers set it here around execution.

``rank_rows`` says how the current call runs: ``None`` for one process
(the whole batch, a cache whose every leaf is whole or a logical mesh's),
or, inside a step run rank-locally on a mesh of processes
(:func:`repro_torch.runtime.sharding.local_run`), the mesh axes over
which the batch rows are split across ranks (``()`` when every rank holds
every row).  The step factories set it for the call; model code reads it
through :func:`on_ranks` and :func:`rank_rows`.

``tp_local`` is set only by the rank-local serve and train steps under
``tp`` and ``tp_fsdp`` on a ``model`` axis of several ranks: a
:class:`~repro_torch.runtime.sharding.TPPlan` saying which modules this
rank computes split (its heads, d_ff columns, Mamba-2 heads, RG-LRU
channels, cross-attention heads and vocabulary rows) and how.
Everywhere else it is ``None`` and every layer computes whole.  The
layers count what they did under a plan in :data:`TP_COUNTS` (``attn``,
``cross`` (an encoder-decoder's cross-attention), ``mlp``, ``moe``,
``ssm``, ``rec``, ``embed``, ``logits`` (the serve step's logits or the
train step's loss), each split or ``*_whole``: ``ssm_whole`` where the
heads do not divide over ``model``), once per call: a layer that remat
runs again in the backward is counted again there.

``gather`` is set by the rank-local serve and train steps, whose model
receives this rank's shards of the parameters: a
:class:`~repro_torch.runtime.sharding.ParamGather` holding each leaf's
sharding and the axes it keeps.  Model code asks for a layer's, or a
table's, leaves through :func:`working` just before it uses them (the
FSDP gather of that layer only, inside a remat'd layer: again in its
recompute) and drops them after; elsewhere :func:`working` returns them
as they are.
"""

from __future__ import annotations

from contextlib import contextmanager

_CURRENT: dict = {"mesh": None, "policy": "tp_fsdp", "multi_pod": False, "rank_rows": None,
                  "tp_local": None, "gather": None}
TP_COUNTS: dict = {}


def set_mesh_ctx(mesh, policy: str = "tp_fsdp", multi_pod: bool = False, rank_rows=None,
                 tp_local=None, gather=None):
    _CURRENT.update(mesh=mesh, policy=policy, multi_pod=multi_pod, rank_rows=rank_rows,
                    tp_local=tp_local, gather=gather)


def clear_mesh_ctx():
    set_mesh_ctx(None)


@contextmanager
def mesh_ctx(mesh, policy: str = "tp_fsdp", multi_pod: bool = False, rank_rows=None,
             tp_local=None, gather=None):
    prev = dict(_CURRENT)
    set_mesh_ctx(mesh, policy, multi_pod, rank_rows, tp_local, gather)
    try:
        yield
    finally:
        _CURRENT.update(prev)


def current_mesh():
    return _CURRENT["mesh"]


def current_policy() -> str:
    return _CURRENT["policy"]


def on_ranks() -> bool:
    """True inside a step that runs rank-locally on a mesh of processes."""
    return _CURRENT["rank_rows"] is not None


def rank_rows() -> tuple:
    """The mesh axes the batch rows are split over across ranks (``()``
    outside a rank-local step)."""
    return _CURRENT["rank_rows"] or ()


def tp_split(module: str):
    """The current :class:`~repro_torch.runtime.sharding.TPPlan` where it
    splits ``module`` (``"attn"``, ``"cross"``, ``"mlp"``, ``"moe"``,
    ``"embed"``, ``"logits"``, ``"ssm"`` or ``"rec"``), else ``None``; under a plan the
    call is counted in :data:`TP_COUNTS` either way, so a module that runs
    whole is never silent."""
    plan = _CURRENT["tp_local"]
    if plan is None:
        return None
    split = plan.splits(module)
    key = module if split else module + "_whole"
    TP_COUNTS[key] = TP_COUNTS.get(key, 0) + 1
    return plan if split else None


def working(tree, prefix: tuple):
    """The leaves of ``tree`` (the subtree of the parameters at path
    ``prefix``: a layer's dict, or one table leaf) that the model computes
    on: inside a rank-local step this rank's shards gathered along every
    sharded dim, differentiably (a leaf a tensor-parallel plan keeps stays
    this rank's ``model`` shard, gathered over the data axes only);
    elsewhere ``tree`` itself."""
    gather = _CURRENT["gather"]
    return tree if gather is None else gather.working(tree, tuple(prefix))


def data_axes_in_ctx():
    from repro_torch.runtime.sharding import data_axes

    return data_axes(_CURRENT["multi_pod"])
