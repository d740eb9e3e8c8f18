"""Elastic scaling (counterpart of ``repro/runtime/elastic.py``): reshard
a training state onto a different mesh, and replicate serving parameters
onto an attached shard.

When the cluster grows or shrinks, the same sharding *policy* evaluated
against the new mesh gives the target layout: each leaf is made whole
(a placed ``DTensor``'s shards gathered over the ranks by its own
placements; a plain tensor is the full value already) and this rank's
slice of it under the new mesh's specs is placed there
(:mod:`repro_torch.runtime.sharding`).  Both meshes span the process
group (a 1 x 1 mesh on one rank, or two shapes of the same ranks).  The
data-parallel batch is kept by the caller adjusting ``grad_accum``.
"""

from __future__ import annotations

from repro_torch.core import tree as _tree
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import sharding


def reshard_tree(tree, new_mesh, spec_fn):
    """Every leaf of ``tree`` (a tensor, or a placed ``DTensor``, gathered
    by its own placements) placed on ``new_mesh`` by ``spec_fn``: a tree
    of ``DTensor``s of this rank's shards there."""

    def move(path, leaf):
        full = sharding.full_value(leaf)
        new = sharding.NamedSharding(new_mesh, spec_fn(path, full))
        return sharding.from_local(sharding.shard_one(full, new), new, full.shape)

    return _tree.map_with_paths(move, tree)


def serving_params_replica(params, device=None):
    """A parameter replica for a freshly attached serving shard on
    ``device``.  With ``device=None``, or the device the parameters already
    live on, it is ``params``' own tensors: logical shards on one card
    share one parameter set (a second full-width deepseek-v2-mla copy is
    52 GB of bf16 beside an 80 GB card's page pools)."""
    return sharding.shard_put(params, device)


def reshard_train_state(params, opt_state, old_mesh, new_mesh, *, multi_pod=False):
    """``(params, opt_state)`` resharded onto ``new_mesh`` under the
    ``tp_fsdp`` parameter specs (moments as their parameters, the count
    replicated); the leaves come back as ``DTensor``s of this rank's
    shards on the new mesh.  ``old_mesh`` is not read: a placed leaf
    carries its own layout."""
    del old_mesh
    pfn = sharding.param_spec_fn(new_mesh, multi_pod=multi_pod)
    rep = lambda path, leaf: sharding.P()
    return (reshard_tree(params, new_mesh, pfn),
            AdamWState(count=reshard_tree(opt_state.count, new_mesh, rep),
                       mu=reshard_tree(opt_state.mu, new_mesh, pfn),
                       nu=reshard_tree(opt_state.nu, new_mesh, pfn)))
