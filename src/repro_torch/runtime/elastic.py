"""Elastic scaling (counterpart of ``repro/runtime/elastic.py``): reshard
a training state onto a different mesh, and replicate serving parameters
onto an attached shard.

When the cluster grows or shrinks, the same sharding *policy* evaluated
against the new mesh gives the target layout; resharding stages each leaf
on the host (its full value) and places it with the new mesh's specs
(:func:`repro_torch.runtime.sharding.place`).  The data-parallel batch is
kept by the caller adjusting ``grad_accum``.  A placement needs a process
group as large as the new mesh: a 1 x 1 mesh on one rank here; meshes of
several cards wait for a machine that has them.
"""

from __future__ import annotations

from repro_torch.core import tree as _tree
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import sharding


def reshard_tree(tree, new_mesh, spec_fn):
    """Every leaf of ``tree`` (a tensor or a placed ``DTensor``) staged on
    the host (its full value) and placed on ``new_mesh`` by ``spec_fn``:
    a tree of ``DTensor``s on this rank's device of the new mesh."""
    import torch.distributed as dist

    new_mesh.device_mesh()  # raises unless the process group fits the mesh
    dev = new_mesh.devices.flat[dist.get_rank()]

    def move(path, leaf):
        host = sharding.full_value(leaf).detach().to("cpu")
        target = sharding.NamedSharding(new_mesh, spec_fn(path, leaf))
        return sharding.place_one(host.to(dev), target)

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
    replicated); the leaves come back as ``DTensor``s."""
    del old_mesh
    pfn = sharding.param_spec_fn(new_mesh, multi_pod=multi_pod)
    rep = lambda path, leaf: sharding.P()
    params = reshard_tree(params, new_mesh, pfn)
    opt_state = AdamWState(
        count=reshard_tree(opt_state.count, new_mesh, rep),
        mu=reshard_tree(opt_state.mu, new_mesh, pfn),
        nu=reshard_tree(opt_state.nu, new_mesh, pfn),
    )
    return params, opt_state
