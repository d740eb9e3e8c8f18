"""Serving-shard placement (counterpart of ``repro/runtime/sharding.py``'s
``serving_shard_devices`` and ``shard_put``).

Sharded paged serving routes each request (its pages and queue items) to
ONE ``data`` shard; pools never straddle shards, so placement is a copy of
a whole tree onto the shard's anchor device, not a sharding of the pool.
The ``model`` axis carries tensor-parallel head groups within a shard
(the head-chunk loop in ``models.transformer``).  The reference's
partition specs, ``make_shardings`` and the rest of its training-side
sharding are not ported here.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map


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
    return tree_map(lambda t: t.to(device), tree)
