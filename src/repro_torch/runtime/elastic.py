"""Elastic serving (counterpart of ``repro/runtime/elastic.py``'s
``serving_params_replica``).

Serving data-parallelism replicates the parameters per shard (each shard
runs the whole model over its own requests), so an attached shard needs a
replica on its device and nothing else.  The reference's training-state
resharding (``reshard_tree``, ``reshard_train_state``) is not ported here.
"""

from __future__ import annotations

from repro_torch.runtime import sharding


def serving_params_replica(params, device=None):
    """A parameter replica for a freshly attached serving shard on
    ``device``.  With ``device=None``, or the device the parameters already
    live on, it is ``params``' own tensors: logical shards on one card
    share one parameter set (a second full-width deepseek-v2-mla copy is
    52 GB of bf16 beside an 80 GB card's page pools)."""
    return sharding.shard_put(params, device)
