"""Carry a reference (JAX) parameter tree into the port's parameters.

The reference stores layers scanned in groups of ``len(layer_pattern)``:
every leaf under ``params["groups"][f"pos{j}"]`` has a leading
``n_groups`` axis, and a remainder of unscanned layers sits in
``params["rem"]``.  :func:`convert_params` unstacks them into the port's
per-layer list (as the reference's ``transformer.per_layer_params`` does)
and turns every leaf into a tensor with ``np.asarray`` — the tree is walked
as plain dicts and lists, so nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def convert_params(ref_params, cfg, *, device="cuda") -> dict:
    """Port parameters (``embed``, ``final_norm``, ``unembed``, ``layers``)
    from a reference parameter tree, leaves kept at their dtype."""
    dev = resolve_device(device)
    to_t = lambda a: torch.from_numpy(np.array(np.asarray(a))).to(dev)
    period = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // period
    out = {k: _tree_map(to_t, ref_params[k]) for k in ("embed", "final_norm")}
    if "unembed" in ref_params:
        out["unembed"] = _tree_map(to_t, ref_params["unembed"])
    per_layer = []
    for g in range(n_groups):
        for j in range(period):
            per_layer.append(
                _tree_map(lambda a: to_t(np.asarray(a)[g]), ref_params["groups"][f"pos{j}"])
            )
    per_layer.extend(_tree_map(to_t, p) for p in ref_params.get("rem", []))
    if len(per_layer) != cfg.n_layers:
        raise ValueError(
            f"reference tree holds {len(per_layer)} layers, config "
            f"{cfg.name!r} has {cfg.n_layers}"
        )
    out["layers"] = per_layer
    return out
