"""Carry a reference (JAX) parameter tree into the port's parameters.

The reference stores layers scanned in groups of ``len(layer_pattern)``:
every leaf under ``params["groups"][f"pos{j}"]`` has a leading
``n_groups`` axis, and a remainder of unscanned layers sits in
``params["rem"]``.  :func:`convert_params` unstacks them into the port's
per-layer list (as the reference's ``transformer.per_layer_params`` does)
and turns every leaf into a tensor with ``np.asarray`` — the tree is walked
as plain dicts and lists, so nothing here imports JAX.

The encoder-decoder tree (``encdec_init``) stacks its layers with
``vmap`` instead: ``enc_layers`` and ``dec_layers`` carry a leading
``encoder_layers`` / ``n_layers`` axis, unstacked here into two per-layer
lists beside ``embed`` (tied), ``enc_norm`` and ``final_norm``.

:func:`convert_opt_state` carries the reference's AdamW state across the
same way (its moments are trees shaped as the parameters).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_map as _tree_map
from repro_torch.models import layers


def _unstack(tree, n, to_t) -> list:
    """``n`` per-layer trees of a tree whose leaves are stacked along
    their leading axis."""
    row = lambda a, i: a[i] if isinstance(a, torch.Tensor) else np.asarray(a)[i]
    return [_tree_map(lambda a: to_t(row(a, i)), tree) for i in range(n)]


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor copy of a leaf: a JAX or numpy array, or a tensor (a
    checkpoint read back, bf16 included)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
    return torch.from_numpy(np.array(np.asarray(a)))


def convert_params(ref_params, cfg, *, device="cuda") -> dict:
    """Port parameters from a reference parameter tree (``embed``,
    ``final_norm``, ``unembed``, ``layers``; for an encoder-decoder
    ``embed``, ``enc_norm``, ``final_norm``, ``enc_layers``,
    ``dec_layers``), leaves kept at their dtype (and a below-fp32
    unembedding table's fp32 copy made,
    :func:`~repro_torch.models.layers.keep_fp32_table`)."""
    dev = resolve_device(device)
    to_t = lambda a: _host_tensor(a).to(dev)
    if cfg.family == "encdec":
        out = {k: _tree_map(to_t, ref_params[k]) for k in ("embed", "enc_norm", "final_norm")}
        out["enc_layers"] = _unstack(ref_params["enc_layers"], cfg.encoder_layers, to_t)
        out["dec_layers"] = _unstack(ref_params["dec_layers"], cfg.n_layers, to_t)
        layers.keep_fp32_table(out["embed"])
        return out
    period = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // period
    out = {k: _tree_map(to_t, ref_params[k]) for k in ("embed", "final_norm")}
    if "unembed" in ref_params:
        out["unembed"] = _tree_map(to_t, ref_params["unembed"])
    per_layer = []
    if n_groups:
        groups = [_unstack(ref_params["groups"][f"pos{j}"], n_groups, to_t)
                  for j in range(period)]
        per_layer = [groups[j][g] for g in range(n_groups) for j in range(period)]
    per_layer.extend(_tree_map(to_t, p) for p in ref_params.get("rem", []))
    if len(per_layer) != cfg.n_layers:
        raise ValueError(
            f"reference tree holds {len(per_layer)} layers, config "
            f"{cfg.name!r} has {cfg.n_layers}"
        )
    out["layers"] = per_layer
    layers.keep_fp32_table(out.get("unembed", out["embed"]))
    return out


def convert_opt_state(ref_state, cfg, *, device="cuda"):
    """Port AdamW state (:class:`~repro_torch.optim.adamw.AdamWState`)
    from the reference's ``AdamWState`` — or the dict a checkpoint of it
    reads back as (``count``, ``mu``, ``nu``) — whose moments are shaped
    as the reference's parameters and unstacked the same way."""
    from repro_torch.optim.adamw import AdamWState

    get = (ref_state.get if isinstance(ref_state, dict)
           else lambda k: getattr(ref_state, k))
    dev = resolve_device(device)
    return AdamWState(
        count=torch.as_tensor(np.array(get("count")), dtype=torch.int32).to(dev),
        mu=convert_params(get("mu"), cfg, device=dev),
        nu=convert_params(get("nu"), cfg, device=dev),
    )
