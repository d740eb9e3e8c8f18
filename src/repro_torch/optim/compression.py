"""Gradient compression with error feedback (counterpart of
``repro/optim/compression.py``).

Compression is a value transformation of the gradients before the
optimizer consumes them (what a data-parallel all-reduce would then move
in the narrow dtype), with an error-feedback residual so the compression
noise does not bias convergence::

    e     <- residual + g
    g_c   <- decompress(compress(e))
    resid <- e - g_c

Modes: "none", "bf16", "int8" (per-tensor scale, stochastic rounding).
The int8 result is the reference's bit for bit: the tensors are the
reference's leaves (its scanned layers stacked, :func:`~repro_torch.optim.adamw.reference_leaves`),
so each scale ``max|e| / 127`` is taken over the same elements, and the
rounding noise is ``jax.random.uniform`` of the same keys
(:mod:`repro_torch.core.prng`), drawn on the gradients' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core import tree as _tree
from repro_torch.optim.adamw import reference_leaves

MODES = ("none", "bf16", "int8")


class CompressionState(NamedTuple):
    residual: dict  # error-feedback accumulator (fp32, param-shaped)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown compression mode {mode!r}; pick one of {MODES}")


def compression_init(params, mode: str) -> CompressionState | None:
    """Zero residuals for ``mode``, or None for ``"none"``."""
    _check_mode(mode)
    if mode == "none":
        return None
    return CompressionState(residual=_tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def _bf16_roundtrip(g, key):
    del key
    return g.to(torch.bfloat16).float()


def _int8_roundtrip(g, key):
    # A tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which may round one ulp away from the reference's division.
    scale = torch.clamp_min(g.abs().max(), 1e-12) / torch.tensor(127.0, device=g.device)
    noise = prng.uniform(key, g.shape, -0.5, 0.5)
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads, state: CompressionState | None, *, mode: str, rng, cfg=None):
    """Returns (compressed_grads, new_state).  ``rng`` is a key
    (:func:`repro_torch.core.prng.prng_key`) on the gradients' device;
    it is split into one key per reference leaf, as the reference splits
    it.  ``cfg`` is the model config whose reference tree stacks the
    layers of ``grads``; None takes each leaf of ``grads`` as a leaf of
    the reference's tree."""
    _check_mode(mode)
    if mode == "none" or state is None:
        return grads, state
    fn = _bf16_roundtrip if mode == "bf16" else _int8_roundtrip
    g = dict(_tree.leaves_with_paths(grads))
    r = dict(_tree.leaves_with_paths(state.residual))
    groups = [[p] for p in g] if cfg is None else [x.paths for x in reference_leaves(grads, cfg)]
    out, res = {}, {}
    for paths, key in zip(groups, prng.split(rng, len(groups)), strict=True):
        e = torch.stack([r[p] + g[p].float() for p in paths])
        gc = fn(e, key)
        for i, p in enumerate(paths):
            out[p], res[p] = gc[i], e[i] - gc[i]
    return (_tree.map_with_paths(lambda p, _: out[p], grads),
            CompressionState(residual=_tree.map_with_paths(lambda p, _: res[p], grads)))
