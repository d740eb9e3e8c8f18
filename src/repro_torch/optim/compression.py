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
The int8 rounding noise is drawn from an explicit ``torch.Generator``
(the reference draws from ``jax.random``, whose bits are not reproduced
here: the two agree in distribution, not bit for bit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import tree as _tree

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


def _bf16_roundtrip(g, generator):
    del generator
    return g.to(torch.bfloat16).float()


def _int8_roundtrip(g, generator):
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    noise = torch.rand(g.shape, generator=generator, device=g.device) - 0.5  # U[-0.5, 0.5)
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads, state: CompressionState | None, *, mode: str, generator=None):
    """Returns (compressed_grads, new_state); ``generator`` (on the
    gradients' device) draws the int8 rounding noise."""
    _check_mode(mode)
    if mode == "none" or state is None:
        return grads, state
    fn = _bf16_roundtrip if mode == "bf16" else _int8_roundtrip
    outs, new_res = [], []
    for g, r in zip(_tree.leaves(grads), _tree.leaves(state.residual), strict=True):
        e = r + g.float()
        gc = fn(e, generator)
        outs.append(gc)
        new_res.append(e - gc)
    return (_tree.unflatten_like(grads, outs),
            CompressionState(residual=_tree.unflatten_like(grads, new_res)))


def step_generator(step: int, device) -> torch.Generator:
    """The int8 noise generator of training step ``step``, seeded from
    ``(17, step)`` (the reference folds ``step`` into ``PRNGKey(17)``)."""
    return torch.Generator(device=device).manual_seed((17 << 32) + int(step))
