"""Weights from the seed, on the device, in a few large calls: one buffer
per dtype filled by one ``torch.Generator`` on the device (normal draws in
chunks of 2**30), each leaf a contiguous view of it scaled by its standard
deviation.  The same tensors go to the program and to the reference."""

from __future__ import annotations

import torch

ALIGN = 128  # elements: every leaf starts 256-byte aligned or better
CHUNK = 1 << 30


def _insert(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            while len(node) <= key:
                node.append(default.copy())
            node = node[key]
        else:
            node = node.setdefault(key, default)
    node[path[-1]] = value


def make(leaves, seed: int, device) -> dict:
    """The weight tree of ``leaves`` (``reference.common.Leaf``), drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree: dict = {}
    for dtype in sorted({leaf.dtype for leaf in leaves}, key=str):
        group = [leaf for leaf in leaves if leaf.dtype == dtype]
        offsets, total = [], 0
        for leaf in group:
            offsets.append(total)
            n = 1
            for s in leaf.shape:
                n *= s
            total += -(-n // ALIGN) * ALIGN
        buf = torch.empty((total,), dtype=dtype, device=device)
        for a in range(0, total, CHUNK):
            buf[a : a + CHUNK].normal_(generator=gen)
        for leaf, off in zip(group, offsets):
            n = 1
            for s in leaf.shape:
                n *= s
            view = buf[off : off + n].view(leaf.shape)
            view.mul_(leaf.std)
            _insert(tree, leaf.path, view)
    return tree


def flops_params(leaves) -> int:
    """Weights a token's forward pass multiplies by (the model FLOPs of a
    token are twice this, besides attention)."""
    total = 0
    for leaf in leaves:
        if leaf.matmul:
            n = 1
            for s in leaf.shape:
                n *= s
            total += n
    return total
