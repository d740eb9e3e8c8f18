"""JAX's threefry2x32 random keys and uniform draws in plain torch integer
ops, bit for bit (``jax.random`` with ``jax_threefry_partitionable``, the
default since jax 0.5).

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words.
Every word is kept in int64 and masked to 32 bits after each addition and
rotation: torch's ``uint32`` lacks most arithmetic on the CPU and CUDA
both.  The draws are made on the key's device from the same integer ops,
so a key on the card draws on the card.

- :func:`prng_key` is ``jax.random.PRNGKey`` (``threefry_seed`` of a
  32-bit seed);
- :func:`fold_in` is ``jax.random.fold_in``:
  ``threefry2x32(key, (0, data))``;
- :func:`split` is ``jax.random.split``: key ``i`` is the hash of the
  counter ``(0, i)``;
- :func:`random_bits` hashes each element's row-major flat index, split
  into its ``(hi, lo)`` words, and xors the two output words;
- :func:`uniform` is ``jax.random.uniform`` at float32.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 22  # elements hashed at a time: bounds the int64 temporaries


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; int64 tensors or ints holding uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & M32, (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX makes it without x64: the seed
    taken as a 32-bit integer, words ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``, ``data`` a uint32 value."""
    b1, b2 = threefry2x32(key[0], key[1], 0, int(data) & M32)
    return torch.stack([b1, b2])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64, values below 2^32),
    as ``jax.random.bits(key, shape, uint32)`` draws them."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=key.device)
    for s in range(0, n, _CHUNK):
        idx = torch.arange(s, min(s + _CHUNK, n), dtype=torch.int64, device=key.device)
        b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
        out[s:s + idx.numel()] = b1 ^ b2
    return out.view(tuple(shape))


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), less 1, scaled to
    ``[minval, maxval)`` and held at ``minval`` from below."""
    mant = (random_bits(key, shape) >> 9) | 0x3F800000  # below 2^31: fits int32
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    width = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, floats * width + lo)
