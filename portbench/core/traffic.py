"""What every traffic kind (``drivers/<kind>.py``) draws its requests
with: lengths and prompt tokens from a traffic file's parameters and a
seed.

Every seed gets the same set of lengths (the quantiles of the stated
distribution at ``(i + 0.5) / n``), in an order the seed draws, and its own
prompt tokens; so two seeds do the same amount of work and differ only in
what is computed.
"""

from __future__ import annotations

import numpy as np


def lengths(dist: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``dist``
    (``uniform`` on ``[lo, hi]``)."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] != "uniform":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(round(lo + (i + 0.5) / n * (hi - lo))) for i in range(n)]


def prompts(dist: dict, n: int, seed: int, vocab: int) -> list[np.ndarray]:
    """``n`` prompts (int64 token ids) with the lengths of ``dist``, in the
    seed's order, with the seed's tokens."""
    rng = np.random.default_rng(seed)
    plens = rng.permutation(lengths(dist, n))
    # token 0 pads the dense session's prompts; real ids start at 2
    return [rng.integers(2, vocab, size=int(p), dtype=np.int64) for p in plens]
