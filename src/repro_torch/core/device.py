"""Explicit device selection for the port's entry points.

The port never falls back silently: an entry point asked for CUDA on a
machine without it raises, and the CPU is used only when the caller names
it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but
    absent (pass ``device="cpu"`` to run the plain PyTorch versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs CUDA, which is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
