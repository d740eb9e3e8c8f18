"""Qwen2-VL backbone positions (counterpart of ``repro/models/vlm.py``;
the vision tower is a stub: the caller supplies patch embeddings).

The backbone is the standard GQA decoder of
:mod:`repro_torch.models.transformer` with **M-RoPE**
(:func:`repro_torch.models.layers.mrope`): the rotary frequencies are
split into (temporal, height, width) sections, each rotated by its own
position component.  Patch embeddings occupy the first ``n_vision``
positions (``lm_apply(embeds_override=...)``); text tokens get equal
(t, h, w) positions continuing after the image grid (arXiv:2409.12191).
"""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device


def mrope_positions(
    batch: int,
    seq_len: int,
    n_vision: int,
    *,
    grid_hw: tuple[int, int] | None = None,
    offset=None,  # (B,) or scalar decode offset: host value or tensor
    device=None,
) -> torch.Tensor:
    """Build ``(3, B, S)`` int32 M-RoPE position ids.

    Vision tokens ``[0, n_vision)`` use (t=0, h=row, w=col) over an
    (H, W) grid (square-ish when ``grid_hw`` is None); text tokens
    continue with t = h = w = ``max(H, W) + i``.  ``offset`` is added to
    every component.  The positions are built on ``device`` (default: the
    device of a tensor ``offset``, else the card) from the shapes alone: a
    tensor ``offset`` is never read back to the host, so a decode step
    that stages its cache lengths in a tensor can be captured in a CUDA
    graph.
    """
    if device is None:
        device = offset.device if isinstance(offset, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    if n_vision:
        if grid_hw is None:
            side = max(int(n_vision**0.5), 1)
            grid_hw = (side, (n_vision + side - 1) // side)
        gh, gw = grid_hw
        idx = torch.arange(n_vision, **i32)
        vis_t = torch.zeros((n_vision,), **i32)
        vis_h, vis_w = idx // gw, idx % gw
        text_start = int(max(gh, gw))
    else:
        vis_t = vis_h = vis_w = torch.zeros((0,), **i32)
        text_start = 0
    text = text_start + torch.arange(seq_len - n_vision, **i32)
    pos = torch.stack([torch.cat([vis_t, text]), torch.cat([vis_h, text]),
                       torch.cat([vis_w, text])])  # (3, S)
    pos = pos[:, None, :].expand(3, batch, seq_len)
    if offset is not None:
        off = torch.as_tensor(offset, device=dev).to(torch.int32).reshape(-1)
        pos = pos + off.expand(batch)[None, :, None]
    return pos
