"""PyTorch + CUDA port of the AMLA serving stack (``repro``) for Hopper.

Mirrors ``repro``'s module names so each counterpart is easy to find.  The
paged MLA decode path is ported: configs, AMLA numerics, the decode work
queue, the paged AMLA decode kernel and its split-KV combine (hand-written
CUDA for ``sm_90a`` under ``csrc/``), the layered paged KV cache, the MLA
model's paged prefill/decode and the paged serving session.

Nothing here imports ``jax`` or ``repro``.  Entry points default to
``device="cuda"`` and raise when CUDA is absent; the CPU is used only when
a caller passes ``device="cpu"`` (the CPU tests do).
"""
