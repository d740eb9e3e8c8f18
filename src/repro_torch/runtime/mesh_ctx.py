"""Process-global mesh and policy context for sharding decisions made
inside the model (counterpart of ``repro/runtime/mesh_ctx.py``).

Model code (the attention layer's split-KV branch, the MoE dispatch's
expert-parallel placement) sometimes needs the concrete mesh; threading it
through every config would contaminate pure-model signatures, so the
launch factories and callers set it here around execution.
"""

from __future__ import annotations

from contextlib import contextmanager

_CURRENT: dict = {"mesh": None, "policy": "tp_fsdp", "multi_pod": False}


def set_mesh_ctx(mesh, policy: str = "tp_fsdp", multi_pod: bool = False):
    _CURRENT.update(mesh=mesh, policy=policy, multi_pod=multi_pod)


def clear_mesh_ctx():
    _CURRENT.update(mesh=None, policy="tp_fsdp", multi_pod=False)


@contextmanager
def mesh_ctx(mesh, policy: str = "tp_fsdp", multi_pod: bool = False):
    prev = dict(_CURRENT)
    set_mesh_ctx(mesh, policy, multi_pod)
    try:
        yield
    finally:
        _CURRENT.update(prev)


def current_mesh():
    return _CURRENT["mesh"]


def current_policy() -> str:
    return _CURRENT["policy"]


def data_axes_in_ctx():
    from repro_torch.runtime.sharding import data_axes

    return data_axes(_CURRENT["multi_pod"])
