"""Meshes (counterpart of ``repro/launch/mesh.py``): the training and
dry-run meshes ``make_production_mesh`` and ``make_debug_mesh``, and the
serving mesh ``parse_mesh_spec`` / ``make_serving_mesh``.

A :class:`Mesh` is a plain value with the faces of a JAX ``Mesh`` that the
spec functions and the sessions read (``devices``, ``axis_names``,
``shape``).  Single-controller code (the sharded serving sessions, the
split-KV decode of :mod:`repro_torch.core.distributed`) runs one body per
entry on that entry's device; entries may repeat one device (logical
shards on one card, every entry on the CPU).  Placing tensors across
ranks goes through :meth:`Mesh.device_mesh`, a
``torch.distributed.DeviceMesh`` of the same shape and axis names, which
exists only when the process group's world size equals the mesh's size:
the production meshes (256 or 512 entries) are layouts that the spec
functions read here, and run only on a machine with that many cards.
:func:`init_local_process_group` makes the one-rank group that a 1 x 1
mesh places on (a ``HashStore``, so no port is opened);
:func:`init_process_group` joins a group of several ranks (one process
each, as ``torchrun`` starts them) and :func:`rank_mesh` lays a mesh over
its ranks, on which the sharded steps run rank-locally
(:func:`repro_torch.runtime.sharding.local_run`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = AXES

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_mesh(self):
        """The ``torch.distributed.DeviceMesh`` over ranks ``0 .. size - 1``
        of the default process group, with this mesh's shape and axis
        names (made once per process group).  Raises ``RuntimeError``
        unless a process group of world size ``size`` is initialized."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size() if dist.is_initialized() else None
        if world != self.size:
            raise RuntimeError(
                f"placing tensors on a {'x'.join(map(str, self.devices.shape))} mesh needs "
                f"a process group of world size {self.size}; "
                + ("none is initialized" if world is None else f"this one has {world}")
                + " (init_local_process_group() for a 1 x 1 mesh)")
        key = (dist.group.WORLD, self.devices.flat[0].type, self.devices.shape, self.axis_names)
        if key not in _DEVICE_MESHES:
            _DEVICE_MESHES[key] = init_device_mesh(
                key[1], tuple(self.devices.shape), mesh_dim_names=self.axis_names)
        return _DEVICE_MESHES[key]


_DEVICE_MESHES: dict = {}


def init_local_process_group(device="cuda") -> None:
    """A world-size-1 default process group on a ``torch.distributed
    .HashStore`` (gloo for the CPU, nccl for CUDA), unless one exists: what
    a 1 x 1 mesh places on.  Opens no port."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def init_process_group(backend: str, *, rank: int | None = None,
                       world_size: int | None = None, store=None,
                       device="cuda") -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device: ``cuda:{LOCAL_RANK % device_count}``, or
    the CPU when ``device`` says so.  What is not given is read from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
    ``MASTER_ADDR`` / ``MASTER_PORT`` for the rendezvous unless a
    ``store`` is given, e.g. a ``torch.distributed.FileStore``).

    ``backend`` is never chosen here: ``"nccl"`` for one card per rank,
    ``"gloo"`` for the CPU and for ranks that share one card (NCCL refuses
    two ranks on one device)."""
    import os

    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: pick 'nccl' or 'gloo'")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {"store": store}
    if store is None:
        kw = {"init_method": f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"}
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return dev


def rank_mesh(spec: str, device="cuda") -> Mesh:
    """A ``DxM`` ``(data, model)`` mesh over the process group's ranks,
    row-major (rank ``r`` at ``np.unravel_index(r, (D, M))``, as
    ``init_device_mesh`` lays them): entry ``r`` is ``cuda:{r %
    device_count}`` (several ranks may share a card) or the CPU.  Raises
    unless the group's world size is ``D * M``."""
    import torch.distributed as dist

    shape = parse_mesh_spec(spec)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != shape[0] * shape[1]:
        raise RuntimeError(f"mesh {spec!r} needs a process group of world size "
                           f"{shape[0] * shape[1]}; " + ("none is initialized" if world is None
                                                         else f"this one has {world}"))
    return _mesh(shape, AXES, device)


def _mesh(shape, axes, device) -> Mesh:
    """A ``shape`` mesh over ``device``'s kind: rank ``i``'s card is
    ``cuda:i`` modulo the cards this host sees (one process per card), or
    the CPU in every entry."""
    dev = resolve_device(device)
    devs = np.empty(shape, dtype=object)
    if dev.type == "cpu":
        devs.fill(torch.device("cpu"))
    else:
        local = torch.cuda.device_count()
        for i in range(devs.size):
            devs.flat[i] = torch.device("cuda", i % local)
    return Mesh(devs, axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """``(data 16, model 16)``, or ``(pod 2, data 16, model 16)`` with
    ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return _mesh(shape, axes, device)


def make_debug_mesh(device="cuda") -> Mesh:
    """1 x 1 ``(data, model)`` mesh for one-device runs of the same code
    paths."""
    return _mesh((1, 1), AXES, device)


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """Parse a ``DxM`` serving-mesh spec ("2x1", "4x2") into (data, model)."""
    parts = str(spec).lower().split("x")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        dims = []
    if len(dims) != 2 or any(d < 1 for d in dims):
        raise ValueError(
            f"bad mesh spec {spec!r}: expected DxM with positive integers, "
            "e.g. '2x1' (2 data shards) or '2x2' (2 shards x 2-way heads)"
        )
    return dims[0], dims[1]


def make_serving_mesh(spec: str = "1x1", device="cuda") -> Mesh:
    """A ``(data, model)`` mesh of ``spec`` for sharded paged serving
    (``data`` counts page-pool shards, ``model`` head groups within a
    shard) over ``device``'s kind: distinct cards ``cuda:0 ..`` (raising,
    with a remediation hint, when fewer are visible than the spec needs),
    or the CPU in every entry."""
    data, model = parse_mesh_spec(spec)
    kind = resolve_device(device).type
    if kind == "cuda" and torch.cuda.device_count() < data * model:
        raise ValueError(
            f"mesh {spec!r} needs {data * model} devices but only "
            f"{torch.cuda.device_count()} are visible; on one card run logical shards "
            "instead (ShardedPagedServingSession(shards=, head_shards=) with "
            "mesh=None), or pick a smaller mesh"
        )
    return _mesh((data, model), AXES, kind)


def logical_mesh(shape: dict[str, int], device="cuda") -> Mesh:
    """A mesh of ``shape`` (axis name -> size) whose every entry is
    ``device``: logical shards on one card (or the CPU), run one body after
    another by single-controller code.  It places nothing across ranks."""
    dev = resolve_device(device)
    devs = np.empty(tuple(shape.values()), dtype=object)
    devs.fill(dev)
    return Mesh(devs, tuple(shape))
