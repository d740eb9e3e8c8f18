"""The serving mesh (counterpart of ``repro/launch/mesh.py``'s
``parse_mesh_spec`` and ``make_serving_mesh``).

A ``(data, model)`` mesh for sharded paged serving: ``data`` counts page
pool shards (each owns a slice of the request stream), ``model`` counts
tensor-parallel head groups within a shard.  Serving places whole
sessions from one controller, so the mesh is a plain value with the faces
of a JAX ``Mesh`` that serving reads (``devices``, ``axis_names``,
``shape``) and no process group.  On the CPU every entry is the one CPU
device (the counterpart of the reference's forced host devices); on CUDA
the entries are distinct cards.  The reference's ``make_production_mesh``
and ``make_debug_mesh`` (training's meshes) are not ported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """``devices``: a ``(data, model)`` object array of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = AXES

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))


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


def make_serving_mesh(spec: str = "1x1", device="cuda") -> ServingMesh:
    """A ``(data, model)`` mesh of ``spec`` over ``device``'s kind: distinct
    cards ``cuda:0 ..`` (raising, with a remediation hint, when fewer are
    visible than the spec needs), or the CPU in every entry."""
    data, model = parse_mesh_spec(spec)
    kind = resolve_device(device).type
    devs = np.empty((data, model), dtype=object)
    if kind == "cpu":
        devs.fill(torch.device("cpu"))
        return ServingMesh(devs)
    avail = torch.cuda.device_count()
    if avail < data * model:
        raise ValueError(
            f"mesh {spec!r} needs {data * model} devices but only {avail} "
            "are visible; on one card run logical shards instead "
            "(ShardedPagedServingSession(shards=, head_shards=) with "
            "mesh=None), or pick a smaller mesh"
        )
    for i in range(data * model):
        devs.flat[i] = torch.device(kind, i)
    return ServingMesh(devs)
