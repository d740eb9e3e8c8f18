"""Checkpointing with atomic commit, retention, async writes and resume
(counterpart of ``repro/checkpoint/checkpoint.py``, same layout)::

    <dir>/step_000100/
        shard_00000.npz     one file per host (process_index): a0, a1, ...
        manifest.json       leaf names/shapes/dtypes
        COMMIT              empty marker written last (atomicity)

Leaves are stored in JAX's flattening order (:mod:`repro_torch.core.tree`)
under JAX's key-path names (``['params']/['layers']/[0]/['ln1']/['scale']``,
``['opt']/.count``), bf16 leaves as ``uint16`` views with ``bfloat16``
named in the manifest — the reference's layout, written with torch's own
bf16 view (no ``ml_dtypes``).  So a checkpoint the JAX package wrote reads
back here: :meth:`CheckpointManager.read` rebuilds its tree from the
manifest's names, and :func:`repro_torch.convert.convert_params` /
``convert_opt_state`` carry it into the port's layout.

Restore scans for the newest committed step; partially written
directories are skipped.  ``async_save=True`` copies the tree to the host
and hands the write to a background thread, one save in flight at a time;
an error of that write is raised by the next :meth:`~CheckpointManager.wait`.

A train state sharded over ranks (``DTensor`` leaves, as ``jit_train_step``
returns them on a mesh of processes, or any tree saved in a process group
of several ranks) is saved by every rank into the same step directory:

* each rank writes its own local shards as ``shard_{rank:05d}.npz`` (the
  rank from the default process group; a replicated leaf, such as AdamW's
  ``count``, is written by every rank as its local value);
* the manifest keeps the reference's keys (``names`` and rank 0's local
  ``shapes`` and ``dtypes``) and adds what a restore checks and places
  by: ``world_size``, the mesh's ``mesh_shape`` and ``axis_names``, and
  each leaf's ``global_shapes`` and ``specs`` (its ``PartitionSpec``, read
  from the placements; ``null`` for a plain tensor);
* the step is committed once, by rank 0, after every rank's shard is on
  disk.  Collectives belong to the main thread (the train step's are in
  flight there), so the writers agree through files: in :meth:`save`,
  on the main thread, rank 0 clears a stale ``.tmp`` directory and then
  broadcasts a token for this save, which every rank waits for before it
  writes.  Each rank's writer writes its shard, then a ``DONE_{rank:05d}``
  marker holding the token.  Rank 0's writer waits for every marker,
  removes them, writes the manifest and ``COMMIT``, renames the directory
  and removes the steps past ``keep``; then it writes the token into
  ``COMMIT``, which the other ranks' writers wait for.  So ``wait()``
  returns on every rank only once the step is committed and the old steps
  are gone (or raises after ``commit_timeout`` seconds), and ranks that
  restore after it see the same steps.  A step whose shards are not all
  there is never committed.

Restore on ranks reads only this rank's file and returns ``DTensor``s of
the saved placements and global shapes, on the mesh of the like-tree's
``DTensor`` leaves, or, where the like-tree holds whole tensors (a
supervisor's first call, before any step), on the ``(data, model)`` mesh of
the group's ranks that the manifest names
(:func:`repro_torch.launch.mesh.rank_mesh`).  A checkpoint of another world
size, mesh, placement or leaf count raises ``ValueError``: there is no
resharding on restore (the JAX package has none).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import uuid

import numpy as np
import torch

from repro_torch.core import tree as _tree

_POLL = 0.02  # s between looks at the step directory


def _name(path) -> str:
    """JAX's key-path string of a tree path."""
    parts = []
    for p in path:
        if isinstance(p, tuple):
            parts.append(f".{p[1]}")
        elif isinstance(p, int):
            parts.append(f"[{p}]")
        else:
            parts.append(f"[{p!r}]")
    return "/".join(parts)


def _to_host(t) -> tuple[np.ndarray, str]:
    """(host array, dtype name) of a copy of a tensor leaf (a CPU tensor is
    cloned too: a write to it after the save must not reach the file);
    bf16 as its uint16 bits."""
    t = torch.as_tensor(t).detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


_PART = re.compile(r"\[(?:'([^']*)'|(\d+))\]|\.(\w+)")


def _parse(name: str) -> list:
    """The path of a JAX key-path string: dict keys and NamedTuple fields
    as str, sequence indices as int."""
    out = []
    for part in name.split("/"):
        m = _PART.fullmatch(part)
        if m is None:
            raise ValueError(f"unreadable leaf name {name!r} in a manifest")
        key, idx, attr = m.groups()
        out.append(int(idx) if idx is not None else (key if key is not None else attr))
    return out


def _lists(node):
    """Nested dicts whose keys are all ints become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def _group() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _spec(t) -> list:
    """A ``DTensor``'s ``PartitionSpec`` as JSON: per tensor dim ``None``,
    the one mesh axis that shards it, or the list of them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DTensor leaf on a mesh without axis names cannot be checkpointed")
    spec = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            spec[p.dim % t.ndim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"a DTensor placed {p} (a partial value) cannot be checkpointed")
    return [None if not e else e[0] if len(e) == 1 else e for e in spec]


def _placements(spec, names) -> list:
    from repro_torch.runtime.sharding import P, placements

    return placements(P(*[tuple(e) if isinstance(e, list) else e for e in spec]), names)


def _rank_manifest(leaves, world: int) -> dict:
    """What a restore on ranks checks and places by: the world size, the
    mesh's shape and axis names (one mesh for every ``DTensor`` leaf), and
    each leaf's global shape and spec (``None`` for a plain tensor)."""
    meshes = {(tuple(t.device_mesh.shape), t.device_mesh.mesh_dim_names)
              for t in leaves if _is_dtensor(t)}
    if len(meshes) > 1:
        raise ValueError(f"a checkpoint holds DTensors of one mesh; this tree has {sorted(meshes)}")
    shape, names = next(iter(meshes), (None, None))
    return {
        "world_size": world,
        "mesh_shape": None if shape is None else list(shape),
        "axis_names": None if names is None else list(names),
        "global_shapes": [list(t.shape) for t in leaves],
        "specs": [_spec(t) if _is_dtensor(t) else None for t in leaves],
    }


def _put(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (a reader sees the old file or
    the new one)."""
    with open(path + ".part", "w") as f:
        f.write(text)
    os.replace(path + ".part", path)


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return None


def _await(ready, deadline: float, what: str) -> None:
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: {what} did not happen in time")
        time.sleep(_POLL)


class CheckpointManager:
    commit_timeout = 600.0  # s a writer waits for the other ranks' shards, or for the commit

    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, process_index: int | None = None, block: bool = False):
        """Write ``tree`` as step ``step``: on a background thread when the
        manager is async (after the host copy, made here), else now.  A
        tree with ``DTensor`` leaves, or any tree in a group of several
        ranks, is saved by rank (the module's docstring): every rank of the
        group calls ``save`` for the step, and ``process_index``, where
        given, must be the rank."""
        pairs = _tree.leaves_with_paths(tree)
        rank, world = _group()
        ranked = world > 1 or any(_is_dtensor(t) for _, t in pairs)
        if ranked and process_index not in (None, rank):
            raise ValueError(f"process_index {process_index} is not this process's rank {rank}")
        local = [(p, t.to_local() if _is_dtensor(t) else t) for p, t in pairs]
        host = [(_name(p), *_to_host(t)) for p, t in local]
        meta = _rank_manifest([t for _, t in pairs], world) if ranked else None
        self.wait()  # one in-flight save at a time
        if ranked:
            meta["token"] = self._begin(step, rank)
            args = (step, host, rank, meta)
        else:
            args = (step, host, process_index or 0, None)
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write_caught, args=args, daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def _begin(self, step: int, rank: int) -> str:
        """On the main thread of every rank: rank 0 clears a stale ``.tmp``
        of the step, then broadcasts this save's token; no rank writes
        before it has the token."""
        import torch.distributed as dist

        token = [None]
        if rank == 0:
            tmp_dir = os.path.join(self.dir, f"step_{step:08d}.tmp")
            if os.path.exists(tmp_dir):
                shutil.rmtree(tmp_dir)
            token = [uuid.uuid4().hex]
        dist.broadcast_object_list(token, src=0)
        return token[0]

    def wait(self):
        """Wait for the save in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_caught(self, *args):
        try:
            self._write(*args)
        except Exception as e:  # raised by the next wait()
            self._error = e

    def _write(self, step: int, host, process_index: int, meta):
        step_dir = os.path.join(self.dir, f"step_{step:08d}")
        tmp_dir = step_dir + ".tmp"
        if meta is None and os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)
        np.savez(os.path.join(tmp_dir, f"shard_{process_index:05d}.npz"),
                 **{f"a{i}": a for i, (_, a, _) in enumerate(host)})
        manifest = {
            "step": step,
            "names": [n for n, _, _ in host],
            "shapes": [list(a.shape) for _, a, _ in host],
            "dtypes": [d for _, _, d in host],
        }
        if meta is not None:
            token = meta.pop("token")
            deadline = time.monotonic() + self.commit_timeout
            commit = os.path.join(step_dir, "COMMIT")
            _put(os.path.join(tmp_dir, f"DONE_{process_index:05d}"), token)
            if process_index:
                _await(lambda: _read(commit) == token, deadline,
                       f"rank {process_index}: the commit of step {step}")
                return
            markers = [os.path.join(tmp_dir, f"DONE_{r:05d}") for r in range(meta["world_size"])]
            _await(lambda: all(_read(m) == token for m in markers), deadline,
                   f"rank 0: every rank's shard of step {step}")
            for m in markers:
                os.remove(m)
            manifest.update(meta)
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp_dir, step_dir)  # atomic publish
        self._gc()
        if meta is not None:  # the other ranks' writers wait for this
            _put(os.path.join(step_dir, "COMMIT"), token)

    def _gc(self):
        for s in self.committed_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)

    def _arrays(self, step: int, process_index: int) -> list:
        path = os.path.join(self.dir, f"step_{step:08d}", f"shard_{process_index:05d}.npz")
        with np.load(path) as z:
            return [z[f"a{i}"] for i in range(len(z.files))]

    def restore(self, step: int, like_tree, *, process_index: int | None = None):
        """The tree of step ``step`` in the structure, dtypes and devices of
        ``like_tree``'s leaves; a checkpoint saved by rank comes back as
        this rank's shards, placed as they were (the module's docstring)."""
        manifest = self._manifest(step)
        like = _tree.leaves(like_tree)
        if "world_size" in manifest:
            out = self._restore_ranked(step, manifest, like, process_index)
        else:
            arrays = self._arrays(step, process_index or 0)
            if len(arrays) != len(like):
                raise ValueError(f"checkpoint step {step} holds {len(arrays)} leaves, the tree "
                                 f"{len(like)}")
            like = [torch.as_tensor(l) for l in like]
            out = [_from_host(a, d).to(device=l.device, dtype=l.dtype)
                   for a, d, l in zip(arrays, manifest["dtypes"], like)]
        return _tree.unflatten_like(like_tree, out)

    def _restore_ranked(self, step: int, manifest: dict, like: list, process_index):
        from torch.distributed.tensor import DTensor

        rank, world = _group()
        if manifest["world_size"] != world:
            raise ValueError(f"checkpoint step {step} was saved by {manifest['world_size']} "
                             f"ranks; this group has {world}")
        if process_index not in (None, rank):
            raise ValueError(f"process_index {process_index} is not this process's rank {rank}")
        if len(manifest["specs"]) != len(like):
            raise ValueError(f"checkpoint step {step} holds {len(manifest['specs'])} leaves, the "
                             f"tree {len(like)}")
        arrays = self._arrays(step, rank)
        shape, names = manifest["mesh_shape"], manifest["axis_names"]
        out, mesh = [], None
        for a, d, spec, full, l in zip(arrays, manifest["dtypes"], manifest["specs"],
                                        manifest["global_shapes"], like, strict=True):
            if list(l.shape) != full:
                raise ValueError(f"checkpoint step {step} holds a leaf of shape {full} where the "
                                 f"tree has {list(l.shape)}")
            dev = l.to_local().device if _is_dtensor(l) else l.device
            t = _from_host(a, d).to(device=dev, dtype=l.dtype)
            if spec is None:
                out.append(t)
                continue
            pl = _placements(spec, names)
            if _is_dtensor(l):
                dm = l.device_mesh
                if [tuple(dm.shape), dm.mesh_dim_names, list(l.placements)] != [
                        tuple(shape), tuple(names), pl]:
                    raise ValueError(
                        f"checkpoint step {step} was saved on a {shape} {names} mesh placed "
                        f"{pl}; the tree's leaf lies on a {list(dm.shape)} "
                        f"{dm.mesh_dim_names} mesh placed {list(l.placements)} (no resharding "
                        "on restore)")
            else:
                if mesh is None:
                    mesh = _rank_device_mesh(shape, names, dev)
                dm = mesh
            out.append(DTensor.from_local(t, dm, pl, run_check=False, shape=torch.Size(full),
                                          stride=torch.empty(full, device="meta").stride()))
        return out

    def restore_latest(self, like_tree, *, process_index: int | None = None):
        """(step, tree) of the newest committed step, or (None, None); the
        save in flight is waited for first."""
        self.wait()
        steps = self.committed_steps()
        if not steps:
            return None, None
        return steps[-1], self.restore(steps[-1], like_tree, process_index=process_index)

    def read(self, step: int, *, process_index: int = 0):
        """The tree of step ``step`` rebuilt from the manifest's names alone
        (CPU tensors at the stored dtypes; NamedTuple fields as dict keys):
        what a checkpoint written by the JAX package holds; of a checkpoint
        saved by rank, rank ``process_index``'s local shards."""
        manifest, arrays = self._manifest(step), self._arrays(step, process_index)
        root: dict = {}
        for name, a, d in zip(manifest["names"], arrays, manifest["dtypes"], strict=True):
            node, path = root, _parse(name)
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _from_host(a, d)
        return _lists(root)


def _rank_device_mesh(shape, names, device):
    """The ``DeviceMesh`` of the group's ``(data, model)`` rank mesh of
    ``shape`` on ``device``'s kind, the one the sharded steps place on."""
    from repro_torch.launch.mesh import AXES, rank_mesh

    if tuple(names) != AXES or len(shape) != 2:
        raise ValueError(f"a whole like-tree restores onto a (data, model) mesh of ranks; the "
                         f"checkpoint's is {shape} {names}: pass DTensor leaves on it")
    return rank_mesh(f"{shape[0]}x{shape[1]}", device).device_mesh()
