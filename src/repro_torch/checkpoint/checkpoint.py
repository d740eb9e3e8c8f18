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
and hands the write to a background thread, one save in flight at a time.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.core import tree as _tree


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


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, process_index: int = 0, block: bool = False):
        """Write ``tree`` as step ``step``: on a background thread when the
        manager is async (after the host copy, made here), else now."""
        host = [(_name(p), *_to_host(leaf)) for p, leaf in _tree.leaves_with_paths(tree)]
        if self.async_save and not block:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, host, process_index), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, process_index)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host, process_index: int):
        step_dir = os.path.join(self.dir, f"step_{step:08d}")
        tmp_dir = step_dir + ".tmp"
        if os.path.exists(tmp_dir):
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
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp_dir, step_dir)  # atomic publish
        self._gc()

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

    def _load(self, step: int, process_index: int):
        step_dir = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(step_dir, f"shard_{process_index:05d}.npz")) as z:
            arrays = [z[f"a{i}"] for i in range(len(z.files))]
        return manifest, arrays

    def restore(self, step: int, like_tree, *, process_index: int = 0):
        """The tree of step ``step`` in the structure, dtypes and devices of
        ``like_tree``'s leaves."""
        manifest, arrays = self._load(step, process_index)
        like = [torch.as_tensor(l) for l in _tree.leaves(like_tree)]
        if len(arrays) != len(like):
            raise ValueError(f"checkpoint step {step} holds {len(arrays)} leaves, the tree "
                             f"{len(like)}")
        out = [_from_host(a, d).to(device=l.device, dtype=l.dtype)
               for a, d, l in zip(arrays, manifest["dtypes"], like)]
        return _tree.unflatten_like(like_tree, out)

    def restore_latest(self, like_tree, *, process_index: int = 0):
        """(step, tree) of the newest committed step, or (None, None)."""
        steps = self.committed_steps()
        if not steps:
            return None, None
        return steps[-1], self.restore(steps[-1], like_tree, process_index=process_index)

    def read(self, step: int, *, process_index: int = 0):
        """The tree of step ``step`` rebuilt from the manifest's names alone
        (CPU tensors at the stored dtypes; NamedTuple fields as dict keys):
        what a checkpoint written by the JAX package holds."""
        manifest, arrays = self._load(step, process_index)
        root: dict = {}
        for name, a, d in zip(manifest["names"], arrays, manifest["dtypes"], strict=True):
            node, path = root, _parse(name)
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _from_host(a, d)
        return _lists(root)
