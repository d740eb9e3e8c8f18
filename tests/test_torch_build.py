"""The kernel build covers every CUDA source of the port, on the CPU (no
nvcc needed: only the lists of sources and the build's cache key)."""

import shutil

from repro_torch.kernels import _build


def test_build_lists_every_cuda_source():
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    listed = set(_build.SOURCES) | set(_build.HEADERS)
    assert len(_build.SOURCES) + len(_build.HEADERS) == len(listed)
    assert listed == on_disk
    assert all(name.endswith(".cu") for name in _build.SOURCES)
    assert all(name.endswith(".cuh") for name in _build.HEADERS)


def test_source_hash_follows_every_source(tmp_path, monkeypatch):
    """An edit to any source or header changes the cache key, so the next
    load rebuilds."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    seen = {_build.source_hash()}
    for name in _build.SOURCES + _build.HEADERS:
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        seen.add(_build.source_hash())
    assert len(seen) == 1 + len(_build.SOURCES) + len(_build.HEADERS)
