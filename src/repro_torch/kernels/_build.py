"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source is compiled to an object by its own ``nvcc`` process, all
started together, then linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The build runs at first use (never at
import), into ``build/repro_torch/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "mla_decode_paged.cu", "mla_decode_combine.cu", "mla_decode.cu",
    "gqa_decode.cu", "flash_prefill.cu", "mla_decode_paged_padded.cu",
)
HEADERS = ("amla.cuh", "mla_rows.cuh", "mla_rows_mma.cuh", "paged_rows.cuh", "gqa_rows.cuh")
# No --use_fast_math: the AMLA state update needs the accurate expf and
# IEEE division.  -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libamla_kernels.so"


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: pathlib.Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas resource usage), empty when cached


_lib: ctypes.CDLL | None = None
_build_result: BuildResult | None = None


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use on a machine with the CUDA toolkit"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile ``csrc/`` into the shared library unless it is built."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return BuildResult(lib, 0.0, "")
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {name} ==\n{out}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log.append(f"== link ==\n{link.stdout}")
    if link.returncode:
        raise RuntimeError("linking the CUDA kernels failed:\n" + "\n".join(log))
    tmp.replace(lib)
    return BuildResult(lib, time.perf_counter() - t0, "\n".join(log))


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with its C
    signatures declared."""
    global _lib, _build_result
    if _lib is not None:
        return _lib
    _build_result = build()
    lib = ctypes.CDLL(str(_build_result.path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    signatures = {
        "amla_mla_decode_paged_queue": [p] * 14 + [i] * 9 + [f, f] + [i] * 3 + [p],
        "amla_mla_decode_paged_padded": [p] * 6 + [i] * 7 + [f, f] + [i] * 3 + [p],
        "amla_combine_split_partials": [p] * 7 + [i] * 5 + [p],
        "amla_mla_decode_rows": [p] * 5 + [i] * 6 + [ll, f, f] + [i] * 3 + [p],
        "amla_gqa_decode": [p] * 7 + [i] * 7 + [ll] * 6 + [f, f] + [i] * 3 + [p],
        "amla_flash_prefill": [p] * 5 + [i] * 7 + [ll] * 6 + [f, f] + [i] * 4 + [p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.amla_mla_rows_mma_smem.argtypes = [i] * 6
    lib.amla_mla_rows_mma_smem.restype = ll
    lib.amla_gqa_rows_mma_smem.argtypes = [i] * 3
    lib.amla_gqa_rows_mma_smem.restype = ll
    lib.amla_error_string.argtypes = [i]
    lib.amla_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def last_build() -> BuildResult | None:
    """The build (or cache hit) that :func:`load` used, if it ran."""
    return _build_result


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(
            f"{what} failed: CUDA error {err} "
            f"({lib.amla_error_string(err).decode()})"
        )
