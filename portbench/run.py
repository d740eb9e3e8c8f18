"""Run one cell of the port's benchmark once, on the machine it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each number compared beside its limit
(also the last lines of standard error).  Exits nonzero, with no result,
without enough CUDA devices, without the program beside it, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ.setdefault("USE_FLAX", "0")
    from portbench.core import bench, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); {n} found",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program (src/repro_torch) is not here: {e}", file=sys.stderr)
        return 4
    result, ctx = bench.run(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 5
    parts = ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_parts.items())
    print(f"portbench: set-up {ctx.setup_s:.3f} s ({parts}); peak "
          f"{result['device']['memory_peak_bytes'] / 2**30:.2f} GiB", file=sys.stderr)
    q = sorted(ctx.step_s)
    print(f"portbench: {ctx.tokens_compared} served tokens compared in {ctx.check_s:.3f} s; window "
          f"{ctx.window_s:.3f} s, {ctx.steps} steps of min {1e3 * q[0]:.3f} / median "
          f"{1e3 * q[len(q) // 2]:.3f} / max {1e3 * q[-1]:.3f} ms", file=sys.stderr)
    if ctx.traced is not None:
        t = ctx.traced
        print(f"portbench: traced stretch {t.steps} steps in {t.window_s:.4f} s "
              f"({1e3 * t.window_s / t.steps:.3f} ms a step), device busy {t.busy_s:.4f} s",
              file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
