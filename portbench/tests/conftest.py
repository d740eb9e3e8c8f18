"""The benchmark's tests run from the checkout's root: the program from
``src``, the benchmark as the ``portbench`` package."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
