"""The port stands alone: importing ``repro_torch`` (every module under it)
loads neither ``jax`` nor the JAX package ``repro`` and builds no kernel,
and no source file of the port or ``chip_smoke.py`` imports them."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "from repro_torch.kernels import _build\n"
        "print(len(bad), bad[:5], _build.last_build())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # nothing of JAX loaded, and no kernel built: that happens at the first
    # launch on a CUDA tensor, never at import
    assert out.stdout.strip() == "0 [] None", out.stdout


SOURCES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_sources_do_not_import_jax_or_repro(path):
    text = (ROOT / path).read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    assert not pat.search(text), path


def test_dense_serve_without_cuda_raises():
    """``launch.serve --cache dense`` defaults to the card and raises where
    there is none (CUDA hidden here), unless ``--device cpu`` is given."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--cache", "dense", "--smoke",
         "--requests", "1", "--gen-len", "1"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "needs CUDA" in out.stderr
