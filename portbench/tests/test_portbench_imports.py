"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), and the
reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
import run  # noqa: E402  (portbench/run.py)


def imported_tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_top_level_names_compared_whole(monkeypatch):
    fake = {"repro_torch": object(), "repro_torch.models": object(), "reprox": object()}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert run.loaded_forbidden() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"repro.kernels": object()}))
    assert run.loaded_forbidden() == ["repro"]
    monkeypatch.setattr(sys, "modules", {"jax": 1, "jaxlib.xla": 1, "flax": 1})
    assert run.loaded_forbidden() == ["flax", "jax", "jaxlib"]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported_tops(path) <= {"__future__", "dataclasses", "math", "torch", "portbench"}
    text = path.read_text()
    assert "repro_torch" not in text and "portbench.core" not in text


def test_a_run_loads_no_jax():
    """What a run imports, the program included, in a fresh process."""
    code = ("import sys; sys.path[:0] = ['src', '.']; import portbench.core.bench, "
            "portbench.reference.mla_lm, portbench.reference.gqa_lm, portbench.sessions.paged, "
            "portbench.sessions.dense; import repro_torch.runtime.serve_loop, "
            "repro_torch.models.model_zoo; sys.path.insert(0, 'portbench'); import run; "
            "print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/: no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "dsv2mla-paged-decode-3k", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
