"""Nothing of JAX on the card: the whole-name check of loaded modules, and
the reference importing nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = {"artalk_tpu_torch": 1, "artalk_tpu_torch.engine": 1, "jaxtyping": 1,
            "flaxen": 1, "numpy": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "artalk_tpu",
                 "artalk_tpu.engine"):
        monkeypatch.setattr(sys, "modules", dict(fake, **{name: 1}))
        assert harness.forbidden_modules() == [name.split(".")[0]]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_program_or_jax():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.lstrip(".").split(".")[0]
            assert top not in ("artalk_tpu_torch", "artalk_tpu", "jax", "jaxlib", "flax"), \
                (path.name, name)
            assert not name.startswith("benchmark") and not name.startswith(".."), \
                (path.name, name)


def test_harness_files_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.lstrip(".").split(".")[0] not in ("jax", "jaxlib", "flax", "artalk_tpu")


def test_a_run_without_cuda_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is here: a run would measure")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mesh-offline-exact",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
