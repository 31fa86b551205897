"""Nothing the benchmark runs loads JAX or the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import imports

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.core.hashing", True),
    ("repro_torch", False), ("repro_torch.core", False),
    ("jaxtyping", False), ("reprodata", False), ("numpy", False)])
def test_whole_top_level_names(name, bad):
    assert bool(imports.forbidden([name])) == bad


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = imports.forbidden(_imported(path))
        assert not found, f"{path.name} imports {found}"
        assert "benchmarks" not in _imported(path), path.name


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "generator.py", "peaks.py"):
        assert not {"repro_torch", "torch"} & _imported(HERE / name), name


def test_a_run_loads_neither():
    """Import the harness, a driver and the program in a fresh process:
    the check passes on what is loaded."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from portbench import harness, imports\n"
            "from portbench.drivers import rounds\n"
            "import repro_torch.protocol, repro_torch.kernels.ops\n"
            "print(imports.forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a
    run exits with another code than 0 and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "eth-state.catchup", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
