"""The benchmark stands apart from the reference package and from JAX: no
module of the harness, its readers or its references imports ``jax``,
``jaxlib``, ``flax`` or ``repro`` (top-level names compared whole:
``repro_torch`` is the program), the references import nothing of the
program either, and nothing reads the JAX package's ``benchmarks/``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
SOURCES = sorted(p for p in PB.rglob("*.py") if "out" not in p.relative_to(PB).parts)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_reference_package(path):
    bad = {"jax", "jaxlib", "flax", "repro"} & set(_imports(path))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PB / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not {"repro_torch", "repro", "portbench"} & set(_imports(path))


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in SOURCES + sorted(PB.rglob("*.json")):
        if "tests" in path.relative_to(PB).parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "'benchmarks'" not in text, path


def test_the_module_check_compares_whole_names():
    from portbench import harness

    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jaxlib.xla", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                           "qwen2.5-3b.longdoc", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
