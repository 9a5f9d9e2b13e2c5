"""The port stands alone: no JAX, nothing of the reference package.

Every ``repro_torch`` module imports in a fresh interpreter where
``jax``, ``repro``, ``msgpack`` and ``ml_dtypes`` cannot be imported (the
GPU machine has neither of the last two), and a scan of the sources (and
of ``chip_smoke.py``, the port's examples and its A/B serve script) finds no import
of jax or repro.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "examples" / "quickstart_torch.py",
                                         ROOT / "examples" / "serve_cluster_torch.py",
                                         ROOT / "examples" / "train_small_torch.py",
                                         ROOT / "scripts" / "ab_serve_torch.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_reference(path):
    assert path.exists(), path
    bad = [name for name in _imported_names(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _imported_modules(path: Path, package: str):
    """Every module an ``import`` anywhere in ``path`` names (function
    bodies included), relative imports resolved against ``package``, and
    each ``from m import name`` also as ``m.name``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            yield base
            yield from (f"{base}.{alias.name}" for alias in node.names)


KERNEL_SOURCES = sorted((PORT / "kernels").rglob("*.py"))


@pytest.mark.parametrize("path", KERNEL_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_kernels_import_nothing_of_the_models(path):
    """The kernels are the bottom layer: their plain versions live in
    ``kernels/ref.py``, so no module under ``kernels/`` reaches up into
    ``repro_torch.models``, at module level or inside a function."""
    bad = [name for name in _imported_modules(path, "repro_torch.kernels")
           if name == "repro_torch.models" or name.startswith("repro_torch.models.")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
