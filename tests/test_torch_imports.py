"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` never
import JAX or the reference package ``repro``."""

import ast
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "src")
_PORT = os.path.join(_SRC, "repro_torch")


def _port_files():
    for dirpath, _, names in os.walk(_PORT):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported_modules(path: str) -> set[str]:
    """Every module an ``import`` statement anywhere in the file names
    (function-local imports included)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module or "")
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, _SRC))
def test_port_sources_name_neither(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, bad


def test_chip_smoke_names_neither():
    path = os.path.join(_ROOT, "chip_smoke.py")
    mods = _imported_modules(path)
    assert not sorted(m for m in mods if _forbidden(m))
    assert any(m.startswith("repro_torch") for m in mods)
