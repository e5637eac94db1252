"""Import hygiene of the port: no file of hpfrec_tpu_torch imports jax or
the JAX package hpfrec_tpu."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "hpfrec_tpu_torch"
FILES = sorted(PKG.rglob("*.py"))


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_package_has_files():
    assert len(FILES) >= 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_hpfrec_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top != "jax", f"{path.name} imports {mod}"
        assert top not in ("jaxlib", "hpfrec_tpu"), f"{path.name} imports {mod}"


def test_chip_smoke_imports_no_jax():
    path = PKG.parent / "chip_smoke.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "hpfrec_tpu"), mod
