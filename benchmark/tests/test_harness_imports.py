"""No module under benchmark/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

from __future__ import annotations

import ast

import pytest

from benchmark import harness as H

FILES = sorted(p for p in H.ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(H.ROOT)))
def test_no_jax(path):
    assert not set(_imports(path)) & set(H.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((H.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    allowed = {"__future__", "math", "torch", "benchmark"}
    assert set(_imports(path)) <= allowed
    text = path.read_text()
    assert "import nextgen_uia_tpu" not in text and "from nextgen_uia_tpu" not in text
    if "benchmark" in set(_imports(path)):  # only the references' shared plain pieces
        assert "from benchmark.reference._common import" in text


def test_forbidden_modules_compares_top_level_names_whole():
    import sys
    import types
    sys.modules["nextgen_uia_tpu_torch_probe"] = types.ModuleType("x")
    try:
        assert "nextgen_uia_tpu_torch_probe" not in H.forbidden_modules()
    finally:
        del sys.modules["nextgen_uia_tpu_torch_probe"]
