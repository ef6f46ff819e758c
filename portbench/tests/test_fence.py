"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: every import statement of every
file, read with ast, by its top-level name compared whole (the port's name
begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

from portbench import harness

PB = Path(__file__).resolve().parents[1]
FILES = sorted(PB.rglob("*.py"))


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not top_names(path) & {"jax", "jaxlib", "flax", "stemgnn_tpu"}


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_reference_imports_nothing_of_the_program(path):
    assert "stemgnn_tpu_torch" not in top_names(path)


def test_fence_is_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "stemgnn_tpu_torch_like",
                        types.ModuleType("stemgnn_tpu_torch_like"))
    assert harness.FENCED == ("jax", "jaxlib", "flax", "stemgnn_tpu")
    assert harness.fenced_modules() == []
    monkeypatch.setitem(sys.modules, "stemgnn_tpu.ops", types.ModuleType("stemgnn_tpu.ops"))
    assert harness.fenced_modules() == ["stemgnn_tpu"]


def test_emit_refuses_a_fenced_module(monkeypatch, capsys):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    rc = harness.emit({"correct": True, "checks": {}})
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jaxlib" in out.err
