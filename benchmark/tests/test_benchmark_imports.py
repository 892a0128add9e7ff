"""Nothing of the benchmark imports JAX or the JAX package, compared by
each import's whole top-level name; the reference imports nothing of the
port either."""

import ast
from pathlib import Path

import pytest

from benchmark.card import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_whole_name_is_compared():
    assert "shift_gcn_torch" not in FORBIDDEN
    assert "shift_gcn_tpu" in FORBIDDEN
    names = {"shift_gcn_torch.models", "jaxtyping", "jax_helpers"}
    assert not {n.split(".")[0] for n in names} & set(FORBIDDEN)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "shift_gcn_torch" not in top_level_imports(path)
    imported = top_level_imports(path) - {"__future__", "benchmark", "math",
                                          "contextlib",
                                          "typing", "numpy", "torch"}
    assert not imported, imported


def test_the_drivers_do_reach_the_port():
    # the check must not trip on the port's name, which the drivers import
    assert any("shift_gcn_torch" in (m.read_text())
               for m in (BENCH / "drivers").glob("*.py"))


def test_runtime_check_sees_only_whole_names(monkeypatch):
    import sys
    import types

    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    monkeypatch.setitem(sys.modules, "shift_gcn_tpux",
                        types.ModuleType("shift_gcn_tpux"))
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.np"))
    assert "jax" in forbidden_modules()
