"""What the benchmark imports, by whole top-level module name: no module
of mmbench imports jax, jaxlib, flax or the JAX package minimodem_tpu (a
different name from minimodem_tpu_torch, which starts with it), and the
plain reference imports nothing of minimodem_tpu_torch either."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "minimodem_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not _imports(path) & (FORBIDDEN | {"minimodem_tpu_torch"})


def test_whole_names():
    """minimodem_tpu_torch is not the JAX package, though its name starts
    with it."""
    assert "minimodem_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "minimodem_tpu.ops".split(".")[0] in FORBIDDEN
