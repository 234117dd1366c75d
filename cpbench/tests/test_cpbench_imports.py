"""No module of the benchmark imports JAX or the JAX package, and the
yardstick's modules import nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# The plain reference and the yardstick's arithmetic: no part of the port.
YARDSTICK = ("reference.py", "check.py", "tensorgen.py", "leasttime.py",
             "devtrace.py")


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(HERE / name)


def test_whole_name_compare():
    # The port's name begins with the JAX package's: compared whole.
    assert "repro_torch" not in FORBIDDEN
