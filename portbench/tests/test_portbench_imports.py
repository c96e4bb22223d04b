"""What the benchmark may import: nothing under `portbench/` (its tests
aside) imports JAX or the JAX package, top-level names compared whole,
and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "sift_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path) -> set:
    """Top-level module names that `path` imports anywhere in its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "sift_tpu_torch" not in imported(path)
    assert imported(path) <= {"__future__", "dataclasses", "math", "numpy",
                              "torch", "portbench"}


def test_whole_names_compared():
    # the port's name begins with the JAX package's; only whole names match
    assert "sift_tpu_torch" not in BANNED
    assert imported(HERE / "steps" / "pair.py") >= {"sift_tpu_torch"}


def test_judges_and_yardstick_import_no_program():
    for sub in ("judges", "lib", "inputs", "metrics", "e2e"):
        for path in (HERE / sub).glob("*.py"):
            assert "sift_tpu_torch" not in imported(path), path
