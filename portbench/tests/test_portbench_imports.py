"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: module names compared by their
whole first component (``repro_torch`` begins with ``repro``)."""

import ast
from pathlib import Path

import pytest

from portbench.spec import HERE

JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """The top-level names a file imports (relative imports left out:
    they stay inside ``portbench``)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_a_reference_apart_from_the_port(path):
    names = set(imported(path))
    assert not names & JAX, f"{path} imports {names & JAX}"
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in names, f"{path} imports the port"


def test_the_walk_sees_every_form(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import jax.numpy\nfrom repro.x import y\n"
                 "import importlib\n"
                 "importlib.import_module('flax.linen')\n"
                 "from repro_torch import a\nfrom . import b\n")
    assert set(imported(p)) == {"jax", "repro", "importlib", "flax",
                                "repro_torch"}
