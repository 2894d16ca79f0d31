"""Nothing under knnbench/ imports JAX or the JAX package ``repro``
(compared by whole top-level name: ``repro_torch`` is not ``repro``), and
the yardstick imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from knnbench.run import forbidden_modules
from knnbench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: modules that may not import the program either
YARDSTICK = ("reference.py", "datagen.py", "compare.py", "roofline.py",
             "trace.py", "spec.py")
FILES = sorted(p for p in HERE.rglob("*.py"))


def _top_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_reference_package(path):
    assert not (_top_names(path) & FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in _top_names(HERE / name)


def test_forbidden_modules_compares_whole_names():
    ok = ["repro_torch", "repro_torch.api", "numpy", "jaxtyping", "reprox"]
    assert forbidden_modules(ok) == []
    assert forbidden_modules(ok + ["repro.core"]) == ["repro"]
    assert forbidden_modules(["jax._src", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
