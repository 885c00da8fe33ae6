"""No module of the benchmark imports JAX or the JAX package; the reference
and the generator import nothing of the program either.  Names are compared
by their top-level part (before the first dot), whole."""
import ast
import os

import pytest

SVBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "volcanosv_tpu"}


def _modules():
    for d, _sub, files in os.walk(SVBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, SVBENCH))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_reference_and_generator_import_nothing_of_the_program(sub):
    for d, _s, files in os.walk(os.path.join(SVBENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(d, f)))
                assert "volcanosv_tpu_torch" not in names, f
                assert not names & NEVER, f


def test_the_top_level_name_is_compared_whole():
    # the port's name begins with the JAX package's, and is allowed
    assert "volcanosv_tpu_torch".split(".", 1)[0] not in NEVER
