"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port: an AST walk of every file, each
import's top-level name compared whole."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mj_envs_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH)
               for f in fs if f.endswith(".py"))


def imports(path):
    """(level, top-level name or '') of every import in `path`."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield node.level, (node.module or "").split(".")[0]


def test_files_found():
    assert any(p.endswith("run.py") for p in FILES)
    assert any(os.sep + "reference" + os.sep in p for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    bad = [m for lvl, m in imports(path) if lvl == 0 and m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_whole_names_compared():
    # mj_envs_torch begins with the JAX package's name and is not it.
    assert "mj_envs_torch".split(".")[0] not in FORBIDDEN


REF = [p for p in FILES if os.sep + "reference" + os.sep in p]


@pytest.mark.parametrize("path", REF, ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    ref_root = os.path.join(BENCH, "reference")
    depth = os.path.relpath(os.path.dirname(path), ref_root).count(os.sep) \
        + (0 if os.path.dirname(path) == ref_root else 1)
    for lvl, m in imports(path):
        if lvl == 0:
            assert m not in {"mj_envs_torch", "benchmark"}, (path, m)
        else:   # a relative import stays inside reference/
            assert lvl <= depth + 1, (path, lvl, m)
