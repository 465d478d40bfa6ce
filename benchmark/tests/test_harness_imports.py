"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the
program."""

import ast
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
BANNED = {"jax", "jaxlib", "flax", "aim_tpu"}


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "tests")]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere_in_the_harness():
    for path in _sources():
        found = _top_names(path) & BANNED
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = _top_names(path)
        assert "aim_tpu_torch" not in names, path
        # plain NumPy, and the harness's own frozen work counts
        assert names <= {"numpy", "re", "__future__", "roofline"}, \
            (path, names)


def test_whole_name_comparison():
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["aim_tpu_torch_extra"] = sys   # a prefix is no match
        assert run.banned_modules() == []
        sys.modules["aim_tpu.api"] = sys
        assert run.banned_modules() == ["aim_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_that_loaded_jax_prints_no_result(capsys):
    import run
    saved = dict(sys.modules)
    sys.modules["jax"] = sys
    try:
        rc = run.main(["--workload", "wfa100.file", "--seed", "1",
                       "--seconds", "0.1", "--trace", "0", "--rehearse",
                       "--pairs", "64"])
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    out = capsys.readouterr()
    assert rc != 0
    assert "jax" in out.err
    assert out.out.strip() == ""
