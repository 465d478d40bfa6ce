"""The port's packaging: ``pyproject.toml`` names every package directory
of ``aim_tpu_torch`` and ships the sources its kernels and oracle are
built from, so that a wheel built from the tree runs as the tree does."""

import fnmatch
import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setuptools():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]


def _port_packages():
    found = set()
    for root, dirs, files in os.walk(os.path.join(REPO, "aim_tpu_torch")):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        if "__init__.py" in files:
            found.add(os.path.relpath(root, REPO).replace(os.sep, "."))
    return found


def test_package_lists_every_subpackage():
    """Every package directory of the port is in ``packages`` (the wheel
    once lacked ``aim_tpu_torch.parallel``, which ``cli.py`` imports)."""
    found = _port_packages()
    assert {"aim_tpu_torch", "aim_tpu_torch.parallel"} <= found
    assert found - set(_setuptools()["packages"]) == set()


def test_package_data_ships_every_build_source():
    """Every CUDA and C++ source under the port matches a ``package-data``
    glob of its package, so an installed port can build its kernels and
    its oracle."""
    data = _setuptools()["package-data"]
    packages = _port_packages()
    sources = []
    for root, dirs, files in os.walk(os.path.join(REPO, "aim_tpu_torch")):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        sources += [os.path.join(root, f) for f in files
                    if f.endswith((".cu", ".cuh", ".cpp"))]
    assert any(s.endswith(".cu") for s in sources)
    for path in sources:
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        owners = [p for p in packages
                  if rel.startswith(p.replace(".", "/") + "/")]
        owner = max(owners, key=len)
        inside = rel[len(owner) + 1:]
        assert any(fnmatch.fnmatch(inside, g) for g in data.get(owner, [])), \
            rel
