"""The PyTorch port imports neither JAX nor the JAX package.

Importing any ``mcmc_tpu`` module imports jax (``mcmc_tpu/__init__.py``),
so the port must stay clear of both: on the GPU machine it runs without
them.  Checked twice: by importing the port in a fresh interpreter, and by
reading the import statements of every file that runs there.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mcmc_tpu_torch"
# files that run on a machine without JAX: the package, the chip smoke
# script, the card tests with their helpers and the ranks' workers
NO_JAX_FILES = sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tests/test_torch_cuda.py", "tests/torch_helpers.py",
       "tests/torch_dist.py"])

IMPORT_ALL = """
import importlib, pkgutil, sys
import mcmc_tpu_torch
import mcmc_tpu_torch.cli
import mcmc_tpu_torch.drivers
import mcmc_tpu_torch.io.checkpoint
import mcmc_tpu_torch.models.chain_crf
import mcmc_tpu_torch.models.chain_sgs
import mcmc_tpu_torch.ops.cg_kernel
import mcmc_tpu_torch.ops.covariance
import mcmc_tpu_torch.ops.kriging
import mcmc_tpu_torch.ops.lut_kernel
import mcmc_tpu_torch.ops.noise_kernel
import mcmc_tpu_torch.ops.sgs_window_kernel
import mcmc_tpu_torch.ops.transforms
import mcmc_tpu_torch.parallel.distributed
import mcmc_tpu_torch.parallel.grid_sharded
import mcmc_tpu_torch.parallel.mesh
import mcmc_tpu_torch.parallel.sampler
import mcmc_tpu_torch.utils.progress
for m in pkgutil.walk_packages(mcmc_tpu_torch.__path__, "mcmc_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mcmc_tpu"))
print(len([m for m in sys.modules if m.startswith("mcmc_tpu_torch")]))
print(",".join(bad))
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split("\n")[:2]
    assert int(n_modules) >= 29
    assert bad == "", f"imported: {bad}"


def _imported_roots(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", NO_JAX_FILES)
def test_file_imports_no_jax(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "mcmc_tpu"}, (path, roots)


PACKAGE_ONLY = """
import sys
import mcmc_tpu_torch
print(",".join(n for n in ("ops", "models", "geostats", "parallel", "io",
                           "utils") if not hasattr(mcmc_tpu_torch, n)))
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "mcmc_tpu"))))
"""


def test_package_import_binds_the_subpackages_without_jax():
    """``import mcmc_tpu_torch`` alone binds the reference's subpackages
    (``mcmc_tpu/__init__.py:30``: ops, models, geostats, parallel, io,
    utils) and still loads neither JAX nor the JAX package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", PACKAGE_ONLY], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    unbound, bad = out.stdout.split("\n")[:2]
    assert unbound == "", f"not bound: {unbound}"
    assert bad == "", f"imported: {bad}"


NEW_MODULES = """
import sys
import mcmc_tpu_torch
print(int("matplotlib" in sys.modules))
import mcmc_tpu_torch.geostats, mcmc_tpu_torch.utils.plotting
import mcmc_tpu_torch.ops.neighbors, mcmc_tpu_torch.ops.kriging
from mcmc_tpu_torch.models import RandField
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mcmc_tpu"))
print(int("matplotlib" in sys.modules))
print(",".join(bad))
"""


def test_geostats_and_plotting_import_without_jax_or_matplotlib():
    """``geostats`` and ``utils/plotting`` are the port's own copies: they
    import no JAX, and neither they nor the package import matplotlib
    (the card's machine has none; ``plotting`` imports it when it
    draws)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", NEW_MODULES], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    after_package, after_all, bad = out.stdout.split("\n")[:3]
    assert (after_package, after_all) == ("0", "0")
    assert bad == "", f"imported: {bad}"


BLOCKED = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mcmc_tpu", "pandas",
                                  "xarray", "pyproj"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import mcmc_tpu_torch
print(int("mcmc_tpu_torch.data" in sys.modules))
import mcmc_tpu_torch.ops.srf, mcmc_tpu_torch.ops.srf_kernel
import mcmc_tpu_torch.data
from mcmc_tpu_torch.data import interpolate, make_grid
coords, cols, rows = make_grid(0.0, 1000.0, 0.0, 500.0, 500.0)
print(cols, rows, float(interpolate("kneighbors", [0.0, 1.0], [0.0, 1.0],
                                    [2.0, 4.0], [0.1], [0.1])[0]))
try:
    mcmc_tpu_torch.data.load_radar("nowhere", "out.csv")
except ImportError as e:
    print("gated:", "pandas" in str(e))
"""


def test_srf_and_data_import_with_jax_and_pandas_blocked():
    """``ops/srf.py`` and the ``data`` subpackage import with JAX, the JAX
    package, pandas, xarray and pyproj all blocked: the data layer's
    optional dependencies load only in the functions that need them, and
    ``import mcmc_tpu_torch`` does not import ``data``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:3] == ["0", "3 2 2.0", "gated: True"]
