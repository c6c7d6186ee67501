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
# script and the card tests with their helpers
NO_JAX_FILES = sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tests/test_torch_cuda.py", "tests/torch_helpers.py"])

IMPORT_ALL = """
import importlib, pkgutil, sys
import mcmc_tpu_torch
import mcmc_tpu_torch.models.chain_crf
import mcmc_tpu_torch.parallel.sampler
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
    assert int(n_modules) >= 15
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
