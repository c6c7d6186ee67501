"""Running the examples for the port's example tests.

``run_port`` runs one of the PyTorch port's examples
(``examples/torch_port/``) on the CPU (``--device cpu``) in a subprocess
whose interpreter blocks JAX and the JAX package: a meta-path finder makes
any import of ``jax``, ``jaxlib`` or ``mcmc_tpu`` raise before the example
is run with ``runpy.run_path``.  (A ``None`` in ``sys.modules["jax"]``
would block it too, but scipy's array-API helpers read that entry and
fail on it.)  The port's runs use two OpenMP threads.  ``run_jax`` runs
one of the JAX package's examples (``examples/``) on the CPU as
``tests/test_examples_pipeline.py`` does.  Both scrub the environment
(no pre-imported JAX), run from the repo root, and return the stdout of a
run that exited 0.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = ROOT / "examples" / "torch_port"
TIMEOUT = 600  # s, one example

BLOCK_JAX = """
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mcmc_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
"""


def _env(out_dir, quick):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS",
                        "MCMC_TPU_EXAMPLE_QUICK", "MCMC_TPU_EXAMPLE_OUT")}
    env.update(PYTHONPATH=str(ROOT), MPLBACKEND="Agg",
               MCMC_TPU_EXAMPLE_OUT=str(out_dir))
    if quick:
        env["MCMC_TPU_EXAMPLE_QUICK"] = "1"
    return env


def port_process(name, out_dir, *args, quick=True):
    """The finished subprocess of the port's example ``name`` with
    ``args`` (no ``--device``: pass it in ``args``)."""
    env = _env(out_dir, quick)
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, str(PORT_EXAMPLES / name), *args],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=str(ROOT),
        env=env)


def run_port(name, out_dir, quick=True):
    """stdout of the port's example ``name`` run with ``--device cpu``."""
    out = port_process(name, out_dir, "--device", "cpu", quick=quick)
    assert out.returncode == 0, (name, out.stdout, out.stderr[-3000:])
    return out.stdout


def run_jax(name, out_dir, quick=True):
    """stdout of the JAX package's example ``name`` on the CPU."""
    env = _env(out_dir, quick)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name)],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=str(ROOT),
        env=env)
    assert out.returncode == 0, (name, out.stdout, out.stderr[-3000:])
    return out.stdout


def stats_line(stdout, prefix):
    """The JSON of the ``{prefix} STATS {...}`` line."""
    m = re.search(re.escape(prefix) + r" STATS (\{.*\})", stdout)
    assert m, f"no '{prefix} STATS' line in:\n{stdout}"
    return json.loads(m.group(1))
