"""What a cell is, found by name: the benchmark's spec, a workload's
configuration, traffic and limits, and the readers of its per-layer
metrics; the look for JAX in the process; the card's clocks and power."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mcmc_tpu")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str) -> dict:
    """The workload's entry, configuration, traffic, limits and the
    per-layer metrics it reports."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = end_to_end(spec, workload)
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in e2e)]
    return dict(workload=w, cfg=cfg, traffic=traffic,
                limits=limits["limits"], e2e=e2e, per_layer=per_layer)


def end_to_end(spec: dict, workload: str) -> dict:
    """{name: metric} of the end-to-end metrics the workload reports."""
    return {m["name"]: m for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])}


def metric_reader(name: str):
    """The ``read(view)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def query_gpu() -> dict:
    """The card's name, SM clock, power draw and limit and temperature, by
    nvidia-smi; empty where it does not answer."""
    keys = ("name", "clocks.sm", "power.draw", "power.limit",
            "temperature.gpu")
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    line = proc.stdout.strip().splitlines()[:1]
    if proc.returncode or not line:
        return {}
    return dict(zip(keys, (v.strip() for v in line[0].split(","))))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
