"""The benchmark's spec and files: everything is found by name, names and
units keep to their characters, each metric moves a metric its cells
report, the roofline counts give the kernel table's bounds, no run loads
JAX or the JAX package, and no run falls back to the CPU."""

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT

from cardbench import core, roofline

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cardbench"]
    assert SPEC["command"][1].startswith("cardbench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    entries = SPEC[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        for key in e.get("reduced", ()):
            assert NAME.match(key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    c = core.cell(SPEC, workload)
    w = c["workload"]
    conf = {x["name"]: x for x in SPEC["configs"]}[w["config"]]
    assert conf["file"].startswith("cardbench/configs/")
    assert c["cfg"]["name"] == w["config"]
    assert (ROOT / "cardbench" / f"{c['traffic']['kind']}.py").exists()
    assert "setup_s" in c["e2e"] and len(c["e2e"]) >= 2
    assert c["per_layer"], workload
    for name in c["limits"]:
        assert NAME.match(name)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_and_agrees(metric):
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    assert callable(core.metric_reader(metric).read)
    for w in m["workloads"]:
        assert m["moves"] in core.end_to_end(SPEC, w), (metric, w)


def test_every_config_used_and_reduced_keys_exist():
    used = {w["config"] for w in SPEC["workloads"]}
    for conf in SPEC["configs"]:
        assert conf["name"] in used
        cfg = json.loads((ROOT / conf["file"]).read_text())
        for key in conf["reduced"]:
            assert key in cfg and key in cfg["reduced"]


def test_roofline_bounds_match_the_kernel_table():
    """PERF.md's kernel table: the window update's bound 0.0188 ms for
    63.1 MB, the window extract's 0.0169 ms for 56.8 MB, the writeback's
    0.0063 ms for 21.0 MB (by bytes), the mixture CG's 0.0031 ms at 512
    chains, K = 48, 64 iterations and 7 terms (by operations)."""
    for mb, ms in ((63.1, 0.0188), (56.8, 0.0169), (21.0, 0.0063)):
        # the table gives the megabytes to 0.1
        lo, by = roofline.bound_s((mb - 0.05) * 1e6)
        hi, _ = roofline.bound_s((mb + 0.05) * 1e6)
        assert by == "bytes"
        assert round(lo * 1e3, 4) <= ms <= round(hi * 1e3, 4)
    t, by = roofline.bound_s(*roofline.mixture_cg_work(512, 48, 64, 7))
    assert (round(t * 1e3, 4), by) == (0.0031, "operations")


def test_window_bytes_counts_each_byte_once():
    """Closed form: N interior 80 x 80 blocks, none accepted, apart; then
    the same blocks all accepted."""
    H = W = 512
    centres = [(100, 100), (100, 300), (300, 100), (300, 300)]
    block = np.array([[r, c, 80, 80] for r, c in centres])
    none = roofline.window_bytes(block, np.zeros(4), H, W)
    window, blk = 82 * 82, 80 * 80
    const = 3 * 4 * window + 3 * 4 * blk
    per_chain = window + blk + blk
    assert none == 4.0 * (const + 4 * per_chain + blk + 4 * 18)
    every = roofline.window_bytes(block, np.ones(4), H, W)
    assert every - none == 4.0 * 4 * 4 * blk


def test_covered_cells_against_painting():
    rng = np.random.default_rng(3)
    H, W = 40, 50
    r0 = rng.integers(-2, H, 30)
    c0 = rng.integers(-2, W, 30)
    r1 = r0 + rng.integers(-3, 12, 30)
    c1 = c0 + rng.integers(-3, 12, 30)
    r0, c0 = np.maximum(r0, 0), np.maximum(c0, 0)
    r1, c1 = np.minimum(r1, H), np.minimum(c1, W)
    paint = np.zeros((H, W), bool)
    for a, b, c, d in zip(r0, r1, c0, c1):
        paint[a:b, c:d] = True
    assert roofline.covered_cells(r0, r1, c0, c1, H, W) == paint.sum()


def test_a_run_loads_neither_jax_nor_the_jax_package(small):
    """A whole run of a cell, in a fresh process, leaves no module whose
    top-level name is jax, jaxlib, flax or mcmc_tpu (the port's name
    begins with the JAX package's, so names are compared whole)."""
    code = (
        "import sys, time; sys.path.insert(0, %r); "
        "sys.path.insert(0, %r); "
        "from conftest import small_cell; from cardbench import core, run; "
        "[run.run_cell(small_cell(w), 1, 0.2, t, 'cpu', time.perf_counter())"
        " for w in ('crf900.farm', 'sgs900.farm') for t in (False, True)]; "
        "print(core.forbidden_modules()); "
        "print(sorted(m for m in sys.modules if m.startswith('mcmc_tpu_torch'))[:1])"
    ) % (str(ROOT), str(ROOT / "cardbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['mcmc_tpu_torch']"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcmc_tpu_torch_like", sys)
    assert "mcmc_tpu_torch_like" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in core.forbidden_modules()


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "crf900.farm",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no fallback to the CPU" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_on_the_card(workload):
    """A 2 s run of each cell on the card ends with its JSON result line,
    the checks last, judged correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert time.time() - t0 < 1200
