"""The T2 initial beds on the upstream's native 900² grid
(``crf900.initbeds``, configuration ``t2-900``): the cell at a size the
CPU runs in seconds is judged correct and its bfloat16 control not, a bed
broken underneath is not correct, and the configuration is ``t2-512``'s
but for its name, its grid and that nothing is reduced."""

import importlib
import json
import time

import pytest

from conftest import ROOT
from test_cardbench_faults import _loop_half, _loop_unwritten

from cardbench import core, run

CELL = "crf900.initbeds"


def test_the_cell_is_correct_and_its_control_not(small):
    c = small(CELL, grid=64)
    assert c["cfg"]["name"] == "t2-900"
    out = run.run_cell(c, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(),
                       control=True)
    checks = out["result"]["checks"]
    assert out["result"]["correct"], checks
    assert out["result"]["failed"] == 0
    assert set(out["result"]["metrics"]) == {"initbed_cells_per_s",
                                             "setup_s"}
    failed = [k for k, v in out["control_checks"].items()
              if v["value"] > v["limit"]]
    assert failed, out["control_checks"]


@pytest.mark.parametrize("fault", ["unwritten", "half", "altered"])
def test_a_broken_bed_of_the_cell_is_not_correct(small, monkeypatch, fault):
    sgs_mod = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
    if fault == "altered":
        sgs = sgs_mod.sgs
        monkeypatch.setattr(sgs_mod, "sgs",
                            lambda *a, **k: sgs(*a, **k) + 1.0)
    else:
        loops = sgs_mod._chunk_loops
        wrap = _loop_unwritten if fault == "unwritten" else _loop_half
        monkeypatch.setattr(sgs_mod, "_chunk_loops", lambda device: (
            wrap(loops(device)[0]), loops(device)[1]))
    out = run.run_cell(small(CELL, grid=64), 2**31 + 9, 0.3, False, "cpu",
                       time.perf_counter())
    assert not out["result"]["correct"], out["result"]["checks"]
    assert out["result"]["failed"] > 0


def test_t2_900_is_t2_512_at_the_native_grid():
    spec = core.load_spec()
    files = {c["name"]: c for c in spec["configs"]}
    native = json.loads((ROOT / files["t2-900"]["file"]).read_text())
    cut = json.loads((ROOT / files["t2-512"]["file"]).read_text())
    assert {k for k in native.keys() | cut.keys()
            if native.get(k) != cut.get(k)} == {"name", "grid", "reduced"}
    assert (native["name"], native["grid"], native["reduced"]) == (
        "t2-900", 900, {})
    assert files["t2-900"]["reduced"] == []
    assert core.cell(spec, CELL)["cfg"] == native
