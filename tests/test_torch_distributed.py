"""The port's multi-GPU layer with real ranks on the CPU.

Each job starts gloo ranks (``tests/torch_dist.py``: torchrun's variables,
a scrubbed environment, a free port with one retry, every rank under a
kill timeout, no JAX in any worker) and the tests here hold what the ranks
wrote against one-rank runs of the same calls in this process:

- the sharded farm of both families, int-seeded and seed-listed: the first
  step's draws bitwise, the gathered traces to rtol 1e-6 (the beds, which
  carry the drift of the CPU's batched ``irfft2``, to rtol 1e-5 / atol
  1e-3), every rank holding the same traces;
- an indivisible chain count refused;
- ``run_with_checkpointing`` at 2 ranks, 20 then 40 iterations, bitwise a
  2-rank 40 straight and close to the one-rank 40, with the shard files
  and the marker; a 2-rank checkpoint resumed on 1 rank; a set without
  its marker or a file not seen, a same-iteration set retracted by a
  one-rank save;
- the CLI at 2 ranks for both families, rank 0 alone printing;
- ``global_chains_grid_mesh``'s layout and refusals, and
  ``make_sharded_crf_chains`` at (2 x 2) against (2 x 1) and at (1 x 4)
  against (1 x 1), with blocks crossing shard boundaries and blocks
  spanning three shards, under the JAX package's own gates
  (``tests/test_parallel.py:277-283``).

The JAX package's parity of the grid step is in
``test_torch_grid_sharded.py``.
"""

import json
import re

import numpy as np
import pytest
import torch

from mcmc_tpu_torch.io.checkpoint import CheckpointManager
from mcmc_tpu_torch.parallel import (chains_grid_mesh, chains_mesh,
                                     global_chains_mesh,
                                     initialize_distributed)
from tests import torch_dist as td

TRACE_RTOL = 1e-6
BED_TOL = dict(rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def farm_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("farm")
    td.launch("farm", 2, out)
    return out


@pytest.fixture(scope="module")
def grid_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("grid")
    td.launch("grid", 4, out)
    return out


def _ranks(out, name, n=2):
    return [dict(np.load(out / f"{name}.rank{k}.npz")) for k in range(n)]


def _close(got, want, key):
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key.endswith("bed_thin"):
        np.testing.assert_allclose(got, want, err_msg=key, **BED_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=TRACE_RTOL, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("family", ["crf", "sgs"])
@pytest.mark.parametrize("seeding", list(td.SEEDS))
def test_two_rank_farm_is_the_one_rank_farm(farm_job, family, seeding):
    draws, traces, fields, _ = td.farm_run(family, seeding)
    ranks = _ranks(farm_job, f"farm_{family}_{seeding}")
    assert [tuple(r["rows"]) for r in ranks] == [(0, 2), (2, 4)]
    for key, want in draws.items():  # each rank drew its chains' rows
        got = np.concatenate([r["draw_" + key] for r in ranks])
        np.testing.assert_array_equal(got, want, err_msg=key)
    for key, want in traces.items():
        for r in ranks[1:]:  # every rank holds the same gathered traces
            np.testing.assert_array_equal(r["trace_" + key],
                                          ranks[0]["trace_" + key])
        assert ranks[0]["trace_" + key].shape == want.shape
        _close(ranks[0]["trace_" + key], want, key)
    np.testing.assert_allclose(np.concatenate([r["fields"] for r in ranks]),
                               fields, **BED_TOL)


def test_indivisible_chain_count_refused(farm_job):
    for k in range(2):
        text = (farm_job / f"refused.rank{k}.txt").read_text()
        assert re.search(r"n_chains=3 is not divisible by the 2 ranks",
                         text), text


def test_shard_chains_keeps_a_ranks_rows(farm_job):
    """A divisible leading batch is cut to the rank's contiguous rows;
    other leaves (an indivisible batch, a scalar) stay whole; ``replicate``
    keeps everything whole on the rank's device."""
    for k in range(2):
        z = np.load(farm_job / f"shard.rank{k}.npz")
        np.testing.assert_array_equal(
            z["batch"], np.arange(8.0).reshape(4, 2)[2 * k:2 * k + 2])
        np.testing.assert_array_equal(z["odd"], np.arange(3))
        np.testing.assert_array_equal(z["pair"], np.arange(3 * k, 3 * k + 3))
        assert float(z["scalar"]) == 2.5
        np.testing.assert_array_equal(z["whole"],
                                      np.arange(8.0).reshape(4, 2))


def test_incomplete_checkpoint_sets_are_invisible(farm_job, tmp_path):
    """A set without its marker, or with a rank's file missing, is not a
    checkpoint: the directory then holds none."""
    import shutil

    src = farm_job / "ckpt_resumed_crf_int"
    for drop in (f"checkpoint_{td.CKPT_ITERS[1]}.ok",
                 f"checkpoint_{td.CKPT_ITERS[1]}.proc1of2.npz"):
        d = tmp_path / drop
        shutil.copytree(src, d)
        (d / drop).unlink()
        assert CheckpointManager(d).latest_iter() is None
        assert CheckpointManager(d).load(device="cpu") is None
    assert CheckpointManager(src).latest_iter() == td.CKPT_ITERS[1]


def test_single_save_retracts_a_same_iteration_set(farm_job, tmp_path):
    """A one-rank save at the iteration of a sharded set removes the set
    (marker first) before its own file appears, so the two layouts never
    coexist; the saved state is the one read back."""
    import shutil

    d = tmp_path / "resaved"
    shutil.copytree(farm_job / "ckpt_resumed_crf_int", d)
    mgr = CheckpointManager(d)
    it, states, _, meta = mgr.load(device="cpu")
    gen = (meta["rng_kind"], meta["rng_state"])
    mgr.save(it, states, gen, meta={"grid_hw": meta["grid_hw"]})
    names = sorted(p.name for p in d.iterdir()
                   if p.name.startswith("checkpoint_"))
    assert names == [f"checkpoint_{it}.npz"], names
    again = mgr.load(device="cpu")
    assert again[0] == it and torch.equal(again[1].fields, states.fields)
    np.testing.assert_array_equal(again[3]["rng_state"], meta["rng_state"])


@pytest.mark.parametrize("family", ["crf", "sgs"])
@pytest.mark.parametrize("seeding", list(td.SEEDS))
def test_two_rank_checkpoints_resume(farm_job, tmp_path, family, seeding):
    """20 then 40 at 2 ranks (``CKPT_ITERS``): the shard files and the
    marker, bitwise the 2-rank 40 straight, close to the 1-rank 40; and
    the 2-rank checkpoint at 20 resumed to 40 on 1 rank, close to the
    same."""
    tag = f"{family}_{seeding}"
    resumed = _ranks(farm_job, f"ckpt_resumed_{tag}")
    straight = _ranks(farm_job, f"ckpt_straight_{tag}")
    names = {p.name for p in (farm_job / f"ckpt_resumed_{tag}").rglob("*")}
    last = td.CKPT_ITERS[1]
    assert {f"checkpoint_{last}.proc0of2.npz", f"checkpoint_{last}.proc1of2.npz",
            f"checkpoint_{last}.ok"} <= names, names
    man = CheckpointManager(farm_job / f"ckpt_resumed_{tag}").manifest()
    assert [c["layout"] for c in man["checkpoints"]] == ["sharded"]
    for a, b in zip(resumed, straight):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    hist, fields = td.ckpt_run(family, seeding, tmp_path / "one", last)
    for key, want in hist.items():
        _close(resumed[0]["hist_" + key], want, key)
    one_fields = np.concatenate([r["fields"] for r in resumed])
    np.testing.assert_allclose(one_fields, fields, **BED_TOL)
    # the 2-rank set at the first count, resumed on this one rank
    hist_1, fields_1 = td.ckpt_run(family, seeding,
                                   farm_job / f"ckpt_half_{tag}", last)
    for key, want in hist.items():
        _close(hist_1[key], want, key)
    np.testing.assert_allclose(fields_1, fields, **BED_TOL)


def _write_cli(out):
    """The problem and a config of each family for the CLI job."""
    p = td.farm_problem()
    np.savez(out / "dataset.npz", **{k: p[k] for k in (
        "xx", "yy", "initial_bed", "surf", "velx", "vely", "dhdt", "smb",
        "cond_bed", "data_mask", "grounded", "region")},
        resolution=p["resolution"])
    common = {"dataset": "dataset.npz",
              "update_region": {"in_region": True, "mask": "region"},
              "loss": {"sigma_mc": 5.0}}
    crf = {"family": "crf", **common, "crf": {
        "randfield": {"range_min_x": 3e3, "range_max_x": 8e3,
                      "range_min_y": 3e3, "range_max_y": 8e3,
                      "scale_min": 20.0, "scale_max": 60.0,
                      "nugget_max": 0.0, "model_name": "Matern",
                      "isotropic": True, "smoothness": 1.3},
        "blocks": {"min_block_x": 8, "max_block_x": 12, "min_block_y": 8,
                   "max_block_y": 12, "steps": 3},
        "weight": {"L": 2.0, "x0": 0.0, "k": 6.0, "offset": 1.0,
                   "max_dist": 5e3}}}
    sgs = {"family": "sgs", **common, "sgs": {
        "variogram": {"vtype": "Matern", "range": 2.5e3, "sill": 1.0,
                      "nugget": 0.0, "smoothness": 1.3},
        "params": {"num_neighbors": 48, "search_radius": 30e3},
        "blocks": {"min_x": 5, "max_x": 12, "min_y": 5, "max_y": 12},
        "trend": {"gaussian_sigma": 10.0},
        "normal_transform": {"n_quantiles": 500}}}
    for cfg, seeds in ((crf, 11), (sgs, [21, 22, 23, 24])):
        fam = cfg["family"]
        cfg["farm"] = {"n_chains": 4, "n_iter": 16, "rng_seeds": seeds,
                       "segment_size": 8, "output_path": f"run_{fam}"}
        cfg["save"] = {"final_beds": f"{fam}_beds.npy",
                       "histories": f"{fam}_hist.npz"}
        (out / f"{fam}.json").write_text(json.dumps(cfg))


def test_cli_at_two_ranks(tmp_path):
    """The CLI as torchrun would start it, at 2 ranks, against the same
    CLI alone: rank 0's files, the sharded checkpoint and its marker."""
    from mcmc_tpu_torch import cli

    two, one = tmp_path / "two", tmp_path / "one"
    for d in (two, one):
        d.mkdir()
        _write_cli(d)
    logs = td.launch("cli", 2, two)
    # one writer: rank 0 alone prints the progress, banner and summary
    for text, printed in zip(logs, (True, False)):
        for line in ("[sampler] iter", "chain farm complete",
                     "[mcmc-tpu-torch] loss:"):
            assert (line in text) is printed, (line, text[-2000:])
    for fam in ("crf", "sgs"):
        assert cli.main([str(one / f"{fam}.json"), "--device", "cpu",
                         "--quiet"]) == 0
        got = np.load(two / f"{fam}_hist.npz")
        want = np.load(one / f"{fam}_hist.npz")
        for key in want.files:
            _close(got[key], want[key], key)
        np.testing.assert_allclose(np.load(two / f"{fam}_beds.npy"),
                                   np.load(one / f"{fam}_beds.npy"),
                                   **BED_TOL)
        names = {p.name for p in (two / f"run_{fam}").rglob("*")}
        assert {"checkpoint_16.proc0of2.npz", "checkpoint_16.proc1of2.npz",
                "checkpoint_16.ok"} <= names, names


def test_grid_mesh_layout_and_refusals(grid_job):
    for k in range(4):
        layout = json.loads((grid_job / f"layout.rank{k}.json").read_text())
        assert layout["shape"] == {"chains": 2, "grid": 2}
        assert layout["ranks"] == [[0, 1], [2, 3]]
        assert layout["coords"] == [k // 2, k % 2]
        assert [m.split(" not divisible")[0] for m in layout["refused"]] == [
            "4 ranks", "4 ranks"], layout["refused"]


def _grid_one_rank(case):
    """A grid case's chains on a one-rank (1 x 1) mesh, no process group:
    the (2 x 1) and (1 x 1) references at once (chains exchange
    nothing)."""
    return td.grid_run(case, chains_grid_mesh(1, 1, device="cpu"))


@pytest.mark.parametrize("case", list(td.GRID_CASES))
def test_sharded_grid_matches_one_shard(grid_job, case):
    """The reference's gates: steps equal, loss rtol 1e-5, bed rtol 1e-5 /
    atol 1e-3; the chains moved."""
    n_c, n_g, n_chains = td.GRID_CASES[case]
    beds1, loss1, steps1 = _grid_one_rank(case)
    ranks = _ranks(grid_job, f"grid_{case}", 4)
    per = n_chains // n_c
    for r in ranks:
        c, g = (int(v) for v in r["coords"])
        rows = slice(c * per, (c + 1) * per)
        np.testing.assert_array_equal(r["steps"], steps1[rows])
        np.testing.assert_allclose(r["losses"], loss1[rows], rtol=1e-5)
        H = beds1.shape[-2]
        np.testing.assert_allclose(
            r["beds"], beds1[rows, g * H // n_g:(g + 1) * H // n_g],
            rtol=1e-5, atol=1e-3)
    assert steps1.sum() > 0
    if n_chains > 1:  # different draws, different chains
        assert not np.allclose(loss1[0], loss1[1])


def test_initialize_is_a_noop_without_the_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    # a one-rank mesh needs no process group
    mesh = global_chains_mesh(device="cpu")
    assert mesh.shape == {"chains": 1} and mesh.group("chains") is None
    assert chains_mesh(device="cpu").coords == (0,)
