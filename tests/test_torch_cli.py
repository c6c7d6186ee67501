"""The port's entry points: ``python -m mcmc_tpu_torch`` (``cli.py``) and the
farm drivers (``drivers.py``), their share of tests/test_cli.py and
tests/test_drivers.py, at 48 x 48 on the CPU (``--device cpu``).

The configs are tests/test_cli.py's, with an int master seed (seed lists
are tests/test_torch_seeds.py's) and, for the SGS family, the spherical
variogram whose packed solve is the CG on a given Sigma.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmc_tpu_torch import cli, drivers
from mcmc_tpu_torch.ops.cg_kernel import masked_cg_reference
from tests.conftest import make_synthetic_problem
from tests.torch_helpers import small_chain, small_sgs_chain

ROOT = Path(__file__).resolve().parent.parent


def _write_dataset(tmp_path, H=48, W=48):
    p = make_synthetic_problem(H=H, W=W)
    np.savez(tmp_path / "dataset.npz", **{k: p[k] for k in (
        "xx", "yy", "initial_bed", "surf", "velx", "vely", "dhdt", "smb",
        "cond_bed", "data_mask", "grounded", "region")},
        resolution=p["resolution"])
    return p


def _crf_config(n_iter=20, segment=10):
    return {
        "family": "crf",
        "dataset": "dataset.npz",
        "update_region": {"in_region": True, "mask": "region"},
        "loss": {"sigma_mc": 5.0, "mass_conv_in_region": True},
        "crf": {
            "update_type": "RF",
            "randfield": {"range_min_x": 3e3, "range_max_x": 8e3,
                          "range_min_y": 3e3, "range_max_y": 8e3,
                          "scale_min": 20.0, "scale_max": 60.0,
                          "nugget_max": 0.0, "model_name": "Gaussian",
                          "isotropic": True},
            "blocks": {"min_block_x": 8, "max_block_x": 12,
                       "min_block_y": 8, "max_block_y": 12, "steps": 2},
            "weight": {"L": 2, "x0": 0, "k": 6, "offset": 1,
                       "max_dist": 5e3},
        },
        "farm": {"n_chains": 2, "n_iter": n_iter, "rng_seeds": 7,
                 "output_path": "run", "segment_size": segment},
        "save": {"final_beds": "beds.npy", "histories": "hist.npz"},
    }


def _sgs_config(n_iter=16, segment=8, output_path="run"):
    return {
        "family": "sgs",
        "dataset": "dataset.npz",
        "update_region": {"in_region": True, "mask": "region"},
        "loss": {"sigma_mc": 5.0},
        "sgs": {
            "variogram": {"vtype": "Spherical", "range": 6e3, "sill": 1.0,
                          "nugget": 0.0},
            "params": {"num_neighbors": 16, "search_radius": 10e3},
            "blocks": {"min_x": 5, "max_x": 10, "min_y": 5, "max_y": 10},
            "trend": {"gaussian_sigma": 10.0},
            "normal_transform": {"n_quantiles": 300},
        },
        "farm": {"n_chains": 2, "n_iter": n_iter, "rng_seeds": 5,
                 "lsc_rng_seed": 2026, "output_path": output_path,
                 "segment_size": segment},
        "save": {"final_beds": f"{output_path}_beds.npy",
                 "histories": f"{output_path}_hist.npz"},
    }


def _write_config(tmp_path, cfg, name="exp.json"):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return path


def _main(cfg_path, *extra):
    return cli.main([str(cfg_path), "--quiet", "--device", "cpu", *extra])


def test_crf_end_to_end_and_resume(tmp_path):
    _write_dataset(tmp_path)
    cfg_path = _write_config(tmp_path, _crf_config(n_iter=20))
    assert _main(cfg_path) == 0
    beds = np.load(tmp_path / "beds.npy")
    assert beds.shape == (2, 48, 48) and np.isfinite(beds).all()
    with np.load(tmp_path / "hist.npz") as h:
        loss1 = h["loss"].copy()
        assert loss1.shape == (2, 20)
        assert h["blocks_used"].shape == (2, 20, 4)
    # re-invoking with a longer run resumes: the first 20 rows identical
    _write_config(tmp_path, _crf_config(n_iter=40))
    assert _main(cfg_path) == 0
    with np.load(tmp_path / "hist.npz") as h:
        assert h["loss"].shape == (2, 40)
        np.testing.assert_array_equal(h["loss"][:, :20], loss1)


def test_sgs_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    """The spherical SGS farm through the CLI: 10 iterations, resumed to
    16, equal bit for bit to 16 straight, in the nested reference
    layout; the packed solve ran the plain given-Sigma CG."""
    _write_dataset(tmp_path)
    resumed = _write_config(tmp_path, _sgs_config(10, 4, "a"), "a.json")
    assert _main(resumed) == 0
    _write_config(tmp_path, _sgs_config(16, 4, "a"), "a.json")
    calls = []
    from mcmc_tpu_torch.ops import cg_kernel

    def spy(*args):
        calls.append(args[0].shape)
        return masked_cg_reference(*args)

    cg_kernel.masked_cg_reference = spy
    try:
        assert _main(resumed) == 0
    finally:
        cg_kernel.masked_cg_reference = masked_cg_reference
    assert calls == [(2, 16, 16)] * 6
    straight = _write_config(tmp_path, _sgs_config(16, 4, "b"), "b.json")
    assert _main(straight) == 0
    with np.load(tmp_path / "a_hist.npz") as a, \
            np.load(tmp_path / "b_hist.npz") as b:
        assert a["loss"].shape == (2, 16)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(np.load(tmp_path / "a_beds.npy"),
                                  np.load(tmp_path / "b_beds.npy"))
    assert (tmp_path / "a" / "LargeScaleChain" / "2026" /
            "SmallScaleChain" / "checkpoint_16.npz").exists()


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_one_iteration_run(tmp_path, family):
    """``farm.n_iter: 1`` records the initial state alone: one-row
    histories, no step taken, the bed as it started."""
    _write_dataset(tmp_path)
    cfg = _crf_config(n_iter=1) if family == "crf" else _sgs_config(1, 4)
    hist = "hist.npz" if family == "crf" else "run_hist.npz"
    assert _main(_write_config(tmp_path, cfg)) == 0
    with np.load(tmp_path / hist) as h:
        assert h["loss"].shape == (2, 1) and np.isfinite(h["loss"]).all()
        assert not h["steps"].any() and np.isnan(h["blocks_used"]).all()


def test_dry_run_validates_without_sampling(tmp_path, capsys):
    _write_dataset(tmp_path)
    cfg_path = _write_config(tmp_path, _crf_config())
    assert cli.main([str(cfg_path), "--dry-run"]) == 0
    assert "config OK" in capsys.readouterr().out
    assert not (tmp_path / "run").exists()


def test_info_fresh_and_after_run(tmp_path, capsys):
    _write_dataset(tmp_path)
    cfg_path = _write_config(tmp_path, _crf_config(n_iter=12, segment=5))
    assert cli.main([str(cfg_path), "--info"]) == 0
    assert "no complete checkpoint" in capsys.readouterr().out
    assert _main(cfg_path) == 0
    capsys.readouterr()
    assert cli.main([str(cfg_path), "--info"]) == 0
    out = capsys.readouterr().out
    assert "checkpoint @ iter 12: single, 1 file(s)" in out
    assert "trace history rows: 0..6, 6..11, 11..12" in out
    assert "resume: complete (12/12)" in out


def test_default_device_is_the_card(tmp_path, monkeypatch):
    """Without --device the farm runs on the card; with no card it raises,
    naming device='cpu', before sampling anything."""
    _write_dataset(tmp_path)
    cfg_path = _write_config(tmp_path, _crf_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(cfg_path), "--quiet"])
    assert not (tmp_path / "beds.npy").exists()


def test_cli_matches_the_driver(tmp_path):
    """The CLI is a thin declarative layer over the farm driver."""
    p = _write_dataset(tmp_path)
    cfg = _crf_config(n_iter=12)
    results = cli.run(cfg, config_dir=tmp_path, quiet=True, device="cpu")
    chain = cli.build_chain(cfg, cli.load_dataset(tmp_path / "dataset.npz"))
    direct = drivers.large_scale_chain_farm(
        chain, n_chains=2, rng_seeds=7, n_iter=12,
        output_path=tmp_path / "direct", segment_size=10, progress=False,
        quiet=True, device="cpu")
    for a, b in zip(results, direct):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert results[0][0].shape == p["xx"].shape


def test_toml_config_and_errors(tmp_path):
    _write_dataset(tmp_path)
    toml = tmp_path / "exp.toml"
    toml.write_text('family = "crf"\ndataset = "dataset.npz"\n'
                    '[loss]\nsigma_mc = 5.0\n')
    cfg = cli.load_config(toml)
    assert cfg["family"] == "crf" and cfg["loss"]["sigma_mc"] == 5.0
    with pytest.raises(ValueError, match="crf"):
        cli.build_experiment(cfg, tmp_path)
    bad = _crf_config()
    bad["family"] = "nope"
    with pytest.raises(ValueError, match="family"):
        cli.build_experiment(bad, tmp_path)
    seeds = _crf_config()
    seeds["farm"]["rng_seeds"] = [1]  # a list needs a seed a chain
    with pytest.raises(ValueError, match="n_chains"):
        cli.run(seeds, config_dir=tmp_path, quiet=True, device="cpu")


def test_module_entry_point(tmp_path):
    """``python -m mcmc_tpu_torch`` in a fresh interpreter (--dry-run)."""
    _write_dataset(tmp_path)
    cfg_path = _write_config(tmp_path, _sgs_config())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-m", "mcmc_tpu_torch",
                          str(cfg_path), "--dry-run", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "config OK: family=sgs grid=(48, 48)" in out.stdout


# --- the drivers -------------------------------------------------------------

def test_large_scale_farm_and_resume(tmp_path):
    p = make_synthetic_problem(H=48, W=48)
    kw = dict(n_chains=2, rng_seeds=3, output_path=tmp_path,
              segment_size=5, progress=False, quiet=True, device="cpu")
    res = drivers.large_scale_chain_farm(small_chain(p), n_iter=11, **kw)
    assert len(res) == 2 and len(res[0]) == 7
    bed, loss_mc, loss_data, loss, steps, resampled, blocks = res[0]
    assert bed.shape == (48, 48) and loss.shape == (11,)
    assert blocks.shape == (11, 4) and resampled.shape == (48, 48)
    again = drivers.largeScaleChain_mp(small_chain(p), n_iter=15, **kw)
    np.testing.assert_array_equal(again[1][3][:11], res[1][3])
    assert (tmp_path / "LargeScaleChain" / "checkpoint_15.npz").exists()


def test_small_scale_farm_with_per_chain_beds(tmp_path):
    p = make_synthetic_problem(H=48, W=48)
    chain = small_sgs_chain(p, vario=("Spherical", 6e3, 1.0, 0.0, None))
    chain.set_sgs_param(16, 10e3)
    beds = np.stack([p["initial_bed"] - 1.0, p["initial_bed"] + 1.0])
    res = drivers.smallScaleChain_mp(
        chain, n_chains=2, initial_beds=beds, ssc_rng_seeds=4,
        lsc_rng_seed=77, n_iter=6, output_path=tmp_path, segment_size=3,
        progress=False, quiet=True, device="cpu")
    assert (tmp_path / "LargeScaleChain" / "77" / "SmallScaleChain"
            / "checkpoint_6.npz").exists()
    # beds come back with the trend restored, far from the detrended plane
    for r, b in zip(res, beds):
        assert r[0].shape == (48, 48)
        assert np.abs(r[0] - b).mean() < 50.0


def test_async_checkpoints_match_sync(tmp_path):
    p = make_synthetic_problem(H=48, W=48)
    kw = dict(n_chains=2, rng_seeds=9, n_iter=10, segment_size=3,
              progress=False, quiet=True, device="cpu")
    a = drivers.large_scale_chain_farm(small_chain(p),
                                       output_path=tmp_path / "a", **kw)
    b = drivers.large_scale_chain_farm(small_chain(p),
                                       output_path=tmp_path / "b",
                                       async_checkpoints=True, **kw)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_iteration_batches():
    assert drivers.iteration_batches(5000) == [5000]
    assert drivers.iteration_batches(150_000) == [60_000] + [10_000] * 9
    assert sum(drivers.iteration_batches(123_456)) == 123_456


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_snapshot_pickles_and_reproduces(tmp_path, family):
    p = make_synthetic_problem(H=48, W=48)
    if family == "crf":
        chain = small_chain(p)
    else:
        chain = small_sgs_chain(p, vario=("Spherical", 6e3, 1.0, 0.0, None))
        chain.set_sgs_param(16, 10e3)
    snap = pickle.loads(pickle.dumps(drivers.chain_snapshot(chain)))
    rebuilt = drivers.chain_from_snapshot(snap)
    assert type(rebuilt) is type(chain)
    kw = dict(n_chains=2, n_iter=5, segment_size=5, progress=False,
              quiet=True, device="cpu")
    if family == "crf":
        def run(c, out):
            return drivers.large_scale_chain_farm(c, rng_seeds=1,
                                                  output_path=out, **kw)
    else:
        def run(c, out):
            return drivers.small_scale_chain_farm(c, ssc_rng_seeds=1,
                                                  output_path=out, **kw)
    a = run(chain, tmp_path / "a")
    b = run(rebuilt, tmp_path / "b")
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
