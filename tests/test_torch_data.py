"""The port's data layer (``mcmc_tpu_torch.data``) against the JAX
package's (``mcmc_tpu.data``).

Both are numpy / scipy / pandas host code, the port's a copy, so every
function is held bitwise to its JAX twin on the same inputs (the spline's
RBF solve too: the same scipy calls in the same order).  The data-prep
residual is also held to the port's device residual
(``ops/physics.py`` through ``chain_crf.init_state``) within float32
rounding of the flux gradients.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

import mcmc_tpu.data as jdata
import mcmc_tpu_torch.data as tdata
from mcmc_tpu_torch.models.chain_crf import init_state
from tests.torch_helpers import small_chain, small_problem


def _equal(a, b):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _both(name, *args, **kw):
    got = getattr(tdata, name)(*args, **kw)
    want = getattr(jdata, name)(*args, **kw)
    _equal(got, want)
    return got


def test_same_names():
    assert tdata.__all__ == jdata.__all__
    for name in tdata.__all__:
        assert getattr(tdata, name).__module__.startswith("mcmc_tpu_torch.")


@pytest.mark.parametrize("method,k", [("linear", 1), ("spline", 1),
                                      ("kneighbors", 0), ("kneighbors", 1),
                                      ("kneighbors", 5),
                                      ("kneighbors", 500)])
def test_interpolate(method, k):
    rng = np.random.default_rng(2)
    x, y = rng.uniform(0, 10, 120), rng.uniform(0, 10, 120)
    z = np.sin(x) + 0.3 * y
    z[::17] = np.nan  # dropped before the fit
    tx, ty = np.meshgrid(np.linspace(-1, 11, 9), np.linspace(-1, 11, 7))
    out = _both("interpolate", method, x, y, z, tx, ty, k)
    assert out.shape == (63,) and np.isfinite(out).all()


def test_interpolate_refuses_an_unknown_method():
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError, match="interp_method"):
            pkg.interpolate("bogus", [0.0], [0.0], [1.0], [0.0], [0.0])


def test_make_grid():
    coords, cols, rows = _both("make_grid", -1000.0, 2000.0, 500.0, 2500.0,
                               500.0)
    assert (cols, rows) == (7, 5) and coords.shape == (35, 2)


def _raster(x0=0.0, nx=20, ny=15, res=500.0):
    x = x0 + np.arange(nx) * res
    y = np.arange(ny) * res
    xx, yy = np.meshgrid(x, y)
    return pd.DataFrame({"x": xx.ravel(), "y": yy.ravel(),
                         "bed": (xx + 2 * yy).ravel()})


def test_crop_study_area_and_its_refusals():
    dfc, xx, yy, (rows, cols) = _both("crop_study_area", _raster(),
                                      (1000, 8000), (500, 6000))
    assert (rows, cols) == xx.shape
    ragged = pd.DataFrame({"x": [0.0, 500.0, 500.0], "y": [0.0, 0.0, 500.0],
                           "bed": [1, 2, 3.0]})
    north_up = _raster().sort_values(["y", "x"], ascending=[False, True])
    for df, match in ((ragged, "complete raster"),
                      (north_up, "ascending y-major")):
        for pkg in (tdata, jdata):
            with pytest.raises(ValueError, match=match):
                pkg.crop_study_area(df, (-1, 1e4), (-1, 1e4))


def test_grid_data_with_nan_picks_and_negative_indices():
    rng = np.random.default_rng(5)
    n = 400
    df = pd.DataFrame({"px": rng.uniform(-1500, 5500, n),
                       "py": rng.uniform(-1500, 5500, n),
                       "z": rng.normal(size=n)})
    df.loc[::37, "z"] = np.nan
    grid, mat, rows, cols = _both("grid_data", df, "px", "py", "z", 500.0,
                                  0.0, 5000.0, 0.0, 5000.0)
    assert mat.shape == (rows, cols) == (11, 11)
    assert np.isnan(mat).any() and np.isfinite(mat).any()


def test_get_highvel_boundary():
    H, W, res = 60, 70, 500.0
    xx, yy = np.meshgrid(np.arange(W) * res, np.arange(H) * res)
    rng = np.random.default_rng(1)
    velx = np.zeros((H, W))
    velx[20:40, 15:45] = 100.0
    velx += rng.normal(0, 5, (H, W))
    vely = rng.normal(0, 5, (H, W))
    grounded = np.ones((H, W), bool)
    grounded[:, -5:] = False
    ocean = ~grounded
    mask = _both("get_highvel_boundary", velx, vely, 50.0, grounded, ocean,
                 3 * res, xx, yy, smooth_mode=5)
    assert mask.any() and not mask.all()
    empty = _both("get_highvel_boundary", velx, vely, 1e6, grounded,
                  np.zeros((H, W), bool), res, xx, yy)
    assert not empty.any()


def test_mass_conservation_residual_and_the_device_residual():
    """Bitwise the JAX package's numpy residual; and, on the port's small
    problem, the device residual ``init_state`` computes in float32 within
    float32 rounding of the flux gradients (1e-4 of the residual's
    largest magnitude)."""
    p = small_problem(H=48, W=48)
    args = (p["initial_bed"], p["surf"], p["velx"], p["vely"], p["dhdt"],
            p["smb"], p["resolution"])
    res = _both("get_mass_conservation_residual", *args)
    chain = small_chain(p)
    _, consts = chain.build("cpu")
    device = init_state(chain.initial_bed, consts).mc_res[0].numpy()
    np.testing.assert_allclose(device, res, rtol=0,
                               atol=1e-4 * np.abs(res).max())


def _qc_frame(H=6, W=7, seed=4):
    rng = np.random.default_rng(seed)
    bed = rng.normal(0.0, 1.0, H * W)
    bed[rng.random(H * W) < 0.1] = 4.0    # outliers
    bed[rng.random(H * W) < 0.1] = np.nan  # no pick
    mask = np.full(H * W, 2)
    mask[-4:] = [3, 0, 3, 0]               # shelf and ocean rows
    return (pd.DataFrame({"bed": bed, "bedmachine_mask": mask}),
            bed.reshape(H, W))


@pytest.mark.parametrize("shallow", [False, True])
def test_filter_data_by_std(shallow):
    df, cond = _qc_frame()
    H, W = cond.shape
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    rf_bed = np.random.default_rng(9).normal(0.0, 0.3, (H, W))
    out, rate, std = _both("filter_data_by_std", df, rf_bed, cond, 1.5, xx,
                           yy, shallow)
    assert 0 < rate < 0.5 and std > 0
    assert out["bedQCrf"].notna().sum() > 0


def test_filter_data_by_std_plot_uses_the_ports_panels():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df, cond = _qc_frame()
    H, W = cond.shape
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    out = tdata.filter_data_by_std(df, np.zeros((H, W)), cond, 1.0, xx, yy,
                                   False, plot=True)
    assert len(out) == 4 and len(out[3].get_axes()) >= 3
    plt.close(out[3])
    assert "mcmc_tpu_torch.utils.plotting" in sys.modules


@pytest.mark.parametrize("absent", ["xarray", "pyproj"])
def test_require_messages_when_a_dependency_is_absent(absent, monkeypatch,
                                                      tmp_path):
    """With ``absent`` not importable, a loader that needs it raises the
    JAX package's ImportError text, naming the module and its install."""
    monkeypatch.setitem(sys.modules, absent, None)
    calls = {
        "xarray": lambda pkg: pkg.load_dhdt(tmp_path / "nope.nc",
                                            np.zeros((2, 2)),
                                            np.zeros((2, 2)), 500.0),
        "pyproj": lambda pkg: pkg.convert_geoid(tmp_path / "nope.txt",
                                                np.zeros((2, 2)),
                                                np.zeros((2, 2))),
    }
    texts = []
    for pkg in (tdata, jdata):
        with pytest.raises(ImportError, match=absent) as err:
            calls[absent](pkg)
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert f"install {absent}" in texts[0]


def test_torch_is_not_needed_by_the_data_layer():
    """The data layer is host numpy: it returns numpy, never tensors."""
    out = tdata.get_mass_conservation_residual(
        np.zeros((3, 3)), np.ones((3, 3)), np.ones((3, 3)), np.ones((3, 3)),
        np.zeros((3, 3)), np.zeros((3, 3)), 500.0)
    assert isinstance(out, np.ndarray) and not torch.is_tensor(out)
