"""The port's ``geostats`` against the JAX package's, on the CPU.

- ``sgs`` (ordinary and simple kriging, unbounded and bounded, Matérn),
  ``krige`` and ``generate_initial_beds`` with the same seed on a 32 x 36
  grid.  The host generator gets the JAX package's numpy seed, so the
  path and every draw are the same, and the octant picks are bitwise the
  same (``test_torch_neighbors.py``); the beds differ only by float32
  rounding in the kriging solves, carried through later cells.  Measured
  at most 3e-3 m on beds of ~500 m; held to atol 2e-2 m.  The kriging
  maps to atol 2e-3 m.
- The variogram functions: host numpy/SciPy code, equal to rtol 1e-12
  where the data are the same; where they pass through the float32
  normal-score transform (``fit_variogram``, ``variograms``,
  ``gaussian_transformation``) the transformed values to atol 1e-5 and
  the fitted parameters to rtol 1e-3 (a Matérn fit's range is flat in
  its cost).
- The device (float32) ``transform`` / ``inverse`` against the JAX
  package's: scores to atol 1e-5, data values to 1e-5 of the data range.
- ``_check_vario``'s errors, and the host seed against the JAX key data.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from mcmc_tpu import geostats as jgeo
from mcmc_tpu.geostats import variogram as jvar
from mcmc_tpu.ops.transforms import NormalScoreTransform as JNST
from mcmc_tpu.utils.rng import as_key
from mcmc_tpu_torch import geostats as tgeo
from mcmc_tpu_torch.geostats import variogram as tvar
from mcmc_tpu_torch.ops.transforms import NormalScoreTransform as TNST
from tests.conftest import make_synthetic_problem

# the modules (each package's ``geostats.sgs`` is also its function)
jsgs_mod = importlib.import_module("mcmc_tpu.geostats.sgs")
tsgs_mod = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
BED_ATOL = 2e-2
MAP_ATOL = 2e-3
EXP = dict(major_range=5e3, minor_range=4e3, azimuth=20.0, sill=1.0,
           nugget=0.05, vtype="Exponential")
MATERN = dict(EXP, vtype="Matern", s=1.3)
KW = dict(radius=10e3, num_points=16, chunk=32, half_window=8)


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=32, W=36)


def _both(fn, *args, **kw):
    return (getattr(jgeo, fn)(*args, **kw),
            getattr(tgeo, fn)(*args, device="cpu", **kw))


def test_all_matches_jax():
    assert sorted(tgeo.__all__) == sorted(jgeo.__all__)


@pytest.mark.parametrize("ktype,vario,bounded", [
    ("ok", EXP, False), ("sk", EXP, False), ("ok", EXP, True),
    ("ok", MATERN, False)])
def test_sgs_matches_jax(problem, ktype, vario, bounded):
    p = problem
    bounds = ((np.full(p["xx"].shape, -800.0), p["surf"] - 1.0) if bounded
              else None)
    want, got = _both("sgs", p["xx"], p["yy"], p["cond_bed"], vario,
                      ktype=ktype, bounds=bounds, seed=3, **KW)
    np.testing.assert_allclose(got, want, atol=BED_ATOL, rtol=0)
    data = ~np.isnan(p["cond_bed"])
    np.testing.assert_allclose(got[data], p["cond_bed"][data], atol=1.0)
    if bounded:
        assert (got[~data] <= p["surf"][~data] - 1.0 + 1e-3).all()


def test_krige_matches_jax(problem):
    p = problem
    (jm, js), (tm, ts) = _both("krige", p["xx"], p["yy"], p["cond_bed"],
                               EXP, radius=10e3, num_points=16,
                               half_window=8)
    np.testing.assert_allclose(tm, jm, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(ts, js, atol=MAP_ATOL, rtol=0)


def test_generate_initial_beds_matches_jax(problem):
    p = problem
    want, got = _both("generate_initial_beds", p["xx"], p["yy"],
                      p["cond_bed"], EXP, surf=p["surf"], n_beds=2,
                      radius=10e3, num_points=16, seed=7, chunk=32,
                      half_window=8)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=BED_ATOL, rtol=0)
    assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize("seed", [0, 11, 2 ** 32 + 5, 2 ** 40 + 7])
def test_host_seed_is_the_jax_key_datas_last_word(seed):
    want = np.asarray(jax.random.key_data(as_key(seed)))[-1]
    got = tsgs_mod.numpy_seed(seed)
    assert got.dtype == np.uint32 and got == want
    np.testing.assert_array_equal(np.random.default_rng(got).random(4),
                                  np.random.default_rng(want).random(4))


@pytest.mark.parametrize("bad,msg", [
    ({k: v for k, v in EXP.items() if k != "sill"}, "Variogram missing sill"),
    (dict(EXP, vtype="cubic"), "vtype must be"),
    (dict(EXP, vtype="Matern"), "requires the s parameter")])
def test_check_vario_errors_match_jax(bad, msg):
    for check in (jsgs_mod._check_vario, tsgs_mod._check_vario):
        with pytest.raises(ValueError, match=msg):
            check(bad)


def test_variogram_host_functions_match_jax(problem):
    p = problem
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 20e3, (300, 2))
    vals = rng.normal(size=300)
    a = jvar.experimental_variogram(coords, vals, 10e3, 15, max_points=200)
    b = tvar.experimental_variogram(coords, vals, 10e3, 15, max_points=200)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-12)
    h = np.linspace(0, 20e3, 50)
    for name in tvar.MODELS:
        args = (h, 6e3, 1.2, 1.5) if name == "matern" else (h, 6e3, 1.2)
        np.testing.assert_allclose(tvar.MODELS[name](*args),
                                   jvar.MODELS[name](*args), rtol=1e-12)
        np.testing.assert_allclose(tvar.fit_model(a[0], a[1], name),
                                   jvar.fit_model(a[0], a[1], name),
                                   rtol=1e-12)
    np.testing.assert_array_equal(
        tvar.dists_to_cond(p["xx"], p["yy"], p["cond_bed"]),
        jvar.dists_to_cond(p["xx"], p["yy"], p["cond_bed"]))


def test_variogram_fits_match_jax(problem):
    p = problem
    m = p["data_mask"]
    data = p["cond_bed"][m]
    coords = np.column_stack([p["xx"][m], p["yy"][m]])
    a = jvar.fit_variogram(data, coords, maxlag=15e3, n_lags=20)
    b = tvar.fit_variogram(data, coords, maxlag=15e3, n_lags=20)
    np.testing.assert_allclose(b[1], np.asarray(a[1]), atol=1e-5)
    for x, y in zip(a[2], b[2]):
        np.testing.assert_allclose(y, x, rtol=1e-3)
    assert isinstance(b[0], TNST) and b[3] is None
    a = jvar.variograms(p["xx"], p["yy"], p["cond_bed"], maxlag=15e3,
                        n_lags=20)
    b = tvar.variograms(p["xx"], p["yy"], p["cond_bed"], maxlag=15e3,
                        n_lags=20)
    assert set(a[0]) == set(b[0])
    for k in a[0]:
        np.testing.assert_allclose(b[0][k], a[0][k], rtol=1e-3)
    np.testing.assert_allclose(b[1], a[1], rtol=1e-4, atol=1e-6)
    ga, _ = jvar.gaussian_transformation(p["cond_bed"])
    gb, _ = tvar.gaussian_transformation(p["cond_bed"])
    np.testing.assert_array_equal(np.isnan(gb), np.isnan(ga))
    np.testing.assert_allclose(gb, ga, atol=1e-5)


def test_device_transform_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.gamma(2.0, 100.0, 3000)
    j = JNST.fit(data, 500)
    t = TNST(quantiles=j.quantiles, references=j.references)
    x = np.concatenate([rng.uniform(data.min() - 50, data.max() + 50, 4000),
                        j.quantiles, [np.nan]])
    got = t.transform(torch.as_tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j.transform(x)),
                               atol=1e-5)
    z = np.concatenate([rng.normal(0.0, 2.0, 4000), [-40.0, 40.0, np.nan]])
    scale = float(data.max() - data.min())
    np.testing.assert_allclose(t.inverse(z).numpy(),
                               np.asarray(j.inverse(z)), atol=1e-5 * scale)
