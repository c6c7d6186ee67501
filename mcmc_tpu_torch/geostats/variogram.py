"""Experimental variograms and model fitting.

Replaces the reference's skgstat dependency (reference: MCMC.py:257-355
``fit_variogram``; gstatsim_custom/utilities.py:72-114 ``variograms``) with a
NumPy/SciPy implementation: Matheron estimator on evenly-spaced lag bins with
point subsampling, and least-squares fits of the four standard models using
skgstat's effective-range conventions (exponential a=r/3, gaussian a=r/2,
spherical a=r, matérn a=r/2 with smoothness).

The normal-score transform comes from ops.transforms (no sklearn needed on
the hot path).

A copy of ``mcmc_tpu/geostats/variogram.py`` (numpy/SciPy host code; the
port imports nothing of the JAX package); ``fit_variogram`` and
``variograms`` transform the data with the port's float32
``NormalScoreTransform.transform``, as the JAX package's do with its own.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import curve_fit
from scipy.special import gamma as _gamma, kv as _kv

from ..ops.transforms import NormalScoreTransform


# --- theoretical semivariogram models (skgstat conventions) ------------------


def gaussian_model(h, r, sill, nugget=0.0):
    a = r / 2.0
    return nugget + sill * (1.0 - np.exp(-np.square(h / a)))


def exponential_model(h, r, sill, nugget=0.0):
    a = r / 3.0
    return nugget + sill * (1.0 - np.exp(-h / a))


def spherical_model(h, r, sill, nugget=0.0):
    hr = np.clip(h / r, 0.0, 1.0)
    return nugget + sill * (1.5 * hr - 0.5 * hr**3)


def matern_model(h, r, sill, s, nugget=0.0):
    a = r / 2.0
    hs = np.where(h == 0, 1e-12, h / a)
    with np.errstate(invalid="ignore", over="ignore"):
        c = (2.0 ** (1.0 - s) / _gamma(s)) * np.power(hs, s) * _kv(s, hs)
    c = np.where(np.isnan(c), 1.0, c)
    return nugget + sill * (1.0 - c)


MODELS = {
    "gaussian": gaussian_model,
    "exponential": exponential_model,
    "spherical": spherical_model,
    "matern": matern_model,
}


def experimental_variogram(coords, values, maxlag, n_lags=50,
                           max_points=4000, seed=0):
    """Matheron estimator on even bins.

    coords: (N, 2); values: (N,).  Subsamples to ``max_points`` points
    (the reference's ``samples``/downsample knobs) to bound the O(N^2) pair
    set.  Returns (bin_centers, gamma, counts).
    """
    coords = np.asarray(coords, float)
    values = np.asarray(values, float).ravel()
    ok = np.isfinite(values)
    coords, values = coords[ok], values[ok]
    n = coords.shape[0]
    if n > max_points:
        idx = np.random.default_rng(seed).choice(n, max_points, replace=False)
        coords, values = coords[idx], values[idx]
    d = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    dv2 = (values[:, None] - values[None, :]) ** 2
    iu = np.triu_indices(coords.shape[0], k=1)
    d, dv2 = d[iu], dv2[iu]
    sel = d <= maxlag
    d, dv2 = d[sel], dv2[sel]
    edges = np.linspace(0.0, maxlag, n_lags + 1)
    which = np.clip(np.digitize(d, edges) - 1, 0, n_lags - 1)
    counts = np.bincount(which, minlength=n_lags)
    sums = np.bincount(which, weights=dv2, minlength=n_lags)
    with np.errstate(invalid="ignore"):
        gamma = 0.5 * sums / counts
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, gamma, counts


def fit_model(bins, gamma, model: str, maxlag=None, fit_nugget=False):
    """Least-squares fit of one model.

    Returns a parameter list in the reference's ordering
    (MCMC.py:314-339): [range, sill, nugget] or
    [range, sill, smoothness, nugget] for matérn.
    """
    model = model.lower()
    ok = np.isfinite(gamma)
    b, g = np.asarray(bins)[ok], np.asarray(gamma)[ok]
    if b.size < 3:
        raise ValueError("not enough variogram bins to fit")
    maxlag = maxlag or float(b[-1])
    s0 = float(np.nanmax(g))
    if model == "matern":
        if fit_nugget:
            f = lambda h, r, sill, s, n: matern_model(h, r, sill, s, n)
            p0 = [maxlag / 2, s0, 1.0, 0.0]
            bounds = ([1e-6, 1e-9, 0.05, 0.0], [10 * maxlag, 10 * s0, 10.0, s0])
        else:
            f = lambda h, r, sill, s: matern_model(h, r, sill, s)
            p0 = [maxlag / 2, s0, 1.0]
            bounds = ([1e-6, 1e-9, 0.05], [10 * maxlag, 10 * s0, 10.0])
        popt, _ = curve_fit(f, b, g, p0=p0, bounds=bounds, maxfev=20000)
        return list(popt) + ([0.0] if not fit_nugget else [])
    fmodel = MODELS[model]
    if fit_nugget:
        f = lambda h, r, sill, n: fmodel(h, r, sill, n)
        p0 = [maxlag / 2, s0, 0.0]
        bounds = ([1e-6, 1e-9, 0.0], [10 * maxlag, 10 * s0, s0])
    else:
        f = lambda h, r, sill: fmodel(h, r, sill)
        p0 = [maxlag / 2, s0]
        bounds = ([1e-6, 1e-9], [10 * maxlag, 10 * s0])
    popt, _ = curve_fit(f, b, g, p0=p0, bounds=bounds, maxfev=20000)
    return list(popt) + ([0.0] if not fit_nugget else [])


def fit_variogram(data, coords, roughness_region_mask=None, maxlag=100e3,
                  n_lags=50, samples=0.6, subsample=100_000,
                  data_for_trans=(), seed=152, plot=False):
    """Reference-parity wrapper (MCMC.py:257-355).

    Quantile-transforms the data, computes the experimental variogram inside
    the region mask, fits gaussian/exponential/spherical/matérn, and returns
    (nst_trans, transformed_data, params_list, fig_or_None).
    """
    data = np.asarray(data, float).reshape(-1, 1)
    fit_on = (np.asarray(data_for_trans, float).reshape(-1, 1)
              if len(data_for_trans) else data)
    nst = NormalScoreTransform.fit(fit_on, n_quantiles=500,
                                   subsample=subsample, random_state=seed)
    transformed = nst.transform(data.ravel()).numpy().reshape(-1, 1)

    coords = np.asarray(coords, float)
    vals = transformed.ravel()
    if roughness_region_mask is not None:
        m = np.asarray(roughness_region_mask).ravel() == 1
        coords, vals = coords[m], vals[m]
    max_points = max(500, int(samples * min(len(vals), 8000)))
    bins, gamma, _ = experimental_variogram(coords, vals, maxlag, n_lags,
                                            max_points=max_points)
    params = [fit_model(bins, gamma, m) for m in
              ("gaussian", "exponential", "spherical", "matern")]

    fig = None
    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        xi = np.linspace(0, bins[-1], n_lags)
        ax.plot(xi, gaussian_model(xi, *params[0][:2]), "b--", label="Gaussian")
        ax.plot(xi, exponential_model(xi, *params[1][:2]), "b-",
                label="Exponential")
        ax.plot(xi, spherical_model(xi, *params[2][:2]), "b*-",
                label="Spherical")
        ax.plot(xi, matern_model(xi, *params[3][:3]), "b-.", label="Matern")
        ax.plot(bins, gamma, "o", ms=4, alpha=0.5, label="Experimental")
        ax.set_xlabel("Lag [m]")
        ax.set_ylabel("Semivariance")
        ax.legend(loc="lower right", fontsize=8)
    return nst, transformed, params, fig


def variograms(xx, yy, grid, bin_func="even", maxlag=100e3, n_lags=70,
               covmodels=("gaussian", "spherical", "exponential", "matern"),
               downsample=None):
    """Port of gstatsim_custom.utilities.variograms (utilities.py:72-114)."""
    grid = np.asarray(grid, float)
    cond = ~np.isnan(grid)
    nst = NormalScoreTransform.fit(grid[cond], n_quantiles=500)
    vals = nst.transform(grid[cond]).numpy()
    coords = np.column_stack([np.asarray(xx)[cond], np.asarray(yy)[cond]])
    if isinstance(downsample, int):
        vals = vals[::downsample]
        coords = coords[::downsample]
    bins, gamma, _ = experimental_variogram(coords, vals, maxlag, n_lags)
    return ({m: fit_model(bins, gamma, m) for m in covmodels}, gamma, bins)


def gaussian_transformation(grid, cond_msk=None, n_quantiles=500):
    """Normal-score transform of a conditioning grid
    (reference gstatsim_custom/utilities.py:7-26).

    Returns (transformed grid with NaN off-mask, fitted transform).
    """
    grid = np.asarray(grid, float)
    if cond_msk is None:
        cond_msk = ~np.isnan(grid)
    data = grid[cond_msk]
    nst = NormalScoreTransform.fit(data, n_quantiles=min(n_quantiles,
                                                         data.size))
    out = np.full(grid.shape, np.nan)
    out[cond_msk] = nst.transform(data).numpy()
    return out, nst


def dists_to_cond(xx, yy, grid):
    """Minimum distance to conditioning data
    (reference gstatsim_custom/utilities.py:28-48 — O(N^2) loops replaced
    by an exact Euclidean distance transform)."""
    from ..ops.distance import min_dist_from_mask

    return min_dist_from_mask(np.asarray(xx), np.asarray(yy),
                              ~np.isnan(np.asarray(grid)))
