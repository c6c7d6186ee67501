"""Host-side regridding utilities: a copy of
``mcmc_tpu/data/interpolate.py`` for the PyTorch port (no JAX).

Replaces the reference's verde-based ``_interpolate`` switch
(reference: gstatsMCMC/Utilities.py:5-19) with SciPy equivalents:
'linear' -> Delaunay linear interpolation (+ nearest fill outside the hull),
'spline' -> thin-plate RBF, 'kneighbors' -> k-nearest-neighbor mean.
"""

from __future__ import annotations

import numpy as np


def interpolate(method: str, from_x, from_y, data, to_x, to_y, k: int = 1):
    """Scattered-data regridding. Returns values at (to_x, to_y)."""
    from_x = np.asarray(from_x, float).ravel()
    from_y = np.asarray(from_y, float).ravel()
    data = np.asarray(data, float).ravel()
    to_x = np.asarray(to_x, float).ravel()
    to_y = np.asarray(to_y, float).ravel()
    ok = np.isfinite(data) & np.isfinite(from_x) & np.isfinite(from_y)
    from_x, from_y, data = from_x[ok], from_y[ok], data[ok]
    pts = np.column_stack([from_x, from_y])
    tgt = np.column_stack([to_x, to_y])

    if method == "linear":
        from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator

        lin = LinearNDInterpolator(pts, data)
        out = lin(tgt)
        nan = np.isnan(out)
        if nan.any():
            out[nan] = NearestNDInterpolator(pts, data)(tgt[nan])
        return out
    if method == "spline":
        from scipy.interpolate import RBFInterpolator

        # subsample control points for tractability on large clouds
        if pts.shape[0] > 20_000:
            idx = np.random.default_rng(0).choice(pts.shape[0], 20_000,
                                                  replace=False)
            pts, data = pts[idx], data[idx]
        return RBFInterpolator(pts, data, kernel="thin_plate_spline",
                               neighbors=64)(tgt)
    if method == "kneighbors":
        from scipy.spatial import cKDTree

        # one normalized k for BOTH the query and the reduction: un-capped
        # k > len(pts) makes cKDTree pad with the out-of-bounds sentinel
        # index (data[idx] would raise), and k=0 would query k=1 but then
        # take mean(axis=1) of a 1-D result
        kq = max(1, min(int(k), pts.shape[0]))
        tree = cKDTree(pts)
        d, idx = tree.query(tgt, k=kq)
        if kq == 1:
            return data[idx]
        return data[idx].mean(axis=1)
    raise ValueError("the interp_method is not correctly defined, exit the function")


# reference-parity alias
_interpolate = interpolate
