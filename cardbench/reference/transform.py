"""The normal-score transform by sklearn's QuantileTransformer rule
(output_distribution="normal"), as the upstream's
gstatsim_custom/utilities.py fits it: ``n_q`` evenly spaced references in
[0, 1], the data's percentiles at them made non-decreasing; the inverse
maps a score z to ndtr(z) and interpolates the quantiles there.
"""

from __future__ import annotations

import numpy as np
import torch


def fit_quantiles(data, n_quantiles: int):
    """(quantiles, references) of 1-D ``data`` (NaN left out), float64."""
    x = np.asarray(data, np.float64).ravel()
    x = x[~np.isnan(x)]
    n_q = int(min(n_quantiles, x.size))
    references = np.linspace(0.0, 1.0, n_q)
    quantiles = np.maximum.accumulate(np.percentile(x, references * 100.0))
    return quantiles, references


def _interp(x, xp, fp):
    """numpy.interp in torch: the ends held at ``fp[0]`` and ``fp[-1]``."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    f = f0 + (x - x0) * (f1 - f0) / torch.where(dx > 0, dx, 1.0)
    f = torch.where(dx > 0, f, f0)
    f = torch.where(x <= xp[0], fp[0], f)
    return torch.where(x >= xp[-1], fp[-1], f)


def inverse(z, quantiles, references):
    """Data values of scores ``z``, in ``z``'s dtype and on its device."""
    q = torch.as_tensor(quantiles, dtype=z.dtype, device=z.device)
    r = torch.as_tensor(references, dtype=z.dtype, device=z.device)
    return _interp(torch.special.ndtr(z.to(torch.float64)).to(z.dtype), r, q)


def forward(x, quantiles, references):
    """Scores of data values ``x`` (numpy, float64) by sklearn's rule: the
    mean of the forward and the reversed interpolation, the ends mapped to
    p = 0 and 1, the scores clipped at the 1e-7 tails."""
    from scipy.special import ndtri

    q = np.asarray(quantiles, np.float64)
    r = np.asarray(references, np.float64)
    x = np.asarray(x, np.float64)
    p = 0.5 * (np.interp(x, q, r) - np.interp(-x, -q[::-1], -r[::-1]))
    p = np.where(x == q[-1], 1.0, np.where(x == q[0], 0.0, p))
    tail = 1e-7 - np.spacing(1)
    with np.errstate(divide="ignore"):
        z = np.clip(ndtri(p), ndtri(tail), ndtri(1.0 - tail))
    return np.where(np.isnan(x), np.nan, z)


def scores(x, quantiles, references):
    """The scores whose inverse transform gave data values ``x`` (numpy,
    float64): ndtri of the interpolated reference, unclipped, so that a
    simulated score past the data's tails comes back as it was drawn."""
    from scipy.special import ndtri

    return ndtri(np.interp(np.asarray(x, np.float64), quantiles, references))
