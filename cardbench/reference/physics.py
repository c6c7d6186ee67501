"""Mass conservation, as the upstream defines it (MCMC.py's chain.loss and
its numpy-gradient residual):

    res = d/dx(velx (surf - bed)) + d/dy(vely (surf - bed)) + dhdt - smb

central differences inside the grid and one-sided ones on its edges (x is
the last axis), and the loss nansum(res[mask]^2) / (2 sigma^2).

Every function runs in the dtype of its inputs, one rounding an
operation: float64 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import torch


def _gradient(f, spacing: float, dim: int):
    """numpy.gradient of ``f`` along ``dim`` (edge_order 1)."""
    n = f.shape[dim]
    first = (f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)) / spacing
    inner = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) / (2 * spacing)
    last = (f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)) / spacing
    return torch.cat([first, inner, last], dim=dim)


def residual(bed, surf, velx, vely, dhdt, smb, resolution: float):
    """The mass-conservation residual of ``bed`` (..., H, W); the other
    planes (H, W) broadcast over its leading axes."""
    thick = surf - bed
    return (_gradient(velx * thick, resolution, -1)
            + _gradient(vely * thick, resolution, -2) + dhdt - smb)


def masked_square_sum(x, mask):
    """Per leading index, the sum of ``x``'s squares over ``mask`` (H, W),
    NaN counting zero, accumulated in float64."""
    sq = torch.nan_to_num(x.to(torch.float64) ** 2, nan=0.0)
    return torch.where(mask, sq, 0.0).sum(dim=(-2, -1))


def gaussian_loss(x, mask, sigma: float):
    """nansum(x[mask]^2) / (2 sigma^2), per leading index, in float64."""
    return masked_square_sum(x, mask) / (2.0 * float(sigma) ** 2)
