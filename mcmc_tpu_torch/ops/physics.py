"""Ice-sheet physics: mass-conservation residual and masked losses.

PyTorch counterpart of ``mcmc_tpu/ops/physics.py``.  The residual is

    res = d/dx(velx * (surf - bed)) + d/dy(vely * (surf - bed)) + dhdt - smb

with numpy-gradient finite differences (central in the interior, one-sided
at the array edges); the last axis is x.  ``torch.gradient`` with a scalar
spacing and ``edge_order=1`` has exactly these edge semantics.  Every
function broadcasts over leading (chain) dimensions.
"""

from __future__ import annotations

import torch


def mass_conservation_residual(bed, surf, velx, vely, dhdt, smb, resolution):
    """Full-grid mass-conservation residual over the trailing (H, W) axes."""
    thick = surf - bed
    fx = velx * thick
    fy = vely * thick
    (dx,) = torch.gradient(fx, spacing=float(resolution), dim=-1)
    (dy,) = torch.gradient(fy, spacing=float(resolution), dim=-2)
    return dx + dy + dhdt - smb


def _nansq(x):
    sq = torch.square(x)
    return torch.where(torch.isnan(sq), torch.zeros_like(sq), sq)


def masked_sq_sum(res, mask):
    """nansum of squared residuals inside ``mask`` over the trailing (H, W)
    axes (no sigma scaling)."""
    sq = _nansq(res)
    return torch.where(mask, sq, torch.zeros_like(sq)).sum(dim=(-2, -1))


def masked_gaussian_loss(res, mask, sigma):
    """nansum(res[mask]**2) / (2 sigma**2): NaN residuals count zero, like
    np.nansum (reference chain.loss)."""
    return masked_sq_sum(res, mask) / (2.0 * sigma ** 2)


def thickness_violations(bed, surf, mask):
    """Count of cells inside ``mask`` where the ice thickness is <= 0."""
    viol = (surf - bed) <= 0.0
    return (viol & mask).sum(dim=(-2, -1))
