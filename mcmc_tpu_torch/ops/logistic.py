"""Logistic distance-decay weighting for conditional random fields.

PyTorch counterpart of ``mcmc_tpu/ops/logistic.py``: the map
f(x) = L / (1 + exp(-k (x - x0))) - offset applied to distances rescaled so
that ``max_dist`` maps to 1.  ``make_edge_mask`` stays host numpy (a setup
precompute); ``crf_weight_from_dist`` runs on tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _rescaled_logistic(dist, L, x0, k, offset, max_dist, xp):
    """dist -> (logistic(dist/max_dist clamped to 1), the rescaled dist)."""
    dist_rescale = xp.where(dist > max_dist, 1.0, dist / max_dist)
    return L / (1.0 + xp.exp(-k * (dist_rescale - x0))) - offset, dist_rescale


def crf_weight_from_dist(dist, L, x0, k, offset, max_dist):
    """CRF conditioning weight from a distance-to-data tensor, shifted so
    its minimum is zero (weight 0 at data).  Returns (weight, dist_rescale,
    dist_logi)."""
    dist = torch.as_tensor(dist)
    dist_logi, dist_rescale = _rescaled_logistic(dist, L, x0, k, offset,
                                                 max_dist, torch)
    return dist_logi - dist_logi.min(), dist_rescale, dist_logi


def make_edge_mask(height: int, width: int, resolution: float,
                   L: float, x0: float, k: float, offset: float,
                   max_dist: float) -> np.ndarray:
    """Logistic edge-decay mask for one (height, width) block: the distance
    of each cell to the block's boundary ring, min(i, h-1-i, j, w-1-j) *
    resolution, through the rescaled logistic map."""
    ii = np.arange(height)[:, None]
    jj = np.arange(width)[None, :]
    dist = np.minimum(
        np.minimum(ii, height - 1 - ii), np.minimum(jj, width - 1 - jj)
    ).astype(np.float64) * resolution
    mask, _ = _rescaled_logistic(dist, L, x0, k, offset, max_dist, np)
    return mask.astype(np.float32)
