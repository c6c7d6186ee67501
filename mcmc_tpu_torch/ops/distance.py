"""Distance-to-mask transforms (host-side setup kernels).

Replaces the reference's KD-tree query (gstatsMCMC/Utilities.py:21-24) and
the O(N^2) brute-force loops (Topography.py:564-566, gstatsim_custom/
utilities.py:28-48) with an exact Euclidean distance transform — O(N) via
scipy.ndimage, used only at setup time on the host.
"""

from __future__ import annotations

import numpy as np


def min_dist_from_mask(xx: np.ndarray, yy: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-cell Euclidean distance to the nearest True cell of ``mask``.

    Assumes a uniform rectilinear grid (as all reference call sites do).
    Cells inside the mask get distance 0.  Matches
    Utilities.min_dist_from_mask for grid-aligned data.
    """
    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return np.full(mask.shape, np.inf)
    dx = float(abs(xx[0, 1] - xx[0, 0])) if xx.shape[1] > 1 else 1.0
    dy = float(abs(yy[1, 0] - yy[0, 0])) if yy.shape[0] > 1 else 1.0
    from scipy.ndimage import distance_transform_edt

    return distance_transform_edt(~mask, sampling=(dy, dx)).astype(np.float64)
