"""Octant nearest-neighbour search with static shapes, batched over cells.

PyTorch counterpart of ``mcmc_tpu/ops/neighbors.py`` (the reference's
octant search, gstatsim_custom/neighbors.py:4-64): candidate conditioning
points within a radius are binned into 8 angular sectors, with the
reference's half-open convention ``b/4*pi < angle <= (b+1)/4*pi``, and the
``num_points // 8`` nearest of each sector are kept, in a fixed output
shape with a validity mask.  The JAX package ``vmap``s one cell's search
over a chunk of cells; here a leading cell axis is written out.

Ties: ``jax.lax.top_k`` returns, among equal keys, the lower index first,
and on a grid window equal distances are common at the k-th place.  So
the selection is one stable sort of each cell's candidates by the same
float32 distance key, then the first ``num_points // 8`` of each sector in
that order: the same picks as the JAX package's, ties included.

Sectors: the JAX package bins ``atan2(dy, dx)``, and on a grid the cells
on a diagonal or an axis lie exactly on a sector boundary, where float32
``atan2`` implementations differ in the last bit (PyTorch's vectorized
CPU ``atan2`` against XLA's) and so pick other sectors.  Here the sector
is decided from the signs and magnitudes of dx and dy, the sector of the
exact angle, which is the JAX package's wherever the window coordinates
are exact multiples of the grid spacing (any spacing float32 holds
exactly, as 500 m does).

The two stencil helpers are host numpy (setup).
"""

from __future__ import annotations

import math

import numpy as np
import torch



def octant_sector(dx, dy):
    """Sector b in -4 .. 3 with b/4*pi < atan2(dy, dx) <= (b+1)/4*pi, the
    reference's half-open convention (atan2(0, 0) = 0 gives -1), decided
    exactly from comparisons of dx and dy."""
    w = torch.where
    up = w(dx >= dy, 0, w(dx >= 0, 1, w(dy >= -dx, 2, 3)))
    flat = w(dx >= 0, -1, 3)
    down = w(dx > -dy, -1, w(dx > 0, -2, w(-dx < -dy, -3, -4)))
    return w(dy > 0, up, w(dy == 0, flat, down))


def make_circle_stencil(x, rad):
    """Boolean circle mask on the grid spacing of ``x`` (reference
    neighbors.py:66-83).  Host-side setup helper."""
    x = np.asarray(x)
    dx = abs(float(x[1] - x[0]))
    ncells = math.ceil(rad / dx)
    xs = np.linspace(-rad, rad, 2 * ncells + 1)
    xx, yy = np.meshgrid(xs, xs)
    return np.sqrt(xx**2 + yy**2) < rad, xx, yy


def make_ellipse_stencil(x, major_axis, minor_axis, angle_degrees):
    """Rotated ellipse mask (reference neighbors.py:85-116)."""
    x = np.asarray(x)
    angle_rad = (180.0 - angle_degrees) * np.pi / 180.0
    dx = abs(float(x[1] - x[0]))
    ncells = math.ceil(major_axis / dx)
    xs = np.linspace(-major_axis, major_axis, 2 * ncells + 1)
    xx, yy = np.meshgrid(xs, xs)
    xr = xx * np.cos(angle_rad) + yy * np.sin(angle_rad)
    yr = -xx * np.sin(angle_rad) + yy * np.cos(angle_rad)
    ell = (xr / major_axis) ** 2 + (yr / minor_axis) ** 2
    return np.where(ell <= 1, 1, 0), xx, yy


def octant_select(dist, sector, valid, k_per: int):
    """The octant picks of each row: ``dist`` (C, N) float32 distances,
    ``sector`` (C, N) in -4 .. 3, ``valid`` (C, N) bool.  Returns (idx,
    mask), each (C, 8 * k_per): sector by sector its ``k_per`` nearest
    valid candidates' indices (ties: the lower index first), an empty
    slot masked off (its index some index into the row)."""
    C, N = dist.shape
    # one stable sort on (group, distance): the group is the sector, 9
    # for the rejected, above the float32 distance's bit pattern (which
    # orders like the distance, since no distance is negative); ties keep
    # the lower index first, as lax.top_k's picks do
    group = torch.where(valid, sector + 4, 8)
    key = (group << 32) | dist.view(torch.int32).to(torch.int64)
    order = torch.sort(key, dim=-1, stable=True).indices
    counts = torch.zeros((C, 9), dtype=torch.long, device=dist.device)
    counts.scatter_add_(1, group, torch.ones_like(group))
    starts = torch.cumsum(counts, dim=1) - counts
    r = torch.arange(k_per, device=dist.device)
    mask = (r < counts[:, :8, None]).reshape(C, -1)
    pos = torch.clamp(starts[:, :8, None] + r, max=N - 1)
    return torch.gather(order, 1, pos.reshape(C, -1)), mask


def octant_neighbors_window(target_xy, win_xy, win_values, win_valid,
                            radius, num_points: int):
    """Octant search over statically shaped windows, one a cell.

    target_xy: (C, 2) coordinates of the cells being estimated; win_xy:
    (C, S, S, 2) window coordinates; win_values: (C, S, S); win_valid:
    (C, S, S) bool (conditioning data present, inside the stencil, not the
    target itself).  Returns (coords (C, K, 2), values (C, K), mask (C, K)
    bool) with K = 8 * max(num_points // 8, 1): sector by sector (b = -4
    .. 3), its nearest first; empty slots are zero with mask False.  As in
    the JAX package, num_points < 8 keeps 1 a sector (the reference keeps
    none)."""
    C = target_xy.shape[0]
    dx = target_xy[:, None, None, 0] - win_xy[..., 0]
    dy = target_xy[:, None, None, 1] - win_xy[..., 1]
    dist = torch.sqrt(dx * dx + dy * dy).reshape(C, -1)
    valid = win_valid.reshape(C, -1) & (dist < radius)
    idx, mask = octant_select(dist, octant_sector(dx, dy).reshape(C, -1),
                              valid, max(int(num_points) // 8, 1))
    coords = torch.gather(win_xy.reshape(C, -1, 2), 1,
                          idx[..., None].expand(-1, -1, 2))
    vals = torch.gather(win_values.reshape(C, -1), 1, idx)
    return (torch.where(mask[..., None], coords, 0.0),
            torch.where(mask, vals, 0.0), mask)
