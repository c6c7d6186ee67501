"""Sequential Gaussian simulation of an initial bed (the upstream's T2
workflow, gstatsim's ``sgs`` with the bounded draw of
T2_StatisticalAnalysis cells 20-22), followed cell by cell from the
program's own bed.

The simulation: the radar picks' normal scores condition a random path
over every other cell, taken in chunks of ``chunk`` cells; each cell of a
chunk is kriged (ordinary kriging, Matérn covariance) from the
``num_points // 8`` nearest known cells of each octant within ``radius``
inside a (2 half_window + 1)^2 window, known meaning a pick or a cell of
an earlier chunk, then drawn from a normal truncated to the bounds' scores
(2000 m below the lowest pick, 1 m below the surface).  The path and the
draws come from numpy's generator seeded with ``seed mod 2**32``: the
permutation of the cells, then one uniform a cell, chunk after chunk,
mapped through the truncated normal's quantile function.

A sampled chunk is judged from the program's bed: the scores of every cell
before it are recovered from the bed (the inverse transform is monotone),
the reference krieges the chunk's cells from those in float64 and draws
them with the chunk's own uniforms; the program's values at those cells
must be the reference's to rounding.  So every judged cell is conditioned
on exactly what the program conditioned it on, and an error in one chunk
does not carry to the next.  Ties in the octant search go to the lower
window index (row-major), distances being exact on the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import transform


@dataclasses.dataclass
class T2:
    """The inputs of the bounded simulation, as the harness made them."""

    cond: np.ndarray        # (H, W) picks, NaN elsewhere
    surf: np.ndarray        # (H, W)
    resolution: float
    vario: dict             # vtype "Matern", s, major/minor range, ...
    radius: float
    num_points: int
    chunk: int
    half_window: int

    def prepared(self) -> dict:
        cond_msk = ~np.isnan(self.cond)
        data = self.cond[cond_msk]
        q, r = transform.fit_quantiles(data, min(500, data.size))
        z = np.full(self.cond.shape, np.nan)
        z[cond_msk] = transform.forward(data, q, r)
        lo = np.full(self.cond.shape, float(np.nanmin(self.cond) - 2000.0))
        return dict(cond_msk=cond_msk, q=q, r=r, z_data=z,
                    global_mean=float(z[cond_msk].mean()),
                    cells=np.argwhere(~cond_msk),
                    lo=transform.forward(lo, q, r),
                    hi=transform.forward(self.surf - 1.0, q, r))


def matern(h, s: float):
    """The upstream's normalized Matérn covariance (gstatsim_custom/
    covariance.py): with scale = 0.45246434 exp(-0.70449189 s) +
    1.7863836, c(h) = 2 / Gamma(s) (scale h sqrt(s))^s K_s(2 scale h
    sqrt(s)), c(0) = 1."""
    from scipy.special import gamma, kv

    h = np.asarray(h, np.float64)
    scale = 0.45246434 * np.exp(-0.70449189 * s) + 1.7863836
    hc = np.where(h == 0.0, 1e-8, h)
    with np.errstate(invalid="ignore", over="ignore"):
        c = (2.0 / gamma(s) * np.power(scale * hc * np.sqrt(s), s)
             * kv(s, 2.0 * scale * hc * np.sqrt(s)))
    return np.where(np.isnan(c), 1.0, c)


def sector(dx, dy):
    """Octant b in -4 .. 3 with b pi/4 < atan2(dy, dx) <= (b + 1) pi/4,
    decided from the exact offsets (atan2(0, 0) = 0 gives -1)."""
    b = np.empty(np.broadcast(dx, dy).shape, np.int64)
    dx, dy = np.broadcast_arrays(dx, dy)
    up, flat, down = dy > 0, dy == 0, dy < 0
    b[up] = np.select([dy[up] <= dx[up], dx[up] >= 0, dy[up] >= -dx[up]],
                      [0, 1, 2], 3)
    b[flat] = np.where(dx[flat] >= 0, -1, 3)
    b[down] = np.select([dx[down] > -dy[down], dx[down] > 0,
                         -dx[down] < -dy[down]], [-1, -2, -3], -4)
    return b


def path_and_uniforms(n_cells: int, seed: int, chunk: int, wanted) -> tuple:
    """The path's permutation and the uniforms of the chunks ``wanted``
    ({chunk index: (n,) uniforms})."""
    rng = np.random.default_rng(np.uint32(int(seed) % (1 << 32)))
    order = rng.permutation(n_cells)
    wanted = set(int(k) for k in wanted)
    uniforms = {}
    for k in range(max(wanted) + 1):
        u = rng.uniform(size=min(chunk, n_cells - k * chunk))
        if k in wanted:
            uniforms[k] = u
    return order, uniforms


def krige(t2: T2, prep: dict, grid_z, known, cells, dtype=np.float64):
    """(est, var) of ``cells`` (n, 2) by ordinary kriging from the cells
    of ``grid_z`` that ``known`` (H, W) marks, in ``dtype``: float64, or
    bfloat16 with the system, its solution and the results rounded to it
    (the solve itself in float32 on the rounded values)."""
    H, W = grid_z.shape
    hw = min(int(t2.half_window), (min(H, W) - 1) // 2)
    WN = 2 * hw + 1
    res = t2.resolution
    k_per = max(int(t2.num_points) // 8, 1)
    i, j = cells[:, 0], cells[:, 1]
    r0 = np.clip(i - hw, 0, H - WN)
    c0 = np.clip(j - hw, 0, W - WN)
    ar = np.arange(WN)
    rows = r0[:, None] + ar              # (n, WN)
    cols = c0[:, None] + ar
    di = i[:, None, None] - rows[:, :, None]     # (n, WN, 1)
    dj = j[:, None, None] - cols[:, None, :]     # (n, 1, WN)
    dist = np.sqrt((dj * res) ** 2 + (di * res) ** 2)
    kn = known[rows[:, :, None], cols[:, None, :]]
    valid = (kn & (dist < t2.radius)).reshape(len(i), -1)
    sec = sector(dj, di).reshape(len(i), -1)
    dist = dist.reshape(len(i), -1)
    n = len(i)
    picks = np.zeros((n, 8 * k_per), np.int64)
    mask = np.zeros((n, 8 * k_per), bool)
    for c in range(n):
        idx = np.flatnonzero(valid[c])
        order = idx[np.lexsort((idx, dist[c, idx], sec[c, idx]))]
        s_sorted = sec[c, order]
        for b in range(-4, 4):
            mine = order[s_sorted == b][:k_per]
            slot = (b + 4) * k_per
            picks[c, slot:slot + len(mine)] = mine
            mask[c, slot:slot + len(mine)] = True
    pr = rows[np.arange(n)[:, None], picks // WN]
    pc = cols[np.arange(n)[:, None], picks % WN]
    vals = np.where(mask, grid_z[pr, pc], 0.0)
    return _ok(t2, prep, np.stack([pc * res, pr * res], -1),
               np.stack([j * res, i * res], -1), vals, mask, dtype)


def _rotation(vario):
    th = np.deg2rad(vario["azimuth"])
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return rot @ np.diag([1.0 / vario["major_range"],
                          1.0 / vario["minor_range"]])


def _ok(t2, prep, coords, target, vals, mask, dtype):
    """Ordinary kriging of each row: the bordered system with the Lagrange
    row over the valid neighbours (1e-6 on the covariance's diagonal),
    the estimate in local-mean form, the variance sill - w . rho; a row
    with no neighbour takes the prior (global mean, sill)."""
    v = t2.vario
    amp = v["sill"] - v["nugget"]
    rot = _rotation(v)
    pts = np.concatenate([coords, target[:, None]], axis=1) @ rot
    h = np.sqrt(((pts[:, :, None] - pts[:, None, :]) ** 2).sum(-1))
    full = amp * matern(h, v["s"])
    k = coords.shape[1]
    m = mask.astype(np.float64)
    sigma = full[:, :k, :k] * m[:, :, None] * m[:, None, :]
    sigma = sigma + np.eye(k) * ((1.0 - m) + 1e-6)[:, None, :]
    rho = full[:, :k, k] * m
    has = m.sum(-1) > 0
    A = np.zeros((len(m), k + 1, k + 1))
    A[:, :k, :k] = sigma
    A[:, k, :k] = m
    A[:, :k, k] = m
    A[:, k, k] = 1.0 - has
    b = np.concatenate([rho, has[:, None].astype(np.float64)], -1)
    At, bt = (torch.as_tensor(A), torch.as_tensor(b))
    if dtype is not np.float64:
        At, bt = (x.to(torch.bfloat16).to(torch.float32) for x in (At, bt))
    w = torch.linalg.solve(At, bt[..., None])[..., 0]
    w = _round(w, dtype).double().numpy()
    local = (vals * m).sum(-1) / np.maximum(m.sum(-1), 1.0)
    est = local + (w[:, :k] * m * (vals - local[:, None])).sum(-1)
    var = v["sill"] - (w[:, :k] * rho).sum(-1)
    est = np.where(has, est, prep["global_mean"])
    var = np.where(has, var, v["sill"])
    return _round(est, dtype), _round(var, dtype)


def _round(x, dtype):
    if dtype is np.float64:
        return x
    t = torch.as_tensor(x).to(torch.bfloat16)
    return t.float() if isinstance(x, torch.Tensor) else t.double().numpy()


def draw(prep, cells, est, var, u, dtype=np.float64):
    """The bounded draw of ``cells`` from (est, var) with uniforms ``u``:
    est + sd ppf(u) of the normal truncated to the bounds' scores (the
    point mass where they meet)."""
    from scipy.stats import truncnorm

    sd = np.maximum(np.sqrt(np.abs(var)), 1e-12)
    lo = prep["lo"][cells[:, 0], cells[:, 1]]
    hi = prep["hi"][cells[:, 0], cells[:, 1]]
    eq = lo == hi
    a = np.where(eq, -1.0, (lo - est) / sd)
    b = np.where(eq, 1.0, (hi - est) / sd)
    z = np.where(eq, lo, est + sd * truncnorm.ppf(u, a, b))
    return _round(z, dtype)


def judge_bed(t2: T2, prep: dict, bed, seed: int, chunks, dtype=np.float64):
    """The reference's scores of the cells of the path's ``chunks`` of the
    bed the program made with ``seed``, each kriged from the scores the
    program's ``bed`` holds before its chunk; with them, the program's
    scores there.  Returns (reference, program), in standard-normal
    score units."""
    cells = prep["cells"]
    order, uniforms = path_and_uniforms(len(cells), seed, t2.chunk, chunks)
    path = cells[order]
    rank = np.full(t2.cond.shape, -1, np.int64)
    rank[path[:, 0], path[:, 1]] = np.arange(len(path))
    z = np.where(prep["cond_msk"], prep["z_data"],
                 transform.scores(bed, prep["q"], prep["r"]))
    ref, got = [], []
    for k in sorted(uniforms):
        sl = slice(k * t2.chunk, (k + 1) * t2.chunk)
        cc = path[sl]
        known = prep["cond_msk"] | ((rank >= 0) & (rank < sl.start))
        est, var = krige(t2, prep, z, known, cc, dtype)
        ref.append(draw(prep, cc, est, var, uniforms[k], dtype))
        got.append(z[cc[:, 0], cc[:, 1]])
    return np.concatenate(ref), np.concatenate(got)
