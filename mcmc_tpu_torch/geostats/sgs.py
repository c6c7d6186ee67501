"""Sequential Gaussian simulation and kriging maps, batched over chunks of
cells.

PyTorch counterpart of ``mcmc_tpu/geostats/sgs.py`` (the reference's
per-cell SGS loop, gstatsim_custom/interpolate.py:92-191 ``sgs`` and
:13-89 ``krige``).  The shuffled simulation path is processed in chunks:
each chunk's cells take their neighbours from a fixed (2w+1)^2 window by
the octant search (``ops/neighbors.py``), one masked kriging solve a cell
(``ops/kriging.py``), then a Gaussian (or bounded truncated-normal) draw.
Cells of one chunk are conditioned on everything before the chunk, not on
each other, exactly as in the JAX package; a cell with no conditioning in
its window draws from N(global_mean, sill).

Where the work runs: a chunk's window gather, octant search, kriging
solve and scatter are a fixed set of batched torch ops on ``device`` (the
card unless the caller asks for the CPU), in float32 as the JAX package
computes them; the normal-score transforms (``transform_np`` /
``inverse_np``) stay on the host in numpy, as the JAX package's do.  The
draws follow the grid (``_bed_draws``).  On a CPU grid they stay on the
host, as the JAX package's do: a chunk's (est, var) go to the host and
scipy draws there (``_host_draws``, one ``mcmc.sgs.draw`` a chunk).  On
the card the bed's uniforms (bounded) or standard normals (unbounded),
one a cell, are drawn on the host at once after the path's permutation,
the same stream the chunk-by-chunk calls take, and uploaded with the
transformed bounds (``_CardDraws``); each chunk then draws in float64 and
scatters its scores on the card (``ops/bounded_draw_kernel.py``), so no
chunk waits for the host.

How the chunks reach the device: one runner (``_run_chunks``) takes a
chunk body, ``sgs``'s (solve, then draw and scatter) or ``krige``'s
(solve, then est and var into device maps read back once at the end).
Eagerly it launches every chunk from Python (``_sgs_loop_eager``,
``_krige_loop_eager``): the plain versions, which CPU grids run.  On the
card, as the JAX package's jitted ``batch_cell`` and ``scatter`` do, it
captures the body as one CUDA graph a call (``_sgs_loop_captured``,
``_krige_loop_captured``): the first chunk runs eagerly (it warms the
sort's and the solver's workspaces), every later full chunk is the copy
of its cells and a replay, with no wait, and the last ``n mod chunk``
cells run eagerly; the captured loops give the eager loops' bits.  Only a
chunk that lives on the device whole is captured: an ``sgs`` loop given a
host ``draw`` runs eagerly.  Under any profiler the runner shows as spans
(``utils/spans.py``): ``.eager`` (the first chunk, the tail, a CPU grid's
every chunk), ``.capture`` and one ``.chunk`` holding its ``.replay`` a
replayed chunk; ``sgs`` adds ``mcmc.sgs`` a call, holding ``.prepare``
(the transforms, the path), ``.draw`` (the bed's draw and upload on the
card, a chunk's draws on the host) and ``.finish`` (the inverse
transform).  A chunk drawn on the card counts one launch of
``ops/bounded_draw_kernel.bounded_draw`` (``.launches``), replays
included (``utils/graphs.CountedGraph``).

Random stream: the host generator is seeded with the same numpy uint32
scalar as the JAX package's (the last word of its key data, ``seed mod
2**32``), so the path permutation and every normal or truncated-normal
draw are the JAX package's; beds then differ from the JAX package's only
by float32 rounding in the solves (and, on the card, by the draws'
float64 rounding on the card against scipy's on the host, about 1e-15).
``seed=None`` draws fresh entropy.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.bounded_draw_kernel import bounded_draw
from ..ops.covariance import CovarianceSpec, _f32, make_rotation_matrix
from ..ops.kriging import ok_solve_masked, sk_solve_masked
from ..ops.neighbors import octant_sector, octant_select
from ..ops.transforms import NormalScoreTransform
from ..utils.graphs import CountedGraph, capture_graph
from ..utils.rng import resolve_device, resolve_seed
from ..utils.spans import span


def _vario_to_spec(variogram: dict) -> CovarianceSpec:
    vt = variogram["vtype"].lower()
    return CovarianceSpec(vt, s=variogram.get("s"))


def _check_vario(variogram):
    missing = [k for k in ("major_range", "minor_range", "azimuth", "sill",
                           "nugget", "vtype") if k not in variogram]
    if missing:
        raise ValueError(f"Variogram missing {', '.join(missing)}")
    if variogram["vtype"].lower() not in ("exponential", "gaussian",
                                          "spherical", "matern"):
        raise ValueError("vtype must be exponential, gaussian, spherical, "
                         "or matern")
    if variogram["vtype"].lower() == "matern" and "s" not in variogram:
        raise ValueError("Matern covariance requires the s parameter in "
                         "the variogram")


def _make_cell_kernel(spec, ktype, num_points, half_window):
    """Per chunk of cells (i, j): gather each cell's window, octant
    neighbours, kriging -> (est, var), each (C,) float32.

    The JAX package's cell kernel, batched and in fewer launches: the
    grid holds NaN where no score is known yet, so one gather gives the
    window's values and validity (the target's own cell is NaN until it
    is drawn, so it needs no exclusion); the distance and sector planes
    are broadcast from the window's row and column coordinates (the same
    float32 values as the JAX package's (S, S, 2) coordinate window); a
    pick's coordinates are read back from those by index."""
    WN = 2 * half_window + 1
    k_per = max(int(num_points) // 8, 1)

    def cells(grid, i, j, res, rot, sill, nugget, radius, global_mean):
        H, W = grid.shape
        C = i.shape[0]
        ar = torch.arange(WN, device=grid.device)
        rows = torch.clamp(i - half_window, 0, H - WN)[:, None] + ar
        cols = torch.clamp(j - half_window, 0, W - WN)[:, None] + ar
        gw = grid[rows[:, :, None], cols[:, None, :]].reshape(C, -1)
        rows_f = rows.to(torch.float32) * res
        cols_f = cols.to(torch.float32) * res
        target = torch.stack([j.to(torch.float32) * res,
                              i.to(torch.float32) * res], dim=-1)
        dx = target[:, None, None, 0] - cols_f[:, None, :]   # (C, 1, WN)
        dy = target[:, None, None, 1] - rows_f[:, :, None]   # (C, WN, 1)
        dist = torch.sqrt(dx * dx + dy * dy).reshape(C, -1)
        valid = ~torch.isnan(gw) & (dist < radius)
        idx, mask = octant_select(dist, octant_sector(dx, dy).reshape(C, -1),
                                  valid, k_per)
        # an empty slot's coordinates are finite and its weight zero
        coords = torch.stack([torch.gather(cols_f, 1, idx % WN),
                              torch.gather(rows_f, 1, idx // WN)], dim=-1)
        vals = torch.where(mask, torch.gather(gw, 1, idx), 0.0)
        mask_f = mask.to(torch.float32)
        if ktype == "ok":
            est, var = ok_solve_masked(spec, target, coords, vals, mask_f,
                                       rot, sill, nugget)
        else:
            est, var = sk_solve_masked(spec, target, coords, vals, mask_f,
                                       rot, sill, nugget, global_mean)
        # no-neighbour fallback: an unconditional draw from the prior
        has = mask.any(dim=-1)
        return (torch.where(has, est, global_mean),
                torch.where(has, var, sill))

    return cells


def _prepare(xx, grid, variogram, sim_mask, num_points, ktype, half_window,
             device):
    """Shared ``sgs``/``krige`` set-up on the host: the normal-score fit
    and the transformed grid, the target cells, the window (clamped to
    the grid, WN <= min(H, W)) and the per-chunk cell function; the
    scalars as Python floats holding the float32 values the device
    computes with."""
    _check_vario(variogram)
    grid = np.asarray(grid, float)
    H, W = grid.shape
    res = float(abs(np.asarray(xx)[0, 1] - np.asarray(xx)[0, 0]))

    cond_msk = ~np.isnan(grid)
    data = grid[cond_msk]
    nst = NormalScoreTransform.fit(data, n_quantiles=min(500, data.size))
    z0 = np.where(cond_msk, np.nan_to_num(grid), 0.0)
    z0 = np.asarray(nst.transform_np(z0))
    z0 = np.where(cond_msk, z0, 0.0)
    global_mean = float(z0[cond_msk].mean())

    if sim_mask is None:
        sim_mask = np.ones((H, W), bool)
    cells = np.argwhere(np.asarray(sim_mask, bool) & ~cond_msk)

    hw = min(int(half_window), (min(H, W) - 1) // 2)
    rot = make_rotation_matrix(variogram["azimuth"],
                               variogram["major_range"],
                               variogram["minor_range"]).to(device)
    cell = _make_cell_kernel(_vario_to_spec(variogram), ktype,
                             int(num_points), hw)
    return dict(grid=grid, H=H, W=W, res=_f32(res), cond_msk=cond_msk,
                nst=nst, z0=z0, global_mean=_f32(global_mean), cells=cells,
                rot=rot, cell=cell, sill=_f32(variogram["sill"]),
                nugget=_f32(variogram["nugget"]))


def _transformed_bounds(p, bounds):
    """The (lower, upper) bounds, each a scalar or an (H, W) array, as
    normal-score planes; None without bounds."""
    if bounds is None:
        return None
    if len(bounds) != 2:
        raise ValueError("bounds must be an iterable of length 2 with "
                         "lower and upper bounds")
    tb = []
    for b in bounds:
        b = (np.full((p["H"], p["W"]), float(b)) if np.isscalar(b)
             else np.asarray(b, float))
        if b.shape != p["grid"].shape:
            raise ValueError("bounds must have same shape as grid")
        tb.append(np.asarray(p["nst"].transform_np(b)))
    return tb


def _score_grid(p, device):
    """The (H, W) float32 normal scores on ``device``: the data's, NaN
    where no score is known yet."""
    return torch.as_tensor(np.where(p["cond_msk"], p["z0"], np.nan),
                           dtype=torch.float32, device=device)


def _solve(p, zg, ii, jj, radius):
    """(est, var) of the cells (ii, jj), each (C,) float32 on ``zg``'s
    device."""
    return p["cell"](zg, ii, jj, p["res"], p["rot"], p["sill"],
                     p["nugget"], _f32(radius), p["global_mean"])


def _host_draws(rng, bounds):
    """``sgs``'s draws on the host: ``draw(cells, est, var)``, the float64
    draws at ``cells`` given (est, var), from ``rng`` chunk by chunk;
    ``bounds`` the transformed (lower, upper) planes or None."""

    def draw(cells, est, var):
        sd = np.sqrt(np.abs(var))
        if bounds is None:
            return rng.normal(est, np.maximum(sd, 1e-12))
        from scipy.stats import truncnorm

        lo, hi = (b[cells[:, 0], cells[:, 1]] for b in bounds)
        eq = lo == hi
        sd_s = np.maximum(sd, 1e-12)
        # mask degenerate bounds BEFORE calling rvs: scipy raises on
        # a == b instead of returning the point mass
        a = np.where(eq, -1.0, (lo - est) / sd_s)
        b = np.where(eq, 1.0, (hi - est) / sd_s)
        return np.where(eq, lo, truncnorm.rvs(a, b, loc=est, scale=sd_s,
                                               random_state=rng))

    return draw


class _CardDraws:
    """``sgs``'s draws on the grid's device: every cell's uniform
    (bounded) or standard normal (unbounded) drawn from ``rng`` at once,
    which is the stream the host's chunk-by-chunk draws take (one
    ``rng.uniform`` a cell in ``truncnorm.rvs``, one standard normal in
    ``rng.normal``), laid at the path's cells in an (H, W) float64 plane
    and uploaded once with the transformed ``bounds`` (or None).
    ``scatter`` draws a chunk and writes it into the grid there
    (``ops/bounded_draw_kernel.py``)."""

    def __init__(self, rng, path, bounds, grid):
        with span("mcmc.sgs.draw"):
            n = path.shape[0]
            plane = np.zeros(tuple(grid.shape))
            plane[path[:, 0], path[:, 1]] = (
                rng.standard_normal(n) if bounds is None
                else rng.uniform(size=n))
            self.bounds = None
            if bounds is not None:
                lo, hi = (b[path[:, 0], path[:, 1]] for b in bounds)
                if not np.all((lo < hi) | (lo == hi)):
                    # as scipy's truncnorm.rvs refuses a > b on the host
                    raise ValueError("Domain error in arguments: a lower "
                                     "bound above its upper bound")
                self.bounds = tuple(torch.as_tensor(
                    np.ascontiguousarray(b, float), device=grid.device)
                    for b in bounds)
            self.u = torch.as_tensor(plane, device=grid.device)

    def scatter(self, zg, cells, est, var):
        """Draw the ``cells`` ((C, 2) int64 on ``zg``'s device) from their
        (est, var) and write them into ``zg``."""
        bounded_draw(zg, cells, est, var, self.u,
                     *(self.bounds or (None, None)))


def _host_scatter(draw):
    """A host ``draw(cells, est, var) -> ndarray`` as a chunk's scatter:
    (est, var) to the host in float64 (one sync), the draws there, written
    into the grid."""

    def scatter(zg, cells, est, var):
        est, var = torch.stack([est, var]).cpu().numpy().astype(float)
        with span("mcmc.sgs.draw"):
            draws = draw(cells.cpu().numpy(), est, var)
        zg[cells.unbind(1)] = torch.as_tensor(draws, dtype=torch.float32,
                                              device=zg.device)

    return scatter


def _bed_draws(rng, path, bounds, zg):
    """``sgs``'s draws for the grid ``zg``: the card's (``_CardDraws``) on
    a CUDA grid, the host's chunk by chunk (``_host_draws``) elsewhere."""
    return (_CardDraws(rng, path, bounds, zg) if zg.device.type == "cuda"
            else _host_draws(rng, bounds))


@contextlib.contextmanager
def _batched_lu(device):
    """For the call, the kriging solves' batched LU from cuBLAS on the
    card (torch's "cusolver" backend: ``getrfBatched`` / ``getrsBatched``),
    in the eager and the captured loop alike, so both give the same bits;
    torch's default at these shapes is MAGMA's batched LU, which a CUDA
    graph cannot capture.  Elsewhere nothing changes."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _run_chunks(run, path, C, device, capture):
    """``run(cells)`` over the ``C``-cell chunks of ``path`` ((n, 2) cells),
    which it returns as an int64 tensor on ``device``.  With ``capture``
    None every chunk is launched from Python; else the first chunk runs
    eagerly, ``run`` on a fixed (C, 2) cell buffer is captured once
    (``utils/graphs.CountedGraph``) and replayed for every later full
    chunk, and the last ``n mod C`` cells run eagerly.  Fewer than two
    full chunks have nothing to replay and run eagerly."""
    path_t = torch.as_tensor(np.ascontiguousarray(path), dtype=torch.long,
                             device=device)
    n = path_t.shape[0]
    full = 0 if capture is None else n // C

    def eager(lo, hi):
        with span("mcmc.sgs.eager"):
            for start in range(lo, hi, C):
                run(path_t[start: start + C])

    if full < 2:
        eager(0, n)
        return path_t
    eager(0, C)
    this = path_t[C: 2 * C].clone()
    with span("mcmc.sgs.capture"):
        graph = CountedGraph(capture, lambda: run(this))
    for k in range(1, full):
        with span("mcmc.sgs.chunk"), span("mcmc.sgs.replay"):
            if k > 1:
                this.copy_(path_t[k * C: (k + 1) * C])
            graph.replay()
    if n > full * C:
        eager(full * C, n)
    return path_t


def _sgs_loop_captured(p, zg, path, radius, chunk, draw,
                       capture=capture_graph):
    """The SGS chunk loop (``_run_chunks``): each chunk solved, then drawn
    and scattered into ``zg`` by ``sgs``'s card draws (``_CardDraws``) or
    by a host ``draw(cells, est, var)`` (``_host_scatter``).  Only the
    card draws' chunk lives on the device whole and is captured: with a
    host ``draw`` the loop is the eager one."""
    card = isinstance(draw, _CardDraws)
    scatter = draw.scatter if card else _host_scatter(draw)
    _run_chunks(lambda cells: scatter(zg, cells, *_solve(
        p, zg, *cells.unbind(1), radius)), path, int(chunk), zg.device,
        capture if card else None)


def _sgs_loop_eager(p, zg, path, radius, chunk, draw):
    """``_sgs_loop_captured`` with every chunk launched from Python: the
    plain version, which CPU grids run."""
    _sgs_loop_captured(p, zg, path, radius, chunk, draw, capture=None)


def _krige_loop_captured(p, zg, cells, radius, chunk, est_map, var_map,
                         capture=capture_graph):
    """``krige``'s chunk loop (``_run_chunks``): the chunks do not depend
    on each other, so each writes its (est, var) into (2, H, W) device
    maps, read back once at the end into ``est_map`` / ``var_map``."""
    maps = torch.zeros((2,) + tuple(zg.shape), dtype=torch.float32,
                       device=zg.device)

    def run(c):
        ii, jj = c.unbind(1)
        maps[:, ii, jj] = torch.stack(_solve(p, zg, ii, jj, radius))

    cells_t = _run_chunks(run, cells, int(chunk), zg.device, capture)
    out = maps[:, cells_t[:, 0], cells_t[:, 1]].cpu().numpy().astype(float)
    est_map[cells[:, 0], cells[:, 1]], var_map[cells[:, 0], cells[:, 1]] = out


def _krige_loop_eager(p, zg, cells, radius, chunk, est_map, var_map):
    """``_krige_loop_captured`` with every chunk launched from Python: the
    plain version, which CPU grids run."""
    _krige_loop_captured(p, zg, cells, radius, chunk, est_map, var_map,
                         capture=None)


def _chunk_loops(device):
    """(``sgs``'s, ``krige``'s) chunk loop for a grid on ``device``: the
    captured loops on the card, the eager loops, their plain versions,
    elsewhere."""
    if device.type == "cuda":
        return _sgs_loop_captured, _krige_loop_captured
    return _sgs_loop_eager, _krige_loop_eager


def numpy_seed(seed) -> np.uint32:
    """The host generator's seed: ``seed mod 2**32`` as a numpy uint32,
    the last word of the JAX package's key data for ``seed`` (fresh
    entropy for None)."""
    return np.uint32(resolve_seed(seed) % (1 << 32))


def sgs(xx, yy, grid, variogram, radius=100e3, num_points=20, ktype="ok",
        sim_mask=None, quiet=True, stencil=None, rcond=None, bounds=None,
        seed=None, chunk=64, half_window=40, *, device=None):
    """Full sequential Gaussian simulation (reference
    interpolate.py:92-191).

    grid: NaN except at conditioning data.  Applies the normal-score
    transform internally and inverse-transforms the result, including the
    bounded (truncated-normal) draw path used for initial-bed generation
    below the ice surface (interpolate.py:176-187).  ``device``: where
    each chunk's solves run (the card unless the caller asks for the
    CPU; on the card the chunks replay a captured CUDA graph).  Returns
    the simulated 2D array in data units.
    """
    device = resolve_device(device)
    with span("mcmc.sgs"):
        # the fit and the bounds depend on the data alone; the path on
        # the seed too
        with span("mcmc.sgs.prepare"):
            with span("mcmc.sgs.prepare.fit"):
                p = _prepare(xx, grid, variogram, sim_mask, num_points,
                             ktype, half_window, device)
                H, W, nst = p["H"], p["W"], p["nst"]
            with span("mcmc.sgs.prepare.path"):
                rng = np.random.default_rng(numpy_seed(seed))
                order = rng.permutation(p["cells"].shape[0])
                path = p["cells"][order]
            with span("mcmc.sgs.prepare.bounds"):
                tb = _transformed_bounds(p, bounds)
                zg = _score_grid(p, device)

        draw = _bed_draws(rng, path, tb, zg)
        with _batched_lu(device):
            _chunk_loops(device)[0](p, zg, path, radius, chunk, draw)

        with span("mcmc.sgs.finish"):
            # cells outside sim_mask keep the score 0, as in the JAX package
            out = np.asarray(nst.inverse_np(np.nan_to_num(
                zg.cpu().numpy())))
            return out.reshape(H, W)


def krige(xx, yy, grid, variogram, radius=100e3, num_points=20, ktype="ok",
          sim_mask=None, quiet=True, stencil=None, chunk=256,
          half_window=40, *, device=None):
    """Kriging mean and std maps (reference interpolate.py:13-89; the
    reference's own ``krige`` is broken, SURVEY.md §8.3).  The std map is
    ``inverse_np(sqrt(var))``, as in the JAX package.  Returns (mean_map,
    std_map) in data units."""
    device = resolve_device(device)
    p = _prepare(xx, grid, variogram, sim_mask, num_points, ktype,
                 half_window, device)
    H, W, nst = p["H"], p["W"], p["nst"]
    est_map = p["z0"].copy()
    var_map = np.zeros((H, W))
    with _batched_lu(device):
        _chunk_loops(device)[1](p, _score_grid(p, device), p["cells"],
                                radius, chunk, est_map, var_map)

    var_map = np.where(var_map < 0, 0.0, var_map)
    mean_out = np.asarray(nst.inverse_np(est_map))
    std_out = np.asarray(nst.inverse_np(np.sqrt(var_map)))
    return mean_out.reshape(H, W), std_out.reshape(H, W)


def generate_initial_beds(xx, yy, cond_bed, variogram, surf=None, n_beds=1,
                          radius=50e3, num_points=32, seed=0, *,
                          device=None, **kw):
    """Per-chain SGS initial beds, bounded below the ice surface (the T2
    workflow: reference T2_StatisticalAnalysis.ipynb cells 20-22, consumed
    by largeScaleChain_multiprocessing.py:602-606): bed i is ``sgs`` with
    ``seed + i``, between 2000 m below the lowest datum and ``surf - 1``
    where ``surf`` is given."""
    device = resolve_device(device)
    beds = []
    bounds = None
    if surf is not None:
        lo = np.full(np.shape(cond_bed),
                     float(np.nanmin(cond_bed) - 2000.0))
        bounds = (lo, np.asarray(surf, float) - 1.0)
    for i in range(n_beds):
        beds.append(sgs(xx, yy, np.asarray(cond_bed, float), variogram,
                        radius=radius, num_points=num_points, bounds=bounds,
                        seed=seed + i, device=device, **kw))
    return beds
