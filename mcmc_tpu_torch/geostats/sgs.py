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
draws follow the grid.  On a CPU grid they stay on the host, as the JAX
package's do: a chunk's (est, var) go to the host and scipy draws there
(``_host_draws``).  On the card the bed's uniforms (bounded) or standard
normals (unbounded), one a cell, are drawn on the host at once after the
path's permutation, the same stream the chunk-by-chunk calls take, and
uploaded with the transformed bounds (``_CardDraws``); each chunk then
draws in float64 and scatters its scores on the card
(``ops/bounded_draw_kernel.py``), so no chunk waits for the host.

How the chunks reach the device: on the card, as the JAX package's
jitted ``batch_cell`` and ``scatter`` do, one CUDA graph is captured a
call and replayed for every full chunk but the first
(``_sgs_loop_captured``, ``_krige_loop_captured``); the first chunk runs
eagerly (it warms the sort's and the solver's workspaces), and so do the
last ``n mod chunk`` cells.  The eager loops (``_sgs_loop_eager``,
``_krige_loop_eager``) launch every op from Python: they are the plain
versions, which CPU grids run, and the captured loops give their bits.
With the card's draws a replayed chunk is the copy of its cells and the
replay: it solves, draws and scatters, and the host queues the next
without waiting; the one sync is ``.finish``'s grid to the host.  With
host draws (a CPU grid, or a ``draw`` callable other than ``sgs``'s own)
the chunk's (est, var) go to a pinned host buffer, one sync a chunk.
Under any profiler ``sgs`` shows as spans (``utils/spans.py``):
``mcmc.sgs`` a call, holding ``.prepare`` (the transforms, the path),
``.eager`` (the first chunk, the tail, a CPU grid's every chunk),
``.capture``, one ``.chunk`` a replayed chunk (its ``.replay``; with host
draws also ``.wait`` for the card and the host's ``.draw``) and
``.finish`` (the inverse transform); ``.draw`` is the host's draws, a
chunk's on the host path, and on the card the one draw and upload of a
bed.  A chunk drawn on the card counts one launch of
``ops/bounded_draw_kernel.bounded_draw`` (``.launches``), replays
included.

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
from ..ops.launch_counts import uncounted
from ..ops.neighbors import octant_sector, octant_select
from ..ops.transforms import NormalScoreTransform
from ..utils.graphs import capture_graph
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


def _solve_chunk(p, zg, ii, jj, radius):
    """(est, var) of the cells (ii, jj) as float64 host arrays: one sync."""
    out = torch.stack(_solve(p, zg, ii, jj, radius)).cpu().numpy()
    return out.astype(float)


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


def _sgs_loop_eager(p, zg, path, radius, chunk, draw):
    """The SGS chunk loop with every op launched from Python, the plain
    version of ``_sgs_loop_captured`` and what CPU grids run: a chunk's
    (est, var) to the host, ``draw(cells, est, var)`` there, the draws
    scattered into ``zg``; or, with ``sgs``'s card draws
    (``_CardDraws``), the chunk drawn and scattered on ``zg``'s device."""
    with span("mcmc.sgs.eager"):
        path_t = torch.as_tensor(np.ascontiguousarray(path),
                                 dtype=torch.long, device=zg.device)
        for start in range(0, path.shape[0], chunk):
            cells = path_t[start: start + chunk]
            if isinstance(draw, _CardDraws):
                draw.scatter(zg, cells, *_solve(p, zg, *cells.unbind(1),
                                                radius))
                continue
            est, var = _solve_chunk(p, zg, *cells.unbind(1), radius)
            with span("mcmc.sgs.draw"):
                draws = draw(path[start: start + chunk], est, var)
            zg[cells.unbind(1)] = torch.as_tensor(draws, dtype=torch.float32,
                                                  device=zg.device)


def _sgs_loop_captured(p, zg, path, radius, chunk, draw,
                       capture=capture_graph):
    """``_sgs_loop_eager``'s bits from one captured chunk (module
    docstring): the first chunk eagerly, then ``capture(body)`` of a
    chunk on fixed buffers replayed for every later full chunk
    (``_card_replays`` with ``sgs``'s card draws, else
    ``_host_replays``), then the last ``n mod chunk`` cells eagerly.  A
    path of fewer than two full chunks has nothing to replay and runs
    eagerly."""
    n, C = path.shape[0], int(chunk)
    full = n // C
    if full < 2:
        return _sgs_loop_eager(p, zg, path, radius, C, draw)
    _sgs_loop_eager(p, zg, path[:C], radius, C, draw)
    replays = (_card_replays if isinstance(draw, _CardDraws)
               else _host_replays)
    replays(p, zg, path, radius, C, full, draw, capture)
    if n > full * C:
        _sgs_loop_eager(p, zg, path[full * C:], radius, C, draw)


def _card_replays(p, zg, path, radius, C, full, draws, capture):
    """Full chunks 1 .. ``full`` - 1 of ``path`` with ``sgs``'s card draws:
    a captured chunk that solves, draws and scatters on the device, from
    Python a copy of its cells and the replay, with no wait.  Each replay
    counts the launches its capture counted (``ops/launch_counts.py``)."""
    cells_t = torch.as_tensor(path[C: full * C], dtype=torch.long,
                              device=zg.device)
    this = torch.empty((C, 2), dtype=torch.long, device=zg.device)

    def body():
        draws.scatter(zg, this, *_solve(p, zg, *this.unbind(1), radius))

    this.copy_(cells_t[:C])
    with span("mcmc.sgs.capture"):
        graph, launches = uncounted(capture, body)
    for k in range(full - 1):
        with span("mcmc.sgs.chunk"), span("mcmc.sgs.replay"):
            if k:
                this.copy_(cells_t[k * C: (k + 1) * C])
            graph.replay()
        for counter, count in launches:
            counter.launches += count


def _host_replays(p, zg, path, radius, C, full, draw, capture):
    """Full chunks 1 .. ``full`` - 1 of ``path`` with host draws: a
    captured chunk on fixed buffers (the last chunk's scatter, then this
    chunk's solve), from Python a copy of its cells, the replay, (est,
    var) to a pinned host buffer (the one sync), ``draw`` there and the
    draws back from another; the last replayed chunk's draws scattered
    after the loop."""
    dev = zg.device
    pin = dev.type == "cuda"
    path_t = torch.as_tensor(path[:full * C], dtype=torch.long, device=dev)
    cells = torch.empty((2 * C, 2), dtype=torch.long, device=dev)
    last, this = cells[:C].unbind(1), cells[C:].unbind(1)
    draws = torch.empty(C, dtype=torch.float32, device=dev)
    out = torch.empty((2, C), dtype=torch.float32, device=dev)
    draws_h = torch.empty(C, dtype=torch.float32, pin_memory=pin)
    out_h = torch.empty((2, C), dtype=torch.float32, pin_memory=pin)

    def body():
        zg[last] = draws
        out[0], out[1] = _solve(p, zg, *this, radius)

    cells.copy_(path_t[:2 * C])
    draws.copy_(zg[last])  # the first chunk's, which the first replay rewrites
    with span("mcmc.sgs.capture"):
        graph = capture(body)
    for k in range(1, full):
        with span("mcmc.sgs.chunk"):
            with span("mcmc.sgs.replay"):
                if k > 1:
                    cells.copy_(path_t[(k - 1) * C: (k + 1) * C])
                graph.replay()
            with span("mcmc.sgs.wait"):
                out_h.copy_(out)  # waits for the replay
                est, var = out_h.numpy().astype(float)
            with span("mcmc.sgs.draw"):
                draws_h.numpy()[:] = draw(path[k * C: (k + 1) * C], est,
                                          var)
            draws.copy_(draws_h, non_blocking=True)
    zg[this] = draws  # the last replayed chunk's draws


def _krige_loop_eager(p, zg, cells, radius, chunk, est_map, var_map):
    """``krige``'s chunk loop with every op launched from Python, the plain
    version of ``_krige_loop_captured`` and what CPU grids run: each
    chunk's (est, var) to the host and into ``est_map`` / ``var_map``."""
    cells_t = torch.as_tensor(cells, dtype=torch.long, device=zg.device)
    for start in range(0, cells.shape[0], chunk):
        cc = cells[start: start + chunk]
        est, var = _solve_chunk(p, zg,
                                *cells_t[start: start + chunk].unbind(1),
                                radius)
        est_map[cc[:, 0], cc[:, 1]] = est
        var_map[cc[:, 0], cc[:, 1]] = var


def _krige_loop_captured(p, zg, cells, radius, chunk, est_map, var_map,
                         capture=capture_graph):
    """``_krige_loop_eager``'s bits from one captured chunk: the chunks do
    not depend on each other, so each writes its (est, var) into device
    maps, read back once at the end, and a replayed chunk is a copy of its
    cells and the replay, with no sync.  The first chunk runs eagerly,
    then ``capture(body)`` is replayed for every later full chunk, then
    the last ``n mod chunk`` cells run eagerly."""
    n, C = cells.shape[0], int(chunk)
    full = n // C
    if full < 2:
        return _krige_loop_eager(p, zg, cells, radius, C, est_map, var_map)
    cells_t = torch.as_tensor(cells, dtype=torch.long, device=zg.device)
    maps = torch.zeros((2,) + tuple(zg.shape), dtype=torch.float32,
                       device=zg.device)
    this = torch.empty((C, 2), dtype=torch.long, device=zg.device)

    def solve(ii, jj):
        maps[:, ii, jj] = torch.stack(_solve(p, zg, ii, jj, radius))

    def body():
        solve(*this.unbind(1))

    this.copy_(cells_t[:C])
    body()
    graph = capture(body)
    for k in range(1, full):
        this.copy_(cells_t[k * C: (k + 1) * C])
        graph.replay()
    if n > full * C:
        solve(*cells_t[full * C:].unbind(1))
    est, var = maps[:, cells_t[:, 0], cells_t[:, 1]].cpu().numpy().astype(
        float)
    est_map[cells[:, 0], cells[:, 1]] = est
    var_map[cells[:, 0], cells[:, 1]] = var


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

        draw = (_CardDraws(rng, path, tb, zg) if device.type == "cuda"
                else _host_draws(rng, tb))
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
