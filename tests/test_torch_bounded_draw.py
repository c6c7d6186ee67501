"""The T2 chunk's draws on the card (``mcmc_tpu_torch/ops/
bounded_draw_kernel.py`` and ``geostats/sgs.py``'s card path), on the CPU.

- The plain version's quantile function against scipy's ``truncnorm.ppf``
  over a grid of (u, a, b) (``tests/torch_helpers.ppf_grid``) within
  ``PPF_ATOL`` max(1, |x|), beyond scipy's own rounding where its left
  case cancels, and there against a 60-digit mpmath quantile within
  ``PPF_ATOL`` max(1, |x|); the unbounded draw as numpy's ``normal``.
- The stream: one draw of the bed's uniforms (normals) after the path's
  permutation is, bit for bit, what the host's chunk-by-chunk
  ``truncnorm.rvs`` (``rng.normal``) calls take.
- The card path's loops (``_CardDraws`` in ``_run_chunks``) run here with
  the plain version and ``tests/test_torch_geostats_graph.py``'s stub
  capture: the captured loop bit for bit the eager loop with the same
  draws, over every path length, bounded and not; the bed the host
  draws' bed to float32 rounding; its spans (a chunk is its replay, one
  ``.draw`` a bed).  The kernel itself: ``tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.stats import truncnorm

from mcmc_tpu_torch.ops import bounded_draw_kernel as K
from tests.test_torch_geostats import EXP
from tests.test_torch_geostats_graph import (  # noqa: F401  (fixtures)
    C, KW, LENGTHS, StubCapture, _bits, _bounds, problem)
from tests.test_torch_spans import _count, _inside, _profiled
from tests.torch_helpers import PPF_ATOL, ppf_grid, scipy_ppf_tolerance

tsgs = importlib.import_module("mcmc_tpu_torch.geostats.sgs")


def _t(*arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float64) for a in arrays)


def test_ppf_matches_scipy_over_the_grid():
    q, a, b = ppf_grid()
    want = truncnorm.ppf(q, a, b)
    got = K.truncnorm_ppf(*_t(q, a, b)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    tol = scipy_ppf_tolerance(q, a, b, want)
    assert (np.abs(got - want) <= tol).all()
    # where scipy's own rounding is below it, the plain tolerance alone
    plain = PPF_ATOL * np.maximum(1.0, np.abs(want))
    strict = tol <= 2 * plain
    assert (np.abs(got - want)[strict] <= plain[strict]).all()
    assert strict.mean() > 0.9


def test_ppf_matches_the_quantile_where_scipy_cancels():
    """Where a < 0 < x scipy sums log Φ(x) near 0 and loses x as u nears
    1 (by 0.01 at the largest uniform below 1); the plain version, on the
    right case where the quantile lies above 0, holds the 60-digit
    quantile on every such cell of the grid."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 60
    q, a, b = ppf_grid()
    want = truncnorm.ppf(q, a, b)
    sel = (a < 0) & (want > 0)
    q, a, b = q[sel], a[sel], b[sel]
    got = K.truncnorm_ppf(*_t(q, a, b)).numpy()
    for qi, ai, bi, x in zip(q, a, b, got):
        qm, am, bm = mpmath.mpf(qi), mpmath.mpf(ai), mpmath.mpf(bi)
        upper = (1 - qm) * (mpmath.ncdf(bm) - mpmath.ncdf(am)) \
            + mpmath.ncdf(-bm)  # Φ(-x), exact
        true = -mpmath.findroot(lambda t: mpmath.log(mpmath.ncdf(t))
                                - mpmath.log(upper), -mpmath.mpf(x))
        assert abs(x - float(true)) <= PPF_ATOL * max(1.0, abs(x)), (qi, ai,
                                                                     bi)
    assert sel.sum() > 300


def test_ndtri_exp_matches_scipy():
    from scipy import special

    y = -np.concatenate([np.logspace(-18, 5, 400), [0.14541, 0.14542, 2.0,
                                                    700.0, 708.0, 800.0]])
    got = K.ndtri_exp(torch.as_tensor(y)).numpy()
    want = special.ndtri_exp(y)
    assert (np.abs(got - want) <= PPF_ATOL * np.maximum(1, np.abs(want))).all()
    assert K.ndtri_exp(torch.tensor([-np.inf]))[0] == -np.inf


def _cells(n, shape, seed=3):
    rng = np.random.default_rng(seed)
    flat = rng.choice(shape[0] * shape[1], n, replace=False)
    return np.stack(np.unravel_index(flat, shape), axis=1)


@pytest.mark.parametrize("bounded", [False, True])
def test_draws_are_the_host_draws(bounded):
    """The dispatcher on a CPU grid against ``sgs``'s host draws (scipy's
    ``truncnorm.rvs`` / numpy's ``normal``) from the same seed: the
    float32 scores within one unit in the last place; the unbounded ones
    and the point masses (lo == hi) bit for bit."""
    shape, n = (40, 50), 700
    rng = np.random.default_rng(1)
    cells = _cells(n, shape)
    est = rng.normal(0, 1.5, n).astype(np.float32)
    var = rng.uniform(0, 2, n).astype(np.float32)
    var[:5] = 0.0  # the sd floor
    bounds = None
    if bounded:
        lo = rng.uniform(-4, 1, shape)
        hi = lo + rng.uniform(0, 3, shape)
        hi[tuple(cells[:40].T)] = lo[tuple(cells[:40].T)]  # point masses
        bounds = (lo, hi)
    want = tsgs._host_draws(np.random.default_rng(9), bounds)(
        cells, est.astype(float), var.astype(float)).astype(np.float32)
    grid = torch.full(shape, np.nan, dtype=torch.float32)
    draws = tsgs._CardDraws(np.random.default_rng(9), cells, bounds, grid)
    draws.scatter(grid, torch.as_tensor(cells), torch.as_tensor(est),
                  torch.as_tensor(var))
    got = grid.numpy()[tuple(cells.T)]
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    if bounded:
        np.testing.assert_array_equal(got[:40], want[:40])
    else:
        np.testing.assert_array_equal(got, want)
    assert K.bounded_draw.launches == 0  # a CPU grid runs the plain version


def test_one_draw_a_bed_is_the_chunk_by_chunk_stream():
    """After the same permutation, one ``uniform(size=n)`` is the chunks'
    uniforms, and ``truncnorm.rvs(a, b, loc, scale, random_state=rng)``
    is ``loc + scale·ppf(u, a, b)`` of them; one ``standard_normal(n)``
    gives ``rng.normal(est, sd)`` as ``est + sd·z``: bit for bit."""
    n, chunk = 300, 64
    rng = np.random.default_rng(7)
    est, sd = rng.normal(size=n), rng.uniform(0.1, 2, n)
    a = rng.uniform(-3, 0.5, n)
    b = a + rng.uniform(0.01, 4, n)
    starts = range(0, n, chunk)

    def fresh():
        g = np.random.default_rng(11)
        g.permutation(n)
        return g

    g = fresh()
    rvs = np.concatenate([truncnorm.rvs(a[s:s + chunk], b[s:s + chunk],
                                        loc=est[s:s + chunk],
                                        scale=sd[s:s + chunk],
                                        random_state=g) for s in starts])
    u = fresh().uniform(size=n)
    g = fresh()
    np.testing.assert_array_equal(np.concatenate(
        [g.uniform(size=len(range(s, min(s + chunk, n)))) for s in starts]),
        u)
    np.testing.assert_array_equal(rvs, est + sd * truncnorm.ppf(u, a, b))
    g = fresh()
    normal = np.concatenate([g.normal(est[s:s + chunk], sd[s:s + chunk])
                             for s in starts])
    np.testing.assert_array_equal(normal,
                                  est + sd * fresh().standard_normal(n))


def _loop(p, path, bounded, captured, seed=5):
    """A score grid after the chunk loop over ``path`` with the card's
    draws (the plain version here): eager, or captured with the stub."""
    bounds = (tuple(np.asarray(p["nst"].transform_np(b)) for b in bounded)
              if bounded else None)
    zg = tsgs._score_grid(p, torch.device("cpu"))
    draws = tsgs._CardDraws(np.random.default_rng(seed), path, bounds, zg)
    stub = StubCapture()
    stub.grids.append(zg)
    if captured:
        tsgs._sgs_loop_captured(p, zg, path, KW["radius"], C, draws,
                                capture=stub)
    else:
        tsgs._sgs_loop_eager(p, zg, path, KW["radius"], C, draws)
    return zg, stub


def _prepared(problem):
    return tsgs._prepare(problem["xx"], problem["cond_bed"], EXP, None,
                         KW["num_points"], "ok", KW["half_window"],
                         torch.device("cpu"))


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_card_path_captured_is_its_eager_loop(problem, n, bounded):
    """The card path's captured loop (the fused draw and scatter in the
    body, no host draw) against its eager loop with the same draws, bit
    for bit; one capture where a full chunk follows the first, a replay
    for each full chunk after it."""
    p = _prepared(problem)
    path = p["cells"][np.random.default_rng(2).permutation(
        len(p["cells"]))][:n]
    bounds = _bounds(problem) if bounded else None
    want, _ = _loop(p, path, bounds, captured=False)
    got, stub = _loop(p, path, bounds, captured=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    full = n // C
    assert stub.captures == (1 if full >= 2 else 0)
    assert stub.replays == max(full - 1, 0)
    assert np.isfinite(got.numpy()[tuple(path.T)]).all()


def test_card_path_bed_is_the_host_bed(problem):
    """Every cell of the grid, bounded: the card path's bed (the plain
    version's draws, captured with the stub) against ``sgs``'s CPU bed
    (scipy on the host) from the same seed, within float32 rounding of
    the scores carried through the later cells' kriging (at this size the
    two beds come out bit for bit the same)."""
    p = problem
    kw = dict(KW, seed=4, bounds=_bounds(p))
    host = tsgs.sgs(p["xx"], p["yy"], p["cond_bed"], EXP, device="cpu",
                    **kw)
    prep = _prepared(p)
    rng = np.random.default_rng(tsgs.numpy_seed(4))
    path = prep["cells"][rng.permutation(len(prep["cells"]))]
    bounds = tuple(np.asarray(prep["nst"].transform_np(b))
                   for b in _bounds(p))
    zg = tsgs._score_grid(prep, torch.device("cpu"))
    stub = StubCapture()
    stub.grids.append(zg)
    tsgs._sgs_loop_captured(prep, zg, path, KW["radius"], C,
                            tsgs._CardDraws(rng, path, bounds, zg),
                            capture=stub)
    card = np.asarray(prep["nst"].inverse_np(np.nan_to_num(zg.numpy())))
    assert stub.replays == len(path) // C - 1
    np.testing.assert_allclose(card, host, atol=1e-3, rtol=0)


def test_card_path_spans(problem):
    """On the card path a replayed chunk's span holds its replay alone, no
    host draw; ``.draw`` is the bed's one draw and upload; the first chunk
    and the tail are one ``.eager`` each."""
    p = _prepared(problem)
    n = 3 * C + 5
    path = p["cells"][:n]
    (zg, stub), found = _profiled(
        lambda: _loop(p, path, _bounds(problem), captured=True))
    chunks = [x for x in found if x[2] == "mcmc.sgs.chunk"]
    assert len(chunks) == stub.replays == n // C - 1
    for chunk in chunks:
        assert [x[2] for x in found if chunk[0] <= x[0] and x[1] <= chunk[1]
                and x != chunk] == ["mcmc.sgs.replay"]
    assert _count(found, "mcmc.sgs.draw") == 1
    assert _count(found, "mcmc.sgs.eager") == 2


def test_card_draws_refuse_crossed_bounds(problem):
    """A lower bound above its upper bound at a cell of the path raises,
    as scipy's ``truncnorm.rvs`` does on the host."""
    cells = _cells(10, (8, 8))
    lo = np.zeros((8, 8))
    hi = np.ones((8, 8))
    hi[tuple(cells[3])] = -1.0
    with pytest.raises(ValueError, match="Domain error"):
        tsgs._CardDraws(np.random.default_rng(0), cells, (lo, hi),
                        torch.zeros((8, 8)))


@pytest.mark.parametrize("bad", ["one bound", "dtype", "shape", "strided"])
def test_dispatcher_refuses_bad_operands(bad):
    grid = torch.zeros((6, 7))
    cells = torch.tensor([[1, 2], [3, 4]])
    est, var = torch.zeros(2), torch.ones(2)
    u = torch.full((6, 7), 0.5, dtype=torch.float64)
    lo, hi = -torch.ones_like(u), torch.ones_like(u)
    args = dict(grid=grid, cells=cells, est=est, var=var, u=u, lo=lo, hi=hi)
    if bad == "one bound":
        args["hi"] = None
    elif bad == "dtype":
        args["est"] = est.double()
    elif bad == "shape":
        args["u"] = u[:5]
    else:
        args["cells"] = torch.tensor([[1, 3], [2, 4]]).t()
    with pytest.raises((TypeError, ValueError)):
        K.bounded_draw(**args)
    K.bounded_draw(grid, cells, est, var, u, lo, hi)
    assert abs(grid[1, 2]) < 1e-12  # the median of [-1, 1]
