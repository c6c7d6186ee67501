"""The port's captured T2 chunk loop: ``sgs`` and ``krige`` replaying one
captured CUDA graph a chunk (``mcmc_tpu_torch/geostats/sgs.py``).

A CUDA graph exists only on the card, so here the captured loops' own
code (the runner's eager first chunk, its fixed cell buffer, the replays,
the eager remainder, ``krige``'s device maps read back once) runs on the
CPU with a stub in place of ``capture_graph``, as
``tests/test_torch_graph_loop.py`` does for the segment scan.  The stub
does what a capture and a replay do to everything the loop can see: the
capture runs the chunk's Python once and puts the grid back as it was,
since a capture runs no device work; a replay runs the chunk's work.
Inside the ``captured`` fixture ``sgs`` draws as on the card
(``_CardDraws``, whose plain version runs here), since only a chunk that
lives on the device whole is captured.  Every case is held bitwise to the
eager loop with the same draws (the plain version, which ``device="cpu"``
runs), over path lengths of none, less than a chunk, the eager first
chunk alone, one replayed chunk after it, and replayed chunks with a
remainder; the captured loop given the host's draws is the eager loop and
captures nothing; and one case is held to the JAX package's ``sgs``
within ``test_torch_geostats.BED_ATOL``.  The card's own capture is held
to the eager loop by the ``cuda``-marked test in
``tests/test_torch_cuda.py``.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from mcmc_tpu import geostats as jgeo
from mcmc_tpu_torch import geostats as tgeo
from tests.conftest import make_synthetic_problem
from tests.test_torch_geostats import BED_ATOL, EXP, MATERN

tsgs = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
C = 8
KW = dict(radius=10e3, num_points=16, chunk=C, half_window=8)
# cells on the path: none, less than a chunk, the eager first chunk alone,
# one replayed chunk after it, one and two replayed chunks and a remainder
LENGTHS = (0, C - 3, C, 2 * C, 2 * C + 3, 3 * C + 5)


class StubGraph:
    """A replay: the chunk's work."""

    def __init__(self, body, stub):
        self.body, self.stub = body, stub

    def replay(self):
        self.body()
        self.stub.replays += 1


class StubCapture:
    """``capture(body)`` of a chunk: runs its Python once, then puts back
    the grid the call made (``grids[-1]``), since a capture runs no
    device work."""

    def __init__(self):
        self.grids = []
        self.captures = self.replays = 0

    def __call__(self, body, generator=None):
        grid = self.grids[-1]
        saved = grid.clone()
        body()
        grid.copy_(saved)
        self.captures += 1
        return StubGraph(body, self)


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=32, W=36)


def _card_draws(monkeypatch):
    """Inside, CPU calls of ``sgs`` draw as on the card (``_CardDraws``)."""
    monkeypatch.setattr(tsgs, "_bed_draws", tsgs._CardDraws)


@pytest.fixture
def captured(monkeypatch):
    """Inside, CPU calls of ``sgs`` and ``krige`` run the captured loops
    with the stub capture, ``sgs`` with the card's draws; returns the
    stub."""
    _card_draws(monkeypatch)
    stub = StubCapture()
    score_grid = tsgs._score_grid

    def grid(p, device):
        stub.grids.append(score_grid(p, device))
        return stub.grids[-1]

    monkeypatch.setattr(tsgs, "_score_grid", grid)
    monkeypatch.setattr(tsgs, "_chunk_loops", lambda device: (
        functools.partial(tsgs._sgs_loop_captured, capture=stub),
        functools.partial(tsgs._krige_loop_captured, capture=stub)))
    return stub


def _mask(p, n):
    """A sim_mask holding the first ``n`` cells without data."""
    free = np.argwhere(np.isnan(p["cond_bed"]))
    assert free.shape[0] >= n
    mask = np.zeros(p["cond_bed"].shape, bool)
    mask[free[:n, 0], free[:n, 1]] = True
    return mask


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.int64)


def _sgs_both(p, request, vario, n=None, **kw):
    """The eager and the stub-captured ``sgs`` of one call (``n`` cells,
    or every cell without data), both with the card's draws, and the
    stub."""
    kw = dict(KW, seed=5, sim_mask=None if n is None else _mask(p, n), **kw)
    args = (p["xx"], p["yy"], p["cond_bed"], vario)
    _card_draws(request.getfixturevalue("monkeypatch"))
    want = tgeo.sgs(*args, device="cpu", **kw)
    stub = request.getfixturevalue("captured")
    return want, tgeo.sgs(*args, device="cpu", **kw), stub


def _bounds(p):
    return (np.full(p["xx"].shape, -800.0), p["surf"] - 1.0)


@pytest.mark.parametrize("n", LENGTHS)
def test_captured_sgs_is_the_eager_loop_at_every_path_length(problem,
                                                             request, n):
    """Bounded simple kriging with a Matérn covariance over each path
    length (``tests/test_torch_bounded_draw.py`` runs ordinary kriging's
    loop at each): the bed bit for bit, one capture where a full chunk
    follows the first, a replay for each full chunk after the first."""
    want, got, stub = _sgs_both(problem, request, MATERN, n, ktype="sk",
                                bounds=_bounds(problem))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    full = n // C
    assert stub.captures == (1 if full >= 2 else 0)
    assert stub.replays == max(full - 1, 0)


@pytest.mark.parametrize("vario", [EXP, MATERN], ids=["exp", "matern"])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("ktype", ["ok", "sk"])
def test_captured_sgs_is_the_eager_loop(problem, request, ktype, bounded,
                                        vario):
    """Every cell of the grid, ordinary and simple kriging, with and
    without bounds, exponential and Matérn: the bed bit for bit."""
    p = problem
    want, got, stub = _sgs_both(p, request, vario, ktype=ktype,
                                bounds=_bounds(p) if bounded else None)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    n = int(np.isnan(p["cond_bed"]).sum())
    assert (stub.captures, stub.replays) == (1, n // C - 1)


@pytest.mark.parametrize("n", LENGTHS)
def test_captured_loop_with_host_draws_is_the_eager_loop(problem, n):
    """``_sgs_loop_captured`` given a host ``draw(cells, est, var)`` (the
    CPU's scipy draws) runs the eager loop: no capture, and the grid bit
    for bit the eager loop's with the same draws."""
    p = tsgs._prepare(problem["xx"], problem["cond_bed"], EXP, None,
                      KW["num_points"], "ok", KW["half_window"],
                      torch.device("cpu"))
    path = p["cells"][np.random.default_rng(2).permutation(
        len(p["cells"]))][:n]
    bounds = tuple(np.asarray(p["nst"].transform_np(b))
                   for b in _bounds(problem))
    grids, stub = [], StubCapture()
    for loop in (tsgs._sgs_loop_eager, functools.partial(
            tsgs._sgs_loop_captured, capture=stub)):
        zg = tsgs._score_grid(p, torch.device("cpu"))
        stub.grids.append(zg)
        loop(p, zg, path, KW["radius"], C,
             tsgs._host_draws(np.random.default_rng(5), bounds))
        grids.append(zg.numpy())
    np.testing.assert_array_equal(_bits(grids[1]), _bits(grids[0]))
    assert (stub.captures, stub.replays) == (0, 0)
    assert np.isfinite(grids[1][tuple(path.T)]).all()


@pytest.mark.parametrize("n", LENGTHS + (None,))
def test_captured_krige_is_the_eager_loop(problem, request, n):
    """``krige``'s mean and std maps bit for bit, its device maps read
    back once, over each path length and the whole grid (Matérn)."""
    p = problem
    kw = dict(KW, sim_mask=None if n is None else _mask(p, n))
    args = (p["xx"], p["yy"], p["cond_bed"], MATERN)
    want = tgeo.krige(*args, device="cpu", **kw)
    stub = request.getfixturevalue("captured")
    got = tgeo.krige(*args, device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    full = (int(np.isnan(p["cond_bed"]).sum()) if n is None else n) // C
    assert stub.replays == max(full - 1, 0)


def test_captured_sgs_matches_jax(problem, captured):
    """The stub-captured bounded bed against the JAX package's ``sgs``
    with the same seed, within ``test_torch_geostats.BED_ATOL``."""
    p = problem
    kw = dict(KW, seed=3, bounds=_bounds(p))
    want = jgeo.sgs(p["xx"], p["yy"], p["cond_bed"], EXP, **kw)
    got = tgeo.sgs(p["xx"], p["yy"], p["cond_bed"], EXP, device="cpu", **kw)
    assert captured.replays > 1
    np.testing.assert_allclose(got, want, atol=BED_ATOL, rtol=0)
