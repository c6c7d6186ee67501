"""The port's octant neighbour search against the JAX package's, on the
CPU: the stencil helpers equal, and ``octant_neighbors_window``'s indices
(the coordinates it returns), values and mask BITWISE equal to
``jax.vmap`` of the JAX function on grid windows, where equal distances
at the k-th place of a sector are the rule.  A different pick among tied
cells would move a kriging estimate far beyond rounding, so no tolerance
is allowed.  The sectors are decided from exact comparisons in the port
(``octant_sector``); they are held against the exact angle and against
the JAX package's ``atan2`` binning on exact window coordinates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops import neighbors as jnb
from mcmc_tpu_torch.ops import neighbors as tnb

S = 21  # window side


def _windows(rng, C, res, density):
    """C windows of an (S, S) grid patch in float32 grid coordinates, the
    target inside (off centre, as at a clipped domain edge), validity at
    ``density`` with the target excluded."""
    res = np.float32(res)
    si, sj = rng.integers(0, 60, C), rng.integers(0, 60, C)
    ti, tj = rng.integers(0, S, C), rng.integers(0, S, C)
    rows = (si[:, None] + np.arange(S)).astype(np.float32) * res
    cols = (sj[:, None] + np.arange(S)).astype(np.float32) * res
    win = np.stack([np.broadcast_to(cols[:, None, :], (C, S, S)),
                    np.broadcast_to(rows[:, :, None], (C, S, S))], -1)
    target = np.stack([(sj + tj).astype(np.float32) * res,
                       (si + ti).astype(np.float32) * res], -1)
    valid = rng.random((C, S, S)) < density
    valid[np.arange(C), ti, tj] = False
    vals = rng.normal(size=(C, S, S)).astype(np.float32)
    return (target.astype(np.float32), np.ascontiguousarray(win, np.float32),
            vals, valid)


def _jax(target, win, vals, valid, radius, num_points):
    out = jax.vmap(lambda t, w, v, m: jnb.octant_neighbors_window(
        t, w, v, m, np.float32(radius), num_points))(
            jnp.asarray(target), jnp.asarray(win), jnp.asarray(vals),
            jnp.asarray(valid))
    return [np.asarray(x) for x in out]


def _port(target, win, vals, valid, radius, num_points):
    out = tnb.octant_neighbors_window(
        torch.from_numpy(target), torch.from_numpy(win),
        torch.from_numpy(vals), torch.from_numpy(valid),
        float(np.float32(radius)), num_points)
    return [x.numpy() for x in out]


def test_stencils_equal_jax():
    x = np.arange(40) * 500.0
    for got, want in zip(tnb.make_circle_stencil(x, 4.2e3),
                         jnb.make_circle_stencil(x, 4.2e3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tnb.make_ellipse_stencil(x, 6e3, 2.5e3, 35.0),
                         jnb.make_ellipse_stencil(x, 6e3, 2.5e3, 35.0)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res", [500.0, 250.0, 1000.0])
@pytest.mark.parametrize("density", [0.9, 0.3, 0.04])
@pytest.mark.parametrize("num_points,radius", [(32, 1e6), (20, 4.1e3),
                                               (64, 6e3), (5, 1e6)])
def test_octant_search_bitwise_with_ties(res, density, num_points, radius):
    rng = np.random.default_rng(int(res) + int(100 * density) + num_points)
    ops = _windows(rng, 24, res, density)
    want = _jax(*ops, radius * res / 500.0, num_points)
    got = _port(*ops, radius * res / 500.0, num_points)
    for name, g, w in zip(("coords", "values", "mask"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_windows_have_ties_at_the_kth_place():
    """The windows above do exercise the tie rule: within a sector, cells
    at the same distance as the last pick are left out (a full window,
    4 a sector)."""
    rng = np.random.default_rng(3)
    target, win, vals, valid = _windows(rng, 24, 500.0, 1.0)
    coords, _, mask = _port(target, win, vals, valid, 1e6, 32)
    d = np.hypot(*(target[:, None, :] - coords).transpose(2, 0, 1))
    dist = np.hypot(*(target[:, None, None, :] - win).transpose(3, 0, 1, 2))
    ties = 0
    for c in range(24):
        for b in range(8):
            last = d[c, 4 * b + 3]
            if mask[c, 4 * b + 3]:
                ties += int((dist[c] == last).sum()) > 1
    assert ties > 24


def test_sectors_are_the_exact_angles_and_jax_s():
    """On exact grid offsets (the eight boundary directions included) the
    port's sector equals the exact angle's, b/4 pi < angle <= (b+1)/4 pi,
    and the JAX package's atan2 binning."""
    k = np.arange(-40, 41, dtype=np.float32) * np.float32(500.0)
    dx, dy = np.meshgrid(k, k)
    got = tnb.octant_sector(torch.from_numpy(dx),
                            torch.from_numpy(dy)).numpy()
    ang = np.arctan2(dy.astype(np.float64), dx.astype(np.float64))
    q = np.round(ang / (np.pi / 4), 12)
    exact = np.clip(np.ceil(q) - 1, -4, 3)
    np.testing.assert_array_equal(got, exact)
    jang = jnp.arctan2(jnp.asarray(dy), jnp.asarray(dx))
    jsec = np.asarray(jnp.clip(jnp.ceil(jang / (jnp.pi / 4.0)) - 1, -4, 3))
    np.testing.assert_array_equal(got, jsec)
