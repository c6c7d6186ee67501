"""The port's kriging systems and solves against the JAX package's, on
the CPU, in float32 with the same numpy inputs.

Tolerances: the covariance matrices to atol 2e-6 (float32 distances in
another operation order, on values of order 1); the simple and ordinary
kriging estimates and variances to atol 2e-5, the weights to atol 5e-5
(LAPACK LU in both, float32; a Gaussian covariance is ill-conditioned in
float32 (its estimates measured 1.7e-4 apart), so its estimate and
weights to 1e-3); the conditional block draw
to atol 2e-5 (Cholesky in float32; the caller's normals given)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops import covariance as jcov
from mcmc_tpu.ops import kriging as jkr
from mcmc_tpu_torch.ops import covariance as tcov
from mcmc_tpu_torch.ops import kriging as tkr

MODELS = ["exponential", "gaussian", "spherical", "matern"]
SILL, NUGGET = 1.0, 0.1
C, K = 16, 32


def _specs(vtype):
    s = 1.3 if vtype == "matern" else None
    return jcov.CovarianceSpec(vtype, s=s), tcov.CovarianceSpec(vtype, s=s)


def _rot():
    return (jcov.make_rotation_matrix(30.0, 8e3, 5e3),
            tcov.make_rotation_matrix(30.0, 8e3, 5e3))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 20e3, (C, K, 2)).astype(np.float32)
    target = rng.uniform(0, 20e3, (C, 2)).astype(np.float32)
    vals = rng.normal(size=(C, K)).astype(np.float32)
    n_valid = rng.integers(0, K + 1, C)
    n_valid[:4] = [0, 1, 5, K]
    mask = (np.arange(K)[None] < n_valid[:, None]).astype(np.float32)
    return xy, target, vals, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _tol(vtype):
    return 1e-3 if vtype == "gaussian" else 2e-5


@pytest.mark.parametrize("vtype", MODELS)
def test_covariance_builders_match_jax(vtype):
    js, ts = _specs(vtype)
    jr, tr = _rot()
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    xy, target, _, _ = _inputs(1)
    a = jax.vmap(lambda c: jcov.make_sigma(js, c, jr, SILL, NUGGET))(xy)
    np.testing.assert_allclose(
        tcov.make_sigma(ts, *_t(xy), tr, SILL, NUGGET).numpy(),
        np.asarray(a), atol=2e-6)
    a = jax.vmap(lambda c, t: jcov.make_rho(js, c, t, jr, SILL, NUGGET))(
        xy, target)
    np.testing.assert_allclose(
        tcov.make_rho(ts, *_t(xy, target), tr, SILL, NUGGET).numpy(),
        np.asarray(a), atol=2e-6)
    a = jcov.cross_sigma(js, xy[0], xy[1, :7], jr, SILL, NUGGET)
    np.testing.assert_allclose(
        tcov.cross_sigma(ts, *_t(xy[0], xy[1, :7]), tr, SILL,
                         NUGGET).numpy(), np.asarray(a), atol=2e-6)


@pytest.mark.parametrize("vtype", MODELS)
def test_sk_and_ok_solves_match_jax(vtype):
    """At n_valid 0, 1, 5, K and random counts: the estimates, variances
    and weights; with no valid slot the ordinary system stays
    nonsingular (its border corner set to 1)."""
    js, ts = _specs(vtype)
    jr, tr = _rot()
    xy, target, vals, mask = _inputs(2)
    j = (jnp.asarray(target), jnp.asarray(xy))
    t = _t(target, xy)
    tol = _tol(vtype)
    want = jkr.ok_solve_batch(js, *j, jnp.asarray(vals), jnp.asarray(mask),
                              jr, SILL, NUGGET)
    got = tkr.ok_solve_masked(ts, *t, *_t(vals, mask), tr, SILL, NUGGET)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    want = jkr.sk_solve_batch(js, *j, jnp.asarray(vals), jnp.asarray(mask),
                              jr, SILL, NUGGET, 0.2)
    got = tkr.sk_solve_batch(ts, *t, *_t(vals, mask), tr, SILL, NUGGET, 0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    assert float(got[1][0]) == pytest.approx(SILL, abs=1e-6)  # n_valid 0
    for jf, tf in ((jkr.sk_weights_masked, tkr.sk_weights_masked),
                   (jkr.ok_weights_masked, tkr.ok_weights_masked)):
        want = jax.vmap(lambda tg, c, m: jf(js, tg, c, m, jr, SILL, NUGGET))(
            *j, jnp.asarray(mask))
        got = tf(ts, *t, torch.from_numpy(mask), tr, SILL, NUGGET)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=max(tol, 5e-5))
        assert got[0].shape == (C, K)


@pytest.mark.parametrize("vtype", MODELS)
def test_conditional_gaussian_block_matches_jax(vtype):
    """The exact conditional block draw with the same standard normals:
    draw, mean and the conditional variances."""
    js, ts = _specs(vtype)
    jr, tr = _rot()
    rng = np.random.default_rng(5)
    block = rng.uniform(0, 5e3, (12, 2)).astype(np.float32)
    cond = rng.uniform(0, 20e3, (20, 2)).astype(np.float32)
    cv = rng.normal(size=20).astype(np.float32)
    cm = (rng.random(20) < 0.7).astype(np.float32)
    noise = rng.normal(size=12).astype(np.float32)
    want = jkr.conditional_gaussian_block(js, block, cond, cv, cm, jr, SILL,
                                          NUGGET, 0.1, noise)
    got = tkr.conditional_gaussian_block(ts, *_t(block, cond, cv, cm), tr,
                                         SILL, NUGGET, 0.1,
                                         torch.from_numpy(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
