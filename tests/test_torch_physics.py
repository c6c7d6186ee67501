"""The port's physics operators against the JAX package and the NumPy
reference (tests/reference_impl.py).

The same float32 inputs, made from a seed with numpy, go to all three.
The JAX and PyTorch operators do the same float32 arithmetic, so they agree
to rtol 1e-5; against the float64 reference the float32 rounding of the
fluxes (|velx * thick| ~ 2e5) bounds the error, so that comparison is taken
relative to the flux gradient's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.models.chain_crf import chain_loss_mc as jax_chain_loss_mc
from mcmc_tpu.ops import physics as jphys
from mcmc_tpu_torch.models.chain_crf import chain_loss_mc
from mcmc_tpu_torch.ops import physics as tphys
from tests import reference_impl as ref
from tests.conftest import make_synthetic_problem

RES = 500.0


def _planes(seed, H, W, n=None):
    """Synthetic problem planes plus beds perturbed from the true bed, all
    float32; ``n`` chains of beds, or one bed when None."""
    p = make_synthetic_problem(H=H, W=W, seed=seed)
    rng = np.random.default_rng(seed + 100)
    shape = (H, W) if n is None else (n, H, W)
    bed = (p["bed_true"] + rng.normal(0.0, 50.0, shape)).astype(np.float32)
    planes = {k: np.asarray(p[k], np.float32)
              for k in ("surf", "velx", "vely", "dhdt", "smb")}
    return bed, planes, p


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("seed,H,W", [(0, 64, 64), (1, 40, 56), (2, 33, 17)])
def test_residual_matches_jax_and_reference(seed, H, W):
    bed, c, _ = _planes(seed, H, W)
    args = (c["surf"], c["velx"], c["vely"], c["dhdt"], c["smb"])
    got = tphys.mass_conservation_residual(_t(bed), *map(_t, args),
                                           RES).numpy()
    want_jax = np.asarray(jphys.mass_conservation_residual(
        jnp.asarray(bed), *map(jnp.asarray, args), RES))
    scale = np.abs(want_jax).max()
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5 * scale)
    want_ref = ref.mass_conservation_residual(
        bed.astype(np.float64), *(a.astype(np.float64) for a in args), RES)
    flux = np.abs(c["velx"] * (c["surf"] - bed)).max() / RES
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6 * flux)


def test_residual_is_batched_over_chains():
    bed, c, _ = _planes(3, 48, 40, n=3)
    args = [_t(c[k]) for k in ("surf", "velx", "vely", "dhdt", "smb")]
    batched = tphys.mass_conservation_residual(_t(bed), *args, RES)
    assert batched.shape == (3, 48, 40)
    for i in range(3):
        one = tphys.mass_conservation_residual(_t(bed[i]), *args, RES)
        assert torch.equal(batched[i], one)


def test_residual_edges_are_one_sided():
    """numpy-gradient semantics: central inside, one-sided on the edges."""
    rng = np.random.default_rng(4)
    fx = rng.normal(size=(6, 7)).astype(np.float32)
    zero = np.zeros_like(fx)
    ones = np.ones_like(fx)
    # bed = -fx, surf = 0, velx = 1, vely = 0 -> residual = d/dx fx
    got = tphys.mass_conservation_residual(
        _t(-fx), _t(zero), _t(ones), _t(zero), _t(zero), _t(zero),
        2.0).numpy()
    np.testing.assert_allclose(got, np.gradient(fx, 2.0, axis=1), rtol=1e-6)


@pytest.mark.parametrize("with_nans", [False, True])
def test_masked_losses_match_jax(with_nans):
    rng = np.random.default_rng(5)
    res = rng.normal(0.0, 3.0, (4, 32, 32)).astype(np.float32)
    if with_nans:
        res[rng.random(res.shape) < 0.05] = np.nan
    mask = rng.random((32, 32)) < 0.6
    sigma = 5.0
    got = tphys.masked_gaussian_loss(_t(res), _t(mask), sigma).numpy()
    got_sq = tphys.masked_sq_sum(_t(res), _t(mask)).numpy()
    for i in range(4):
        want = float(jphys.masked_gaussian_loss(jnp.asarray(res[i]),
                                                jnp.asarray(mask), sigma))
        want_sq = float(jphys.masked_sq_sum(jnp.asarray(res[i]),
                                            jnp.asarray(mask)))
        np.testing.assert_allclose(got[i], want, rtol=1e-5)
        np.testing.assert_allclose(got_sq[i], want_sq, rtol=1e-5)
        np.testing.assert_allclose(
            got[i], ref.masked_gaussian_loss(res[i].astype(np.float64),
                                             mask.astype(int), sigma),
            rtol=1e-5)
    assert np.isfinite(got).all()


def test_thickness_violations_match_jax():
    rng = np.random.default_rng(6)
    surf = rng.normal(100.0, 5.0, (32, 32)).astype(np.float32)
    bed = rng.normal(95.0, 5.0, (3, 32, 32)).astype(np.float32)
    mask = rng.random((32, 32)) < 0.5
    got = tphys.thickness_violations(_t(bed), _t(surf), _t(mask)).numpy()
    for i in range(3):
        want = int(jphys.thickness_violations(jnp.asarray(bed[i]),
                                              jnp.asarray(surf),
                                              jnp.asarray(mask)))
        assert got[i] == want
    assert got.min() > 0


def test_chain_loss_mc_matches_jax():
    rng = np.random.default_rng(7)
    res = rng.normal(0.0, 2.0, (20, 24))
    res[0, :3] = np.nan
    mask = (rng.random((20, 24)) < 0.7).astype(np.float32)
    assert chain_loss_mc(res, mask, 5.0) == jax_chain_loss_mc(res, mask, 5.0)
