"""The port's covariance models and mixture fit against the JAX package's.

Both evaluate the host covariance in float32 (the JAX package's
``jnp.asarray`` of float64 numpy gives float32) in the same operation
order; their ``exp`` implementations may round an ulp apart, hence rtol
1e-6 where values pass through one exp, and 1e-5 for fitted mixture
coefficients (NNLS on curves that differ by ulps).
"""

import numpy as np
import pytest
import torch

from mcmc_tpu.ops import covariance as jcov
from mcmc_tpu_torch.ops import covariance as tcov

MODELS = [("exponential", None), ("gaussian", None), ("spherical", None),
          ("matern", 1.3), ("matern", 0.7)]


@pytest.mark.parametrize("vtype,s", MODELS)
def test_covariance_norm(vtype, s):
    """Every model on normalized distances from 0 past the matérn table's
    end, sill 1.3 and nugget 0.2 (spherical's ``sill - 1`` beyond the
    range included)."""
    h = np.concatenate([np.linspace(0.0, 9.0, 3001), [1.0, 8.0, 0.5]])
    want = np.asarray(jcov.covariance_norm(jcov.CovarianceSpec(vtype, s=s),
                                           h, 1.3, 0.2))
    got = tcov.covariance_norm(tcov.CovarianceSpec(vtype, s=s), h, 1.3, 0.2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if vtype == "spherical":
        np.testing.assert_allclose(got.numpy()[h > 1.0], 0.3, rtol=1e-6)


@pytest.mark.parametrize("s", [0.5, 1.3, 2.5])
def test_matern_table_equal(s):
    np.testing.assert_array_equal(tcov.make_matern_table(s),
                                  jcov.make_matern_table(s))
    assert tcov.matern_scale_fit(s) == jcov.matern_scale_fit(s)


@pytest.mark.parametrize("s", [1.3, 0.7])
def test_matern_table_copied_to_a_device_once(s, monkeypatch):
    """``covariance_norm`` copies the matérn table to a device on its first
    call there and reads the spec's copy on every later one, with the
    values of a fresh copy's lerp, bit for bit, and the JAX package's to
    ``test_covariance_norm``'s tolerance."""
    spec = tcov.CovarianceSpec("matern", s=s)
    copies = []
    as_tensor = torch.as_tensor

    def counted(data, *args, **kw):
        if data is spec.matern_table:
            copies.append(kw.get("device"))
        return as_tensor(data, *args, **kw)

    monkeypatch.setattr(torch, "as_tensor", counted)
    h = torch.linspace(0.0, 9.0, 3001)
    first = tcov.covariance_norm(spec, h, 1.3, 0.2)
    again = tcov.covariance_norm(spec, h, 1.3, 0.2)
    assert len(copies) == 1
    assert spec.table_on(h.device) is spec.table_on("cpu")
    # the lerp on a table copied afresh, as every call made it before
    table = as_tensor(spec.matern_table, dtype=torch.float32)
    xs = torch.clamp(h / 8.0, 0.0, 1.0) * float(table.shape[0] - 1)
    lo = torch.floor(xs)
    frac = xs - lo
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + 1, max=table.shape[0] - 1)
    c01 = table[lo_i] * (1.0 - frac) + table[hi_i] * frac
    fresh = tcov._f32(1.3 - 0.2) * torch.where(h >= 8.0, 0.0, c01)
    for got in (first, again):
        assert torch.equal(got.view(torch.int32), fresh.view(torch.int32))
    want = np.asarray(jcov.covariance_norm(jcov.CovarianceSpec("matern", s=s),
                                           h.numpy(), 1.3, 0.2))
    np.testing.assert_allclose(again.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("azimuth,major,minor", [(0.0, 5e3, 5e3),
                                                 (30.0, 8e3, 4e3),
                                                 (117.0, 12e3, 3e3)])
def test_rotation_matrix(azimuth, major, minor):
    want = np.asarray(jcov.make_rotation_matrix(azimuth, major, minor))
    got = tcov.make_rotation_matrix(azimuth, major, minor)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("vtype,s,sill,nugget,h_max", [
    ("matern", 1.3, 1.0, 0.0, 2.6),
    ("gaussian", None, 1.3, 0.0, 3.0),
    ("exponential", None, 1.0, 0.3, 4.0),
    ("matern", 0.7, 1.0, 0.0, 5.0),
])
def test_fit_cov_mixture(vtype, s, sill, nugget, h_max):
    """Pruned fits (the chain's call: target 1e-3 of the amplitude) keep
    the same support and coefficients within rtol 1e-5, the same max
    error, and so the chain's same accept decision (matérn 0.7 over a long
    range misses the target in both packages)."""
    tol = 1e-3 * (sill - nugget)
    want = jcov.fit_cov_mixture(jcov.CovarianceSpec(vtype, s=s), sill, nugget,
                                h_max, target_err=tol)
    got = tcov.fit_cov_mixture(tcov.CovarianceSpec(vtype, s=s), sill, nugget,
                               h_max, target_err=tol)
    for a, b in zip(got[:4], want[:4]):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert abs(got[4] - want[4]) <= 1e-5 * tol + 1e-7
    assert (got[4] <= tol) == (want[4] <= tol)


def _h2(rng, n=4000):
    return np.concatenate([rng.uniform(0.0, 6.0, n), [0.0, 1e-6, 36.0]]
                          ).astype(np.float32)


@pytest.mark.parametrize("mix", [
    # dyadic, with gaps in k and both families (the fit's dictionaries)
    ((0.2, 0.3, 0.1), (1.5, 3.0, 24.0), (0.25, 0.15), (0.75, 6.0),
     (1.0, 0.0, 1.0)),
    # a fitted matérn mixture: Gaussian family only
    "fitted",
    # non-dyadic rates: one exp per term (tests/test_kriging.py:222)
    ((0.5, 0.3), (0.01, 0.002), (0.4,), (0.05,), (1.0, 0.1, 1.2)),
])
def test_eval_mixture_static(mix):
    if mix == "fitted":
        ag, bg, ae, be, _ = tcov.fit_cov_mixture(
            tcov.CovarianceSpec("matern", s=1.3), 1.0, 0.0, 2.6,
            target_err=1e-3)
        mix = tuple(tuple(float(v) for v in a)
                    for a in (ag, bg, ae, be, (1.0, 0.0, 1.0)))
        assert len(mix[0]) > 2
    h2 = _h2(np.random.default_rng(0))
    want = np.asarray(jcov.eval_mixture_static(mix, h2))
    got = tcov.eval_mixture_static(mix, torch.from_numpy(h2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_mixture_families_order():
    """The terms the plain evaluation and the CUDA kernel take: families
    in order, dyadic ones as rising (k, a), others as given (b, a)."""
    mix = ((0.3, 0.2), (6.0, 1.5), (0.4, 0.1), (0.05, 0.3), (1.0, 0.0, 1.0))
    fams = tcov.mixture_families(mix)
    assert fams[0] == (False, 1.5, [(0, 0.2), (2, 0.3)])
    assert fams[1] == (True, None, [(0.05, 0.4), (0.3, 0.1)])
    assert tcov.mixture_families(((), (), (1.0,), (3.0,), mix[4])) == [
        (True, 3.0, [(0, 1.0)])]
