"""The port's normal-score transform, its LUT and the LUT lookup (the
plain version of the CUDA LUT kernel) against the JAX package's.

The host transform is numpy in both packages: equal.  The lookup is held
within 2 ulp of the JAX package's ``NormalScoreLUT._lookup`` (XLA may
contract the lerp into an FMA, tests/test_chain_sgs.py:517-519) and of
its Pallas ``lut_interp`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops.lut_kernel import lut_interp as jlut_interp
from mcmc_tpu.ops.transforms import NormalScoreLUT as JLUT
from mcmc_tpu.ops.transforms import NormalScoreTransform as JNST
from mcmc_tpu_torch.ops.lut_kernel import lut_interp, lut_interp_reference
from mcmc_tpu_torch.ops.transforms import (NormalScoreLUT,
                                           NormalScoreTransform,
                                           lut_clip_bound)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(120.0, 40.0, 4000),
                        rng.gamma(2.0, 30.0, 1000)])
    x[::97] = np.nan
    return x


@pytest.mark.parametrize("n_quantiles,subsample", [(500, None), (1000, None),
                                                   (200, 800)])
def test_fit_and_host_transforms_equal(n_quantiles, subsample):
    data = _data()
    j = JNST.fit(data, n_quantiles, subsample=subsample, random_state=3)
    t = NormalScoreTransform.fit(data, n_quantiles, subsample=subsample,
                                 random_state=3)
    np.testing.assert_array_equal(t.quantiles, j.quantiles)
    np.testing.assert_array_equal(t.references, j.references)
    x = np.concatenate([np.linspace(-100, 400, 777), [np.nan, j.quantiles[0],
                                                      j.quantiles[-1]]])
    np.testing.assert_array_equal(t.transform_np(x), j.transform_np(x))
    z = np.concatenate([np.linspace(-7, 7, 555), [np.nan, -40.0, 40.0]])
    np.testing.assert_array_equal(t.inverse_np(z), j.inverse_np(z))


def _luts():
    data = _data(1)
    return (JLUT.from_transform(JNST.fit(data, 500)),
            NormalScoreLUT.from_transform(NormalScoreTransform.fit(data, 500),
                                          device="cpu"))


def test_lut_tables_equal():
    jl, tl = _luts()
    for t in ("fwd_table", "inv_table"):
        assert getattr(tl, t).dtype == torch.float32
        np.testing.assert_array_equal(getattr(tl, t).numpy(),
                                      np.asarray(getattr(jl, t)))
    for s in ("fwd_lo", "fwd_scale", "inv_lo", "inv_scale"):
        assert getattr(tl, s) == float(getattr(jl, s)), s


def test_clip_bound_reaches_the_last_row():
    """n - 1.000001 rounds to 4095.0 in float32: the last row is read."""
    assert lut_clip_bound(4096) == 4095.0
    assert lut_clip_bound(4096) == float(np.float32(4096 - 1.000001))


def _inputs(lut):
    rng = np.random.default_rng(2)
    lo, scale = lut.inv_lo, lut.inv_scale
    n = lut.inv_table.shape[0]
    return np.concatenate([
        rng.uniform(-8.0, 8.0, 5000),                  # incl. out of range
        lo + np.arange(9) / scale,                      # exact nodes
        lo + (n - 1 - np.array([0.5, 1e-3, 0.0])) / scale,  # last rows
        [6.5, 6.49999, 7.0, np.nan, -1e9, 1e9, 0.0, -np.inf, np.inf],
    ]).astype(np.float32)


def test_lookup_matches_jax_within_2_ulp():
    jl, tl = _luts()
    x = _inputs(tl)
    got = lut_interp_reference(torch.from_numpy(x), tl.inv_lo, tl.inv_scale,
                               tl.inv_table).numpy()
    want = np.asarray(JLUT._lookup(jnp.asarray(x), jl.inv_lo, jl.inv_scale,
                                   jl.inv_table))
    pallas = np.asarray(jlut_interp(jnp.asarray(x), jl.inv_lo, jl.inv_scale,
                                    jl.inv_table, interpret=True))
    for ref in (want, pallas):
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        ulp = np.spacing(np.abs(ref[ok]).astype(np.float32))
        assert np.all(np.abs(got[ok] - ref[ok]) <= 2 * ulp)
    # the last row: positions past n - 2 read row n - 1 (its pair is
    # (x_{n-1}, x_{n-1})), so the top saturates at the table's last value
    top = got[np.isfinite(x) & (x >= 6.5)]
    np.testing.assert_array_equal(top, tl.inv_table[-1, 0].item())


def test_forward_lookup_and_dispatch_on_cpu():
    """The forward table through ``NormalScoreLUT.transform``, and the
    dispatcher: a CPU tensor runs the plain version (no launch counted)."""
    jl, tl = _luts()
    x = np.linspace(-50, 400, 1001).astype(np.float32)
    want = np.asarray(jl.transform(jnp.asarray(x)))
    got = tl.transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-6)
    before = lut_interp.launches
    z = torch.from_numpy(_inputs(tl)).reshape(1, -1, 1)
    out = lut_interp(z, tl.inv_lo, tl.inv_scale, tl.inv_table)
    assert out.shape == z.shape and lut_interp.launches == before
    torch.testing.assert_close(out, tl.inverse(z), rtol=0, atol=0,
                               equal_nan=True)
