"""The port's spectral proposal engine against the JAX package.

Identical inputs made with numpy (complex half-spectrum noise, ranges,
scales, block sizes) go to both packages.  The port's own draws from its
``torch.Generator`` are held statistically: per-draw standardization,
the parameter ranges, and the ensemble correlogram against the NumPy
reference synthesis (tests/reference_impl.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.models import randfield as jrf
from mcmc_tpu.ops import distance as jdist
from mcmc_tpu.ops import logistic as jlog
from mcmc_tpu.ops import spectral as jsp
from mcmc_tpu.utils.config import (BlockMenuConfig, RandFieldConfig,
                                   WeightConfig)
from mcmc_tpu_torch.models import randfield as trf
from mcmc_tpu_torch.ops import distance as tdist
from mcmc_tpu_torch.ops import logistic as tlog
from mcmc_tpu_torch.ops import spectral as tsp
from mcmc_tpu_torch.utils.rng import make_generator
from tests import reference_impl as ref

MODELS = [("Gaussian", None), ("Exponential", None), ("Matern", 1.3)]
RES = 500.0
CPU = torch.device("cpu")


def _noise(rng, n, B):
    nh = (n, B, B // 2 + 1)
    return (rng.normal(size=nh) + 1j * rng.normal(size=nh)).astype(
        np.complex64)


def _configs(model="Matern", smoothness=1.3, nugget_max=0.0):
    return (RandFieldConfig(3e3, 8e3, 3e3, 8e3, scale_min=20.0,
                            scale_max=60.0, nugget_max=nugget_max,
                            model_name=model, isotropic=True,
                            smoothness=smoothness),
            BlockMenuConfig(12, 20, 10, 18, steps=3),
            WeightConfig(L=2.0, x0=0.0, k=6.0, offset=1.0, max_dist=5e3,
                         resolution=RES))


@pytest.mark.parametrize("model,smoothness", MODELS)
def test_field_from_noise_matches_jax(model, smoothness):
    """Same noise and ranges -> the same raw field.  The field's size
    depends on the model's normalisation (~1e-2 Gaussian, ~20 Matérn
    here), so the absolute tolerance is taken relative to max |field|."""
    rng = np.random.default_rng(1)
    n, B = 4, 24
    noise = _noise(rng, n, B)
    rx = rng.uniform(3e3, 8e3, n).astype(np.float32)
    ry = rng.uniform(3e3, 8e3, n).astype(np.float32)
    got = tsp.spectral_field_from_noise(
        torch.as_tensor(noise), (B, B), RES, model, torch.as_tensor(rx),
        torch.as_tensor(ry), smoothness).numpy()
    want = np.stack([np.asarray(jsp.spectral_field_from_noise(
        jnp.asarray(noise[i]), (B, B), RES, model, rx[i], ry[i],
        smoothness)) for i in range(n)])
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("model,smoothness", MODELS)
def test_spectral_density_matches_jax_and_reference(model, smoothness):
    k = tsp._rfreq_grid_np((16, 16), RES)
    rx, ry = 5e3, 3e3
    got = tsp.spectral_density(model, torch.as_tensor(k),
                               torch.tensor(rx), torch.tensor(ry),
                               smoothness).numpy()
    want = np.asarray(jsp.spectral_density(model, jnp.asarray(k), rx, ry,
                                           smoothness))
    # XLA flushes float32 subnormals (the Gaussian tail) to zero, PyTorch
    # on the CPU keeps them: an absolute floor far below the peak
    tiny = 1e-7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tiny)
    np.testing.assert_allclose(
        got, ref.spectral_density(model, k.astype(np.float64), rx, ry,
                                  smoothness), rtol=1e-4, atol=tiny)


def test_rfreq_grid_is_cached_per_device():
    a = tsp._rfreq_grid((8, 8), RES, CPU)
    assert tsp._rfreq_grid((8, 8), RES, CPU) is a
    np.testing.assert_array_equal(a.numpy(),
                                  jsp._rfreq_grid_np((8, 8), RES))


def test_standardize_masked_matches_jax():
    """Not bitwise: the float32 sums run in another order.  On
    unit-variance output that moves values by ~1e-7."""
    rng = np.random.default_rng(2)
    field = rng.normal(3.0, 7.0, (3, 20, 20)).astype(np.float32)
    mask = np.zeros((3, 20, 20), bool)
    for i, (h, w) in enumerate([(20, 20), (12, 9), (5, 17)]):
        mask[i, :h, :w] = True
    got = tsp.standardize_masked(torch.as_tensor(field),
                                 torch.as_tensor(mask)).numpy()
    for i in range(3):
        want = np.asarray(jsp.standardize_masked(jnp.asarray(field[i]),
                                                 jnp.asarray(mask[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)
        blk = got[i][mask[i]]
        assert abs(blk.mean()) < 1e-5 and abs(blk.std() - 1.0) < 1e-5
        assert np.all(got[i][~mask[i]] == 0.0)


@pytest.mark.parametrize("steps", [2, 3, 5])
def test_block_menu_matches_jax(steps):
    cfg = BlockMenuConfig(50, 80, 41, 77, steps=steps)
    got = trf.make_block_menu(cfg)
    want = jrf.make_block_menu(cfg)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("nugget_max", [0.0, 25.0])
def test_build_randfield_matches_jax(nugget_max):
    cfgs = _configs(nugget_max=nugget_max)
    t_static, t_arr = trf.build_randfield(*cfgs, device=CPU)
    j_static, j_arr = jrf.build_randfield(*cfgs)
    assert dataclasses.asdict(t_static) == dataclasses.asdict(j_static)
    np.testing.assert_array_equal(t_arr.pairs.numpy(), np.asarray(j_arr.pairs))
    np.testing.assert_array_equal(t_arr.edge_masks.numpy(),
                                  np.asarray(j_arr.edge_masks))
    for name in ("scale_min", "scale_max", "nugget_max", "range_min_x",
                 "range_max_x", "range_min_y", "range_max_y"):
        assert getattr(t_arr, name) == float(getattr(j_arr, name))


@pytest.mark.parametrize("h,w", [(12, 20), (50, 50), (80, 64)])
def test_edge_mask_matches_jax(h, w):
    args = (h, w, RES, 2.0, 0.0, 6.0, 1.0, 30e3)
    np.testing.assert_array_equal(tlog.make_edge_mask(*args),
                                  jlog.make_edge_mask(*args))


def test_crf_weight_and_distance_match_jax():
    rng = np.random.default_rng(4)
    xx, yy = np.meshgrid(np.arange(40) * RES, np.arange(30) * RES)
    mask = rng.random((30, 40)) < 0.03
    dist = tdist.min_dist_from_mask(xx, yy, mask)
    np.testing.assert_array_equal(dist, jdist.min_dist_from_mask(xx, yy,
                                                                 mask))
    d32 = dist.astype(np.float32)
    got = tlog.crf_weight_from_dist(torch.from_numpy(d32), 2.0, 0.0, 6.0,
                                    1.0, 5e3)
    want = jlog.crf_weight_from_dist(jnp.asarray(d32), 2.0, 0.0, 6.0, 1.0,
                                     5e3)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-7)
    assert float(got[0].min()) == 0.0


@pytest.mark.parametrize("max_dist", [5e3, 40e3])
def test_logistic_weight_matches_jax(max_dist):
    """``ops.logistic_weight`` on a float32 tensor against the JAX
    function on the same values, to 1e-6 relative to the map's scale L
    (an exp that may round an ulp apart; where the offset cancels the
    logistic, an ulp of L is far more than 1e-6 of the difference),
    distances below and past ``max_dist`` (clamped)."""
    from mcmc_tpu_torch.ops import logistic_weight

    d32 = np.random.default_rng(6).uniform(0.0, 20e3, (30, 40)).astype(
        np.float32)
    got = logistic_weight(torch.from_numpy(d32), 2.0, 0.3, 6.0, 1.0,
                          max_dist)
    want = jlog.logistic_weight(jnp.asarray(d32), 2.0, 0.3, 6.0, 1.0,
                                max_dist)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * 2.0)


@pytest.mark.parametrize("nugget_max", [0.0, 25.0])
def test_finish_block_matches_jax_draw_block_math(nugget_max):
    """The port's finishing step (standardize over the block, scale, the
    nugget, the edge mask) against draw_block's arithmetic in JAX on the
    same raw fields and draws."""
    cfgs = _configs(nugget_max=nugget_max)
    t_static, t_arr = trf.build_randfield(*cfgs, device=CPU)
    _, j_arr = jrf.build_randfield(*cfgs)
    rng = np.random.default_rng(3)
    n, B = 5, t_static.B
    raw = rng.normal(0.0, 2.0, (n, B, B)).astype(np.float32)
    size_idx = rng.integers(0, t_static.n_sizes, n)
    scale = rng.uniform(20.0, 60.0, n).astype(np.float32) / 3.0
    nug = rng.uniform(0.0, nugget_max, n).astype(np.float32)
    nz = rng.normal(size=(n, B, B)).astype(np.float32)
    got = trf.finish_block(
        torch.as_tensor(raw), torch.as_tensor(size_idx),
        torch.as_tensor(scale), t_arr,
        torch.as_tensor(nz) if nugget_max else None,
        torch.as_tensor(nug) if nugget_max else None).numpy()
    pairs = np.asarray(j_arr.pairs)
    for i in range(n):
        w, h = pairs[0, size_idx[i]], pairs[1, size_idx[i]]
        bm = (np.arange(B)[:, None] < h) & (np.arange(B)[None, :] < w)
        f = jsp.standardize_masked(jnp.asarray(raw[i]), jnp.asarray(bm))
        bmf = jnp.asarray(bm, jnp.float32)
        if nugget_max:
            f = (f * scale[i] + jnp.asarray(nz[i]) * jnp.sqrt(nug[i])) * bmf
        else:
            f = f * scale[i] * bmf
        want = np.asarray(f * j_arr.edge_masks[size_idx[i]])
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def test_half_spectrum_noise_is_standard_complex_normal():
    gen = make_generator(0, CPU)
    z = tsp.half_spectrum_noise(gen, 64, (32, 32), CPU)
    assert z.shape == (64, 32, 17) and z.dtype == torch.complex64
    for part in (z.real, z.imag):
        assert abs(float(part.mean())) < 0.02
        assert abs(float(part.std()) - 1.0) < 0.02
    assert abs(float((z.real * z.imag).mean())) < 0.02


@pytest.mark.parametrize("isotropic", [True, False])
def test_sample_field_params_ranges(isotropic):
    gen = make_generator(1, CPU)
    scale, nug, rx, ry = tsp.sample_field_params(
        gen, 30.0, 90.0, 4.0, 1e3, 5e3, 2e3, 3e3, isotropic, n=2000,
        device=CPU)
    assert float(scale.min()) >= 10.0 and float(scale.max()) <= 30.0
    assert abs(float(scale.mean()) - 20.0) < 0.5
    assert float(nug.min()) >= 0.0 and float(nug.max()) <= 4.0
    assert float(rx.min()) >= 1e3 and float(rx.max()) <= 5e3
    if isotropic:
        assert torch.equal(rx, ry)
    else:
        assert float(ry.min()) >= 2e3 and float(ry.max()) <= 3e3


def test_draw_block_is_standardized_and_scaled():
    """Every draw is exactly zero-mean over its (h, w) block with standard
    deviation equal to its scale, drawn uniformly in [smin, smax] / 3;
    cells outside the block are zero.  (The edge masks are set to ones so
    the block statistics are those of the standardized field.)"""
    static, arrays = trf.build_randfield(*_configs(), device=CPU)
    arrays = dataclasses.replace(arrays,
                                 edge_masks=torch.ones_like(arrays.edge_masks))
    f, size_idx, w, h = trf.draw_block(make_generator(2, CPU), static,
                                       arrays, n=400)
    B = static.B
    stds = []
    for i in range(400):
        blk = f[i, :h[i], :w[i]].double()
        assert abs(float(blk.mean())) < 1e-4 * float(blk.std())
        stds.append(float(blk.std(unbiased=False)))
        outside = f[i].clone()
        outside[:h[i], :w[i]] = 0.0
        assert float(outside.abs().max()) == 0.0
    stds = np.array(stds)
    assert stds.min() >= 20.0 / 3 * (1 - 1e-4)
    assert stds.max() <= 60.0 / 3 * (1 + 1e-4)
    assert abs(stds.mean() - 40.0 / 3) < 0.05 * 40.0 / 3
    counts = np.bincount(size_idx.numpy(), minlength=static.n_sizes)
    assert counts.min() > 0 and f.shape == (400, B, B)


@pytest.mark.parametrize("model,smoothness", [("Gaussian", None),
                                              ("Matern", 1.3)])
def test_draws_correlogram_matches_reference(model, smoothness):
    """Ensemble correlation at axis lags 1..4 of the port's standardized
    fields against the NumPy reference synthesis on the same canvas."""
    n, B, R = 300, 32, 4e3
    gen = make_generator(3, CPU)
    r = torch.full((n,), R)
    raw = tsp.spectral_field(gen, (B, B), RES, model, r, r, smoothness)
    full = torch.ones((B, B), dtype=torch.bool)
    port = tsp.standardize_masked(raw, full).double().numpy()
    rng = np.random.default_rng(3)
    refs = np.stack([ref.spectral_field(rng, (B, B), RES, model, R, R,
                                        smoothness, 1.0, 0.0)
                     for _ in range(n)])

    def correlogram(f):
        var = np.mean(f * f)
        return np.array([(np.mean(f[:, :, :-h] * f[:, :, h:])
                          + np.mean(f[:, :-h, :] * f[:, h:, :])) / (2 * var)
                         for h in range(1, 5)])

    got, want = correlogram(port), correlogram(refs)
    assert np.all(np.abs(got - want) < 0.05), (got, want)
    assert got[0] > 0.3  # a correlated field, not white noise


def test_same_seed_same_draws():
    static, arrays = trf.build_randfield(*_configs(), device=CPU)
    a = trf.draw_block(make_generator(9, CPU), static, arrays, n=3)
    b = trf.draw_block(make_generator(9, CPU), static, arrays, n=3)
    c = trf.draw_block(make_generator(10, CPU), static, arrays, n=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
