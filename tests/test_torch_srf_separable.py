"""The float64 references that hold the SRF kernel, against the JAX package.

The SRF kernel (``mcmc_tpu_torch/ops/csrc/srf_kernel.cu``) computes the
harmonic sum as a separable product: with a = fl(x kx) and b = fl(y ky),
the phase's two float32 products, cos(a + b) and sin(a + b) expand into
cos a, sin a, cos b and sin b, and a + b is never rounded.  The JAX
package (``mcmc_tpu/ops/srf.py:114-123``) and the port's plain version
round the phase fl(a + b) first.  ``mcmc_tpu_torch.testing`` holds the
two functions the kernel is checked with on the card:

- ``srf_separable_float64``: the field on the unrounded a + b in float64;
- ``srf_rounding_bound``: per cell, norm * sum_m (|z1| + |z2|) |fl(a + b)
  - (a + b)|, which bounds the field on the rounded phases against the
  field on the unrounded ones, since |cos u - cos v| <= |u - v|.

Here, on the CPU: the JAX package's ``srf_field`` and the port's plain
version lie within the bound plus 1e-5 of the separable field in every
cell, for the Matern, Gaussian and rotated Exponential models at 20^2 and
48^2, fed the wavevectors and normals that the JAX key draws (the port's
own wavevectors round the rotation apart, ``test_torch_srf.py``); the
bound is sound cell by cell against a float64 sum on the JAX package's
float32 phases; the separable field is the direct float64 field on the
unrounded phases; and neither function depends on how many chains share
the call or on its temporaries' budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops import srf as jsrf
from mcmc_tpu_torch import testing
from mcmc_tpu_torch.ops import srf_kernel as tsk
from mcmc_tpu_torch.testing import srf_rounding_bound, srf_separable_float64

M = 1000
RES = 500.0
# (model, smoothness, range_x, range_y, angle): the rotated Exponential's
# Cauchy-like tail puts phases at 1e3-1e5 rad on these grids
MODELS = {
    "matern": ("Matern", 1.3, 6e3, 6e3, 0.0),
    "gaussian": ("Gaussian", None, 6e3, 6e3, 0.0),
    "exponential-rotated": ("Exponential", None, 6e3, 2.5e3, 0.7),
}
SHAPES = {"20": (20, 20), "48": (48, 48)}
FIELD_ATOL = 1e-5    # float32 cos, sin and sums of 1000 terms, unit variance
F64_ATOL = 1e-12     # float64 rounding of two sums of 1000 terms


def _jax_operands(key, model):
    """The JAX package's (kv (2, M), z1, z2) for ``srf_field(key, ...)``:
    the splits it makes, as float32 numpy."""
    name, nu, rx, ry, angle = MODELS[model]
    k_vec, k_z1, k_z2 = jax.random.split(key, 3)
    kv = jsrf.sample_wavevectors(k_vec, M, name, np.float32(rx),
                                 np.float32(ry), nu, np.float32(angle))
    return tuple(np.asarray(v) for v in (
        kv, jax.random.normal(k_z1, (M,)), jax.random.normal(k_z2, (M,))))


def _batch(*arrays):
    return tuple(torch.as_tensor(np.array(a))[None] for a in arrays)


def _jax_field(key, model, shape):
    name, nu, rx, ry, angle = MODELS[model]
    return np.asarray(jsrf.srf_field(key, shape, RES, name, np.float32(rx),
                                     np.float32(ry), nu, np.float32(angle)))


@pytest.mark.parametrize("impl", ["jax", "plain"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("model", list(MODELS))
def test_rounded_fields_lie_within_the_bound_of_the_separable_field(
        model, shape, impl):
    """The field on the rounded phase, as the JAX package's ``srf_field``
    and the port's plain version compute it, is within the rounding
    bound plus 1e-5 of ``srf_separable_float64`` in every cell."""
    ny, nx = SHAPES[shape]
    key = jax.random.key(3)
    kv, z1, z2 = _batch(*_jax_operands(key, model))
    if impl == "jax":
        got = _jax_field(key, model, (ny, nx))
    else:
        got = tsk.srf_harmonics_reference(kv, z1, z2, ny, nx, RES)[0].numpy()
    sep = srf_separable_float64(kv, z1, z2, ny, nx, RES)[0].numpy()
    bound = srf_rounding_bound(kv, z1, z2, ny, nx, RES)[0].numpy()
    assert sep.shape == bound.shape == got.shape == (ny, nx)
    assert sep.dtype == bound.dtype == np.float64
    excess = np.abs(got - sep) - bound
    assert excess.max() <= FIELD_ATOL, excess.max()


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("model", list(MODELS))
def test_rounding_bound_is_sound(model, shape):
    """A float64 sum of the harmonics on the JAX package's float32 phases
    (``y * ky + x * kx`` as ``srf_field`` rounds it) departs from the
    separable field by at most the bound, cell by cell; and the bound is
    not slack by orders of magnitude where the phases are large."""
    ny, nx = SHAPES[shape]
    kv, z1, z2 = _jax_operands(jax.random.key(5), model)
    x = jnp.arange(nx, dtype=jnp.float32) * RES
    y = jnp.arange(ny, dtype=jnp.float32) * RES
    k = jnp.asarray(kv)
    phase = np.asarray(y[:, None, None] * k[1][None, None, :]
                       + x[None, :, None] * k[0][None, None, :])
    assert phase.dtype == np.float32
    phase = phase.astype(np.float64)
    direct = ((np.cos(phase) @ z1.astype(np.float64)
               + np.sin(phase) @ z2.astype(np.float64)) * tsk.srf_norm(M))
    op = _batch(kv, z1, z2) + (ny, nx, RES)
    sep = srf_separable_float64(*op)[0].numpy()
    bound = srf_rounding_bound(*op)[0].numpy()
    gap = np.abs(direct - sep)
    assert np.all(gap <= bound + F64_ATOL), (gap - bound).max()
    assert gap.max() >= 1e-3 * bound.max(), (gap.max(), bound.max())


@pytest.mark.parametrize("model", list(MODELS))
def test_separable_field_is_the_direct_field_on_the_unrounded_phase(model):
    """cos a (z1 cos b + z2 sin b) + sin a (z2 cos b - z1 sin b) summed
    is z1 cos(a + b) + z2 sin(a + b) summed, a + b in float64."""
    ny, nx = 17, 23
    kv, z1, z2 = _jax_operands(jax.random.key(8), model)
    x = np.arange(nx, dtype=np.float32) * np.float32(RES)
    y = np.arange(ny, dtype=np.float32) * np.float32(RES)
    a = (x[:, None] * kv[0][None, :]).astype(np.float64)   # fl32 products
    b = (y[:, None] * kv[1][None, :]).astype(np.float64)
    phase = b[:, None, :] + a[None, :, :]
    want = ((np.cos(phase) @ z1.astype(np.float64)
             + np.sin(phase) @ z2.astype(np.float64)) * tsk.srf_norm(M))
    got = srf_separable_float64(*_batch(kv, z1, z2), ny, nx, RES)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_ATOL)


def test_checks_do_not_depend_on_the_batch_or_the_budget(monkeypatch):
    """Both functions give each chain of a batch its values alone, and the
    same values (to float64 rounding) when their temporaries are cut into
    many small chunks."""
    rng = np.random.default_rng(2)
    n, ny, nx = 3, 11, 14
    kv = torch.as_tensor(rng.normal(0.0, 2e-3, (n, 2, M)).astype(np.float32))
    z1 = torch.as_tensor(rng.normal(size=(n, M)).astype(np.float32))
    z2 = torch.as_tensor(rng.normal(size=(n, M)).astype(np.float32))
    op = (kv, z1, z2, ny, nx, RES)
    for fn in (srf_separable_float64, srf_rounding_bound):
        full = fn(*op)
        assert full.shape == (n, ny, nx) and full.dtype == torch.float64
        for i in range(n):
            one = fn(kv[i:i + 1], z1[i:i + 1], z2[i:i + 1], ny, nx, RES)
            torch.testing.assert_close(one[0], full[i], rtol=0,
                                       atol=F64_ATOL)
        with monkeypatch.context() as m:
            m.setattr(testing, "SRF_CHECK_BUDGET", 977)
            small = fn(*op)
        torch.testing.assert_close(small, full, rtol=0, atol=F64_ATOL)
    assert float(srf_rounding_bound(*op).max()) > 0.0
