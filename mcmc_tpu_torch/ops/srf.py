"""gstools-SRF random fields by the randomization method, batched over
chains.

PyTorch counterpart of ``mcmc_tpu/ops/srf.py``.  The reference's
non-spectral generation path draws gstools' ``SRF(model).structured``
(reference gstatsMCMC/MCMC.py:657-687), whose backend is the
randomization method (Kraichnan): sample M wavevectors from the model's
normalized spectral measure and superpose random-phase harmonics,

    f(x) = sqrt(1 / M) * sum_j  z1_j cos(k_j . x) + z2_j sin(k_j . x),

exact in distribution as M -> infinity; M = ``N_MODES`` = 1000, gstools'
default, fixed as in the JAX package.  The 2-D spectral measures are in
closed form for the reference's three model families, so sampling is
inverse-CDF transforms of uniforms (no rejection, no tables):

  Gaussian     rho(r) = exp(-3 r^2 / R^2)      k ~ Normal(0, 6/R^2 I)
  Exponential  rho(r) = exp(-3 r / R)          |k| = sqrt((1-u)^-2 - 1) * 3/R
  Matern(nu)   standard Matern with effective length l = R / (sqrt(2) c(nu))
               |k| = sqrt(2 nu ((1-u)^{-1/nu} - 1)) / l

with the reference's length conventions and its fitted Matern scale
c(nu) (``ops/covariance.matern_scale_fit``), so the fields reproduce
``ops/covariance.covariance_norm`` for the same range.

The correlation-length convention, as the JAX package records it
(``mcmc_tpu/ops/srf.py:98-106``): gstools' own models carry their own
rescale constants (its Gaussian uses the integral scale, rescale
sqrt(pi)/2), so the reference's gstools draw of the Gaussian model has a
correlation length ~2/sqrt(pi) = 1.13x this one at the same nominal
range, an inconsistency within the reference (its SRF fields against its
kriging covariance) that both packages resolve in favour of the
covariance module.

Unlike the spectral path, realizations are NOT standardized: their
variance is random around 1 (gstools' behaviour; SURVEY.md §8.11).

The pieces: ``sample_wavevectors`` maps injected unit uniforms to
wavevectors; ``srf_field`` sums the harmonics through
``ops/srf_kernel.srf_harmonics`` (the CUDA kernel for CUDA tensors, its
plain version for CPU ones); ``draw_srf`` (a ``torch.Generator``) and
``srf_entries`` / ``srf_draws_from`` (a seed-listed step's draw plan)
make the draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .chain_draws import entry
from .covariance import matern_scale_fit
from .srf_kernel import srf_harmonics, srf_harmonics_reference

N_MODES = 1000
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
SQRT6 = float(np.sqrt(np.float32(6.0)))


def radial_wavenumber(u, model_name: str, smoothness=None):
    """|k| at unit range from unit uniforms ``u`` by the model's radial
    inverse CDF (module docstring), float32."""
    if model_name == "Gaussian":
        # rho(r) = exp(-3 r^2) at unit range -> k ~ N(0, 6 I): the
        # Box-Muller radius sqrt(-2 ln u) of a 2-D standard normal
        return SQRT6 * torch.sqrt(-2.0 * torch.log(torch.clamp_min(u,
                                                                   1e-12)))
    if model_name == "Exponential":
        # rho(r) = exp(-r/l), l = 1/3: F = 1 - (1 + (l k)^2)^{-1/2}
        v = 1.0 - u
        return torch.sqrt(torch.clamp_min(1.0 / (v * v) - 1.0, 0.0)) / (
            1.0 / 3.0)
    if model_name == "Matern":
        nu = float(smoothness if smoothness is not None else 1.0)
        lam = 1.0 / (np.sqrt(2.0) * float(matern_scale_fit(nu)))
        # S(k) ~ (1 + l^2 k^2 / (2 nu))^{-(nu+1)}; F = 1 - (1+.)^{-nu}
        return torch.sqrt((2.0 * nu) * torch.clamp_min(
            torch.pow(1.0 - u, -1.0 / nu) - 1.0, 0.0)) / lam
    raise ValueError(f"unknown model {model_name!r}")


def sample_wavevectors(u, theta, model_name: str, range_x, range_y,
                       smoothness=None, angle=None):
    """(n, 2, M) float32 wavevectors [kx; ky] from the model's 2-D
    spectral measure, as ``mcmc_tpu/ops/srf.py:45-85`` computes them from
    its uniforms.

    ``u`` and ``theta`` are (n, M) unit uniforms on [0, 1): the radius's
    and the polar angle's (the angle is 2 pi theta, as ``jax.random.
    uniform(maxval=2 pi)`` scales its unit draws).  ``range_x`` and
    ``range_y`` (n,) are the variogram ranges in metres: the unit-range
    sample is scaled per axis, then rotated by ``angle`` (n,) radians
    (None: isotropic, no rotation), gstools' ``angles=`` convention."""
    kappa = radial_wavenumber(u, model_name, smoothness)
    t = theta * TWO_PI
    s0 = kappa * torch.cos(t) / range_x[:, None]
    s1 = kappa * torch.sin(t) / range_y[:, None]
    if angle is None:
        return torch.stack([s0, s1], dim=1)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    return torch.stack([ca * s0 + (-sa) * s1, sa * s0 + ca * s1], dim=1)


def srf_field(kv, z1, z2, shape, resolution: float, impl: str = "auto"):
    """(n, ny, nx) unit-variance fields, not standardized, from
    wavevectors ``kv`` (n, 2, M) and normals ``z1``, ``z2`` (n, M) on
    the grid x = arange(nx) * res, y = arange(ny) * res (``ops/
    srf_kernel.py``).  ``impl="eager"`` runs the plain version on any
    device, anything else the dispatcher."""
    fn = srf_harmonics_reference if impl == "eager" else srf_harmonics
    ny, nx = shape
    return fn(kv, z1, z2, int(ny), int(nx), resolution)


def srf_entries(isotropic: bool, n_modes: int = N_MODES):
    """A seed-listed step's draw-plan entries for ``srf_draws_from``:
    the radius's and the polar angle's uniforms, the two sets of
    normals, and (anisotropic) the azimuth's uniform."""
    return ((entry("wave_u", "uniform", n_modes),
             entry("wave_theta", "uniform", n_modes),
             entry("z1", "normal", n_modes), entry("z2", "normal", n_modes))
            + (() if isotropic else (entry("angle", "uniform"),)))


def srf_draws_from(d, isotropic: bool):
    """(wave_u, wave_theta, z1, z2, angle) from the views ``d`` of a draw
    plan holding ``srf_entries``; ``angle`` in [0, pi), None when
    isotropic."""
    angle = None if isotropic else d["angle"][:, 0] * PI
    return d["wave_u"], d["wave_theta"], d["z1"], d["z2"], angle


def draw_srf(gen, n: int, isotropic: bool, device, n_modes: int = N_MODES):
    """(wave_u, wave_theta, z1, z2, angle) for ``n`` chains from ``gen``,
    drawn in that order: (n, M) uniforms, (n, M) uniforms, (n, M)
    normals twice and, anisotropic, the (n,) azimuth uniform times pi
    (the reference samples it in [0, 180) degrees, MCMC.py:652)."""
    shape = (n, n_modes)
    wave_u = torch.rand(shape, generator=gen, device=device)
    wave_theta = torch.rand(shape, generator=gen, device=device)
    z1 = torch.randn(shape, generator=gen, device=device)
    z2 = torch.randn(shape, generator=gen, device=device)
    angle = None
    if not isotropic:
        angle = torch.rand((n,), generator=gen, device=device) * PI
    return wave_u, wave_theta, z1, z2, angle


__all__ = ["N_MODES", "draw_srf", "radial_wavenumber", "sample_wavevectors",
           "srf_draws_from", "srf_entries", "srf_field"]
