"""FFT spectral synthesis of 2D Gaussian random fields, batched over chains.

PyTorch counterpart of ``mcmc_tpu/ops/spectral.py`` (the proposal
generator of the reference's RandField, MCMC.py:176-254).  Every draw takes
an explicit ``torch.Generator`` (``half_spectrum_noise`` also the per-chain
streams of a seed-listed farm, ``utils/rng.PerChainStreams``) and a
leading chain dimension ``n``; the field is synthesized on a fixed (B, B)
grid by the half-spectrum form ``irfft2(noise_half * sqrt(S_half))`` so
one FFT shape serves the whole block-size menu.  Reference quirks kept as in the JAX package: anisotropic
ranges collapse to the geometric mean, per-model length conventions
(range/sqrt(3), /3, /2), the matérn density in ``4 pi k^2`` form, and exact
zero-mean / unit-variance standardization over the block.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.rng import PerChainStreams
from .chain_draws import SLOTS, entry
from .noise_kernel import (batched_normal, batched_normal_keyed,
                           batched_normal_keyed_reference,
                           batched_normal_reference, draw_seed)


def field_param_entries(isotropic: bool):
    """The draw-plan entries of ``field_params``' unit uniforms."""
    names = ("scale", "nugget", "range_x") + (() if isotropic
                                               else ("range_y",))
    return tuple(entry(name, "uniform") for name in names)


def field_params(unit, scale_min, scale_max, nugget_max, range_min_x,
                 range_max_x, range_min_y, range_max_y, isotropic: bool):
    """Per-draw variogram parameters (reference MCMC.py:199-207) from unit
    uniforms: ``unit(name)`` gives the (n,) float32 draws on [0, 1) of
    ``scale``, ``nugget``, ``range_x`` and, anisotropic, ``range_y``,
    asked for in that order.  Returns (scale, nugget, range_x, range_y),
    each (n,) float32; scale is already divided by 3."""
    def on(name, lo, hi):
        return lo + (hi - lo) * unit(name)

    scale = on("scale", scale_min, scale_max) / 3.0
    nug = on("nugget", 0.0, nugget_max)
    range_x = on("range_x", range_min_x, range_max_x)
    range_y = (range_x if isotropic
               else on("range_y", range_min_y, range_max_y))
    return scale, nug, range_x, range_y


def sample_field_params(gen, scale_min, scale_max, nugget_max,
                        range_min_x, range_max_x, range_min_y, range_max_y,
                        isotropic: bool, *, n: int, device):
    """Per-draw variogram parameters for ``n`` chains from ``gen``
    (``field_params``); the reference's arguments in its order, ``gen``
    in place of its key."""
    return field_params(
        lambda name: torch.rand((n,), generator=gen, device=device,
                                dtype=torch.float32),
        scale_min, scale_max, nugget_max, range_min_x, range_max_x,
        range_min_y, range_max_y, isotropic)


def spectral_density(model_name: str, k, range_x, range_y, smoothness):
    """Spectral power density S(k) of the named model; ``k`` is the angular
    wavenumber magnitude (2 pi included), ranges broadcast against it."""
    if model_name == "Gaussian":
        len_x, len_y = range_x / math.sqrt(3.0), range_y / math.sqrt(3.0)
        a = torch.sqrt(len_x * len_y)
        return torch.exp(-0.5 * torch.square(a * k))
    if model_name == "Exponential":
        len_x, len_y = range_x / 3.0, range_y / 3.0
        a = torch.sqrt(len_x * len_y)
        return 1.0 / (1.0 + torch.square(a * k)) ** 1.5
    nu = float(smoothness) if smoothness else 1.0
    len_x, len_y = range_x / 2.0, range_y / 2.0
    a = torch.sqrt(len_x * len_y)
    constant = ((4.0 * math.pi * math.gamma(nu + 1.0) * (2.0 * nu) ** nu)
                / math.gamma(nu))
    constant = constant / a ** (2.0 * nu)
    kappa = 2.0 * nu / torch.square(a)
    return constant * (kappa + 4.0 * math.pi * torch.square(k)) ** (-nu - 1.0)


@functools.lru_cache(maxsize=32)
def _rfreq_grid_np(shape, res):
    """Wavenumber magnitude on the half (rfft) grid (host-cached)."""
    ny, nx = shape
    kx = np.fft.rfftfreq(nx, d=res) * 2.0 * np.pi
    ky = np.fft.fftfreq(ny, d=res) * 2.0 * np.pi
    kxv, kyv = np.meshgrid(kx, ky, indexing="xy")
    return (np.sqrt(np.square(kxv) + np.square(kyv)) + 1e-10).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _rfreq_grid(shape, res, device):
    """The half-grid wavenumbers on ``device``, moved there once."""
    return torch.from_numpy(_rfreq_grid_np(shape, res)).to(device)


def spectral_field_from_noise(noise, shape, res, model_name: str, range_x,
                              range_y, smoothness):
    """Half-spectrum synthesis from complex white noise of shape
    ``(n, ny, nx//2+1)`` with per-chain ranges of shape ``(n,)``.  Returns
    the raw (unstandardized) ``(n, ny, nx)`` float32 fields."""
    kh = _rfreq_grid(tuple(shape), float(res), noise.device)
    rx = torch.as_tensor(range_x, dtype=torch.float32, device=noise.device)
    ry = torch.as_tensor(range_y, dtype=torch.float32, device=noise.device)
    s_dens = spectral_density(model_name, kh, rx[..., None, None],
                              ry[..., None, None], smoothness)
    spec = noise * torch.sqrt(s_dens).to(torch.complex64)
    return torch.fft.irfft2(spec, s=tuple(shape)).to(torch.float32)


def half_spectrum_noise(gen, n, shape, device, impl: str = "auto"):
    """(n, ny, nx//2+1) complex64 standard white noise: (n, 2·ny, nx//2+1)
    Philox normals (``ops/noise_kernel.py``), the first ny rows the real
    parts and the rest the imaginary, as the JAX package's hardware-PRNG
    path assembles them (``chain_crf.py:424-425``).  From a generator:
    one seed drawn from it, then the single-seed entry; from per-chain
    streams: the keyed entry at the ``spectrum`` slot, chain c from its
    own key.  ``impl="eager"`` draws them with the plain version,
    anything else through the dispatcher (the kernel for a CUDA
    device)."""
    ny, nh = shape[0], shape[1] // 2 + 1
    eager = impl == "eager"
    if isinstance(gen, PerChainStreams):
        if gen.n_chains != n:
            raise ValueError(f"{gen.n_chains} per-chain streams for {n} "
                             "chains")
        normal = (batched_normal_keyed_reference if eager
                  else batched_normal_keyed)
        zn = normal(gen.keys, gen.step, SLOTS["spectrum"], 2 * ny, nh)
    else:
        normal = batched_normal_reference if eager else batched_normal
        zn = normal(draw_seed(gen, device), n, 2 * ny, nh)
    return torch.complex(zn[:, :ny], zn[:, ny:])


def spectral_field(gen, shape, res, model_name: str, range_x, range_y,
                   smoothness):
    """One raw field realization of ``shape`` for each of the (n,)
    ``range_x`` (not standardized; callers standardize over the block and
    scale); the reference's arguments in its order, ``gen`` in place of
    its key."""
    noise = half_spectrum_noise(gen, range_x.shape[0], shape, range_x.device)
    return spectral_field_from_noise(noise, shape, res, model_name,
                                     range_x, range_y, smoothness)


def block_mask(h, w, B):
    """(n, B, B) bool: the top-left (h, w) block of each chain's canvas."""
    idx = torch.arange(B, device=h.device)
    return ((idx[None, :, None] < h[:, None, None])
            & (idx[None, None, :] < w[:, None, None]))


def standardize_masked(field, mask):
    """Zero mean / unit population variance (+1e-12 on the std) over the
    mask cells of the trailing (H, W) axes; cells outside the mask are
    zeroed (reference MCMC.py:248)."""
    m = mask.to(field.dtype)
    n = torch.clamp(m.sum(dim=(-2, -1), keepdim=True), min=1.0)
    mean = (field * m).sum(dim=(-2, -1), keepdim=True) / n
    var = (torch.square(field - mean) * m).sum(dim=(-2, -1), keepdim=True) / n
    out = (field - mean) / (torch.sqrt(var) + 1e-12)
    return out * m
