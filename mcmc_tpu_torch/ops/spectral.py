"""FFT spectral synthesis of 2D Gaussian random fields, batched over chains.

PyTorch counterpart of ``mcmc_tpu/ops/spectral.py`` (the proposal
generator of the reference's RandField, MCMC.py:176-254).  Every draw takes
an explicit ``torch.Generator`` and a leading chain dimension ``n``; the
field is synthesized on a fixed (B, B) grid by the half-spectrum form
``irfft2(noise_half * sqrt(S_half))`` so one FFT shape serves the whole
block-size menu.  Reference quirks kept as in the JAX package: anisotropic
ranges collapse to the geometric mean, per-model length conventions
(range/sqrt(3), /3, /2), the matérn density in ``4 pi k^2`` form, and exact
zero-mean / unit-variance standardization over the block.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _uniform(gen, n, lo, hi, device):
    """(n,) float32 uniform draws on [lo, hi)."""
    u = torch.rand((n,), generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def sample_field_params(gen, n, scale_min, scale_max, nugget_max,
                        range_min_x, range_max_x, range_min_y, range_max_y,
                        isotropic: bool, device):
    """Per-draw variogram parameters for ``n`` chains (reference
    MCMC.py:199-207).  Returns (scale, nugget, range_x, range_y), each (n,)
    float32; scale is already divided by 3."""
    scale = _uniform(gen, n, scale_min, scale_max, device) / 3.0
    nug = _uniform(gen, n, 0.0, nugget_max, device)
    range_x = _uniform(gen, n, range_min_x, range_max_x, device)
    range_y = (range_x if isotropic
               else _uniform(gen, n, range_min_y, range_max_y, device))
    return scale, nug, range_x, range_y


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


def half_spectrum_noise(gen, n, shape, device):
    """(n, ny, nx//2+1) complex64 standard white noise."""
    nh = (n, shape[0], shape[1] // 2 + 1)
    re = torch.randn(nh, generator=gen, device=device, dtype=torch.float32)
    im = torch.randn(nh, generator=gen, device=device, dtype=torch.float32)
    return torch.complex(re, im)


def spectral_field(gen, n, shape, res, model_name: str, range_x, range_y,
                   smoothness):
    """``n`` raw field realizations of ``shape`` (not standardized; callers
    standardize over the block and scale)."""
    noise = half_spectrum_noise(gen, n, shape, range_x.device)
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
