"""A T2 chunk's draws, made and scattered on the grid's device: one
launch a chunk draws each cell from its kriging (est, var) and writes
the float32 score into the grid.

For cell (i, j) of a chunk, in float64 as scipy computes it on the host
(``geostats/sgs.py``'s host draws):

    sd = max(sqrt(|var|), 1e-12)
    bounded:   a = (lo - est) / sd,  b = (hi - est) / sd
               z = lo                              where lo == hi
               z = est + sd · ppf(u; a, b)         elsewhere
    unbounded: z = est + sd · u
    grid[i, j] = float32(z)

with ``u``, ``lo`` and ``hi`` read at (i, j) from (H, W) float64 planes:
the bed's uniforms (bounded) or standard normals (unbounded), drawn on
the host at once, and the transformed bounds.  ``ppf`` is the truncated
normal's quantile function by scipy 1.17's ``truncnorm._ppf`` scheme,
in log space: the left case y = log(Φ(a) + q·m), x = ndtri_exp(y), and
the right case, the left case of the reflected normal, y = log(Φ(-b) +
(1 - q)·m), x = -ndtri_exp(y), with m the Gaussian mass of [a, b] from
the side away from the tail and log Φ through erfcx below -1.  scipy
takes the left case wherever a < 0; here it is taken where the quantile
lies at or below 0 (b <= 0, or a <= 0 < b and q·m <= Φ(0) - Φ(a)), and
the right case elsewhere, so that the sum in y never cancels: where a <
0 < x, the left case rounds log Φ(x) near 0 and loses x as u nears 1
(scipy's by 0.01 at the largest uniform below 1; this module's, taken
there, rounded y to 0 and x to inf).  It also gives every cell one path
through the same operations, which the kernel's warps take together.
``ndtri_exp(y)``, the x with log Φ(x) = y, is scipy's -ndtri(-expm1(y))
above y = log1p(-e⁻²) and ndtri(exp(y)) below it, down to y = -700;
below, where exp(y) nears the subnormals (and underflows below about
-745), ``NEWTON`` Newton steps on log Φ from its asymptote, the slope
φ/Φ from erfcx without cancellation.

Three pieces, as for every kernel of the port:

- ``bounded_draw_reference``: the plain PyTorch version of the same
  algorithm in float64, on any device;
- ``csrc/bounded_draw.cu``: the hand-written CUDA kernel for Hopper,
  one thread a cell, built with ``-fmad=false``.  It is the port's own
  kernel: the JAX package draws these values on the host with scipy
  (``mcmc_tpu/geostats/sgs.py``), not in Pallas.  Kernel and plain
  version use different libraries' erfcx and ndtri, so they agree to
  about 1e-15, not bitwise;
- ``bounded_draw``: the dispatcher.  A CPU grid goes to the plain
  version; a CUDA grid launches the kernel or raises.  Nothing falls
  back.  ``bounded_draw.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .launch_counts import counted

SD_FLOOR = 1e-12
NEWTON = 3  # Newton steps of ndtri_exp below _Y_UNDERFLOW
_Y_HIGH = math.log1p(-math.exp(-2.0))  # scipy's switch to -ndtri(-expm1(y))
_Y_UNDERFLOW = -700.0  # below: exp(y) nears the subnormals
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_SQRT1_2 = math.sqrt(0.5)


def _log_diff(p, q):
    """log(exp(p) - exp(q)) for p >= q."""
    return p + torch.log1p(-torch.exp(q - p))


def _log_sum(p, q):
    """log(exp(p) + exp(q))."""
    m = torch.maximum(p, q)
    out = m + torch.log1p(torch.exp(torch.minimum(p, q) - m))
    return torch.where(m == -math.inf, m, out)


def _ndtr(x):
    """Φ(x), to its relative precision in the lower tail."""
    return 0.5 * torch.special.erfc(-x * _SQRT1_2)


def _phi_over_ndtr(x, log_ndtr_x):
    """φ(x) / Φ(x), the slope of log Φ."""
    tail = _SQRT_2_OVER_PI / torch.special.erfcx(-x * _SQRT1_2)
    body = torch.exp(-0.5 * x * x - _LOG_SQRT_2PI - log_ndtr_x)
    return torch.where(x < -1.0, tail, body)


def ndtri_exp(y):
    """The x with log Φ(x) = y, for float64 y <= 0 (module docstring)."""
    ndtri = torch.special.ndtri
    tail = -torch.sqrt(-2.0 * y - torch.log(-2.0 * y) - 2.0 * _LOG_SQRT_2PI)
    for _ in range(NEWTON):
        lp = torch.special.log_ndtr(tail)
        tail = tail - (lp - y) / _phi_over_ndtr(tail, lp)
    x = torch.where(y < _Y_UNDERFLOW, tail, ndtri(torch.exp(y)))
    x = torch.where(y > _Y_HIGH, -ndtri(-torch.expm1(y)), x)
    return torch.where(y == -math.inf, y, x)


def truncnorm_ppf(q, a, b):
    """The quantile ``q`` of the standard normal truncated to [a, b],
    float64 (module docstring)."""
    log_ndtr = torch.special.log_ndtr
    pa, pb = _ndtr(a), _ndtr(-b)
    mass = torch.where(
        b <= 0, _log_diff(log_ndtr(b), log_ndtr(a)),
        torch.where(a > 0, _log_diff(log_ndtr(-a), log_ndtr(-b)),
                    torch.log1p(-pa - pb)))
    # the quantile lies at or below 0: F(0) >= q
    left = (b <= 0) | ((a <= 0) & (q * (1.0 - pa - pb) <= 0.5 - pa))
    y = _log_sum(log_ndtr(torch.where(left, a, -b)),
                 torch.where(left, torch.log(q), torch.log1p(-q)) + mass)
    x = ndtri_exp(y)
    return torch.where(left, x, -x)


def bounded_draw_reference(grid, cells, est, var, u, lo=None, hi=None):
    """Plain PyTorch version (module docstring): each cell's draw written
    into ``grid`` in place, on any device."""
    i, j = cells.unbind(1)
    est = est.to(torch.float64)
    sd = torch.sqrt(var.to(torch.float64).abs()).clamp_min(SD_FLOOR)
    if lo is None:
        z = est + sd * u[i, j]
    else:
        lo, hi = lo[i, j], hi[i, j]
        eq = lo == hi
        a = torch.where(eq, -1.0, (lo - est) / sd)
        b = torch.where(eq, 1.0, (hi - est) / sd)
        z = torch.where(eq, lo, est + sd * truncnorm_ppf(u[i, j], a, b))
    grid[i, j] = z.to(torch.float32)


def bind_library(lib):
    """Type the entry points of a built ``bounded_draw.cu``; returns
    ``lib``."""
    lib.mcmc_bounded_draw.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p])
    lib.mcmc_bounded_draw.restype = ctypes.c_int
    lib.mcmc_truncnorm_ppf.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.mcmc_truncnorm_ppf.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("bounded_draw").lib
    if lib.mcmc_bounded_draw.argtypes is None:  # else pointers are cut
        bind_library(lib)
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"bounded draw {what} failed: {msg} ({err})")


def _check(grid, cells, est, var, u, lo, hi):
    if (lo is None) != (hi is None):
        raise ValueError("give both bounds or neither")
    if grid.dim() != 2 or grid.dtype != torch.float32:
        raise TypeError(f"grid must be a 2-D float32 tensor, got "
                        f"{grid.dtype} of shape {tuple(grid.shape)}")
    n = cells.shape[0]
    want = {"cells": (cells, torch.int64, (n, 2)),
            "est": (est, torch.float32, (n,)),
            "var": (var, torch.float32, (n,)),
            "u": (u, torch.float64, tuple(grid.shape))}
    if lo is not None:
        want.update(lo=(lo, torch.float64, tuple(grid.shape)),
                    hi=(hi, torch.float64, tuple(grid.shape)))
    if not grid.is_contiguous():
        raise ValueError("grid must be contiguous")
    for name, (t, dtype, shape) in want.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != grid.device:
            raise ValueError(f"{name} is on {t.device}, grid on "
                             f"{grid.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {dtype} of shape {shape}, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")


@counted("19bounded_draw_kernel")
def bounded_draw(grid, cells, est, var, u, lo=None, hi=None):
    """Draw the ``cells`` ((n, 2) int64 rows and columns) from their
    ``est`` and ``var`` and scatter them into ``grid`` (module
    docstring): the plain version for a CPU grid, the CUDA kernel for a
    CUDA grid."""
    _check(grid, cells, est, var, u, lo, hi)
    if cells.shape[0] >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2^31 cells a launch")
    if grid.device.type == "cpu":
        return bounded_draw_reference(grid, cells, est, var, u, lo, hi)
    if grid.device.type != "cuda":
        raise ValueError(f"no bounded-draw kernel for device {grid.device}")
    lib = _cuda_library()
    bounds = (0, 0) if lo is None else (lo.data_ptr(), hi.data_ptr())
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    with torch.cuda.device(grid.device):
        err = lib.mcmc_bounded_draw(
            grid.data_ptr(), grid.shape[1],
            *(t.data_ptr() for t in (cells, est, var, u)), *bounds,
            cells.shape[0], stream)
    _raise_on(lib, err, "kernel launch")
    bounded_draw.launches += 1


def truncnorm_ppf_on_card(q, a, b):
    """The kernel's ``truncnorm_ppf`` alone on CUDA float64 ``q``, ``a``
    and ``b`` of one shape, in float64: the tests' probe of the quantile
    function, which the draws round to float32."""
    lib = _cuda_library()
    ops = [t.contiguous() for t in (q, a, b)]
    for name, t in zip("qab", ops):
        if t.dtype != torch.float64 or t.shape != q.shape or not t.is_cuda:
            raise TypeError(f"{name} must be a CUDA float64 tensor of "
                            f"q's shape")
    out = torch.empty_like(ops[0])
    with torch.cuda.device(q.device):
        _raise_on(lib, lib.mcmc_truncnorm_ppf(
            *(t.data_ptr() for t in ops), out.data_ptr(), q.numel(),
            torch.cuda.current_stream(q.device).cuda_stream), "ppf launch")
    return out


__all__ = ["bounded_draw", "bounded_draw_reference", "ndtri_exp",
           "truncnorm_ppf", "truncnorm_ppf_on_card"]
