"""Uniform-grid LUT interpolation: the SGS chain's inverse normal-score
transform over every chain's window in one pass.

    t = clip((x - lo)·scale, 0, n - 1.000001),  i = floor(t),  f = t - i,
    y = T[i, 0]·(1 - f) + T[i, 1]·f,            NaN in gives NaN out

over any-shape float32 ``x`` with an (n, 2) float32 pair table ``T``.  The
clip bound is ``n - 1.000001`` rounded to float32 (4095.0 for n = 4096),
so ``i`` does reach the last row.

Three pieces, as for every kernel of the port:

- ``lut_interp_reference``: the plain PyTorch version
  (``ops/transforms.lut_lookup``, the JAX package's
  ``NormalScoreLUT._lookup``);
- ``csrc/lut_kernel.cu``: the hand-written CUDA kernel for Hopper that
  replaces the Pallas kernel ``mcmc_tpu/ops/lut_kernel.py::lut_interp``
  (``_lookup_positions``); built with ``-fmad=false``, it rounds each
  operation as the plain version's separate PyTorch operations do, so the
  two agree bitwise;
- ``lut_interp``: the dispatcher.  A CPU tensor goes to the plain version;
  a CUDA tensor launches the kernel or raises.  Nothing falls back.
  ``lut_interp.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .launch_counts import counted
from .transforms import lut_clip_bound, lut_lookup


lut_interp_reference = lut_lookup  # the plain version, on any device


def bind_library(lib):
    """Type the entry points of a built ``lut_kernel.cu`` (this
    checkout's, or another's in ``ab_lut_kernel.py``); returns ``lib``."""
    lib.mcmc_lut_interp.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    lib.mcmc_lut_interp.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("lut_kernel").lib
    if lib.mcmc_lut_interp.argtypes is None:  # else pointers are cut
        bind_library(lib)
        lib.mcmc_lut_info.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p]
        lib.mcmc_lut_info.restype = ctypes.c_int
        lib.mcmc_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.mcmc_empty_launch.restype = ctypes.c_int
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def lut_kernel_info(x) -> dict:
    """The kernel's launch for the CUDA tensor ``x`` as the CUDA runtime
    reports it: CTAs, threads a CTA, registers and local (spill) bytes a
    thread, resident CTAs a multiprocessor."""
    lib = _cuda_library()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(x.device):
        _raise_on(lib, lib.mcmc_lut_info(x.data_ptr(), x.numel(),
                                         ctypes.addressof(out)), "LUT info")
    return dict(zip(("ctas", "threads", "registers", "local_bytes",
                     "resident_ctas_per_sm"), list(out)))


def empty_launch(blocks: int, device=None):
    """Launch an empty kernel on ``blocks`` CTAs of the LUT kernel's width
    on the current stream: the floor under any launch of that grid."""
    lib = _cuda_library()
    device = torch.device("cuda" if device is None else device)
    with torch.cuda.device(device):
        _raise_on(lib, lib.mcmc_empty_launch(
            int(blocks), torch.cuda.current_stream(device).cuda_stream),
            "empty launch")


def launch_lut(lib, x, lo: float, scale: float, table):
    """Check CUDA operands and launch the LUT entry point of ``lib`` (this
    checkout's, or another's in ``ab_lut_kernel.py``) on the current
    stream; returns y."""
    for name, t in (("x", x), ("table", table)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 2 or table.shape[1] != 2 or table.shape[0] < 2:
        raise ValueError(f"table must be (n >= 2, 2), got "
                         f"{tuple(table.shape)}")
    if table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned (one float2 a row)")
    n = table.shape[0]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mcmc_lut_interp(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), float(lo),
            float(scale), lut_clip_bound(n), n, x.numel(), stream)
    _raise_on(lib, err, "LUT kernel launch")
    return out


@counted("10lut_kernel")
def lut_interp(x, lo: float, scale: float, table):
    """LUT interpolation (module docstring): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return lut_interp_reference(x, lo, scale, table)
    if x.device.type != "cuda":
        raise ValueError(f"no LUT kernel for device {x.device}")
    out = launch_lut(_cuda_library(), x, lo, scale, table)
    lut_interp.launches += 1
    return out
