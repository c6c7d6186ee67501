"""The gstools-SRF proposal's harmonic sum, batched over chains.

For wavevectors ``kv`` (n, 2, M) [kx; ky] and normals ``z1``, ``z2``
(n, M), all float32, the (n, ny, nx) float32 fields

    out[c, i, k] = sqrt(1/M) * (sum_j z1[c, j] cos(phi) + z2[c, j] sin(phi)),
    phi = y_i * ky[c, j] + x_k * kx[c, j],

on the grid x = arange(nx) * res, y = arange(ny) * res (float32), the
phase's two products rounded before their sum, as
``mcmc_tpu/ops/srf.py:114-123`` computes it with XLA ops.

Three pieces, as for every kernel of the port:

- ``srf_harmonics_reference``: the plain PyTorch version.  It sums over
  the modes in chunks, so that the (chains, ny, nx, chunk) phase tensor
  stays under a fixed budget (``PLAIN_BUDGET_BYTES``: 256 MiB on the
  card, 32 MiB on the CPU), with as many chains a pass as the budget
  holds.  The chunk and the number of chains a pass depend on (ny, nx,
  M) and the device alone, so a chain's field does not depend on how
  many chains share the call;
- ``csrc/srf_kernel.cu``: the hand-written CUDA kernel for Hopper.  It
  computes the field as a separable product: with a = fl(x kx) and b =
  fl(y ky), cos(a + b) and sin(a + b) expand into cos a, sin a, cos b
  and sin b, so a chain's field is one (ny x 2M) by (2M x nx) matrix
  product in 3xTF32 on the tensor cores, with (ny + nx) M accurate
  ``sincosf`` a chain instead of ny nx M.  It does not round a + b, as
  the plain version does: ``testing.srf_separable_float64`` is the value
  it approximates and ``testing.srf_rounding_bound`` what the phase's
  rounding allows between the two, cell by cell.  There is no Pallas
  kernel at this site: the kernel is the port's own, like
  ``csrc/chain_draws.cu``, because written as tensors the card would
  move some 60 GB a step at the CRF headline (768 chains x 80 x 80 x
  1000 terms, three 19.7 GB intermediates);
- ``srf_harmonics``: the dispatcher.  CPU tensors go to the plain
  version; CUDA tensors launch the kernel or raise.  Nothing falls back.
  ``srf_harmonics.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .launch_counts import counted

PLAIN_BUDGET_BYTES = {"cuda": 256 << 20, "cpu": 32 << 20}
MAX_CHAINS = 65535          # the grid's y dimension holds the chain


def srf_norm(n_modes: int) -> float:
    """sqrt(1 / M) rounded to float32, as ``jnp.sqrt(1.0 / n_modes)``."""
    return float(np.sqrt(np.float32(1.0 / n_modes)))


def srf_harmonics_reference(kv, z1, z2, ny: int, nx: int,
                            resolution: float):
    """Plain PyTorch version (module docstring): (n, ny, nx) float32."""
    n, _, M = kv.shape
    device = kv.device
    x = torch.arange(nx, dtype=torch.float32, device=device) * float(
        resolution)
    y = torch.arange(ny, dtype=torch.float32, device=device) * float(
        resolution)
    budget = PLAIN_BUDGET_BYTES["cuda" if device.type == "cuda" else "cpu"]
    cell_bytes = 4 * ny * nx
    chunk = max(1, min(M, budget // cell_bytes))
    group = max(1, budget // (cell_bytes * chunk))
    out = torch.empty((n, ny, nx), dtype=torch.float32, device=device)
    for c0 in range(0, n, group):
        kx, ky = kv[c0:c0 + group, 0], kv[c0:c0 + group, 1]
        a, b = z1[c0:c0 + group], z2[c0:c0 + group]
        acc_c = acc_s = 0.0
        for m0 in range(0, M, chunk):
            ms = slice(m0, m0 + chunk)
            phase = (y[None, :, None, None] * ky[:, None, None, ms]
                     + x[None, None, :, None] * kx[:, None, None, ms])
            acc_c = acc_c + (torch.cos(phase) * a[:, None, None, ms]).sum(-1)
            acc_s = acc_s + (torch.sin(phase) * b[:, None, None, ms]).sum(-1)
            del phase
        out[c0:c0 + group] = (acc_c + acc_s) * srf_norm(M)
    return out


def bind_library(lib):
    """Type the entry points of a built ``srf_kernel.cu``."""
    lib.mcmc_srf_harmonics.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
        + [ctypes.c_void_p])
    lib.mcmc_srf_harmonics.restype = ctypes.c_int
    lib.mcmc_srf_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.mcmc_srf_kernel_info.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("srf_kernel").lib
    if lib.mcmc_srf_harmonics.argtypes is None:  # else pointers are cut
        bind_library(lib)
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"SRF kernel {what} failed: {msg} ({err})")


def srf_kernel_info(ny: int, nx: int) -> dict:
    """The launch an (ny, nx) grid takes: the kernel's registers and
    local (spill) bytes a thread, resident CTAs a multiprocessor, dynamic
    shared bytes a CTA, its tile side and threads a CTA, as the CUDA
    runtime reports them on the current card."""
    lib = _cuda_library()
    out = (ctypes.c_int * 6)()
    _raise_on(lib, lib.mcmc_srf_kernel_info(int(ny), int(nx),
                                            ctypes.addressof(out)), "query")
    return dict(zip(("registers", "local_bytes", "resident_ctas_per_sm",
                     "shared_bytes", "tile", "threads"), list(out)))


def _check(kv, z1, z2, ny: int, nx: int):
    if kv.dim() != 3 or kv.shape[1] != 2:
        raise ValueError(f"kv must be (n, 2, M), got {tuple(kv.shape)}")
    n, _, M = kv.shape
    for name, z in (("z1", z1), ("z2", z2)):
        if tuple(z.shape) != (n, M):
            raise ValueError(f"{name} must be ({n}, {M}), got "
                             f"{tuple(z.shape)}")
    for name, t in (("kv", kv), ("z1", z1), ("z2", z2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != kv.device:
            raise ValueError(f"{name} is on {t.device}, kv on {kv.device}")
    if M < 1 or ny < 1 or nx < 1:
        raise ValueError(f"need M, ny, nx >= 1, got {M}, {ny}, {nx}")


def launch_srf(lib, kv, z1, z2, ny: int, nx: int, resolution: float):
    """One launch of a built ``srf_kernel.cu`` (``lib``, typed by
    ``bind_library``) on checked contiguous CUDA operands: the (n, ny,
    nx) float32 fields on the current stream."""
    n, _, M = kv.shape
    out = torch.empty((n, ny, nx), dtype=torch.float32, device=kv.device)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    with torch.cuda.device(kv.device):
        err = lib.mcmc_srf_harmonics(
            kv.data_ptr(), z1.data_ptr(), z2.data_ptr(), out.data_ptr(), n,
            M, ny, nx, float(np.float32(resolution)), srf_norm(M), stream)
    _raise_on(lib, err, "launch")
    return out


@counted("10srf_kernel")
def srf_harmonics(kv, z1, z2, ny: int, nx: int, resolution: float):
    """The (n, ny, nx) float32 harmonic sums (module docstring): the
    operands checked, then the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    ny, nx = int(ny), int(nx)
    _check(kv, z1, z2, ny, nx)
    if kv.device.type == "cpu":
        return srf_harmonics_reference(kv, z1, z2, ny, nx, resolution)
    if kv.device.type != "cuda":
        raise ValueError(f"no SRF kernel for device {kv.device}")
    if kv.shape[0] > MAX_CHAINS:
        raise ValueError(f"{kv.shape[0]} chains: the SRF kernel takes at "
                         f"most {MAX_CHAINS} a launch")
    if ny * nx >= 2 ** 31:
        raise ValueError(f"{ny} x {nx} cells: the SRF kernel takes fewer "
                         "than 2^31")
    out = launch_srf(_cuda_library(), kv.contiguous(), z1.contiguous(),
                     z2.contiguous(), ny, nx, resolution)
    srf_harmonics.launches += 1
    return out
