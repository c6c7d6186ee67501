"""Batched standard normals for the CRF chain's half-spectrum proposal
noise, from a counter-based generator.

PyTorch counterpart of ``mcmc_tpu/ops/noise_kernel.py`` (the JAX
package's opt-in hardware-PRNG draw).  The card has no hardware
generator, so the bits come from Philox4x32-10 keyed by one 64-bit seed
and countered by (call, chain, 0, 0): every output is a pure function of
(seed, chain, index), so the kernel and its plain version agree whatever
their launch layouts.  The bits then go through the JAX kernel's
Box–Muller transform unchanged (``box_muller``): 24-bit uniforms, ``u1``
offset by 2⁻²⁵, cos into the first half of the rows and sin into the
second, the tail capped at √(50 ln 2) ≈ 5.887.

Three pieces, as for every kernel of the port:

- ``batched_normal_reference``: the plain PyTorch version, Philox in int64
  arithmetic masked to 32 bits (the 32 × 32-bit products split into
  16-bit halves so they do not overflow);
- ``csrc/noise_kernel.cu``: the hand-written CUDA kernel for Hopper that
  replaces the Pallas kernel ``mcmc_tpu/ops/noise_kernel.py::
  batched_normal`` (body ``_noise_kernel``);
- ``batched_normal``: the dispatcher.  A CPU seed goes to the plain
  version; a CUDA seed launches the kernel or raises.  Nothing falls
  back.  ``batched_normal.launches`` counts kernel launches.

The seed is a one-element int64 tensor on the device (``draw_seed``
draws it from the sampler's generator), read by the kernel from device
memory, so no draw waits for the host.  Its low word is Philox's key 0,
its high word key 1.

The keyed entry, for a farm seeded with a list of per-chain seeds
(``utils/rng.PerChainStreams``): ``batched_normal_keyed`` (dispatcher),
``batched_normal_keyed_reference`` (plain version), the same kernel
launched with chain c keyed by its own (k0, k1) = ``keys[c]`` and
countered by (step low word, slot, call, step high word), the step a
(1,) int64 tensor read from device memory.  Every output is then a pure
function of (key c, step, slot, index): chain c's normals do not depend
on the other chains.  The layout and transform are the single-seed
entry's.  ``batched_normal_keyed.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .launch_counts import counted

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)   # Philox4x32 round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)   # Weyl key increments
TWO_PI = float(np.float32(2.0 * np.pi))


def draw_seed(gen: torch.Generator, device) -> torch.Tensor:
    """A (1,) int64 seed on ``device`` from ``gen`` (63 random bits; no
    host synchronisation)."""
    return torch.empty((1,), dtype=torch.int64, device=device).random_(
        generator=gen)


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of ``a * b`` for a constant ``a`` < 2³² and
    int64 ``b`` < 2³², without overflowing int64: b splits into 16-bit
    halves, each partial product < 2⁴⁸."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (counter c0..c3,
    key k0, k1; broadcast together).  Returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & M32
            k1 = (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def box_muller(bits1, bits2):
    """The JAX kernel's transform (``noise_kernel.py:67-76``) of integer
    words: their low 24 bits as uniforms, ``u1 = b1·2⁻²⁴ + 2⁻²⁵``,
    ``u2 = b2·2⁻²⁴``.  Returns (r cos t, r sin t) in float32."""
    u1 = (bits1 & 0xFFFFFF).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (bits2 & 0xFFFFFF).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = TWO_PI * u2
    return r * torch.cos(t), r * torch.sin(t)


def _check_rows(rows: int):
    if rows % 2:
        raise ValueError("rows must be even (sin/cos Box-Muller pairs)")


def _normals_from_words(words, n: int, rows: int, cols: int):
    """(n, rows, cols) normals from the (n, calls) Philox words of each
    chain's calls: pair 2c takes words (0, 1) of call c, pair 2c + 1
    words (2, 3); cos into the first half of the rows, sin the second."""
    w0, w1, w2, w3 = words
    pairs = rows // 2 * cols
    calls = w0.shape[1]
    b1 = torch.stack([w0, w2], dim=-1).reshape(n, 2 * calls)[:, :pairs]
    b2 = torch.stack([w1, w3], dim=-1).reshape(n, 2 * calls)[:, :pairs]
    zc, zs = box_muller(b1, b2)
    return torch.cat([zc, zs], dim=1).reshape(n, rows, cols)


def _calls(rows: int, cols: int) -> int:
    return (rows // 2 * cols + 1) // 2


def batched_normal_reference(seed, n: int, rows: int, cols: int):
    """Plain PyTorch version (module docstring): (n, rows, cols) float32
    normals from the (1,) int64 ``seed`` tensor, on its device."""
    _check_rows(rows)
    calls = _calls(rows, cols)
    s = seed.reshape(()).to(torch.int64)
    k0, k1 = s & M32, (s >> 32) & M32
    call = torch.arange(calls, dtype=torch.int64, device=seed.device)
    chain = torch.arange(n, dtype=torch.int64, device=seed.device)
    call, chain = call[None, :].expand(n, calls), chain[:, None].expand(
        n, calls)
    zero = torch.zeros_like(call)
    words = philox4x32_10(call, chain, zero, zero, k0, k1)
    return _normals_from_words(words, n, rows, cols)


def keyed_words(keys, step, slot: int, calls: int):
    """The four (N, calls) Philox words of each chain's calls 0..calls-1
    at ``slot``: chain c keyed by ``keys[c]``, call j countered by (step
    low word, slot, j, step high word).  int64 tensors holding 32-bit
    words, on ``keys``' device."""
    n = keys.shape[0]
    k = keys.to(torch.int64) & M32
    s = step.reshape(()).to(torch.int64)
    call = torch.arange(calls, dtype=torch.int64,
                        device=keys.device)[None, :].expand(n, calls)
    shape = (n, calls)
    return philox4x32_10((s & M32).expand(shape),
                         torch.full(shape, int(slot), dtype=torch.int64,
                                    device=keys.device),
                         call, ((s >> 32) & M32).expand(shape),
                         k[:, 0:1], k[:, 1:2])


def batched_normal_keyed_reference(keys, step, slot: int, rows: int,
                                   cols: int):
    """Plain PyTorch version of the keyed entry (module docstring):
    (N, rows, cols) float32 normals, chain c from ``keys[c]``."""
    _check_rows(rows)
    words = keyed_words(keys, step, slot, _calls(rows, cols))
    return _normals_from_words(words, keys.shape[0], rows, cols)


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("noise_kernel").lib
    if lib.mcmc_batched_normal.argtypes is None:  # else pointers are cut
        lib.mcmc_batched_normal.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.mcmc_batched_normal.restype = ctypes.c_int
        lib.mcmc_batched_normal_keyed.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.mcmc_batched_normal_keyed.restype = ctypes.c_int
        lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


@counted("12noise_kernelILb0E")
def batched_normal(seed, n: int, rows: int, cols: int):
    """(n, rows, cols) float32 standard normals (module docstring): the
    seed and sizes checked, then the plain version for a CPU seed, the
    CUDA kernel for a CUDA seed."""
    _check_rows(rows)
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no noise kernel for device {seed.device}")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError(f"seed must be one int64 value, got {seed.dtype} "
                        f"of shape {tuple(seed.shape)}")
    if n * rows * cols >= 2 ** 31:
        raise ValueError(f"{n} x {rows} x {cols} normals: the kernel takes "
                         "fewer than 2^31 per launch")
    if seed.device.type == "cpu":
        return batched_normal_reference(seed, n, rows, cols)
    seed = seed.contiguous()
    out = torch.empty((n, rows, cols), dtype=torch.float32,
                      device=seed.device)
    lib = _cuda_library()
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with torch.cuda.device(seed.device):
        err = lib.mcmc_batched_normal(seed.data_ptr(), out.data_ptr(), n,
                                      rows, cols, stream)
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"noise kernel launch failed: {msg} ({err})")
    batched_normal.launches += 1
    return out


def check_streams(keys, step):
    """Refuse per-chain keys and a step counter the kernels do not take."""
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no per-chain kernel for device {keys.device}")
    if keys.dtype != torch.uint32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise TypeError(f"keys must be (N, 2) uint32, got {keys.dtype} of "
                        f"shape {tuple(keys.shape)}")
    if step.dtype != torch.int64 or step.numel() != 1:
        raise TypeError(f"step must be one int64 value, got {step.dtype} "
                        f"of shape {tuple(step.shape)}")
    if step.device != keys.device:
        raise ValueError(f"step is on {step.device}, keys on {keys.device}")


@counted("12noise_kernelILb1E")
def batched_normal_keyed(keys, step, slot: int, rows: int, cols: int):
    """(N, rows, cols) float32 standard normals, chain c from its own key
    (module docstring): the operands checked, then the plain version for
    CPU keys, the CUDA kernel for CUDA keys."""
    _check_rows(rows)
    check_streams(keys, step)
    n = keys.shape[0]
    if n * rows * cols >= 2 ** 31:
        raise ValueError(f"{n} x {rows} x {cols} normals: the kernel takes "
                         "fewer than 2^31 per launch")
    if not 0 <= int(slot) < 2 ** 31:
        raise ValueError(f"slot {slot} is not a non-negative int32")
    if keys.device.type == "cpu":
        return batched_normal_keyed_reference(keys, step, slot, rows, cols)
    keys, step = keys.contiguous(), step.contiguous()
    out = torch.empty((n, rows, cols), dtype=torch.float32,
                      device=keys.device)
    lib = _cuda_library()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    with torch.cuda.device(keys.device):
        err = lib.mcmc_batched_normal_keyed(
            keys.data_ptr(), step.data_ptr(), out.data_ptr(),
            int(slot), n, rows, cols, stream)
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"keyed noise kernel launch failed: {msg} "
                           f"({err})")
    batched_normal_keyed.launches += 1
    return out
