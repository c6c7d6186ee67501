"""The SGS chain's packed conditioning solve, batched over chains: fixed-
iteration conjugate gradients on each chain's masked K x K system

    A = Sigma·m·mᵀ + diag(eps + 1 - m),   b = m·rhs,

run ``n_iters`` iterations from zero (the JAX package's ``_cg_core``, with
its 1e-30 guards), returning ``w·m``.  Two forms, as in the JAX package:

- ``mix_masked_cg``: Sigma built from the static Gaussian+exponential
  mixture of ``SGSStatic.mix`` (``ops/covariance.eval_mixture_static``) at
  the packed cells' window coordinates (iaf, jaf), exact small integers in
  float32:

      Sigma_ij = mixture(h2_ij),  h2_ij = q0·dj² + q1·dj·di + q2·di²,
      di = ia_i - ia_j, dj = ja_i - ja_j;

- ``masked_cg``: a given (N, K, K) Sigma, for a covariance with no mixture
  fit (a spherical variogram), gathered by the caller from the covariance
  stamp.

Three pieces each, as for every kernel of the port:

- ``mix_masked_cg_reference`` / ``masked_cg_reference``: the plain
  PyTorch versions (batched, their sums in the kernel's order, one shared
  iteration ``_cg_kernel_order``);
- ``csrc/cg_kernel.cu``: the hand-written CUDA kernels for Hopper that
  replace the Pallas kernels ``mcmc_tpu/ops/cg_kernel.py::
  lanes_mix_masked_cg`` and ``lanes_masked_cg`` (bodies
  ``_cg_lanes_mix_kernel`` and ``_cg_lanes_kernel``, solver ``_cg_core``);
- ``mix_masked_cg`` / ``masked_cg``: the dispatchers.  A CPU tensor goes
  to the plain version; a CUDA tensor launches the kernel or raises.
  Nothing falls back.  ``.launches`` counts kernel launches.

The plain versions sum in the kernels' order, so they differ only where
the kernel's ``expf`` and PyTorch's ``exp`` round differently.  Against
the JAX package's kernels (XLA or Mosaic sums, another ``exp``) they agree
to float32 roundoff on well-conditioned systems.  The plain versions take
any K; the kernels take every K whose one-chain system fits a CTA's
shared memory on the card (``kernel_max_k``), and the dispatchers refuse
a larger K, naming that limit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .covariance import eval_mixture_static, mixture_families
from .launch_counts import counted

_MAX_TERMS = 16     # per mixture family (the fit's dictionaries have <= 13)


def _f32(x) -> float:
    return float(np.float32(x))


def _eps_vector(eps, N, like):
    """(N,) float32 per-chain jitter on ``like``'s device.  A float is
    filled on the device: a tensor made from it on the host would be a
    synchronous host-to-device copy on every call."""
    if torch.is_tensor(eps):
        return eps.to(device=like.device, dtype=torch.float32).expand(
            N).contiguous()
    return torch.full((N,), float(eps), dtype=torch.float32,
                      device=like.device)


def _kernel_order_sum(v):
    """Row sums of (N, K) in the kernel's order: rows in slots of 32 (slot
    r holds rows 32r .. 32r + 31, zero-padded, at least two slots); per
    slot a butterfly (lane l adds lane l + 16, then + 8, ... + 1); then
    the slots' sums added in rising order."""
    N, K = v.shape
    R = max(2, -(-K // 32))
    w = torch.nn.functional.pad(v, (0, 32 * R - K)).view(N, R, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[:, :, :off] + w[:, :, off:2 * off]
    s = w[:, 0] + w[:, 1]
    for r in range(2, R):
        s = s + w[:, r]
    return s                                      # (N, 1)


def _cg_kernel_order(cols, m, rhs, n_iters: int):
    """``_cg_core`` in the kernels' order: ``cols[:, j]`` (N, K) is column
    j of the system, the matvec sums j in rising order, the dot products
    run as the kernels' warp butterflies, one rounding per operation."""
    N, K = m.shape
    b = m * rhs
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = _kernel_order_sum(r * r)
    for _ in range(int(n_iters)):
        Ap = cols[:, 0] * p[:, 0:1]
        for j in range(1, K):
            Ap = Ap + cols[:, j] * p[:, j:j + 1]
        alpha = rs / torch.clamp(_kernel_order_sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _kernel_order_sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x * m


def _masked_system(Sigma, m, eps):
    """``Sigma·m·mᵀ + diag(eps + 1 - m)`` (the JAX package's
    ``_masked_system``), eps a float or (N,)."""
    A = Sigma * m[:, :, None] * m[:, None, :]
    return A + torch.diag_embed(_eps_vector(eps, m.shape[0], m)[:, None]
                                + (1.0 - m))


def mix_masked_cg_reference(iaf, jaf, mask, rhs, eps, mix, n_iters: int = 64):
    """Plain PyTorch version of the mixture-system CG (module docstring):
    iaf, jaf, mask, rhs (N, K) float32, eps a float or (N,), mix =
    SGSStatic.mix.  Returns w (N, K) with masked slots zeroed.

    At the production configuration the fixed-iteration CG stops far from
    convergence (condition numbers ~1e4), where two orders of the same
    float32 sums drift apart by ~1e-3 of the solution; in the same order
    the plain version and the kernel stay together."""
    q0, q1, q2 = (_f32(q) for q in mix[4])
    dif = iaf[:, :, None] - iaf[:, None, :]
    djf = jaf[:, :, None] - jaf[:, None, :]
    h2 = q0 * djf * djf + q1 * djf * dif + q2 * dif * dif
    A = _masked_system(eval_mixture_static(mix, h2), mask, eps)
    cols = A.transpose(1, 2).contiguous()         # cols[:, j] = A[:, :, j]
    return _cg_kernel_order(cols, mask, rhs, n_iters)


def masked_cg_reference(Sigma, mask, rhs, eps, n_iters: int = 48):
    """Plain PyTorch version of the CG on a given Sigma (module
    docstring): Sigma (N, K, K), mask, rhs (N, K) float32, eps a float or
    (N,).  Returns w (N, K) with masked slots zeroed.  Row j of the masked
    system serves as column j, as in the kernel and in ``_cg_core``
    (Sigma is symmetric)."""
    A = _masked_system(Sigma, mask, eps).contiguous()  # A[:, j] = row j
    return _cg_kernel_order(A, mask, rhs, n_iters)


class _Family(ctypes.Structure):
    """One mixture family, as ``MixFamily`` in ``csrc/cg_kernel.cu``."""

    _fields_ = [("in_h", ctypes.c_int), ("dyadic", ctypes.c_int),
                ("nb0", ctypes.c_float), ("n", ctypes.c_int),
                ("k", ctypes.c_int * _MAX_TERMS),
                ("nrate", ctypes.c_float * _MAX_TERMS),
                ("amp", ctypes.c_float * _MAX_TERMS)]


class _Mix(ctypes.Structure):
    """The mixture, as ``MixParams`` in ``csrc/cg_kernel.cu``."""

    _fields_ = [("n_fam", ctypes.c_int), ("fam", _Family * 2),
                ("q", ctypes.c_float * 3)]


def mix_params(mix) -> _Mix:
    """The kernel's by-value mixture parameters: per family the base rate
    and the (k, amplitude) pairs by rising k (dyadic), or the (rate,
    amplitude) pairs in order (non-dyadic), exactly as
    ``eval_mixture_static`` takes them."""
    p = _Mix()
    fams = mixture_families(mix)
    p.n_fam = len(fams)
    for f, (in_h, b0, terms) in enumerate(fams):
        if len(terms) > _MAX_TERMS:
            raise ValueError(f"a mixture family has {len(terms)} terms; the "
                             f"kernel takes at most {_MAX_TERMS}")
        fam = p.fam[f]
        fam.in_h = int(in_h)
        fam.dyadic = int(b0 is not None)
        fam.nb0 = _f32(-b0) if b0 is not None else 0.0
        fam.n = len(terms)
        for t, (kb, a) in enumerate(terms):
            if b0 is not None:
                fam.k[t] = kb
            else:
                fam.nrate[t] = _f32(-kb)
            fam.amp[t] = _f32(a)
    for i in range(3):
        p.q[i] = _f32(mix[4][i])
    return p


def bind_library(lib):
    """Type the C entry points of a loaded ``cg_kernel`` library (this
    one, or another checkout's in ``ab_cg_kernels.py``); untyped, ctypes
    cuts the pointers."""
    lib.mcmc_mix_masked_cg.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(_Mix)]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.mcmc_mix_masked_cg.restype = ctypes.c_int
    lib.mcmc_masked_cg.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.mcmc_masked_cg.restype = ctypes.c_int
    lib.mcmc_cg_max_k.argtypes = [ctypes.c_void_p]
    lib.mcmc_cg_max_k.restype = ctypes.c_int
    lib.mcmc_cg_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.mcmc_cg_info.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("cg_kernel").lib
    if lib.mcmc_mix_masked_cg.argtypes is None:
        bind_library(lib)
    return lib


def _raise_on(err, what):
    if err != 0:
        msg = _cuda_library().mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"CG kernel {what} failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def _max_k(device_index: int) -> int:
    lib = _cuda_library()
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        _raise_on(lib.mcmc_cg_max_k(ctypes.addressof(out)), "query")
    return out.value


def kernel_max_k(device=None) -> int:
    """The largest K the CUDA kernels take on ``device`` (the current
    card by default): one chain's K x K system, its rows padded to a
    multiple of 4, in one CTA's opt-in shared memory (the limit is
    computed beside the kernels, ``csrc/cg_kernel.cu::card_limits``)."""
    dev = torch.device("cuda" if device is None else device)
    return _max_k(torch.cuda.current_device() if dev.index is None
                  else dev.index)


def cg_kernel_info(K: int, mix: bool = True, device=None) -> dict:
    """The launch of the mixture (``mix``) or given-Sigma CG kernel at
    ``K`` as the CUDA runtime reports it on the card: threads and chains
    a CTA, dynamic and static shared bytes, registers and local (spill)
    bytes a thread, resident CTAs and warps a multiprocessor."""
    lib = _cuda_library()
    out = (ctypes.c_int * 7)()
    dev = torch.device("cuda" if device is None else device)
    with torch.cuda.device(dev):
        _raise_on(lib.mcmc_cg_info(int(mix), int(K), ctypes.addressof(out)),
                  "query")
    info = dict(zip(("threads", "chains_per_cta", "dynamic_shared_bytes",
                     "static_shared_bytes", "registers", "local_bytes",
                     "resident_ctas_per_sm"), list(out)))
    info["resident_warps_per_sm"] = (info["resident_ctas_per_sm"]
                                     * info["threads"] // 32)
    return info


def _check_operands(mask, named, shapes):
    """The kernels' operand rules, held on both devices: a CPU or CUDA
    device, every tensor float32, contiguous, on mask's device, of its
    expected shape; on the card, K within the kernels' limit."""
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no CG kernel for device {mask.device}")
    for (name, t), shape in zip(named, shapes):
        if t.device != mask.device:
            raise ValueError(f"{name} is on {t.device}, mask on "
                             f"{mask.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K = mask.shape[1]
    if mask.device.type == "cuda" and K > kernel_max_k(mask.device):
        raise ValueError(
            f"the CG kernels take K <= {kernel_max_k(mask.device)} packed "
            f"conditioning cells on this card (one chain's K x K float32 "
            f"system in one CTA's shared memory); got K = {K}")


def _launch(fn, mask, pointers, params):
    """Allocate w, launch ``fn(*pointers, w, *params, stream)`` on the
    current stream, raise on a refused launch."""
    N, K = mask.shape
    out = torch.empty((N, K), dtype=torch.float32, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    with torch.cuda.device(mask.device):
        err = fn(*pointers, out.data_ptr(), *params, stream)
    _raise_on(err, "launch")
    return out


@counted("13mix_cg_kernel")
def mix_masked_cg(iaf, jaf, mask, rhs, eps, mix, n_iters: int = 64):
    """Mixture-system CG (module docstring): the operands checked, then
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if len(mix) != 5 or not (mix[0] or mix[2]):
        raise ValueError("mix_masked_cg needs a non-empty mixture "
                         "(SGSStatic.mix)")
    N, K = mask.shape
    _check_operands(mask, (("iaf", iaf), ("jaf", jaf), ("mask", mask),
                           ("rhs", rhs)), [(N, K)] * 4)
    if mask.device.type == "cpu":
        return mix_masked_cg_reference(iaf, jaf, mask, rhs, eps, mix,
                                       n_iters)
    eps_v = _eps_vector(eps, N, mask)
    params = mix_params(mix)
    lib = _cuda_library()
    out = _launch(lib.mcmc_mix_masked_cg, mask,
                  [t.data_ptr() for t in (iaf, jaf, mask, rhs, eps_v)],
                  (ctypes.byref(params), N, K, int(n_iters)))
    mix_masked_cg.launches += 1
    return out


@counted("16masked_cg_kernel")
def masked_cg(Sigma, mask, rhs, eps, n_iters: int = 48):
    """CG on a given Sigma (module docstring): the operands checked, then
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    N, K = mask.shape
    _check_operands(mask, (("Sigma", Sigma), ("mask", mask), ("rhs", rhs)),
                    [(N, K, K), (N, K), (N, K)])
    if mask.device.type == "cpu":
        return masked_cg_reference(Sigma, mask, rhs, eps, n_iters)
    eps_v = _eps_vector(eps, N, mask)
    lib = _cuda_library()
    out = _launch(lib.mcmc_masked_cg, mask,
                  [t.data_ptr() for t in (Sigma, mask, rhs, eps_v)],
                  (N, K, int(n_iters)))
    masked_cg.launches += 1
    return out
