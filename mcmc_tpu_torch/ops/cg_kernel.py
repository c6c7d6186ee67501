"""The SGS chain's packed conditioning solve with its system built from the
covariance mixture, batched over chains.

For each chain the K packed conditioning cells sit at window coordinates
(iaf, jaf) (exact small integers in float32).  The solve builds

    A = S·m·mᵀ + diag(eps + 1 - m),   S_ij = mixture(h2_ij),
    h2_ij = q0·dj² + q1·dj·di + q2·di²,  di = ia_i - ia_j, dj = ja_i - ja_j

with the static Gaussian+exponential mixture of ``SGSStatic.mix``
(``ops/covariance.eval_mixture_static``), then runs ``n_iters`` fixed
conjugate-gradient iterations from zero on ``b = m·rhs`` (the JAX
package's ``_cg_core``, with its 1e-30 guards) and returns ``w·m``.

Three pieces, as for every kernel of the port:

- ``mix_masked_cg_reference``: the plain PyTorch version (batched, its
  sums in the kernel's order);
- ``csrc/cg_kernel.cu``: the hand-written CUDA kernel for Hopper that
  replaces the Pallas kernel ``mcmc_tpu/ops/cg_kernel.py::
  lanes_mix_masked_cg`` (its body ``_cg_lanes_mix_kernel`` and
  ``_cg_core``);
- ``mix_masked_cg``: the dispatcher.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises.  Nothing falls
  back.  ``mix_masked_cg.launches`` counts kernel launches.

The plain version sums in the kernel's order, so the two differ only where
the kernel's ``expf`` and PyTorch's ``exp`` round differently.  Against
the JAX package's kernel (XLA or Mosaic sums, another ``exp``) they agree
to float32 roundoff on well-conditioned systems.  The kernel takes K <= 64
(one CTA of 64 threads per chain) and rejects larger K.
The same CG on a given (N, K, K) Sigma (``lanes_masked_cg``, the
stamp-gather fallback) is not ported yet.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .covariance import eval_mixture_static, mixture_families

MAX_K = 64          # one CTA of 64 threads per chain
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
    """Row sums of (N, K <= 64) in the kernel's order: per 32-lane warp a
    butterfly (lane l adds lane l + 16, then + 8, ... + 1), then warp 0's
    sum plus warp 1's."""
    N, K = v.shape
    w = torch.nn.functional.pad(v, (0, MAX_K - K)).view(N, 2, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[:, :, :off] + w[:, :, off:2 * off]
    return w[:, 0] + w[:, 1]                      # (N, 1)


def mix_masked_cg_reference(iaf, jaf, mask, rhs, eps, mix, n_iters: int = 64):
    """Plain PyTorch version (module docstring): iaf, jaf, mask, rhs (N, K)
    float32, eps a float or (N,), mix = SGSStatic.mix.  Returns w (N, K)
    with masked slots zeroed.

    Every sum runs in the kernel's order (the matvec over j rising, the
    dot products as the kernel's warp butterflies), one rounding per
    operation.  At the production configuration the fixed-iteration CG
    stops far from convergence (condition numbers ~1e4), where two orders
    of the same float32 sums drift apart by ~1e-3 of the solution; in the
    same order the plain version and the kernel stay together."""
    N, K = mask.shape
    if K > MAX_K:
        raise ValueError(f"K = {K} packed cells; at most {MAX_K}")
    q0, q1, q2 = (_f32(q) for q in mix[4])
    dif = iaf[:, :, None] - iaf[:, None, :]
    djf = jaf[:, :, None] - jaf[:, None, :]
    h2 = q0 * djf * djf + q1 * djf * dif + q2 * dif * dif
    S = eval_mixture_static(mix, h2)
    m = mask
    A = S * m[:, :, None] * m[:, None, :]
    A = A + torch.diag_embed(_eps_vector(eps, N, m)[:, None] + (1.0 - m))
    cols = A.transpose(1, 2).contiguous()         # cols[:, j] = A[:, :, j]
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


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("cg_kernel").lib
    if lib.mcmc_mix_masked_cg.argtypes is None:  # else pointers are cut
        lib.mcmc_mix_masked_cg.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.POINTER(_Mix)]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.mcmc_mix_masked_cg.restype = ctypes.c_int
        lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def mix_masked_cg(iaf, jaf, mask, rhs, eps, mix, n_iters: int = 64):
    """Mixture-system CG (module docstring): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if mask.device.type == "cpu":
        return mix_masked_cg_reference(iaf, jaf, mask, rhs, eps, mix,
                                       n_iters)
    if mask.device.type != "cuda":
        raise ValueError(f"no CG kernel for device {mask.device}")
    if len(mix) != 5 or not (mix[0] or mix[2]):
        raise ValueError("mix_masked_cg needs a non-empty mixture "
                         "(SGSStatic.mix)")
    N, K = mask.shape
    if K > MAX_K:
        raise ValueError(f"the CG kernel takes K <= {MAX_K} packed "
                         f"conditioning cells (one CTA of {MAX_K} threads "
                         f"per chain); got K = {K}")
    for name, t in (("iaf", iaf), ("jaf", jaf), ("mask", mask),
                    ("rhs", rhs)):
        if t.device != mask.device:
            raise ValueError(f"{name} is on {t.device}, mask on "
                             f"{mask.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (N, K):
            raise ValueError(f"{name} must have shape {(N, K)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    eps_v = _eps_vector(eps, N, mask)
    params = mix_params(mix)
    lib = _cuda_library()
    out = torch.empty((N, K), dtype=torch.float32, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    with torch.cuda.device(mask.device):
        err = lib.mcmc_mix_masked_cg(
            iaf.data_ptr(), jaf.data_ptr(), mask.data_ptr(), rhs.data_ptr(),
            eps_v.data_ptr(), out.data_ptr(), ctypes.byref(params), N, K,
            int(n_iters), stream)
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"CG kernel launch failed: {msg} ({err})")
    mix_masked_cg.launches += 1
    return out


mix_masked_cg.launches = 0
