"""Masked SPD solves of the SGS chain's packed conditioning system.

PyTorch counterpart of ``masked_cg_solve`` and ``masked_spd_solve`` in
``mcmc_tpu/ops/kriging.py``, batched over a leading chain axis.  Both solve

    (M Sigma M + (I - M) + eps I) w = M rhs,   M = diag(mask)

for per-chain (n, n) ``Sigma``.  The SGS chain does not call them: its
packed solve is the CG of ``ops/cg_kernel.py`` (a CUDA kernel, its plain
version summing in the kernel's order).  These are the JAX package's
general solves, batched.  The simple- and ordinary-kriging solves belong
to ``geostats`` and wait.
"""

from __future__ import annotations

import torch


def _eps_column(eps, like):
    """``eps`` as a float (scalar) or an (..., 1) column of per-chain
    values."""
    if torch.is_tensor(eps) and eps.dim():
        return eps.to(like.dtype)[..., None]
    return float(eps)


def masked_spd_solve(Sigma, mask, rhs, eps):
    """Cholesky solve of the masked system.  Sigma: (..., n, n); mask,
    rhs: (..., n).  Returns w (..., n) with masked slots zeroed."""
    m = mask
    n = Sigma.shape[-1]
    Sm = Sigma * m[..., :, None] * m[..., None, :]
    diag = _eps_column(eps, m) + (1.0 - m)
    Sm = Sm + torch.eye(n, dtype=Sigma.dtype, device=Sigma.device) * diag[
        ..., None, :]
    L = torch.linalg.cholesky(Sm)
    w = torch.cholesky_solve((m * rhs)[..., None], L)[..., 0]
    return w * m


def masked_cg_solve(Sigma, mask, rhs, eps, n_iters: int = 48):
    """Fixed-iteration conjugate gradients on the masked system, from
    x = 0 with the JAX package's 1e-30 guards.  Sigma: (..., n, n); mask,
    rhs: (..., n); eps a float or (...,) per-chain values.  Returns x
    (..., n) (zero at masked slots, where b is zero)."""
    m = mask
    b = m * rhs
    e = _eps_column(eps, m)

    def A(v):
        mv = torch.matmul((m * v)[..., None, :], Sigma)[..., 0, :]
        return m * mv + (1.0 - m) * v + e * v

    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(int(n_iters)):
        Ap = A(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap, dim=-1, keepdim=True),
                                 min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x
