"""Kriging solves, and the masked SPD solves of the SGS chain's packed
conditioning system.

PyTorch counterpart of ``mcmc_tpu/ops/kriging.py`` (the reference's
per-cell solvers, gstatsim_custom/_krige.py:5-81), every function batched
over leading axes where the JAX package ``vmap``s a single system.
Neighbour sets have a fixed size K with a validity mask: invalid slots get
identity rows and columns and zero cross-covariance, so they take zero
weight and leave the valid subsystem's solution as it is.

- ``sk_solve_masked`` / ``ok_solve_masked`` (and their ``_batch``
  aliases): simple and ordinary kriging estimate and variance; the
  ordinary system is a bordered saddle-point system, solved by LU
  (``torch.linalg.solve_ex``: as in the JAX package, no singularity
  check, which would wait for the device).  ``sk_weights_masked`` /
  ``ok_weights_masked``: the weights, for reuse.
- ``conditional_gaussian_block``: the exact joint conditional Gaussian
  draw of a block of cells, the caller's standard normals given.
- ``masked_spd_solve`` / ``masked_cg_solve``: both solve

    (M Sigma M + (I - M) + eps I) w = M rhs,   M = diag(mask)

for per-chain (n, n) ``Sigma``.  The SGS chain does not call them: its
packed solve is the CG of ``ops/cg_kernel.py`` (a CUDA kernel, its plain
version summing in the kernel's order).  These are the JAX package's
general solves, batched.

Everything computes in float32, as the JAX package does without x64.
"""

from __future__ import annotations

import torch

from .covariance import (CovarianceSpec, _f32, _pair_norm, covariance_norm,
                         rotate)


def _masked_system(spec: CovarianceSpec, coords, mask, target_xy,
                   rotation_matrix, sill, nugget, jitter=0.0):
    """Sigma (..., k, k) and rho (..., k) with invalid slots neutralized,
    ``jitter`` on Sigma's diagonal: one covariance matrix over the k
    points and the target.  (Adding the jitter with the identity rows
    rounds as adding it after them does: the diagonal gets sigma + 0 +
    jitter or 0 + 1 + jitter, each sum exact but the last.)"""
    k = coords.shape[-2]
    t = rotate(torch.cat([coords, target_xy[..., None, :]], dim=-2),
               rotation_matrix)
    full = covariance_norm(spec, _pair_norm(t, t), sill, nugget)
    sigma, rho = full[..., :k, :k], full[..., :k, k]
    m = mask.to(sigma.dtype)
    eye = torch.eye(k, dtype=sigma.dtype, device=sigma.device)
    sigma = sigma * (m[..., :, None] * m[..., None, :]) + eye * (
        (1.0 - m) + jitter)[..., None, :]
    return sigma, rho * m


def _sk_weights(spec, target_xy, coords, mask, rotation_matrix, sill,
                nugget, jitter):
    sigma, rho = _masked_system(spec, coords, mask, target_xy,
                                rotation_matrix, sill, nugget, jitter)
    w = torch.linalg.solve_ex(sigma, rho[..., None])[0][..., 0]
    return w, rho, _f32(sill) - torch.sum(w * rho, dim=-1)


def _ok_weights(spec, target_xy, coords, mask, rotation_matrix, sill,
                nugget, jitter):
    """The bordered system's solution w (..., k + 1), rho and the
    variance; with no valid slot the border's corner is 1 and its
    right-hand side 0, so the system stays nonsingular."""
    sigma, rho = _masked_system(spec, coords, mask, target_xy,
                                rotation_matrix, sill, nugget, jitter)
    m = mask.to(sigma.dtype)
    k = m.shape[-1]
    has = (torch.sum(m, dim=-1) > 0).to(sigma.dtype)
    A = sigma.new_zeros(sigma.shape[:-2] + (k + 1, k + 1))
    A[..., :k, :k] = sigma
    A[..., k, :k] = m
    A[..., :k, k] = m
    A[..., k, k] = 1.0 - has
    b = torch.cat([rho, has[..., None]], dim=-1)
    w = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    return w, rho, _f32(sill) - torch.sum(w[..., :k] * rho, dim=-1)


def sk_solve_masked(spec: CovarianceSpec, target_xy, coords, values, mask,
                    rotation_matrix, sill, nugget, global_mean,
                    jitter=1e-6):
    """Simple kriging with masked fixed-size neighbours: target_xy
    (..., 2), coords (..., k, 2), values and mask (..., k).  Returns
    (est, var), each (...)."""
    w, _, var = _sk_weights(spec, target_xy, coords, mask, rotation_matrix,
                            sill, nugget, jitter)
    gm = _f32(global_mean)
    est = gm + torch.sum(w * mask.to(w.dtype) * (values - gm), dim=-1)
    return est, var


def ok_solve_masked(spec: CovarianceSpec, target_xy, coords, values, mask,
                    rotation_matrix, sill, nugget, jitter=1e-6):
    """Ordinary kriging with masked fixed-size neighbours, the Lagrange
    row carrying 1 only for valid slots; the estimate in the reference's
    local-mean form (_krige.ok_solve).  Returns (est, var)."""
    w, _, var = _ok_weights(spec, target_xy, coords, mask, rotation_matrix,
                            sill, nugget, jitter)
    m = mask.to(w.dtype)
    k = m.shape[-1]
    local_mean = (torch.sum(values * m, dim=-1)
                  / torch.clamp(torch.sum(m, dim=-1), min=1.0))
    est = local_mean + torch.sum(w[..., :k] * m
                                 * (values - local_mean[..., None]), dim=-1)
    return est, var


# the JAX package's vmapped forms: the functions above are batched already
sk_solve_batch = sk_solve_masked
ok_solve_batch = ok_solve_masked


def conditional_gaussian_block(spec: CovarianceSpec, block_xy, cond_xy,
                               cond_values, cond_mask, rotation_matrix,
                               sill, nugget, global_mean, noise,
                               jitter=1e-4):
    """Exact joint conditional Gaussian draw for a block of cells:

        x_B | x_C  ~  N( mu + S_BC S_CC^{-1} (x_C - mu),
                         S_BB - S_BC S_CC^{-1} S_CB )

    by Cholesky of the conditional covariance (reference README.md:21-23).
    block_xy (..., nb, 2); cond_xy / cond_values / cond_mask (..., nc, 2)
    / (..., nc) / (..., nc); noise (..., nb) standard normals.  The jitter
    scales with max(sill, 1).  Returns (draw, mean, the conditional
    covariance's diagonal), each (..., nb)."""
    tb = rotate(block_xy, rotation_matrix)
    tc = rotate(cond_xy, rotation_matrix)

    def cov(a, b):
        return covariance_norm(spec, _pair_norm(a, b), sill, nugget)

    m = cond_mask.to(tb.dtype)
    jitter = _f32(jitter * max(float(sill), 1.0))
    nc, nb = tc.shape[-2], tb.shape[-2]
    eye_c = torch.eye(nc, dtype=tb.dtype, device=tb.device)
    eye_b = torch.eye(nb, dtype=tb.dtype, device=tb.device)
    S_cc = (cov(tc, tc) * (m[..., :, None] * m[..., None, :])
            + eye_c * (1.0 - m)[..., None, :])
    S_cc = S_cc + jitter * eye_c
    S_bc = cov(tb, tc) * m[..., None, :]
    S_bb = cov(tb, tb) + (_f32(nugget) + jitter) * eye_b
    L_cc = torch.linalg.cholesky(S_cc)
    A = torch.cholesky_solve(S_bc.transpose(-1, -2), L_cc)       # (nc, nb)
    gm = _f32(global_mean)
    r = torch.cholesky_solve((m * (cond_values - gm))[..., None], L_cc)
    mean = gm + torch.matmul(S_bc, r)[..., 0]
    S_cond = S_bb - torch.matmul(S_bc, A)
    S_cond = 0.5 * (S_cond + S_cond.transpose(-1, -2)) + jitter * eye_b
    L = torch.linalg.cholesky(S_cond)
    draw = mean + torch.matmul(L, noise[..., None])[..., 0]
    return draw, mean, torch.diagonal(S_cond, dim1=-2, dim2=-1)


def sk_weights_masked(spec: CovarianceSpec, target_xy, coords, mask,
                      rotation_matrix, sill, nugget, jitter=1e-6):
    """Simple-kriging weights for reuse (the reference's
    ``precompute=True`` mode, _krige.py:77-78).  Returns (weights
    (..., k), var)."""
    w, _, var = _sk_weights(spec, target_xy, coords, mask, rotation_matrix,
                            sill, nugget, jitter)
    return w, var


def ok_weights_masked(spec: CovarianceSpec, target_xy, coords, mask,
                      rotation_matrix, sill, nugget, jitter=1e-6):
    """Ordinary-kriging weights for reuse (reference _krige.py:40-41):
    (weights (..., k) including masked slots, var); the Lagrange
    multiplier is dropped like the reference."""
    w, _, var = _ok_weights(spec, target_xy, coords, mask, rotation_matrix,
                            sill, nugget, jitter)
    return w[..., :-1], var


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
