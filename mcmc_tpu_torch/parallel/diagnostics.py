"""Convergence diagnostics on host numpy: split R-hat and effective sample
size, classic and rank-normalized.

Counterpart of ``mcmc_tpu/parallel/diagnostics.py``, computed in float32
like the JAX functions so the two agree to float32 rounding:

- classic split-R-hat and multi-chain ESS (Gelman et al., BDA3);
- the rank-normalized variants of Vehtari et al. 2021: ``rank_normalized_
  rhat`` (max of the bulk and folded statistics), ``ess_bulk`` and
  ``ess_tail``.  Ranks are tie-aware averages (MH traces repeat values on
  every rejection).
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri

_F32 = np.float32


def split_rhat(traces):
    """Split-R-hat over (n_chains, n_samples) or (n_chains, n_samples, P).

    Each chain is split in half, doubling the chain count; R-hat =
    sqrt((W*(n-1)/n + B/n) / W).
    """
    x = np.asarray(traces, _F32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    n = x.shape[1]
    # the samples on the last, contiguous axis: summed pairwise (``ess``)
    xs = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    chain_means = xs.mean(axis=-1)
    chain_vars = xs.var(axis=-1, ddof=1)
    B = n * chain_means.var(axis=0, ddof=1)
    W = chain_vars.mean(axis=0)
    var_plus = _F32((n - 1) / n) * W + B / _F32(n)
    out = np.sqrt(var_plus / W)
    return out[0] if squeeze else out


def _autocov_fft(x):
    """Biased autocovariance along the last axis via FFT (like Stan)."""
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    f = np.fft.rfft(xc, n=2 * n, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), n=2 * n, axis=-1)[..., :n].real
    return (acov / n).astype(_F32)


def ess(traces):
    """Effective sample size over (n_chains, n_samples) or (..., P):
    multi-chain ESS with Geyer's initial sequence truncated at the first
    negative paired autocorrelation sum."""
    x = np.asarray(traces, _F32)
    if x.ndim == 2:
        x = x[..., None]
    # (P, m, n), contiguous: numpy sums a float32 axis pairwise only when
    # it is contiguous, and a plain running sum over ~300 values near -150
    # is 1e-3 off, enough to move the ESS by 3e-4
    x = np.ascontiguousarray(np.moveaxis(x, -1, 0))
    P, m, n = x.shape
    if m == 1:
        half = n // 2
        x = np.concatenate([x[:, :, :half], x[:, :, half:2 * half]], axis=1)
        P, m, n = x.shape
    acov = _autocov_fft(x)
    chain_var = acov[..., 0] * _F32(n / (n - 1.0))
    mean_var = chain_var.mean(axis=-1)
    var_plus = mean_var * _F32((n - 1.0) / n) + x.mean(axis=-1).var(
        axis=-1, ddof=1)
    rho = 1.0 - (mean_var[:, None] - acov.mean(axis=1)) / var_plus[:, None]
    even = rho[:, 0:n - 1:2]
    odd = rho[:, 1:n:2]
    k = min(even.shape[1], odd.shape[1])
    paired = even[:, :k] + odd[:, :k]
    keep = np.cumprod((paired > 0.0).astype(_F32), axis=1)
    tau = -1.0 + 2.0 * (paired * keep).sum(axis=1)
    tau = np.maximum(tau, _F32(1.0 / np.log10(_F32(n + 9.0))))
    return (m * n / tau).astype(_F32).squeeze()


def acceptance_rate(steps):
    """Mean acceptance over the trailing axis of a (chains, n_iter) trace."""
    return np.asarray(steps, _F32).mean(axis=-1)


def _rank_normalize(x):
    """Tie-aware rank-normal (z-scale) transform over all chains pooled:
    average fractional ranks, then z = ndtri((r - 3/8) / (S + 1/4)), with u
    clamped inside (0, 1) so the top rank of a large pool stays finite."""
    shape = x.shape
    flat = x.reshape(shape[:-2] + (-1,)).reshape(-1, shape[-2] * shape[-1])
    S = flat.shape[-1]
    rank = np.empty(flat.shape, np.float64)
    for i, row in enumerate(flat):
        srt = np.sort(row)
        left = np.searchsorted(srt, row, side="left")
        right = np.searchsorted(srt, row, side="right")
        rank[i] = 0.5 * (left + right + 1)
    u = ((rank - 0.375) / (S + 0.25)).astype(_F32)
    u = np.clip(u, _F32(1e-10), _F32(1.0) - _F32(1.2e-7))
    return ndtri(u).astype(_F32).reshape(shape)


def _as_pmn(traces):
    """(m, n) or (m, n, P) traces -> (P, m, n)."""
    x = np.asarray(traces, _F32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    return np.ascontiguousarray(np.moveaxis(x, -1, 0)), squeeze


def rank_normalized_rhat(traces):
    """Rank-normalized split-R-hat: max of the bulk statistic and the
    folded one (on |x - median|).  Vehtari et al. 2021 flag > 1.01."""
    x, squeeze = _as_pmn(traces)
    z_bulk = _rank_normalize(x)
    med = np.median(x.reshape(x.shape[0], -1), axis=-1).astype(_F32)
    z_fold = _rank_normalize(np.abs(x - med[:, None, None]))
    out = np.maximum(np.atleast_1d(split_rhat(np.moveaxis(z_bulk, 0, -1))),
                     np.atleast_1d(split_rhat(np.moveaxis(z_fold, 0, -1))))
    return out[0] if squeeze else out


def ess_bulk(traces):
    """Bulk ESS: multi-chain ESS of the rank-normal transform."""
    x, squeeze = _as_pmn(traces)
    out = np.atleast_1d(ess(np.moveaxis(_rank_normalize(x), 0, -1)))
    return out[0] if squeeze else out


def ess_tail(traces, prob: float = 0.05):
    """Tail ESS: min of the ESS of the ``prob`` / ``1 - prob`` quantile
    exceedance indicators."""
    x, squeeze = _as_pmn(traces)
    flat = x.reshape(x.shape[0], -1)
    qlo = np.quantile(flat, prob, axis=-1).astype(_F32)
    qhi = np.quantile(flat, 1.0 - prob, axis=-1).astype(_F32)
    ind_lo = (x <= qlo[:, None, None]).astype(_F32)
    ind_hi = (x >= qhi[:, None, None]).astype(_F32)
    e_lo = np.atleast_1d(ess(np.moveaxis(ind_lo, 0, -1)))
    e_hi = np.atleast_1d(ess(np.moveaxis(ind_hi, 0, -1)))
    out = np.minimum(e_lo, e_hi)
    return out[0] if squeeze else out
