"""Convergence diagnostics on the traces' device: split R-hat and effective
sample size, classic and rank-normalized.

Counterpart of ``mcmc_tpu/parallel/diagnostics.py``, function for function,
computed with torch in float32 like the JAX functions, so a farm's traces
are summarized where they were made:

- classic split-R-hat and multi-chain ESS (Gelman et al., BDA3) —
  ``split_rhat`` / ``ess``;
- the rank-normalized variants of Vehtari et al. 2021 ("Rank-normalization,
  folding, and localization") — ``rank_normalized_rhat`` (max of the bulk
  and folded statistics), ``ess_bulk``, ``ess_tail``.  Ranks are tie-aware
  AVERAGE ranks (MH traces repeat values on every rejection), read off one
  sort of the pooled values by two searchsorted passes of the sorted values
  over themselves; the median and the tail quantiles come from the same
  sorted rows.

Where the work runs: a tensor stays on its own device unless ``device``
names another; a numpy array or array-like goes to
``utils/rng.resolve_device(device)``, the card unless ``device="cpu"`` is
asked for.  Every public function returns numpy values of the JAX
function's shapes: one device-to-host copy of the final values a call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.rng import resolve_device

# u = (rank - 3/8) / (S + 1/4) clamped inside (0, 1): for S >~ 1e7 pooled
# samples the top rank's u rounds to exactly 1.0 in float32 and
# ndtri(1.0) = +inf would make every R-hat NaN
_U_MIN = float(np.float32(1e-10))
_U_MAX = float(np.float32(1.0) - np.float32(1.2e-7))


def _on(traces, device):
    """``traces`` as a float32 tensor: a tensor on its own device unless
    ``device`` names another, anything else on ``resolve_device(device)``."""
    if isinstance(traces, torch.Tensor):
        dev = traces.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        traces = torch.as_tensor(np.asarray(traces))
    return traces.to(dev, torch.float32)


def _host(t):
    """The result's one device-to-host copy."""
    return t.cpu().numpy()


def _split_rhat(x):
    """Split-R-hat of (n_chains, n_samples, P) -> (P,)."""
    half = x.shape[1] // 2
    x = torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)  # (2m, half, P)
    n = x.shape[1]
    xs = x.movedim(1, -1)                              # samples last
    chain_means = xs.mean(dim=-1)                      # (2m, P)
    chain_vars = xs.var(dim=-1, correction=1)          # (2m, P)
    B = n * chain_means.var(dim=0, correction=1)
    W = chain_vars.mean(dim=0)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / W)


def split_rhat(traces, *, device=None):
    """Split-R-hat over (n_chains, n_samples) or (n_chains, n_samples, P).

    Each chain is split in half, doubling the chain count; R-hat =
    sqrt((W*(n-1)/n + B/n) / W).
    """
    x = _on(traces, device)
    squeeze = x.ndim == 2
    out = _split_rhat(x[..., None] if squeeze else x)
    return _host(out[0] if squeeze else out)


def _autocov_fft(x):
    """Autocovariance along the last axis via FFT (biased, like Stan).

    x: (P, m, n), one probe (the m chains' rows of one parameter) a
    transform: a probes trace holds one probe's 2n-point spectrum and
    the FFT's work area at a time, and each probe's numbers are those it
    has alone."""
    n = x.shape[-1]
    acov = torch.empty_like(x)
    for p in range(x.shape[0]):
        xc = x[p] - x[p].mean(dim=-1, keepdim=True)
        f = torch.fft.rfft(xc, n=2 * n, dim=-1)
        acov[p] = torch.fft.irfft(f * f.conj(), n=2 * n, dim=-1)[:, :n]
        del xc, f
    return acov / n


def _ess(x):
    """Multi-chain ESS of (P, n_chains, n) -> (P,)."""
    P, m, n = x.shape
    if m == 1:
        # single chain: split it in half (same trick as split_rhat) so
        # the between-chain variance term is defined — ddof=1 over one
        # chain mean would otherwise make every ESS NaN
        half = n // 2
        x = torch.cat([x[:, :, :half], x[:, :, half:2 * half]], dim=1)
        P, m, n = x.shape
    acov = _autocov_fft(x)                             # (P, m, n)
    chain_var = acov[..., 0] * (n / (n - 1.0))         # (P, m)
    mean_var = chain_var.mean(dim=-1)                  # (P,)
    var_plus = mean_var * ((n - 1.0) / n) + x.mean(dim=-1).var(
        dim=-1, correction=1)
    rho = 1.0 - (mean_var[:, None] - acov.mean(dim=1)) / var_plus[:, None]
    del acov
    # paired sums rho[2t] + rho[2t+1]
    even = rho[:, 0:n - 1:2]
    odd = rho[:, 1:n:2]
    k = min(even.shape[1], odd.shape[1])
    paired = even[:, :k] + odd[:, :k]
    # truncate at the first negative paired sum (a prefix mask)
    keep = torch.cumprod((paired > 0.0).to(torch.float32), dim=1)
    tau = -1.0 + 2.0 * (paired * keep).sum(dim=1)
    tau = torch.clamp_min(tau, float(np.float32(1.0) / np.log10(
        np.float32(n + 9.0))))
    return m * n / tau


def ess(traces, *, device=None):
    """Effective sample size over (n_chains, n_samples) or (..., P).

    Multi-chain ESS with Geyer's initial sequence truncated at the first
    negative paired autocorrelation sum.
    """
    x = _on(traces, device)
    if x.ndim == 2:
        x = x[..., None]
    return _host(_ess(x.movedim(-1, 0)).squeeze())


def acceptance_rate(steps, *, device=None):
    """Mean acceptance over the trailing axis of a (chains, n_iter) step
    trace."""
    return _host(_on(steps, device).mean(dim=-1))


# ---------------------------------------------------------------------------
# Rank-normalized diagnostics (Vehtari et al. 2021)
# ---------------------------------------------------------------------------


def _normal_scores(srt, order):
    """Rank-normal scores of rows ``flat`` given their sort (``srt``,
    ``order`` = ``torch.sort(flat, dim=-1)``), in ``flat``'s places.

    The average rank of a value is the midpoint of its run of equals in
    the sort: 1-based (left + right + 1) / 2, with left / right the run's
    ends (the JAX function's two searchsorted passes; the searches here
    are of the sorted values, so the scores are made in sorted order and
    put back through ``order`` once).  Then the Blom-offset normal
    quantile z = ndtri((r - 3/8) / (S + 1/4)).
    """
    S = srt.shape[-1]
    narrow = 2 * S + 1 < 2 ** 31                       # left + right + 1
    left = torch.searchsorted(srt, srt, out_int32=narrow)
    left += torch.searchsorted(srt, srt, right=True, out_int32=narrow)
    left += 1
    rank = 0.5 * left.to(torch.float32)                # average rank
    del left
    u = ((rank - 0.375) / (S + 0.25)).clamp_(_U_MIN, _U_MAX)
    del rank
    z = torch.special.ndtri(u)
    del u
    return torch.empty_like(z).scatter_(-1, order, z)


def _rank_normalize(x):
    """Tie-aware rank-normal (z-scale) transform over ALL chains pooled.

    x: (..., m, n) tensor; average fractional ranks, then
    z = ndtri((r - 3/8) / (S + 1/4)), u clamped inside (0, 1).
    """
    shape = x.shape
    srt, order = torch.sort(x.reshape(-1, shape[-2] * shape[-1]), dim=-1)
    return _normal_scores(srt, order).reshape(shape)


def _median(srt):
    """The median of each sorted row: its middle value, or the midpoint of
    its two middle values (``numpy.median`` and ``jnp.median``)."""
    S = srt.shape[-1]
    if S % 2:
        return srt[:, S // 2]
    return (srt[:, S // 2 - 1] + srt[:, S // 2]) * 0.5


def _quantile(srt, q):
    """The ``q`` quantile of each sorted row by ``numpy.quantile``'s
    ``linear`` rule on float32 data: the position (S - 1)·q in float32, the
    two values either side of it interpolated as numpy's ``_lerp`` does."""
    S = srt.shape[-1]
    pos = np.float32(S - 1) * np.float32(q)
    lo = min(int(math.floor(pos)), S - 1)
    hi = min(lo + 1, S - 1)
    t = np.float32(pos - np.float32(lo))
    a, b = srt[:, lo], srt[:, hi]
    diff = b - a
    if t >= 0.5:
        return b - diff * float(np.float32(1.0) - t)
    return a + diff * float(t)


def _as_pmn(traces, *, device=None):
    """(m, n) or (m, n, P) traces -> a float32 (P, m, n) tensor."""
    x = _on(traces, device)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    return x.movedim(-1, 0).contiguous(), squeeze


def rank_normalized_rhat(traces, *, device=None):
    """Rank-normalized split-R-hat: max of the BULK statistic (split-R-hat
    of the rank-normal transform) and the FOLDED statistic (same on
    |x - median|, which detects variance/tail mismatches that mean-based
    R-hat misses).  Vehtari et al. 2021 recommend flagging > 1.01.

    traces: (n_chains, n_samples) or (n_chains, n_samples, P).
    """
    x, squeeze = _as_pmn(traces, device=device)        # (P, m, n)
    srt, order = torch.sort(x.reshape(x.shape[0], -1), dim=-1)
    med = _median(srt)
    z = _normal_scores(srt, order).reshape(x.shape)
    del srt, order
    bulk = _split_rhat(z.movedim(0, -1))
    del z
    z = _rank_normalize(torch.abs(x - med[:, None, None]))
    out = torch.maximum(bulk, _split_rhat(z.movedim(0, -1)))
    return _host(out[0] if squeeze else out)


def ess_bulk(traces, *, device=None):
    """Bulk ESS: multi-chain ESS of the rank-normal transform — how well
    the center of the distribution is resolved (Vehtari et al. 2021)."""
    x, squeeze = _as_pmn(traces, device=device)
    out = _ess(_rank_normalize(x))
    return _host(out[0] if squeeze else out)


def ess_tail(traces, prob: float = 0.05, *, device=None):
    """Tail ESS: min of the ESS of the ``prob`` / ``1 - prob`` quantile
    exceedance indicators — how well the tails are resolved.  Low tail-ESS
    with healthy bulk-ESS means credible-interval endpoints are noisy."""
    x, squeeze = _as_pmn(traces, device=device)        # (P, m, n)
    srt = torch.sort(x.reshape(x.shape[0], -1), dim=-1).values
    qlo = _quantile(srt, prob)
    qhi = _quantile(srt, 1.0 - prob)
    del srt
    ind_lo = (x <= qlo[:, None, None]).to(torch.float32)
    ind_hi = (x >= qhi[:, None, None]).to(torch.float32)
    out = torch.minimum(_ess(ind_lo), _ess(ind_hi))
    return _host(out[0] if squeeze else out)
