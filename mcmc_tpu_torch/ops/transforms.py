"""Normal-score (Gaussian quantile) transform of the SGS chain.

PyTorch counterpart of ``mcmc_tpu/ops/transforms.py``.  The reference uses
sklearn's QuantileTransformer (gstatsim_custom/utilities.py:7-26) and
re-transforms the full grid every iteration (MCMC.py:1766-1769).  Here the
quantile tables are fitted on the host with sklearn's rule and applied:

- on the host, exactly, by ``NormalScoreTransform.transform_np`` /
  ``inverse_np`` (numpy/SciPy; the chain's build and its initial z-plane);
- on tensors, in float32 as the JAX package's device transform, by
  ``NormalScoreTransform.transform`` / ``inverse`` (``torch.special``'s
  ``ndtri`` / ``ndtr`` and ``jnp.interp``'s interpolation; the variogram
  fit transforms its data this way);
- on the hot path, by ``NormalScoreLUT``: the transform resampled onto a
  uniform grid, so a lookup is index arithmetic plus one pair read.  Its
  inverse lookup over a step's windows is the CUDA kernel of
  ``ops/lut_kernel.py``; ``NormalScoreLUT.lookup`` is its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.rng import resolve_device

_BOUNDS_THRESHOLD = 1e-7


@dataclasses.dataclass
class NormalScoreTransform:
    """Fitted Gaussian quantile transform (host numpy tables)."""

    quantiles: np.ndarray   # (n_q,), ascending
    references: np.ndarray  # (n_q,), linspace(0, 1, n_q)

    @classmethod
    def fit(cls, data, n_quantiles: int = 500, subsample=None,
            random_state=None):
        """Fit on 1D data (NaNs ignored), matching sklearn's fitting rule."""
        x = np.asarray(data, dtype=np.float64).ravel()
        x = x[~np.isnan(x)]
        if subsample is not None and x.size > subsample:
            rng = np.random.default_rng(random_state)
            idx = rng.choice(x.size, size=int(subsample), replace=False)
            x = x[idx]
        n_q = int(min(n_quantiles, x.size))
        references = np.linspace(0.0, 1.0, n_q, endpoint=True)
        quantiles = np.nanpercentile(x, references * 100.0)
        quantiles = np.maximum.accumulate(quantiles)  # enforce monotonicity
        return cls(quantiles=quantiles.astype(np.float64),
                   references=references)

    def _tables(self, device):
        return (torch.as_tensor(self.quantiles, dtype=torch.float32,
                                device=device),
                torch.as_tensor(self.references, dtype=torch.float32,
                                device=device))

    def transform(self, x):
        """Data values -> standard-normal scores, elementwise on a float32
        tensor (array-likes become CPU tensors), on its device."""
        x = torch.as_tensor(x).to(torch.float32)
        q, r = self._tables(x.device)
        fwd = _interp(x, q, r)
        bwd = -_interp(-x, -q.flip(0), -r.flip(0))
        p = 0.5 * (fwd + bwd)
        p = torch.where(x == q[-1], 1.0, p)
        p = torch.where(x == q[0], 0.0, p)
        lo, hi = _score_bounds()
        out = torch.clamp(torch.special.ndtri(p), lo, hi)
        return torch.where(torch.isnan(x), x, out)

    def inverse(self, z):
        """Standard-normal scores -> data values, elementwise on a float32
        tensor (array-likes become CPU tensors), on its device."""
        z = torch.as_tensor(z).to(torch.float32)
        q, r = self._tables(z.device)
        p = torch.special.ndtr(z)
        out = _interp(p, r, q)
        out = torch.where(p == 0.0, q[0], out)
        out = torch.where(p == 1.0, q[-1], out)
        return torch.where(torch.isnan(z), z, out)

    def transform_np(self, x):
        """Data values -> standard-normal scores (float64, host)."""
        from scipy.special import ndtri

        q = np.asarray(self.quantiles, np.float64)
        r = np.asarray(self.references, np.float64)
        xj = np.asarray(x, np.float64)
        fwd = np.interp(xj, q, r)
        bwd = -np.interp(-xj, -q[::-1], -r[::-1])
        p = 0.5 * (fwd + bwd)
        p = np.where(xj == q[-1], 1.0, p)
        p = np.where(xj == q[0], 0.0, p)
        with np.errstate(invalid="ignore"):
            out = ndtri(p)
        clip_min = ndtri(_BOUNDS_THRESHOLD - np.spacing(1))
        clip_max = ndtri(1.0 - (_BOUNDS_THRESHOLD - np.spacing(1)))
        out = np.clip(out, clip_min, clip_max)
        return np.where(np.isnan(xj), np.nan, out)

    def inverse_np(self, z):
        """Standard-normal scores -> data values (float64, host)."""
        from scipy.special import ndtr

        q = np.asarray(self.quantiles, np.float64)
        r = np.asarray(self.references, np.float64)
        zj = np.asarray(z, np.float64)
        p = ndtr(zj)
        out = np.interp(p, r, q)
        out = np.where(p == 0.0, q[0], out)
        out = np.where(p == 1.0, q[-1], out)
        return np.where(np.isnan(zj), np.nan, out)


def _score_bounds():
    """The scores' clip (sklearn's 1e-7 tails) as float32 values: the
    float64 ``ndtri`` of each tail rounded once, which is what the JAX
    package's float32 transform clips to (float32 cannot hold 1 - 1e-7,
    so a float32 ``ndtri`` of it would clip at 5.1666 rather than
    5.1993)."""
    from scipy.special import ndtri

    t = _BOUNDS_THRESHOLD - np.spacing(1)
    return (float(np.float32(ndtri(t))), float(np.float32(ndtri(1.0 - t))))


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` in float32 with its formula: the segment
    from a right-sided search, a step narrower than the float32 spacing
    of eps taken as flat, and the ends held at fp[0] and fp[-1]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    f0, x0 = fp[i - 1], xp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    flat = torch.abs(dx) <= eps
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, 1.0, dx))
                    * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def lut_clip_bound(n: int) -> float:
    """The upper clip of a table position, ``n - 1.000001`` rounded to
    float32 as the JAX package's weakly typed scalar is: 4095.0 for
    n = 4096, so the lookup does reach the last row."""
    return float(np.float32(n - 1.000001))


def lut_lookup(x, lo: float, scale: float, table):
    """Uniform-grid LUT interpolation (the JAX package's
    ``NormalScoreLUT._lookup``): ``t = clip((x - lo)·scale, 0, n -
    1.000001)``, ``i = floor(t)``, ``f = t - i``, ``y = T[i,0]·(1 - f) +
    T[i,1]·f``, NaN in gives NaN out.  Each operation is one float32
    rounding, as the CUDA kernel computes it."""
    t = torch.clamp((x - lo) * scale, 0.0, lut_clip_bound(table.shape[0]))
    i = torch.floor(t)
    f = t - i
    pair = table[torch.nan_to_num(i, nan=0.0).long()]   # (..., 2)
    y = pair[..., 0] * (1.0 - f) + pair[..., 1] * f
    return torch.where(torch.isnan(x), x, y)


@dataclasses.dataclass
class NormalScoreLUT:
    """Uniform-grid lookup tables of a fitted transform: rows (v_i,
    v_{i+1}) of an (n, 2) float32 table over [lo, lo + (n-1)/scale].  The
    scalars are Python floats holding float32 values."""

    fwd_lo: float
    fwd_scale: float
    fwd_table: torch.Tensor   # (n, 2) rows (z_i, z_{i+1})
    inv_lo: float
    inv_scale: float
    inv_table: torch.Tensor   # (n, 2) rows (x_i, x_{i+1})

    @classmethod
    def from_transform(cls, nst: NormalScoreTransform, n: int = 4096,
                       device=None):
        """Uniform-grid LUTs of ``nst`` with ``n`` knots, on ``device``
        (the card unless the caller asks for the CPU).  The inverse covers
        z in [-6.5, 6.5]: conditional draws can pass the forward
        transform's ±5.2 clip, and past the knots the inverse saturates at
        the data range like sklearn's."""
        device = resolve_device(device)
        q = np.asarray(nst.quantiles, np.float64)
        xg = np.linspace(q[0], q[-1], n)
        zg = nst.transform_np(xg)
        z_lo, z_hi = -6.5, 6.5
        zgi = np.linspace(z_lo, z_hi, n)
        xgi = nst.inverse_np(zgi)

        def pairs(t):
            t2 = np.stack([t, np.concatenate([t[1:], t[-1:]])], axis=1)
            return torch.as_tensor(t2.astype(np.float32), device=device)

        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return cls(fwd_lo=f32(xg[0]), fwd_scale=f32((n - 1) / (xg[-1] - xg[0])),
                   fwd_table=pairs(zg), inv_lo=f32(z_lo),
                   inv_scale=f32((n - 1) / (z_hi - z_lo)),
                   inv_table=pairs(xgi))

    def transform(self, x):
        """Data values -> scores via the forward LUT (plain PyTorch)."""
        return lut_lookup(x, self.fwd_lo, self.fwd_scale, self.fwd_table)

    def inverse(self, z):
        """Scores -> data values via the inverse LUT (plain PyTorch)."""
        return lut_lookup(z, self.inv_lo, self.inv_scale, self.inv_table)
