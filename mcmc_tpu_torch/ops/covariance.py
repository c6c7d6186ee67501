"""Covariance models of the SGS chain, and their Gaussian+exponential
mixture fit.

PyTorch counterpart of ``mcmc_tpu/ops/covariance.py`` (the reference's
normalized-distance family, gstatsim_custom/covariance.py:4-29).  The
exponential / gaussian / spherical models are closed-form; the matérn model
is tabulated once on the host with SciPy, copied once to each device it is
evaluated on, and interpolated.

The JAX package evaluates the host-side covariance in **float32** (its
``jnp.asarray`` of a float64 numpy array gives float32), and the chain's
build makes discrete choices on the result: the circulant-embedding size
and the greedy pruning of the NNLS mixture fit.  So ``covariance_norm``
here computes in float32 with the JAX package's operation order, and the
host callers (``fit_cov_mixture``, ``models/chain_sgs.py``) convert its
float32 result to float64 exactly where the JAX package does.

``make_sigma`` / ``make_rho`` / ``cross_sigma`` build kriging systems
from point sets (batched over leading axes) for ``ops/kriging.py``.

Reference quirks carried over: spherical returns ``sill - 1`` beyond the
range; matérn uses the reference's fitted scale factor, clamps zero
distances to 1e-8 and maps the h -> 0 NaN to ``sill - nugget``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_MATERN_TABLE_POINTS = 4096
_MATERN_TABLE_HMAX = 8.0


def matern_scale_fit(s):
    """The reference's fitted matérn scale factor
    (gstatsim_custom/covariance.py:19-22)."""
    return 0.45246434 * np.exp(-0.70449189 * s) + 1.7863836


def make_matern_table(s: float, n_points: int = _MATERN_TABLE_POINTS,
                      h_max: float = _MATERN_TABLE_HMAX) -> np.ndarray:
    """The normalized matérn covariance c(h) for unit (sill - nugget),
    float32 of shape (n_points,) on ``h = linspace(0, h_max, n_points)``:

        scale = 0.45246434*exp(-0.70449189*s) + 1.7863836
        c(h)  = 2/Γ(s) * (scale*h*√s)^s * K_s(2*scale*h*√s),  c(0) = 1
    """
    from scipy.special import gamma, kv

    h = np.linspace(0.0, h_max, n_points)
    hc = np.where(h == 0.0, 1e-8, h)
    scale = matern_scale_fit(s)
    with np.errstate(invalid="ignore", over="ignore"):
        c = (2.0 / gamma(s) * np.power(scale * hc * np.sqrt(s), s)
             * kv(s, 2.0 * scale * hc * np.sqrt(s)))
    c = np.where(np.isnan(c), 1.0, c)  # h -> 0 limit is (sill-nugget)·1
    return c.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CovarianceSpec:
    """Static description of a covariance model: ``vtype`` is one of
    'exponential', 'gaussian', 'spherical', 'matern' (case-insensitive);
    for matérn ``matern_table`` holds the host-precomputed table, and
    ``table_on(device)`` its copy on a device."""

    vtype: str
    s: float | None = None
    matern_table: np.ndarray | None = dataclasses.field(default=None,
                                                        compare=False)

    def __post_init__(self):
        vt = self.vtype.lower()
        if vt not in ("exponential", "gaussian", "spherical", "matern"):
            raise ValueError(f"unknown covariance model {self.vtype!r}")
        object.__setattr__(self, "vtype", vt)
        if vt == "matern":
            if self.s is None:
                raise ValueError("matern covariance requires the smoothness "
                                 "parameter s")
            if self.matern_table is None:
                object.__setattr__(self, "matern_table",
                                   make_matern_table(self.s))
        object.__setattr__(self, "_device_tables", {})

    def table_on(self, device) -> torch.Tensor:
        """``matern_table`` as a float32 tensor on ``device``: copied there
        by the first call and held by the spec for every later one, so an
        evaluation on the card makes no host copy (a captured CUDA graph
        can hold none)."""
        device = torch.device(device)
        table = self._device_tables.get(device)
        if table is None:
            table = torch.as_tensor(self.matern_table, dtype=torch.float32,
                                    device=device)
            self._device_tables[device] = table
        return table


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x`` (so that mixing
    it into a float32 tensor expression rounds nothing further)."""
    return float(np.float32(x))


def covariance_norm(spec: CovarianceSpec, norm_range, sill, nugget):
    """Covariance at normalized distance(s), in float32.

    ``norm_range`` is a tensor or array-like (converted to float32);
    ``sill``/``nugget`` are Python numbers, rounded to float32 as the JAX
    package's weakly typed scalars are.  Returns a float32 tensor.
    """
    h = (norm_range if torch.is_tensor(norm_range)
         else torch.as_tensor(np.asarray(norm_range))).to(torch.float32)
    amp = _f32(sill - nugget)
    if spec.vtype == "exponential":
        return amp * torch.exp(-3.0 * h)
    if spec.vtype == "gaussian":
        return amp * torch.exp(-3.0 * (h * h))
    if spec.vtype == "spherical":
        c = (amp - 1.5 * h) + 0.5 * (h * h * h)
        # reference quirk: beyond the range the value is sill - 1
        return torch.where(h > 1.0, torch.full_like(h, _f32(sill - 1.0)), c)
    table = spec.table_on(h.device)
    n = table.shape[0]
    xs = torch.clamp(h / _MATERN_TABLE_HMAX, 0.0, 1.0) * float(n - 1)
    lo = torch.floor(xs)
    lo_i = torch.nan_to_num(lo, nan=0.0).long()
    hi_i = torch.clamp(lo_i + 1, max=n - 1)
    frac = xs - lo
    c01 = table[lo_i] * (1.0 - frac) + table[hi_i] * frac
    c01 = torch.where(h >= _MATERN_TABLE_HMAX, torch.zeros_like(c01), c01)
    return amp * c01


def make_rotation_matrix(azimuth, major_range, minor_range) -> torch.Tensor:
    """(2, 2) float32 anisotropy matrix: rotate by ``azimuth`` degrees,
    then scale the axes by 1/range (reference _krige.py:83-103)."""
    theta = torch.tensor((azimuth / 180.0) * math.pi, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    scale = torch.tensor([[1.0 / major_range, 0.0], [0.0, 1.0 / minor_range]],
                         dtype=torch.float32)
    return rot @ scale


def rotate(coords, rotation_matrix):
    """``coords @ rotation_matrix`` for (..., 2) coordinates, written out
    elementwise (float32, no TF32 path on the card)."""
    r = rotation_matrix.to(coords.device, coords.dtype)
    return coords[..., :1] * r[0] + coords[..., 1:] * r[1]


def _pair_norm(ta, tb):
    """(..., na, nb) Euclidean distances between rotated point sets."""
    d = ta[..., :, None, :] - tb[..., None, :, :]
    return torch.sqrt(torch.sum(d * d, dim=-1))


def make_sigma(spec: CovarianceSpec, coords, rotation_matrix, sill, nugget):
    """Covariance matrix between data points (reference _krige.py:105-122).
    coords: (..., n, 2).  Returns (..., n, n)."""
    t = rotate(coords, rotation_matrix)
    return covariance_norm(spec, _pair_norm(t, t), sill, nugget)


def make_rho(spec: CovarianceSpec, coords, target_xy, rotation_matrix, sill,
             nugget):
    """Covariance vector between data points and a target cell (reference
    _krige.py:124-144).  coords: (..., n, 2), target_xy: (..., 2).
    Returns (..., n)."""
    t1 = rotate(coords, rotation_matrix)
    t2 = rotate(target_xy, rotation_matrix)
    d = t1 - t2[..., None, :]
    return covariance_norm(spec, torch.sqrt(torch.sum(d * d, dim=-1)), sill,
                           nugget)


def cross_sigma(spec: CovarianceSpec, coords_a, coords_b, rotation_matrix,
                sill, nugget):
    """Cross-covariance matrix between two point sets: (..., na, nb)."""
    return covariance_norm(spec, _pair_norm(rotate(coords_a,
                                                   rotation_matrix),
                                            rotate(coords_b,
                                                   rotation_matrix)),
                           sill, nugget)


def fit_cov_mixture(spec: CovarianceSpec, sill, nugget, h_max: float,
                    n_grid: int = 2000, target_err: float = None):
    """Nonnegative gaussian+exponential mixture fit of the covariance curve
    on ``h in [0, h_max]``:

        c(h) ~= sum_g a_g exp(-b_g h^2) + sum_e a_e exp(-b_e h)

    by scipy NNLS over dyadic decay-rate dictionaries (b = 3·2^k).  Both
    families are valid covariances in R^2, so the fit is positive
    semi-definite and can evaluate covariance matrices analytically.
    ``target_err``: prune the support by greedy backward elimination while
    the max abs error stays within it.  Returns ``(a_g, b_g, a_e, b_e,
    max_abs_err)`` (float32 arrays, zero-weight terms pruned).
    """
    from scipy.optimize import nnls

    h = np.linspace(0.0, float(h_max), n_grid)
    c = covariance_norm(spec, h, float(sill), float(nugget)).numpy().astype(
        np.float64)
    bg = 3.0 * 2.0 ** np.arange(-6, 7)
    be = 3.0 * 2.0 ** np.arange(-5, 6)
    A = np.concatenate([np.exp(-np.outer(h ** 2, bg)),
                        np.exp(-np.outer(h, be))], axis=1)
    a, _ = nnls(A, c, maxiter=50 * A.shape[1])
    err = float(np.abs(A @ a - c).max())
    support = np.flatnonzero(a > 0)
    if target_err is not None and err <= target_err:
        while support.size > 1:
            best = None
            for drop in range(support.size):
                sub = np.delete(support, drop)
                a_sub, _ = nnls(A[:, sub], c, maxiter=50 * A.shape[1])
                e_sub = float(np.abs(A[:, sub] @ a_sub - c).max())
                if e_sub <= target_err and (best is None or e_sub < best[0]):
                    best = (e_sub, sub, a_sub)
            if best is None:
                break
            err, support, a_sub = best
            a = np.zeros_like(a)
            a[support] = a_sub
    a_g, a_e = a[: bg.size], a[bg.size:]
    gm, em = a_g > 0, a_e > 0
    return (a_g[gm].astype(np.float32), bg[gm].astype(np.float32),
            a_e[em].astype(np.float32), be[em].astype(np.float32), err)


def mixture_families(mix):
    """The two families of ``SGSStatic.mix`` ((ag...), (bg...), (ae...),
    (be...), qcoef) in evaluation order, each as ``(in_h, b0, terms)``:
    ``in_h`` whether the family decays in √h2 (exponential) rather than h2
    (gaussian); for a dyadic family (rates b0·2^k) ``b0`` is the base rate
    and ``terms`` the (k, a) pairs sorted by k, evaluated from ONE exp by
    repeated squaring; otherwise ``b0`` is None and ``terms`` the (b, a)
    pairs in the given order, one exp each.  Empty families are skipped.
    Shared by the plain evaluation below and the CUDA kernel's parameters
    (``ops/cg_kernel.py``), so both take the same terms in the same order.
    """
    out = []
    for amps, rates, in_h in ((mix[0], mix[1], False), (mix[2], mix[3], True)):
        if not amps:
            continue
        b0 = min(rates)
        ks = [math.log2(b / b0) for b in rates]
        if all(abs(k - round(k)) < 1e-9 for k in ks):
            out.append((in_h, b0, sorted(zip((int(round(k)) for k in ks),
                                             amps))))
        else:
            out.append((in_h, None, list(zip(rates, amps))))
    return out


def eval_mixture_static(mix, h2):
    """The fitted mixture at squared distances ``h2`` (float32 tensor):

        S = Σ ag·exp(-bg·h2) + Σ ae·exp(-be·√h2)

    with ``mix`` = SGSStatic.mix.  A dyadic family costs one exp plus
    repeated squaring (E, E², E⁴, ...), terms summed by rising k; other
    rates fall back to one exp per term, in the given order.  The same
    arithmetic, in the same order, as the JAX package's
    ``eval_mixture_static``.
    """
    out = None
    for in_h, b0, terms in mixture_families(mix):
        x = torch.sqrt(h2) if in_h else h2
        s = None
        if b0 is not None:
            E = torch.exp(x * _f32(-b0))
            k_cur = 0
            for k, a in terms:
                while k_cur < k:
                    E = E * E
                    k_cur += 1
                term = E * _f32(a)
                s = term if s is None else s + term
        else:
            for b, a in terms:
                term = torch.exp(x * _f32(-b)) * _f32(a)
                s = term if s is None else s + term
        out = s if out is None else out + s
    return out
