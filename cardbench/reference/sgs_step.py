"""The small-scale SGS step, followed step by step from a chain's state.

The step the configuration states (the SGS chain's block redraw): a block
of ``bsx`` x ``bsy`` cells about ``(cx, cy)`` is redrawn jointly from its
Gaussian conditional on the K = ``num_neighbors`` nearest other cells of
an (SB, SB) window about it within ``search_radius`` (nearest by their
distance to the block, ties to the lower window index), in normal-score
units: an unconditional draw of the window (the stationary Matérn field
by circulant embedding of its covariance, from the step's white noise)
plus the simple-kriging correction of its misfit at the K cells.  The
K x K system takes, in place of the Matérn, its nonnegative fit by
Gaussian and exponential terms (``mixture``) with 1e-3 sill on the
diagonal; the correction spreads the weights by the Matérn itself.  Radar
cells inside the block are conditioning and keep their scores.  The bed is the inverse normal-score transform of
the scores (plus the trend); the stored residual is recomputed over the
block and its one-cell ring, the loss changes by those cells' squares and
the Metropolis rule accepts with probability min(1, exp(-delta)), never
where grounded ice would lose its thickness.

Here the system is solved exactly (a float64 dense solve), and the
correction is the covariance times the weights, summed directly.
``Step.step`` is ``crf_step.Step.step``'s counterpart; every operation runs in ``dtype`` (bfloat16 for the
control: the FFT and the solve in float32 on bfloat16 values, rounded
back).
"""

from __future__ import annotations

import numpy as np
import torch

from . import transform
from .crf_step import _sq, _window_residual
from .t2 import matern


def _smooth_sizes(lo: int, hi: int) -> list:
    """Even sizes in [lo, hi] with no prime factor above 5."""
    out = []
    for n in range(lo + (lo & 1), hi + 1, 2):
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            out.append(n)
    return out or [hi]


def mixture(cov_h, h_max: float, tol: float) -> tuple:
    """The fit of the covariance curve ``cov_h`` (a function of the
    normalised distance h) on [0, h_max] (2000 points) by nonnegative
    least squares over Gaussian terms exp(-b h^2) and exponential terms
    exp(-b h) with rates b = 3 2^k (k from -6 to 6, and -5 to 5), its
    support then pruned by greedy backward elimination (each round drops
    the term whose refit errs least) while the largest error stays within
    ``tol``.  Returns (gaussian (a, b), exponential (a, b)) arrays."""
    from scipy.optimize import nnls

    h = np.linspace(0.0, h_max, 2000)
    c = cov_h(h)
    bg = 3.0 * 2.0 ** np.arange(-6, 7)
    be = 3.0 * 2.0 ** np.arange(-5, 6)
    A = np.concatenate([np.exp(-np.outer(h ** 2, bg)),
                        np.exp(-np.outer(h, be))], axis=1)
    it = 50 * A.shape[1]
    a, _ = nnls(A, c, maxiter=it)
    support = np.flatnonzero(a > 0)
    if np.abs(A @ a - c).max() <= tol:
        while support.size > 1:
            best = None
            for drop in range(support.size):
                sub = np.delete(support, drop)
                a_sub, _ = nnls(A[:, sub], c, maxiter=it)
                err = np.abs(A[:, sub] @ a_sub - c).max()
                if err <= tol and (best is None or err < best[0]):
                    best = (err, sub, a_sub)
            if best is None:
                break
            _, support, a_sub = best
            a = np.zeros_like(a)
            a[support] = a_sub
    ag, ae = a[:bg.size], a[bg.size:]
    return (ag[ag > 0], bg[ag > 0]), (ae[ae > 0], be[ae > 0])


class Step:
    """The configuration's window, covariance, embedding and planes on
    ``device`` in ``dtype``, the harness's inputs worked out again."""

    def __init__(self, cfg: dict, inp, device, dtype=torch.float64):
        self.dtype, self.device = dtype, device
        H, W = inp.region.shape
        self.H, self.W = H, W
        res = self.resolution = inp.resolution
        self.sigma = inp.sigma_mc
        vario, sgs = cfg["variogram"], cfg["sgs"]
        bmx, bmy = cfg["block_sizes"][1], cfg["block_sizes"][3]
        big = max(bmx, bmy)
        M = int(np.clip(np.ceil(sgs["search_radius"] / res), 2, 8))
        SB = int(min(H, W, big + 2 * M))
        self.M = max(2, (SB - big) // 2) if SB < big + 2 * M else M
        self.SB = SB
        self.K = int(np.clip(sgs["num_neighbors"], 1, SB * SB - 1))
        self.radius = float(sgs["search_radius"])
        self.eps = 1e-3 * max(float(vario["sill"]), 1.0)
        amp = float(vario["sill"]) - float(vario["nugget"])
        rng, s = float(vario["range"]), float(vario["smoothness"])

        def cov(sq):
            """The covariance at squared cell offsets ``sq``."""
            return amp * matern(res * np.sqrt(sq) / rng, s)

        # every squared offset of two window cells: the covariance, and
        # the system's (the mixture's, fitted over the window's reach)
        sq = np.arange(2 * (SB - 1) ** 2 + 1)
        self.cov_table = torch.as_tensor(cov(sq), device=device)
        (ag, bg), (ae, be) = mixture(
            lambda h: amp * matern(h, s), 1.02 * res * (SB - 1) * np.sqrt(2)
            / rng, 1e-3 * max(abs(amp), 1e-6))
        h2 = (res / rng) ** 2 * sq
        self.sys_table = torch.as_tensor(
            (ag * np.exp(-np.outer(h2, bg))).sum(1)
            + (ae * np.exp(-np.outer(np.sqrt(h2), be))).sum(1),
            device=device)
        self.sqrt_spec = torch.as_tensor(self._embedding(cov, SB),
                                         device=device)
        self.NE = self.sqrt_spec.shape[0]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=device).to(dtype)

        trend = np.asarray(inp.trend, np.float64)
        cond0 = np.asarray(inp.cond_bed, np.float64) - trend
        data = np.asarray(inp.data_mask, bool) & np.isfinite(cond0)
        zc = transform.forward(np.where(data, cond0, 0.0), inp.quantiles,
                               inp.references)
        self.planes = torch.stack([
            t(inp.surf), t(inp.velx), t(inp.vely),
            t(np.asarray(inp.dhdt, np.float64) - inp.smb), t(trend),
            t(np.where(data, zc, 0.0))])
        self.data = torch.as_tensor(data, device=device)
        self.grounded = torch.as_tensor(np.asarray(inp.grounded, bool),
                                        device=device)
        self.mc = torch.as_tensor(inp.mc_mask, device=device)
        self.q, self.r = inp.quantiles, inp.references
        ends = transform.forward(np.array([self.q[0], self.q[-1]]),
                                 self.q, self.r)
        self.z_lo, self.z_hi = float(ends[0]), float(ends[1])

    @staticmethod
    def _embedding(cov, SB: int) -> np.ndarray:
        """(NE, NE//2+1) the square root of the circulant embedding's
        spectrum, scaled to the field's variance: NE the least even
        5-smooth size from 2 SB whose embedding is nonnegative to 1e-6 of
        its largest eigenvalue (at most 8 SB, then clamped)."""
        for N in _smooth_sizes(2 * SB, 8 * SB):
            k = np.arange(N)
            off = np.where(k <= N // 2, k, k - N)
            stamp = cov(off[:, None] ** 2 + off[None, :] ** 2)
            E = np.fft.fft2(stamp).real
            if E.min() > -1e-6 * E.max():
                break
        Ec = np.maximum(E, 0.0)
        return np.sqrt(Ec * (stamp[0, 0] / Ec.mean()))[:, : N // 2 + 1]

    def _halfspec(self, noise):
        """(n, NE, NE//2+1) complex noise distributed as the rfft2 of
        NE x NE white noise, from (n, NE^2) normals laid out as: the
        interior columns (real, imaginary interleaved), then the kx = 0
        and kx = NE/2 columns, each [real ky = 0, real ky = NE/2, (real,
        imaginary) of ky = 1 .. NE/2 - 1], mirrored conjugate below."""
        NE = self.NE
        n, Hh = noise.shape[0], NE // 2
        sig = NE * np.sqrt(0.5)
        n_int = NE * (Hh - 1) * 2
        v = noise[:, :n_int].reshape(n, NE, Hh - 1, 2)
        interior = torch.complex(v[..., 0] * sig, v[..., 1] * sig)

        def edge(e):
            up = torch.complex(e[:, 2::2] * sig, e[:, 3::2] * sig)
            zero = torch.zeros_like(e[:, :1])
            return torch.cat([torch.complex(e[:, :1] * NE, zero), up,
                              torch.complex(e[:, 1:2] * NE, zero),
                              up.conj().flip(1)], dim=1)

        c0 = edge(noise[:, n_int:n_int + NE])
        cH = edge(noise[:, n_int + NE:n_int + 2 * NE])
        return torch.cat([c0[:, :, None], interior, cH[:, :, None]], dim=2)

    def _round(self, x):
        return x.to(self.dtype).to(x.dtype) if self.dtype != torch.float64 \
            else x

    def unconditional(self, noise) -> torch.Tensor:
        """(n, SB, SB) the stationary field's draw on the window."""
        lo = torch.float64 if self.dtype == torch.float64 else torch.float32
        Z = self._halfspec(noise[:, :self.NE ** 2].to(lo))
        spec = Z * self.sqrt_spec.to(lo)
        spec = torch.complex(self._round(spec.real), self._round(spec.imag))
        z = torch.fft.irfft2(spec, s=(self.NE, self.NE))
        return z[:, :self.SB, :self.SB].to(self.dtype)

    def nearest(self, rd, cd, sim):
        """Each chain's K nearest conditioning cells of its window, by
        their distance to the block (``rd``, ``cd`` (n, SB): the rows' and
        columns' distances), ties to the lower window index: (n, K) window
        indices, nearest first, and whether each slot holds a cell."""
        n, SB = rd.shape
        d2 = rd[:, :, None] ** 2 + cd[:, None, :] ** 2
        cand = ~sim & (torch.sqrt(d2.to(torch.float64)) * self.resolution
                       <= self.radius)
        big = 4 * SB ** 4
        key = torch.where(cand.reshape(n, -1), d2.reshape(n, -1) * SB * SB
                          + torch.arange(SB * SB, device=rd.device), big)
        key, idx = torch.topk(key, self.K, dim=1, largest=False, sorted=True)
        return idx, key < big

    def step(self, bed, res, z, d: dict, idx, decide=None) -> dict:
        """One step of chains ``idx``: their detrended bed, stored residual
        and score planes (n, H, W), updated in place where the step is
        written.  ``decide``: the judged side's decisions, or None."""
        SB, K, n = self.SB, self.K, bed.shape[0]
        dev, dt = self.device, self.dtype
        cx, cy = d["cx"][idx], d["cy"][idx]
        bsx, bsy = d["bsx"][idx], d["bsy"][idx]

        def fdiv2(x):
            return torch.div(x, 2, rounding_mode="floor")

        r0 = fdiv2(2 * cx - bsx).clamp(min=0)
        r1 = fdiv2(2 * cx + bsx).clamp(max=self.H)
        c0 = fdiv2(2 * cy - bsy).clamp(min=0)
        c1 = fdiv2(2 * cy + bsy).clamp(max=self.W)
        ar = torch.arange(SB, device=dev)
        rows = (r0 - self.M).clamp(0, self.H - SB)[:, None] + ar
        cols = (c0 - self.M).clamp(0, self.W - SB)[:, None] + ar
        r3, c3 = rows[:, :, None], cols[:, None, :]
        n3 = torch.arange(n, device=dev)[:, None, None]
        surf, velx, vely, forcing, trend, zcond = self.planes[:, r3, c3]
        data, grounded, mc = (self.data[r3, c3], self.grounded[r3, c3],
                              self.mc[r3, c3])
        in_block = (((rows >= r0[:, None]) & (rows < r1[:, None]))[:, :, None]
                    & ((cols >= c0[:, None]) & (cols < c1[:, None]))
                    [:, None, :])
        sim = in_block & ~data
        rd = torch.clamp(torch.maximum(r0[:, None] - rows,
                                       rows - (r1[:, None] - 1)), min=0)
        cd = torch.clamp(torch.maximum(c0[:, None] - cols,
                                       cols - (c1[:, None] - 1)), min=0)
        ring = torch.maximum(rd[:, :, None], cd[:, None, :])
        bed_w, res_w, z_w = bed[n3, r3, c3], res[n3, r3, c3], z[n3, r3, c3]
        z_w = torch.where(in_block & data, zcond, z_w)
        z_u = self.unconditional(d["noise"][idx])

        sel_idx, sel = self.nearest(rd, cd, sim)
        ia, ja = sel_idx // SB, sel_idx % SB
        wi = torch.arange(SB * SB, device=dev)

        def cov(a_i, a_j, b_i, b_j, table):
            sq = (a_i[:, :, None] - b_i[:, None, :]) ** 2 + \
                 (a_j[:, :, None] - b_j[:, None, :]) ** 2
            return table[sq]

        lo = torch.float64 if dt == torch.float64 else torch.float32
        eye = torch.eye(K, device=dev, dtype=torch.float64)
        both = sel[:, :, None] & sel[:, None, :]
        A = torch.where(both, cov(ia, ja, ia, ja, self.sys_table), 0.0) + \
            torch.where(sel[:, :, None], self.eps * eye, eye)
        misfit = (z_w - z_u).reshape(n, -1).gather(1, sel_idx)
        rhs = torch.where(sel, misfit, 0.0)
        A, rhs = self._round(A.to(lo)), self._round(rhs.to(lo))
        wts = torch.linalg.solve(A, rhs.unsqueeze(-1)).squeeze(-1)
        wts = torch.where(sel, wts, 0.0).to(dt)
        gi, gj = (wi // SB).expand(n, -1), (wi % SB).expand(n, -1)
        C = cov(gi, gj, ia, ja, self.cov_table).to(dt)
        adj = torch.matmul(C, wts.unsqueeze(-1)).reshape(n, SB, SB)
        z_new = torch.where(sim, z_u + adj, z_w)
        z_keep = torch.clamp(z_new, self.z_lo, self.z_hi)

        inv = transform.inverse(z_new, self.q, self.r)
        bed_new = torch.where(sim | (in_block & data), inv, bed_w)
        full = bed_new + trend
        res_new = _window_residual(surf, full, velx, vely, forcing,
                                   self.resolution)
        chg = ring <= 1
        patch = chg & mc
        delta = (_sq(res_new, patch) - _sq(res_w, patch)) / (
            2.0 * self.sigma ** 2)
        viol = (((surf - full <= 0) & in_block & grounded).flatten(1).any(1)
                | (~torch.isfinite(torch.where(sim, bed_new, 0.0)))
                .flatten(1).any(1))
        u = d["u"][idx].to(torch.float64)
        d64 = delta.to(torch.float64)
        own = (u <= torch.exp(torch.clamp(-d64, max=0.0))) & ~viol
        take = own if decide is None else decide
        keep = (take & ~viol)[:, None, None]
        bed[n3, r3, c3] = torch.where(keep, bed_new, bed_w)
        res[n3, r3, c3] = torch.where(keep, torch.where(chg, res_new, res_w),
                                      res_w)
        z[n3, r3, c3] = torch.where(keep, z_keep, z[n3, r3, c3])
        return dict(delta=delta, accept=own, taken=take, viol=viol,
                    margin=torch.abs(torch.log(u) + d64),
                    block=torch.stack([cx, cy, bsx, bsy], dim=1))
