"""The large-scale CRF step, followed step by step from a chain's state.

The upstream's step (MCMC.py's chain_crf with RandField's spectral
proposal, CRF_weight blocks): a block size from the menu, a centre from
the update region, a Matérn field synthesised on a (B, B) canvas from
complex white noise (irfft2 of noise times the square root of the
spectral density), standardised over the (h, w) block, scaled, tapered by
the size's logistic edge mask and weighted by the logistic distance to
the radar picks; the bed moves by it over the block's update cells, the
stored residual is recomputed over the block (the ring around it is left
stale, as upstream), the loss changes by the block's mass-conservation
squares and the Metropolis rule accepts with probability min(1,
exp(-delta)), never where the ice would lose its thickness.

``follow`` runs ``T`` such steps for a batch of chains from their bed and
stored residual, given each step's draws.  Given ``decisions`` it takes
each step as they say (so it stays on the judged chains' path) and
reports its own decision beside them; without, it decides itself, which
is the control's use.  Every operation runs in ``dtype``: float64 for the
reference, bfloat16 for its control (the FFT in float32 on bfloat16
values, rounded back).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import physics


def menu_pairs(cfg: dict) -> np.ndarray:
    """(n_sizes, 2) (h, w) of each size index: the upstream's
    RandField.get_block_sizes, a meshgrid of the widths (x) and heights
    (y) each made even, heights the slow axis."""
    m = cfg["block_menu"]
    ws = np.linspace(m["min_block_x"], m["max_block_x"], m["steps"],
                     dtype=int) // 2 * 2
    hs = np.linspace(m["min_block_y"], m["max_block_y"], m["steps"],
                     dtype=int) // 2 * 2
    w, h = np.meshgrid(ws, hs)
    return np.stack([h.ravel(), w.ravel()], axis=1)


def _logistic(dist, wt: dict):
    """The upstream's rescaled logistic: distances over ``max_dist``
    (clamped to 1) through L / (1 + exp(-k (x - x0))) - offset."""
    x = np.where(dist > wt["max_dist"], 1.0, dist / wt["max_dist"])
    return wt["L"] / (1.0 + np.exp(-wt["k"] * (x - wt["x0"]))) - wt["offset"]


def edge_masks(cfg: dict) -> np.ndarray:
    """(n_sizes, B, B) each size's edge taper at the canvas's top left:
    the logistic of a cell's distance to the block's boundary ring."""
    pairs = menu_pairs(cfg)
    B = int(pairs.max())
    wt = cfg["weight"]
    out = np.zeros((len(pairs), B, B))
    for i, (h, w) in enumerate(pairs):
        ii = np.arange(h)[:, None]
        jj = np.arange(w)[None, :]
        d = np.minimum(np.minimum(ii, h - 1 - ii),
                       np.minimum(jj, w - 1 - jj)) * wt["resolution"]
        out[i, :h, :w] = _logistic(d.astype(np.float64), wt)
    return out


def crf_weight(cfg: dict, data_mask: np.ndarray, resolution: float):
    """The CRF_weight plane: the logistic of each cell's Euclidean distance
    to the nearest radar pick, shifted so that its least value is 0."""
    from scipy.ndimage import distance_transform_edt

    dist = distance_transform_edt(~np.asarray(data_mask, bool),
                                  sampling=(resolution, resolution))
    w = _logistic(dist, cfg["weight"])
    return w - w.min()


def matern_density(k, range_x, range_y, nu: float):
    """RandField's Matérn spectral density in its 4 pi k^2 form, at
    angular wavenumbers ``k``, the ranges (n,) collapsed to their
    geometric mean over 2."""
    a = torch.sqrt((range_x / 2.0) * (range_y / 2.0))[:, None, None]
    const = (4.0 * math.pi * math.gamma(nu + 1.0) * (2.0 * nu) ** nu
             / math.gamma(nu)) / a ** (2.0 * nu)
    kappa = 2.0 * nu / a ** 2
    return const * (kappa + 4.0 * math.pi * k ** 2) ** (-nu - 1.0)


class Step:
    """The configuration's constant planes and tables on ``device`` in
    ``dtype``, the harness's inputs worked out again."""

    def __init__(self, cfg: dict, inp, device, dtype=torch.float64):
        self.dtype, self.device = dtype, device
        H, W = inp.region.shape
        pairs = menu_pairs(cfg)
        self.B = B = int(pairs.max())
        self.S = min(H, W, B + 4)
        self.H, self.W = H, W
        res = inp.resolution
        self.resolution = res
        self.sigma = inp.sigma_mc
        rf = cfg["randfield"]
        self.nu = float(rf["smoothness"])

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=device).to(dtype)

        self.pairs = torch.as_tensor(pairs, device=device)
        self.edge = t(edge_masks(cfg))
        self.cells = torch.as_tensor(np.argwhere(inp.region),
                                     device=device)
        weight = (crf_weight(cfg, inp.data_mask, res)
                  if cfg["update_type"] == "CRF_weight"
                  else np.ones((H, W)))
        self.planes = torch.stack([
            t(inp.surf), t(inp.velx), t(inp.vely),
            t(np.asarray(inp.dhdt, np.float64) - inp.smb), t(weight)])
        self.update = torch.as_tensor(inp.region, device=device)
        self.mc = torch.as_tensor(inp.mc_mask, device=device)
        kx = np.fft.rfftfreq(B, d=res) * 2.0 * np.pi
        ky = np.fft.fftfreq(B, d=res) * 2.0 * np.pi
        self.k = torch.as_tensor(
            np.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2) + 1e-10,
            device=device)

    def proposal(self, d: dict, idx) -> torch.Tensor:
        """(n, B, B) finished fields of chains ``idx`` from their draws."""
        dens = matern_density(self.k, d["range_x"][idx].to(torch.float64),
                              d["range_y"][idx].to(torch.float64), self.nu)
        spec = d["noise"][idx].to(torch.complex128) * torch.sqrt(dens)
        if self.dtype != torch.float64:
            spec = torch.complex(spec.real.to(self.dtype).float(),
                                 spec.imag.to(self.dtype).float())
        raw = torch.fft.irfft2(spec, s=(self.B, self.B)).to(self.dtype)
        hw = self.pairs[d["size_idx"][idx]]
        ar = torch.arange(self.B, device=self.device)
        m = ((ar[None, :, None] < hw[:, 0, None, None])
             & (ar[None, None, :] < hw[:, 1, None, None])).to(self.dtype)
        n = m.sum(dim=(-2, -1), keepdim=True)
        mean = (raw * m).sum(dim=(-2, -1), keepdim=True) / n
        var = ((raw - mean) ** 2 * m).sum(dim=(-2, -1), keepdim=True) / n
        f = (raw - mean) / (torch.sqrt(var) + 1e-12) * m
        scale = d["scale"][idx].to(self.dtype)[:, None, None]
        return f * scale * self.edge[d["size_idx"][idx]]

    def geometry(self, d: dict, idx):
        """Per chain: the block's rows [r0, r1) and columns [c0, c1), the
        canvas offsets and the (S, S) window's first row and column."""
        hw = self.pairs[d["size_idx"][idx]]
        h, w = hw[:, 0], hw[:, 1]
        cc = self.cells[d["cidx"][idx]]
        cx, cy = cc[:, 0], cc[:, 1]
        lo_x = torch.div(2 * cx - h, 2, rounding_mode="floor")
        lo_y = torch.div(2 * cy - w, 2, rounding_mode="floor")
        hi_x = torch.div(2 * cx + h, 2, rounding_mode="floor")
        hi_y = torch.div(2 * cy + w, 2, rounding_mode="floor")
        r0, c0 = lo_x.clamp(min=0), lo_y.clamp(min=0)
        r1, c1 = hi_x.clamp(max=self.H), hi_y.clamp(max=self.W)
        wr = (r0 - 1).clamp(0, self.H - self.S)
        wc = (c0 - 1).clamp(0, self.W - self.S)
        return dict(cx=cx, cy=cy, h=h, w=w, r0=r0, r1=r1, c0=c0, c1=c1,
                    lo_x=lo_x, lo_y=lo_y, wr=wr, wc=wc)

    def step(self, bed, res, d: dict, idx, decide=None) -> dict:
        """One step of chains ``idx`` (their planes ``bed``, ``res`` (n, H,
        W), updated in place where the step is taken).  ``decide``: the
        judged side's decisions (n,) bool, or None to decide here."""
        g = self.geometry(d, idx)
        S, n = self.S, bed.shape[0]
        ar = torch.arange(S, device=self.device)
        rows = g["wr"][:, None] + ar
        cols = g["wc"][:, None] + ar
        r3, c3 = rows[:, :, None], cols[:, None, :]
        n3 = torch.arange(n, device=self.device)[:, None, None]
        surf, velx, vely, forcing, weight = self.planes[:, r3, c3]
        upd, mc = self.update[r3, c3], self.mc[r3, c3]
        in_block = (((rows >= g["r0"][:, None]) & (rows < g["r1"][:, None])
                     )[:, :, None]
                    & ((cols >= g["c0"][:, None]) & (cols < g["c1"][:, None])
                       )[:, None, :])
        f = self.proposal(d, idx)
        fr = (rows - g["lo_x"][:, None]).clamp(0, self.B - 1)[:, :, None]
        fc = (cols - g["lo_y"][:, None]).clamp(0, self.B - 1)[:, None, :]
        moved = in_block & upd
        bed_w, res_w = bed[n3, r3, c3], res[n3, r3, c3]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        bed_new = bed_w + torch.where(moved, f[n3, fr, fc] * weight, zero)
        res_new = _window_residual(surf, bed_new, velx, vely, forcing,
                                   self.resolution)
        patch = in_block & mc
        two_s2 = 2.0 * self.sigma ** 2
        delta = ((_sq(res_new, patch) - _sq(res_w, patch)) / two_s2)
        viol = ((surf - bed_new <= 0) & moved).flatten(1).any(dim=1)
        u = d["u"][idx].to(torch.float64)
        d64 = delta.to(torch.float64)
        own = (u <= torch.exp(torch.clamp(-d64, max=0.0))) & ~viol
        take = own if decide is None else decide
        new_res = torch.where(in_block, res_new, res_w)
        keep = take[:, None, None]
        bed[n3, r3, c3] = torch.where(keep, bed_new, bed_w)
        res[n3, r3, c3] = torch.where(keep, new_res, res_w)
        return dict(delta=delta, accept=own, taken=take, viol=viol,
                    margin=torch.abs(torch.log(u) + d64),
                    block=torch.stack([g["cx"], g["cy"], g["h"], g["w"]],
                                      dim=1))


def _sq(x, mask):
    s = torch.nan_to_num(x * x, nan=0.0)
    return torch.where(mask, s, 0.0).sum(dim=(-2, -1))


def _window_residual(surf, bed, velx, vely, forcing, resolution: float):
    """The mass-conservation residual over (n, S, S) windows, numpy-
    gradient differences with one-sided ones on the window's edges (exact
    over a block at least one cell inside its window or on the grid's
    edge)."""
    thick = surf - bed
    return (physics._gradient(velx * thick, resolution, -1)
            + physics._gradient(vely * thick, resolution, -2) + forcing)
