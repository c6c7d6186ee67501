"""The judged steps' draws held to the distributions the configuration
states.  The reference takes each step's draws from the program, so this
checks that stage by itself: per family of draws, the Kolmogorov-Smirnov
distance of the judged steps' values to their stated law, against the
distance a sound sampler exceeds with probability 1e-6.

- CRF: the block size index, uniform over the menu; the scale, uniform on
  [scale_min, scale_max) / 3; the range, uniform on [range_min_x,
  range_max_x) (isotropic: the y range the same); the centre, uniform over
  the update region's cells; the MH uniform on [0, 1); the half
  spectrum's white noise, its real and imaginary parts standard normal.
- SGS: the centre, uniform over the update region's cells; the block's
  sides, uniform on [min, max) of each; the window noise standard normal;
  the MH uniform.
"""

from __future__ import annotations

import math

import numpy as np
import torch

P_FALSE = 1e-6     # a sound sampler's chance to fail one family
NOISE_VALUES = 200_000  # noise values tested a family


def _critical(n: int) -> float:
    return math.sqrt(-math.log(P_FALSE / 2.0) / 2.0) / math.sqrt(n)


def _ks(x, cdf) -> float:
    """The Kolmogorov-Smirnov distance of the values ``x`` to ``cdf``."""
    x = np.sort(np.asarray(x, np.float64).ravel())
    n = x.size
    if n == 0 or not np.isfinite(x).all():
        return 1.0 if n else 0.0
    f = cdf(x)
    return float(max(np.max(np.arange(1, n + 1) / n - f),
                     np.max(f - np.arange(n) / n)))


def _uniform(lo, hi):
    return lambda x: np.clip((x - lo) / (hi - lo), 0.0, 1.0)


def _normal(x):
    from scipy.special import ndtr

    return ndtr(x)


def _discrete(k, m: int) -> float:
    """The distance of integers ``k`` to the uniform law on 0 .. m-1, over
    the support (values outside it count as wholly off)."""
    k = np.asarray(k).ravel()
    if k.size == 0:
        return 0.0
    if ((k < 0) | (k >= m)).any():
        return 1.0
    cum = np.cumsum(np.bincount(k, minlength=m)) / k.size
    return float(np.max(np.abs(cum - np.arange(1, m + 1) / m)))


def _stack(draws: list, key: str) -> np.ndarray:
    return torch.stack([d[key] for d in draws]).cpu().numpy()


def distances(cfg: dict, inp, draws: list, n_sizes: int) -> dict:
    """{family: (distance, values tested)} of the judged steps' draws."""
    cells = np.argwhere(inp.region)
    where = np.full(inp.region.shape, -1)
    where[cells[:, 0], cells[:, 1]] = np.arange(len(cells))
    u = _stack(draws, "u")
    noise = torch.stack([d["noise"] for d in draws]).flatten()
    noise = noise[:NOISE_VALUES]
    if cfg["family"] == "sgs":
        cx, cy = _stack(draws, "cx").ravel(), _stack(draws, "cy").ravel()
        inside = ((cx >= 0) & (cx < where.shape[0]) & (cy >= 0)
                  & (cy < where.shape[1]))
        centre = np.where(inside, where[np.clip(cx, 0, where.shape[0] - 1),
                                        np.clip(cy, 0, where.shape[1] - 1)],
                          -1)
        lo_x, hi_x, lo_y, hi_y = cfg["block_sizes"]
        dist = {"centre": _discrete(centre, len(cells)),
                "bsx": _discrete(_stack(draws, "bsx") - lo_x, hi_x - lo_x),
                "bsy": _discrete(_stack(draws, "bsy") - lo_y, hi_y - lo_y),
                "noise": _ks(noise.cpu().numpy(), _normal)}
        n = {"centre": centre.size, "bsx": centre.size, "bsy": centre.size,
             "noise": noise.numel()}
    else:
        rf = cfg["randfield"]
        noise = torch.view_as_real(noise).cpu().numpy()
        dist = {"size_idx": _discrete(_stack(draws, "size_idx"), n_sizes),
                "scale": _ks(_stack(draws, "scale"), _uniform(
                    rf["scale_min"] / 3.0, rf["scale_max"] / 3.0)),
                "range": _ks(_stack(draws, "range_x"), _uniform(
                    rf["range_min_x"], rf["range_max_x"])),
                "centre": _discrete(_stack(draws, "cidx"), len(cells)),
                "noise_re": _ks(noise[:, 0], _normal),
                "noise_im": _ks(noise[:, 1], _normal)}
        m = u.size
        n = {"size_idx": m, "scale": m, "range": m, "centre": m,
             "noise_re": noise.shape[0], "noise_im": noise.shape[0]}
        if rf["isotropic"] and not np.array_equal(_stack(draws, "range_x"),
                                                  _stack(draws, "range_y")):
            dist["range"] = 1.0
    dist["u"] = _ks(u, _uniform(0.0, 1.0))
    n["u"] = u.size
    return {k: (dist[k], n[k]) for k in dist}


def bad_draws(cfg: dict, inp, draws: list, n_sizes: int) -> int:
    """The families of draws whose distance passes the critical one."""
    return sum(d > _critical(n) for d, n in
               distances(cfg, inp, draws, n_sizes).values())
