"""The inputs of a cell, made from its seed, and the port's chains built
from a configuration file.

``build_problem`` is the synthetic ice stream of the repository's chip
smoke test (a seeded numpy problem: a sinusoidal bed under a sloping
surface, a sheared velocity field, the surface mass balance that makes the
true bed conserve mass, a noisy initial bed and 0.5 % of the cells as
radar picks, each off the true bed by a 5 m error).  The harness hands the same arrays to the program and to the
plain reference.
"""

from __future__ import annotations

import numpy as np


def seed_words(seed: int, n: int = 2) -> list:
    """``n`` independent 32-bit words from any whole-number seed (negative
    and beyond 64 bits included): the first seeds the problem, the second
    the program's random stream."""
    return [int(w) for w in
            np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def build_problem(grid: int, resolution: float, seed: int) -> dict:
    """The synthetic ice stream on a ``grid`` x ``grid`` grid of
    ``resolution`` metres, its random parts from ``seed``."""
    H = W = int(grid)
    res = float(resolution)
    rng = np.random.default_rng(seed)
    x = np.arange(W) * res
    y = np.arange(H) * res
    xx, yy = np.meshgrid(x, y)
    Lx, Ly = W * res, H * res
    bed_true = 300 * np.sin(2 * np.pi * xx / (Lx / 3)) * np.cos(
        2 * np.pi * yy / (Ly / 3)) - 400
    surf = 1800 + 0.3e-3 * xx + 150 * np.sin(2 * np.pi * yy / Ly)
    velx = 150 + 80 * np.sin(2 * np.pi * yy / Ly)
    vely = 30 * np.cos(2 * np.pi * xx / Lx)
    thick = surf - bed_true
    smb = (np.gradient(velx * thick, res, axis=1)
           + np.gradient(vely * thick, res, axis=0))
    dhdt = np.zeros_like(xx)
    grounded = np.ones((H, W), bool)
    region = np.zeros((H, W), np.float32)
    border = max(1, min(20, H // 8))
    region[border:-border, border:-border] = 1
    data_mask = rng.random((H, W)) < 0.005
    initial_bed = np.minimum(bed_true + rng.normal(0, 100, (H, W)), surf - 5)
    # a radar pick's error: the sinusoidal bed repeats its values exactly,
    # and real picks never do
    cond_bed = np.where(data_mask, bed_true + rng.normal(0, 5, (H, W)),
                        np.nan)
    return dict(xx=xx, yy=yy, surf=surf, velx=velx, vely=vely, dhdt=dhdt,
                smb=smb, grounded=grounded, region=region,
                data_mask=data_mask, cond_bed=cond_bed,
                initial_bed=initial_bed, resolution=res)


def sgs_trend(initial_bed, sigma: float) -> np.ndarray:
    """The SGS chain's trend: the initial bed under a Gaussian filter of
    ``sigma`` cells (float32)."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(initial_bed, sigma=sigma).astype(np.float32)


def make_chain(cfg: dict, p: dict, trend=None):
    """The port's prototype chain of configuration ``cfg`` on problem
    ``p``: a ``ChainCRF``, or a ``ChainSGS`` detrended by ``trend``
    (``sgs_trend``), by ``cfg["family"]``."""
    if cfg["family"] == "crf":
        return _crf_chain(cfg, p)
    if cfg["family"] == "sgs":
        return _sgs_chain(cfg, p, trend)
    raise ValueError(f"unknown chain family {cfg['family']!r}")


def _arrays(p):
    return (p["xx"], p["yy"], p["initial_bed"], p["surf"], p["velx"],
            p["vely"], p["dhdt"], p["smb"], p["cond_bed"], p["data_mask"],
            p["grounded"], p["resolution"])


def _crf_chain(cfg, p):
    from mcmc_tpu_torch import (BlockMenuConfig, ChainCRF, RandFieldConfig,
                                WeightConfig)

    loss = cfg["loss"]
    chain = ChainCRF(*_arrays(p))
    chain.set_update_region(True, p["region"])
    chain.set_loss_type(sigma_mc=loss["sigma_mc"],
                        massConvInRegion=loss["mass_conservation_in_region"])
    chain.configure_randfield(RandFieldConfig(**cfg["randfield"]),
                              BlockMenuConfig(**cfg["block_menu"]),
                              WeightConfig(**cfg["weight"]))
    chain.set_update_type(cfg["update_type"])
    return chain


def _sgs_chain(cfg, p, trend):
    from mcmc_tpu_torch import ChainSGS, NormalScoreTransform

    loss, vario, sgs = cfg["loss"], cfg["variogram"], cfg["sgs"]
    chain = ChainSGS(*_arrays(p))
    chain.set_update_region(True, p["region"])
    chain.set_loss_type(sigma_mc=loss["sigma_mc"],
                        massConvInRegion=loss["mass_conservation_in_region"])
    chain.set_trend(trend, detrend_map=True)
    nst = NormalScoreTransform.fit((p["initial_bed"] - trend).ravel(),
                                   cfg["n_quantiles"])
    chain.set_normal_transformation(nst, do_transform=True)
    chain.set_variogram(vario["vtype"], vario["range"], vario["sill"],
                        vario["nugget"], vario_smoothness=vario["smoothness"])
    chain.set_sgs_param(sgs["num_neighbors"], sgs["search_radius"])
    chain.set_block_sizes(*cfg["block_sizes"])
    return chain
