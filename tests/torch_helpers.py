"""Helpers shared by the PyTorch port's tests; imports no JAX, so the
``cuda``-marked tests can run on a machine without it (``pytest
--noconftest``)."""

import numpy as np

from mcmc_tpu_torch import (BlockMenuConfig, ChainCRF, ChainSGS,
                            NormalScoreTransform, RandFieldConfig,
                            WeightConfig)


def small_problem(H=96, W=96, res=500.0, seed=0):
    """A small synthetic ice stream: smooth bed under a higher surface, a
    divergent velocity field, a forcing that makes the true bed residual
    zero, a central update region and sparse radar data."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(W) * res, np.arange(H) * res)
    Lx, Ly = W * res, H * res
    bed_true = (200 * np.sin(2 * np.pi * xx / Lx) * np.cos(2 * np.pi * yy / Ly)
                - 300.0)
    surf = 1500.0 + 0.5e-3 * xx + 200 * np.exp(
        -((xx - Lx / 2) ** 2 + (yy - Ly / 2) ** 2) / (Lx / 3) ** 2)
    velx = 100.0 + 50 * np.sin(2 * np.pi * yy / Ly)
    vely = 20.0 * np.cos(2 * np.pi * xx / Lx)
    thick = surf - bed_true
    smb = (np.gradient(velx * thick, res, axis=1)
           + np.gradient(vely * thick, res, axis=0))
    region = np.zeros((H, W), np.float32)
    region[H // 8: 7 * H // 8, W // 8: 7 * W // 8] = 1.0
    data_mask = rng.random((H, W)) < 0.02
    return dict(xx=xx, yy=yy, surf=surf, velx=velx, vely=vely,
                dhdt=np.zeros_like(xx), smb=smb,
                grounded=np.ones((H, W), bool), region=region,
                data_mask=data_mask,
                cond_bed=np.where(data_mask, bed_true, np.nan),
                initial_bed=np.minimum(bed_true + rng.normal(0, 80, (H, W)),
                                       surf - 5.0),
                resolution=res)


def small_chain(p, blocks=(12, 20), nugget_max=0.0, data_loss=False):
    """A CRF_weight chain with the production Matérn (nu=1.3) model."""
    c = ChainCRF(p["xx"], p["yy"], p["initial_bed"], p["surf"], p["velx"],
                 p["vely"], p["dhdt"], p["smb"], p["cond_bed"],
                 p["data_mask"], p["grounded"], p["resolution"])
    c.set_update_region(True, p["region"])
    if data_loss:
        c.set_loss_type(sigma_mc=5.0, diff_func="sumsquare", sigma_data=20.0)
    else:
        c.set_loss_type(sigma_mc=5.0)
    c.configure_randfield(
        RandFieldConfig(3e3, 8e3, 3e3, 8e3, scale_min=20.0, scale_max=60.0,
                        nugget_max=nugget_max, model_name="Matern",
                        isotropic=True, smoothness=1.3),
        BlockMenuConfig(blocks[0], blocks[1], blocks[0], blocks[1], steps=3),
        WeightConfig(L=2.0, x0=0.0, k=6.0, offset=1.0, max_dist=5e3,
                     resolution=p["resolution"]))
    c.set_update_type("CRF_weight")
    return c


def block_losses(fields, stacked, geom, consts):
    """Per chain, the block's old mass-conservation and data losses (nats,
    float64): the size of the two sums whose difference is a delta."""
    mc = stacked[4] >= 2.0
    dmask = stacked[7] > 0
    n = geom.shape[0]
    mc_l, data_l = np.zeros(n), np.zeros(n)
    for i, (x0, x1, y0, y1) in enumerate(geom[:, :4]):
        blk = (slice(x0, x1), slice(y0, y1))
        res = fields[i, 1][blk].astype(np.float64)
        mc_l[i] = np.nansum(np.where(mc[blk], res ** 2, 0.0))
        dd = fields[i, 0][blk].astype(np.float64) - stacked[6][blk]
        data_l[i] = np.nansum(np.where(dmask[blk], dd ** 2, 0.0))
    return (mc_l / (2.0 * consts.sigma_mc ** 2),
            data_l / (2.0 * consts.sigma_data ** 2))


def assert_delta_close(actual, desired, block_loss, msg=""):
    """A delta is the difference of two f32 sums over the block, each of
    the block's loss size; summed in another order it moves by a few ulp
    of that size.  So the relative tolerance (1e-5) is taken against the
    block loss, not against the possibly near-zero delta."""
    err = np.abs(np.asarray(actual, np.float64) - desired)
    bound = 1e-5 * (block_loss + np.abs(desired)) + 1e-6
    assert np.all(err <= bound), (msg, actual, desired, err, bound)


def small_sgs_chain(p, vario=("Matern", 2.5e3, 1.0, 0.0, 1.3), blocks=(5, 12),
                    transform=True):
    """An SGS chain at the production settings (detrend, normal-score
    transform, 48 neighbours within 30 km), with a short-range matérn
    (nu=1.3) so the packed systems are well conditioned at a small size."""
    from scipy.ndimage import gaussian_filter

    c = ChainSGS(p["xx"], p["yy"], p["initial_bed"], p["surf"], p["velx"],
                 p["vely"], p["dhdt"], p["smb"], p["cond_bed"],
                 p["data_mask"], p["grounded"], p["resolution"])
    c.set_update_region(True, p["region"])
    c.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    trend = gaussian_filter(p["initial_bed"], sigma=10).astype(np.float32)
    c.set_trend(trend, detrend_map=True)
    if transform:
        c.set_normal_transformation(NormalScoreTransform.fit(
            (p["initial_bed"] - trend).ravel(), 500), do_transform=True)
    vtype, vrange, sill, nugget, smooth = vario
    c.set_variogram(vtype, vrange, sill, nugget, vario_smoothness=smooth)
    c.set_sgs_param(48, 30e3)
    c.set_block_sizes(blocks[0], blocks[1], blocks[0], blocks[1])
    return c


# the truncated normal's quantile grid of the card's draw kernel
# (ops/bounded_draw_kernel.py): bounds from one-sided tails to |a|, |b| =
# 40, intervals straddling 0, narrow intervals, and u within 1e-12 of 0
# and 1 (the largest uniform below 1 included)
PPF_ENDS = (-40.0, -38.0, -20.0, -5.0, -2.0, -1.0, -0.5, -1e-3, 0.0, 1e-3,
            0.5, 1.0, 2.0, 5.0, 20.0, 38.0, 40.0)
PPF_Q = (0.0, 1e-300, 1e-12, 1e-9, 1e-6, 0.1, 0.37, 0.5, 0.9, 1 - 1e-6,
         1 - 1e-9, 1 - 1e-12, float(np.nextafter(1.0, 0.0)))
PPF_NARROW = ((-39.0, (1e-12, 1e-6, 1e-3)), (-1.0, (1e-12, 1e-6, 1e-3)),
              (0.0, (1e-12, 1e-3)), (10.0, (1e-9, 1e-3)),
              (39.0, (1e-12, 1e-3)))
PPF_ATOL = 1e-9  # times max(1, |x|)
# the most scipy's left case loses where a < 0 < x, times max(1, |x|): x
# off by 0.0101 at the largest uniform below 1 over the grid (8.2095)
SCIPY_LOSS_CAP = 2e-2


def ppf_grid():
    """(q, a, b) float64 arrays of the quantile grid above."""
    rows = [(q, a, b) for a in PPF_ENDS for b in PPF_ENDS if a < b
            for q in PPF_Q]
    rows += [(q, a, a + w) for a, ws in PPF_NARROW for w in ws
             for q in PPF_Q]
    return tuple(np.array(c, np.float64) for c in zip(*rows))


def scipy_ppf_tolerance(q, a, b, x):
    """How far a draw may lie from scipy's ``truncnorm.ppf`` value ``x``:
    ``PPF_ATOL`` max(1, |x|), and where a < 0 < x, beyond it the rounding
    of scipy's own left case, log(Φ(a) + q·m) summed in log space near
    log Φ(x) ~ 0: 8 ulp of its larger term times dx/dy = Φ(x)/φ(x), at
    most ``SCIPY_LOSS_CAP`` max(1, |x|).  Where that term exceeds the
    plain tolerance, the CPU tests hold the plain version to the
    60-digit quantile instead."""
    from scipy import special
    from scipy.stats import norm

    with np.errstate(divide="ignore", over="ignore"):
        mass = np.log1p(-special.ndtr(a) - special.ndtr(-b))
        big = np.abs(np.maximum(special.log_ndtr(a), np.log(q) + mass)) + 1
        slope = np.exp(special.log_ndtr(x) - norm.logpdf(x))
    scale = np.maximum(1.0, np.abs(x))
    cond = np.where((a < 0) & (x > 0), np.minimum(
        8 * np.finfo(float).eps * big * slope, SCIPY_LOSS_CAP * scale), 0.0)
    tol = PPF_ATOL * scale + cond
    assert np.isfinite(tol).all()
    return tol
