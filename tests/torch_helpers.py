"""Helpers shared by the PyTorch port's tests; imports no JAX, so the
``cuda``-marked tests can run on a machine without it (``pytest
--noconftest``)."""

import numpy as np

from mcmc_tpu_torch import (BlockMenuConfig, ChainCRF, RandFieldConfig,
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
