"""T4 equivalent on the PyTorch port — the small-scale (SGS) chain farm.

Reference workflow: T4_SmallScaleChain.ipynb + smallScaleChain_mp
(:403-585): start from large-scale chain output, detrend with a Gaussian-
smoothed trend, normal-score transform the residual topography, and refine
with SGS block re-simulation proposals.  The chains are seeded with a list
(one stream a chain), so on the card every step draws through the
per-chain draw kernel once, then runs the SGS window extract, the mixture
CG, the inverse LUT and the window writeback.

Run: ``python examples/torch_port/04_small_scale_chain.py [--device cpu]``
"""

import sys
import time
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    example_out,
    make_dataset,
    quick_mode,
    require,
    run_main,
)

from mcmc_tpu_torch.drivers import small_scale_chain_farm  # noqa: E402
from mcmc_tpu_torch.models.chain_sgs import ChainSGS  # noqa: E402
from mcmc_tpu_torch.ops.transforms import NormalScoreTransform  # noqa: E402
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    quick = quick_mode()
    hw = 64 if quick else 128
    ds = make_dataset(H=hw, W=hw)
    res = ds["resolution"]

    # initial beds: large-scale chain finals if example 03 ran on the SAME
    # grid, else fresh perturbations of the dataset's initial bed
    lsc_beds = out / "lsc_final_beds.npy"
    beds = None
    if lsc_beds.exists():
        cand = np.load(lsc_beds)[:2]
        if cand.shape[-2:] == ds["xx"].shape:
            beds = cand
    from_03 = beds is not None
    if beds is None:
        rng = np.random.default_rng(1)
        beds = np.stack([
            np.minimum(ds["initial_bed"] + rng.normal(0, 15, ds["xx"].shape),
                       ds["surf"] - 5.0) for _ in range(2)])
    print("initial beds:", "example 03's final beds" if from_03
          else "perturbed dataset beds (no 03 output on this grid)")

    # trend + normal-score transform of the detrended residuals
    # (reference smallScaleChain_multiprocessing.py:486-497)
    trend = gaussian_filter(beds[0], sigma=10).astype(np.float32)
    resid = (beds[0] - trend).ravel()
    nst = NormalScoreTransform.fit(resid, n_quantiles=1000)

    chain = ChainSGS(ds["xx"], ds["yy"], beds[0], ds["surf"], ds["velx"],
                     ds["vely"], ds["dhdt"], ds["smb"], ds["cond_bed"],
                     ds["data_mask"], ds["grounded"], res)
    chain.set_update_region(True, ds["highvel_mask"])
    chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    chain.set_trend(trend, detrend_map=True)
    chain.set_normal_transformation(nst, do_transform=True)
    chain.set_variogram("Matern", 10e3, 1.0, 0.0, vario_smoothness=1.2)
    chain.set_sgs_param(48, 30e3)
    chain.set_block_sizes(5, 20, 5, 20)

    n_iter = 80 if quick else 500
    t0 = time.time()
    results = small_scale_chain_farm(
        chain, n_chains=2, initial_beds=beds, ssc_rng_seeds=[11, 22],
        lsc_rng_seed=2026, n_iter=n_iter,
        output_path=out / "ssc_run",
        segment_size=80 if quick else 250, quiet=True, device=device)
    seconds = time.time() - t0

    losses = np.stack([r[3] for r in results])
    steps = np.stack([r[4] for r in results])
    acc = steps.mean(axis=1)
    print(f"loss: {losses[:, 0].mean():.4e} -> {losses[:, -1].mean():.4e}")
    print(f"acceptance: {acc.round(3)}")
    final = np.stack([r[0] for r in results])
    np.save(out / "ssc_final_beds.npy", final)
    print("refined beds saved to", out / "ssc_final_beds.npy")
    require(np.isfinite(losses).all() and np.isfinite(final).all(),
            "non-finite SGS loss or bed")
    return {"device": str(device), "from_03": from_03, "n_iter": n_iter,
            "grid": hw, "seconds": seconds, "loss_initial": losses[:, 0],
            "loss_final": losses[:, -1], "acceptance": acc}


if __name__ == "__main__":
    sys.exit(run_main(main))
