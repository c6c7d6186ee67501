"""T3 equivalent on the PyTorch port — the large-scale (CRF) chain farm.

Reference workflow: T3_LargeScaleChain.ipynb + the production driver
largeScaleChain_multiprocessing.py __main__ (:451-646): conditional
random-field block proposals with logistic data weighting, Gaussian
mass-conservation likelihood in the high-velocity region, multi-chain farm
with checkpoint/resume, convergence diagnostics.  On the card every step
launches the CRF window kernel and the Philox proposal-noise kernel once.

Run: ``python examples/torch_port/03_large_scale_chain.py [--device cpu]``
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    example_out,
    make_dataset,
    quick_mode,
    require,
    run_main,
)

from mcmc_tpu_torch.data import get_mass_conservation_residual  # noqa: E402
from mcmc_tpu_torch.drivers import (  # noqa: E402
    iteration_batches,
    large_scale_chain_farm,
)
from mcmc_tpu_torch.models import ChainCRF  # noqa: E402
from mcmc_tpu_torch.parallel import split_rhat  # noqa: E402
from mcmc_tpu_torch.utils.config import (  # noqa: E402
    BlockMenuConfig,
    RandFieldConfig,
    WeightConfig,
)
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    quick = quick_mode()
    hw = 64 if quick else 256
    ds = make_dataset(H=hw, W=hw)
    res = ds["resolution"]

    chain = ChainCRF(ds["xx"], ds["yy"], ds["initial_bed"], ds["surf"],
                     ds["velx"], ds["vely"], ds["dhdt"], ds["smb"],
                     ds["cond_bed"], ds["data_mask"], ds["grounded"], res)
    chain.set_update_region(True, ds["highvel_mask"])
    chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    # quick mode shrinks the proposal geometry with the grid (the production
    # 50-80-cell block menu would span the whole 64-cell smoke domain)
    chain.configure_randfield(
        RandFieldConfig(range_min_x=5e3 if quick else 10e3, range_max_x=50e3,
                        range_min_y=5e3 if quick else 10e3, range_max_y=50e3,
                        scale_min=50.0, scale_max=150.0, nugget_max=0.0,
                        model_name="Matern", isotropic=True, smoothness=1.3),
        (BlockMenuConfig(12, 24, 12, 24, steps=3) if quick
         else BlockMenuConfig(50, 80, 50, 80, steps=5)),
        WeightConfig(L=2, x0=0, k=6, offset=1,
                     max_dist=10e3 if quick else 30e3, resolution=res))
    chain.set_update_type("CRF_weight")  # logistic conditioning to radar

    # quality baseline: the known true bed's mass-conservation loss
    # (the reference uses BedMachine for this line, T3 cells 32-35)
    res_true = get_mass_conservation_residual(
        ds["bed_true"], ds["surf"], ds["velx"], ds["vely"], ds["dhdt"],
        ds["smb"], res)
    baseline = np.sum(res_true[ds["highvel_mask"] == 1] ** 2) / 50.0
    print(f"reference-bed loss baseline: {baseline:.4e}")

    n_chains = 2 if quick else 8
    total_iter = 200 if quick else 4000
    results = None
    t0 = time.time()
    for batch in iteration_batches(total_iter):
        # the reference restarts the farm per batch; resume does that here
        results = large_scale_chain_farm(
            chain, n_chains=n_chains, rng_seeds=2026,
            n_iter=total_iter, output_path=out / "lsc_run",
            segment_size=100 if quick else 1000, quiet=True, device=device)
        break  # run_with_checkpointing already handles segmentation
    seconds = time.time() - t0

    losses = np.stack([r[3] for r in results])
    steps = np.stack([r[4] for r in results])
    acc = steps.mean(axis=1)
    rhat = float(split_rhat(losses[:, 1:]))
    print(f"loss: {losses[:, 0].mean():.4e} -> {losses[:, -1].mean():.4e} "
          f"(baseline {baseline:.4e})")
    print(f"acceptance: {acc.round(3)}")
    print(f"split R-hat (loss): {rhat:.4f}")
    np.save(out / "lsc_final_beds.npy", np.stack([r[0] for r in results]))
    print("final beds saved to", out / "lsc_final_beds.npy")
    require(np.isfinite(losses).all(), "non-finite loss trace")
    require(losses[:, -1].mean() < losses[:, 0].mean(), "the loss must fall")
    return {"device": str(device), "n_chains": n_chains, "n_iter": total_iter,
            "grid": hw, "seconds": seconds, "loss_initial": losses[:, 0],
            "loss_final": losses[:, -1], "acceptance": acc,
            "split_rhat": rhat, "baseline": float(baseline)}


if __name__ == "__main__":
    sys.exit(run_main(main))
