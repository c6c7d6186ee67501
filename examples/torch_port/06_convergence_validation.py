"""Production-scale convergence validation on the PyTorch port — quantitative
posterior checks.

The reference validates visually in notebooks (T3 cells 58-74: loss decay
vs the BedMachine baseline, acceptance, variogram reproduction).  This
script runs the same checks QUANTITATIVELY at production scale on the
card: a 256-chain farm on a 512x512 grid, large-scale (CRF) stage followed
by the small-scale (SGS) refinement — the full production pipeline of the
reference drivers.  The scale follows the device it is given, never a
fallback: ``cuda`` (the default) runs the production scale, ``--device
cpu`` the CPU scale (8 chains, 128²), with the same thresholds.

Checks (each printed as PASS/FAIL, exit code 1 on any FAIL):
  1. CRF loss decays monotonically segment-over-segment toward the
     truth-bed loss baseline (the analog of the BedMachine line).
  2. Acceptance stays in the healthy band (both stages).
  3. The PIPELINE (CRF + SGS) closes >=90% of the gap to the truth-bed
     loss baseline.  (The CRF stage alone converges slowly at production
     scale — the reference's own GPU driver runs 3,000,000 iterations
     per chain, largeScaleChain_multiprocessing_GPU.py:469 — which is
     exactly why the reference pipelines the SGS refinement after it.)
  4. RMSE to the true bed (in the update region) improves over the
     initial bed after the pipeline.
  5. The pipeline bed reproduces the radar-data variogram within a
     tolerance band at small lags (T3 cells 72-74).

The last lines are a ``[validate] STATS {...}`` JSON line (the statistics
behind the checks, the device and each stage's chain-it/s) and the verdict.

Run: ``python examples/torch_port/06_convergence_validation.py [--device cpu]``
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    device_name,
    make_dataset,
    run_main,
    synchronize,
)

from mcmc_tpu_torch.data import get_mass_conservation_residual  # noqa: E402
from mcmc_tpu_torch.geostats import experimental_variogram  # noqa: E402
from mcmc_tpu_torch.models import ChainCRF  # noqa: E402
from mcmc_tpu_torch.models.chain_sgs import ChainSGS  # noqa: E402
from mcmc_tpu_torch.ops.transforms import NormalScoreTransform  # noqa: E402
from mcmc_tpu_torch.parallel import MultiChainSampler  # noqa: E402
from mcmc_tpu_torch.utils.config import (  # noqa: E402
    BlockMenuConfig,
    RandFieldConfig,
    WeightConfig,
)
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402

# grid side, chains, CRF iterations, SGS iterations, segment, block menu
SCALES = {
    "cuda": dict(hw=512, n_chains=256, crf_iters=60_000, sgs_iters=8_000,
                 seg=2_000, blocks=(50, 80)),
    "cpu": dict(hw=128, n_chains=8, crf_iters=3_000, sgs_iters=500,
                seg=500, blocks=(20, 40)),
}


def main(device=None):
    device = resolve_device(device)
    sc = SCALES[device.type]
    H = W = sc["hw"]
    n_chains, seg = sc["n_chains"], sc["seg"]
    crf_iters, sgs_iters = sc["crf_iters"], sc["sgs_iters"]
    failures = []

    def check(name, cond, detail=""):
        print(f"[validate] {name}: {'PASS' if cond else 'FAIL'} {detail}",
              flush=True)
        if not cond:
            failures.append(name)

    ds = make_dataset(H=H, W=W)
    res = ds["resolution"]
    region = ds["highvel_mask"]
    rmask = region == 1

    # truth baseline (reference T3 cells 32-35 uses BedMachine here)
    res_true = get_mass_conservation_residual(
        ds["bed_true"], ds["surf"], ds["velx"], ds["vely"], ds["dhdt"],
        ds["smb"], res)
    baseline = float(np.sum(res_true[rmask] ** 2) / (2 * 5.0 ** 2))

    chain = ChainCRF(ds["xx"], ds["yy"], ds["initial_bed"], ds["surf"],
                     ds["velx"], ds["vely"], ds["dhdt"], ds["smb"],
                     ds["cond_bed"], ds["data_mask"], ds["grounded"], res)
    chain.set_update_region(True, region)
    chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    lo, hi = sc["blocks"]
    chain.configure_randfield(
        RandFieldConfig(10e3, 50e3, 10e3, 50e3, 50, 150, 0.0,
                        "Matern", True, 1.3),
        BlockMenuConfig(lo, hi, lo, hi, steps=5),
        WeightConfig(2, 0, 6, 1, 30e3, res))
    chain.set_update_type("CRF_weight")

    sampler = MultiChainSampler(chain, n_chains=n_chains, device=device)
    states = sampler.init(seeds=2026)
    synchronize(device)
    t0 = time.time()
    seg_losses, seg_accs = [], []
    for _ in range(crf_iters // seg):
        states, traces = sampler.run_segment(states, seg)
        seg_losses.append(float(traces["loss"][-1].mean()))
        seg_accs.append(float(traces["step"].float().mean()))
    synchronize(device)
    dt = time.time() - t0
    crf_rate = crf_iters * n_chains / dt
    print(f"[validate] CRF: {crf_iters} iters x {n_chains} chains in "
          f"{dt:.0f}s ({crf_rate:,.0f} chain-it/s); "
          f"loss {seg_losses[0]:.3e} -> {seg_losses[-1]:.3e} "
          f"(baseline {baseline:.3e})", flush=True)

    # 1. segment-over-segment decay, approaching the baseline from above
    decays = sum(b <= a for a, b in zip(seg_losses, seg_losses[1:]))
    check("CRF loss decays", decays >= 0.9 * (len(seg_losses) - 1),
          f"({decays}/{len(seg_losses) - 1} segments)")

    # 2. acceptance band (reference-observed band, SURVEY §6)
    acc = float(np.mean(seg_accs))
    check("CRF acceptance in (0.05, 0.95)", 0.05 < acc < 0.95,
          f"({acc:.3f})")

    # SGS refinement stage (reference SSC driver: detrend + transform)
    lsc_bed = states.bed[0].cpu().numpy()
    del sampler, states, traces
    trend = gaussian_filter(lsc_bed, sigma=10).astype(np.float32)
    nst = NormalScoreTransform.fit((lsc_bed - trend).ravel(), 1000)
    ssc = ChainSGS(ds["xx"], ds["yy"], lsc_bed, ds["surf"], ds["velx"],
                   ds["vely"], ds["dhdt"], ds["smb"], ds["cond_bed"],
                   ds["data_mask"], ds["grounded"], res)
    ssc.set_update_region(True, region)
    ssc.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    ssc.set_trend(trend, detrend_map=True)
    ssc.set_normal_transformation(nst, do_transform=True)
    ssc.set_variogram("Matern", 10e3, 1.0, 0.0, vario_smoothness=1.3)
    ssc.set_sgs_param(48, 30e3)
    ssc.set_block_sizes(5, 20, 5, 20)
    s2 = MultiChainSampler(ssc, n_chains=n_chains, device=device)
    st2 = s2.init(seeds=7)
    loss_a = float(st2.loss_mc.mean())
    synchronize(device)
    t0 = time.time()
    for _ in range(max(1, sgs_iters // seg)):
        st2, tr2 = s2.run_segment(st2, seg)
    synchronize(device)
    dt = time.time() - t0
    sgs_rate = sgs_iters * n_chains / dt
    loss_b = float(st2.loss_mc.mean())
    acc2 = float(tr2["step"].float().mean())
    print(f"[validate] SGS: {sgs_iters} iters x {n_chains} chains in "
          f"{dt:.0f}s ({sgs_rate:,.0f} chain-it/s)", flush=True)
    check("SGS refinement decreases loss", loss_b < loss_a,
          f"({loss_a:.3e} -> {loss_b:.3e}, acc {acc2:.3f})")
    check("SGS acceptance in (0.05, 0.99)", 0.05 < acc2 < 0.99,
          f"({acc2:.3f})")
    # SGS state lives in DETRENDED space — restore the trend (as
    # ChainSGS.run does for its outputs)
    final_beds = s2.full_bed(st2).cpu().numpy()
    check("pipeline state finite", bool(np.isfinite(final_beds).all()))

    # 3. pipeline closes the baseline gap
    gap0 = seg_losses[0] - baseline
    gap1 = loss_b - baseline
    check("pipeline closes >=90% of the baseline gap", gap1 < 0.1 * gap0,
          f"(gap {gap0:.3e} -> {gap1:.3e})")

    # 4. RMSE to truth improves after the pipeline (posterior mean)
    rmse0 = float(np.sqrt(np.mean(
        (ds["initial_bed"][rmask] - ds["bed_true"][rmask]) ** 2)))
    rmse1 = float(np.sqrt(np.mean(
        (final_beds.mean(0)[rmask] - ds["bed_true"][rmask]) ** 2)))
    check("posterior-mean RMSE < initial RMSE", rmse1 < rmse0,
          f"({rmse0:.1f} -> {rmse1:.1f} m)")

    # 5. variogram reproduction at small lags (T3 cells 72-74)
    m = ds["data_mask"] & rmask
    coords = np.column_stack([ds["xx"][m], ds["yy"][m]])
    bins_d, gamma_d, _ = experimental_variogram(
        coords, ds["cond_bed"][m], maxlag=30e3, n_lags=20, max_points=2000)
    bins_p, gamma_p, _ = experimental_variogram(
        coords, final_beds[0][m], maxlag=30e3, n_lags=20, max_points=2000)
    sel = np.isfinite(gamma_d) & np.isfinite(gamma_p) & (bins_d < 20e3)
    ratio = gamma_p[sel] / np.maximum(gamma_d[sel], 1e-9)
    check("variogram reproduced within 3x band at lags < 20 km",
          bool(np.all((ratio > 1 / 3) & (ratio < 3))),
          f"(ratio range {ratio.min():.2f}-{ratio.max():.2f})")

    # machine-readable summary: the checks' statistics, the device and
    # each stage's rate (tests/test_torch_examples_validation.py reads it)
    stats = {
        "crf_acceptance": acc, "sgs_acceptance": acc2,
        "gap_initial": gap0, "gap_final": gap1,
        "rmse_initial": rmse0, "rmse_posterior_mean": rmse1,
        "variogram_ratio_min": float(ratio.min()),
        "variogram_ratio_max": float(ratio.max()),
        "device": device_name(device),
        "crf_chain_it_s": crf_rate, "sgs_chain_it_s": sgs_rate,
    }
    print("[validate] STATS " + json.dumps(stats))
    print(f"[validate] {'ALL PASS' if not failures else 'FAILURES: ' + str(failures)}",
          flush=True)
    return {"stats": stats, "failures": failures, "grid": H,
            "n_chains": n_chains, "crf_iters": crf_iters,
            "sgs_iters": sgs_iters}


if __name__ == "__main__":
    sys.exit(run_main(main))
