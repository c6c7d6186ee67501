"""Declarative experiment workflow on the PyTorch port — the CLI the
reference never had.

The reference configures production runs as ``__main__`` constant blocks
inside its driver scripts (largeScaleChain_multiprocessing.py:451-646);
re-running an experiment means editing source. Here the same experiment is
a JSON (or TOML) file, the JAX package's schema, run by ``python -m
mcmc_tpu_torch <config>``, and re-invoking the config resumes from its
checkpoints.

This example writes the dataset archive + config file and invokes the CLI
twice: once to sample, once more with a larger ``n_iter`` to demonstrate
resume (the first run's iterations are reused bitwise, not recomputed).
The CLI runs on the card; ``--device cpu`` here passes ``--device cpu`` on.

Run: ``python examples/torch_port/08_cli_experiment.py [--device cpu]``
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    example_out,
    make_dataset,
    quick_mode,
    require,
    run_main,
)

from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    quick = quick_mode()
    hw = 64 if quick else 256
    ds = make_dataset(H=hw, W=hw)

    np.savez(out / "experiment_dataset.npz",
             xx=ds["xx"], yy=ds["yy"], initial_bed=ds["initial_bed"],
             surf=ds["surf"], velx=ds["velx"], vely=ds["vely"],
             dhdt=ds["dhdt"], smb=ds["smb"], cond_bed=ds["cond_bed"],
             data_mask=ds["data_mask"], grounded=ds["grounded"],
             highvel_mask=ds["highvel_mask"], resolution=ds["resolution"])

    n1, n2 = (100, 200) if quick else (2000, 4000)
    cfg = {
        "family": "crf",
        "dataset": "experiment_dataset.npz",
        "update_region": {"in_region": True, "mask": "highvel_mask"},
        "loss": {"sigma_mc": 5.0, "mass_conv_in_region": True},
        "crf": {
            "update_type": "CRF_weight",
            "randfield": {"range_min_x": 5e3, "range_max_x": 50e3,
                          "range_min_y": 5e3, "range_max_y": 50e3,
                          "scale_min": 50.0, "scale_max": 150.0,
                          "nugget_max": 0.0, "model_name": "Matern",
                          "isotropic": True, "smoothness": 1.3},
            "blocks": ({"min_block_x": 12, "max_block_x": 24,
                        "min_block_y": 12, "max_block_y": 24, "steps": 3}
                       if quick else
                       {"min_block_x": 50, "max_block_x": 80,
                        "min_block_y": 50, "max_block_y": 80, "steps": 5}),
            "weight": {"L": 2, "x0": 0, "k": 6, "offset": 1,
                       "max_dist": 10e3 if quick else 30e3},
        },
        "farm": {"n_chains": 2 if quick else 8, "n_iter": n1,
                 "rng_seeds": 2026, "output_path": "cli_run",
                 "segment_size": 50 if quick else 1000},
        "save": {"final_beds": "cli_final_beds.npy",
                 "histories": "cli_histories.npz"},
    }
    cfg_path = out / "experiment.json"
    cfg_path.write_text(json.dumps(cfg, indent=2))

    def invoke():
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "mcmc_tpu_torch", str(cfg_path),
             "--quiet", "--device", device.type],
            capture_output=True, text=True, cwd=str(ROOT))
        if res.returncode != 0:
            raise RuntimeError(res.stderr[-2000:])
        return time.time() - t0

    print(f"run 1: {cfg['farm']['n_chains']} chains x {n1} iters")
    sec1 = invoke()
    with np.load(out / "cli_histories.npz") as h:
        loss1 = h["loss"].copy()
    print(f"  loss {loss1[:, 0].mean():.4e} -> {loss1[:, -1].mean():.4e} "
          f"({sec1:.1f} s)")

    cfg["farm"]["n_iter"] = n2
    cfg_path.write_text(json.dumps(cfg, indent=2))
    print(f"run 2 (same config, n_iter={n2}): resumes from run 1")
    sec2 = invoke()
    with np.load(out / "cli_histories.npz") as h:
        loss2 = h["loss"]
    require(loss2.shape[1] == n2, f"run 2's trace has {loss2.shape[1]} rows")
    reused = bool(np.array_equal(loss2[:, : n1], loss1))
    require(reused, "resume must reuse run 1")
    print(f"  loss -> {loss2[:, -1].mean():.4e} "
          f"(first {n1} iters bitwise reused; {sec2:.1f} s)")
    print("final beds:", out / "cli_final_beds.npy")
    return {"device": str(device), "n_iter": (n1, n2), "grid": hw,
            "seconds": (sec1, sec2), "bitwise_reused": reused,
            "loss_final": float(loss2[:, -1].mean())}


if __name__ == "__main__":
    sys.exit(run_main(main))
