"""T2 equivalent on the PyTorch port — variogram analysis and SGS initial beds.

Reference workflow: T2_StatisticalAnalysis.ipynb — normal-score transform of
the conditioning bed, experimental variogram + model fits, and a set of
sequential-Gaussian-simulation initial beds bounded below the ice surface
(cells 13, 20-22; consumed per-chain by the large-scale drivers).  The
fits run on the host; the SGS beds on the card.

Run: ``python examples/torch_port/02_statistical_analysis.py [--device cpu]``
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

from mcmc_tpu_torch.geostats import (  # noqa: E402
    fit_variogram,
    generate_initial_beds,
)
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    quick = quick_mode()
    hw = 64 if quick else 96
    ds = make_dataset(H=hw, W=hw)

    # --- variogram of the (transformed) conditioning bed -------------------
    m = ds["data_mask"]
    coords = np.column_stack([ds["xx"][m], ds["yy"][m]])
    nst, transformed, params, _ = fit_variogram(
        ds["cond_bed"][m], coords,
        maxlag=12e3 if quick else 40e3, n_lags=24 if quick else 40)
    names = ["gaussian", "exponential", "spherical", "matern"]
    for n, p in zip(names, params):
        print(f"{n:12s} range={p[0]:9.0f}  sill={p[1]:6.3f}  "
              + (f"s={p[2]:4.2f}" if n == "matern" else ""))

    # --- SGS initial beds, bounded below the surface ------------------------
    vario = dict(azimuth=0.0, nugget=0.0,
                 major_range=params[1][0], minor_range=params[1][0],
                 sill=params[1][1], vtype="Exponential")
    t0 = time.time()
    beds = generate_initial_beds(
        ds["xx"], ds["yy"], ds["cond_bed"], vario, surf=ds["surf"],
        n_beds=1 if quick else 2, radius=30e3, num_points=16, seed=11,
        chunk=128, half_window=16 if quick else 24, device=device)
    seconds = time.time() - t0
    print(f"{len(beds)} SGS initial beds in {seconds:.1f}s")
    above = []
    for i, b in enumerate(beds):
        viol = int(np.sum((ds["surf"] - b) <= 0))
        above.append(viol)
        print(f"  bed {i}: std {b.std():7.1f} m, cells above surface: {viol}")
        np.save(out / f"sgs_initial_bed_{i}.npy", b)
    print("wrote", out)
    require(all(np.isfinite(b).all() for b in beds), "a non-finite SGS bed")
    require(not any(above), "SGS bed cells above the ice surface")
    return {"device": str(device),
            "fits": {n: [float(v) for v in p] for n, p in zip(names, params)},
            "n_beds": len(beds), "seconds": seconds,
            "cells_above_surface": above}


if __name__ == "__main__":
    sys.exit(run_main(main))
