"""T1 equivalent on the PyTorch port — compile a gridded per-glacier dataset.

Reference workflow: T1_LoadData.ipynb — load RACMO smb, dhdt, MEaSUREs
velocity, BedMachine, Bedmap, radar picks; regrid everything onto a common
EPSG:3031 grid; derive the grounded-ice and high-velocity masks; write one
gridded CSV.

With the raw archives available this script exercises the real loaders
(``mcmc_tpu_torch.data``); without them it demonstrates the same pipeline
stages on synthetic data so it always runs.  The data layer is host code
(numpy, scipy, pandas); the device is resolved first all the same, so the
workflow stops here on a machine without the card it would sample on.

Run: ``python examples/torch_port/01_load_data.py [--device cpu]``
"""

import sys
from pathlib import Path

import numpy as np
import pandas as pd

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    example_out,
    make_dataset,
    quick_mode,
    require,
    run_main,
)

from mcmc_tpu_torch.data import (  # noqa: E402
    get_highvel_boundary,
    get_mass_conservation_residual,
    grid_data,
)
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    # --- stage 1: raw loaders (plug real paths here) -----------------------
    # smb = load_smb_racmo("RACMO_yearly.nc", xx, yy, res)
    # dhdt = load_dhdt("nsidc0782.nc", xx, yy, res)
    # velx, vely, ex, ey = load_vel_measures("measures.nc", xx, yy, res)
    # bm_mask, bm_source, bm_bed, bm_surf, bm_err = load_bedmachine(...)
    # radar, excluded = load_radar("radar_csvs/", "compiled.csv")
    hw = 64 if quick_mode() else 128
    ds = make_dataset(H=hw, W=hw)
    print("synthetic stand-in dataset:", ds["xx"].shape)

    # --- stage 2: grid sparse picks (works on both real + synthetic) -------
    picks = pd.DataFrame({
        "x": ds["xx"][ds["data_mask"]],
        "y": ds["yy"][ds["data_mask"]],
        "bed": ds["cond_bed"][ds["data_mask"]],
    })
    df_grid, grid_matrix, rows, cols = grid_data(
        picks, "x", "y", "bed", ds["resolution"],
        ds["xx"].min(), ds["xx"].max(), ds["yy"].min(), ds["yy"].max())
    n_data = int(np.isfinite(grid_matrix).sum())
    print(f"gridded radar picks: {rows}x{cols}, {n_data} cells with data")

    # --- stage 3: masks ----------------------------------------------------
    highvel = get_highvel_boundary(
        ds["velx"], ds["vely"], velmag_threshold=150.0,
        grounded_ice_mask=ds["grounded"], ocean_mask=np.zeros_like(ds["grounded"]),
        distance_max=10 * ds["resolution"], xx=ds["xx"], yy=ds["yy"])
    print("high-velocity mask cells:", int(highvel.sum()))

    # --- stage 4: QC sanity (the reference's T1 checklist) ------------------
    res = get_mass_conservation_residual(
        ds["bed_true"], ds["surf"], ds["velx"], ds["vely"], ds["dhdt"],
        ds["smb"], ds["resolution"])
    rms = float(np.sqrt(np.mean(res**2)))
    above_surface = int(np.sum(ds["cond_bed"] > ds["surf"]))
    print(f"true-bed residual rms: {rms:.3f} m/yr "
          f"(should be ~0); bed>surface picks: {above_surface} (should be 0)")
    require(above_surface == 0, "radar picks above the ice surface")

    # --- stage 5: write the compiled per-glacier table ----------------------
    table = pd.DataFrame({
        "x": ds["xx"].ravel(), "y": ds["yy"].ravel(),
        "surf": ds["surf"].ravel(), "bed": ds["cond_bed"].ravel(),
        "velx": ds["velx"].ravel(), "vely": ds["vely"].ravel(),
        "smb": ds["smb"].ravel(), "dhdt": ds["dhdt"].ravel(),
        "highvel_mask": highvel.ravel().astype(int),
        "grounded_mask": ds["grounded"].ravel().astype(int),
    })
    out_csv = out / "GlacierDataGridded.csv"
    table.to_csv(out_csv, index=False)
    print("wrote", out_csv)
    return {"device": str(device), "csv": str(out_csv), "grid": (rows, cols),
            "data_cells": n_data, "highvel_cells": int(highvel.sum()),
            "residual_rms": rms, "above_surface": above_surface}


if __name__ == "__main__":
    sys.exit(run_main(main))
