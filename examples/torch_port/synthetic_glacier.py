"""Shared synthetic glacier dataset for the PyTorch port's example workflows.

The port's own copy of ``examples/synthetic_glacier.py``: the same
``make_dataset`` (so both packages' examples sample the same glacier), the
same ``MCMC_TPU_EXAMPLE_QUICK`` / ``MCMC_TPU_EXAMPLE_OUT`` switches, and the
examples' command line.  It stands in for the reference's per-glacier
gridded CSV (T1 output: columns x, y, surf, bed, velx, vely, smb, dhdt,
highvel_mask, ... — reference T1_LoadData.ipynb cells 64-65) so every
example runs end-to-end without the restricted-access raw archives.  Swap
``make_dataset`` for ``mcmc_tpu_torch.data`` loaders + ``grid_data`` when
you have BedMachine / MEaSUREs / RACMO / Bedmap files.

Every example runs on the card unless asked for the CPU
(``--device cpu``); on a machine without a card it raises rather than
moving to the CPU by itself.
"""

import argparse
import os
from pathlib import Path

import numpy as np

DATA_OUT = Path(__file__).resolve().with_name("data_out")


def quick_mode() -> bool:
    """CI smoke switch: ``MCMC_TPU_EXAMPLE_QUICK=1`` makes every example
    shrink its problem size / iteration count so the full 01->05 workflow
    runs inside the test budget (tests/test_torch_examples.py)."""
    return os.environ.get("MCMC_TPU_EXAMPLE_QUICK", "") not in ("", "0")


def example_out() -> Path:
    """The examples' output directory (``examples/torch_port/data_out``),
    overridable via ``MCMC_TPU_EXAMPLE_OUT`` so smokes write to a temp dir
    instead of the repo tree.  Read when an example runs, not when it is
    imported."""
    p = Path(os.environ.get("MCMC_TPU_EXAMPLE_OUT", DATA_OUT))
    p.mkdir(parents=True, exist_ok=True)
    return p


def require(cond, what: str) -> None:
    """An example's check: raise naming ``what`` when ``cond`` fails."""
    if not cond:
        raise AssertionError(what)


def synchronize(device) -> None:
    """Wait for the card's queued work (a host clock around device work
    measures the enqueue otherwise)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    """The card's name, or ``cpu``."""
    import torch

    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run_main(main) -> int:
    """An example's ``__main__``: ``--device`` (the card unless asked for
    the CPU), then ``main(device)``; exit status 1 when the result lists
    failed checks (a failed ``require`` raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, the card; 'cpu' "
                         "runs the kernels' plain versions)")
    result = main(device=ap.parse_args().device)
    return 1 if isinstance(result, dict) and result.get("failures") else 0


def make_dataset(H=256, W=256, resolution=500.0, seed=0, data_frac=0.01):
    rng = np.random.default_rng(seed)
    x = np.arange(W) * resolution
    y = np.arange(H) * resolution
    xx, yy = np.meshgrid(x, y)
    Lx, Ly = W * resolution, H * resolution

    # "true" bed: smooth ridges + a deep trough under the ice stream
    bed_true = (250 * np.sin(2 * np.pi * xx / (Lx / 2))
                * np.cos(2 * np.pi * yy / (Ly / 3))
                - 350 - 300 * np.exp(-((yy - Ly / 2) / (Ly / 6)) ** 2))
    surf = 1600 + 0.4e-3 * xx + 100 * np.sin(2 * np.pi * yy / Ly)
    velx = 120 + 90 * np.exp(-((yy - Ly / 2) / (Ly / 5)) ** 2)
    vely = 25 * np.cos(2 * np.pi * xx / Lx)

    # smb consistent with the true bed (so its residual is ~0) + noise floor
    thick = surf - bed_true
    smb = (np.gradient(velx * thick, resolution, axis=1)
           + np.gradient(vely * thick, resolution, axis=0))
    dhdt = np.zeros_like(xx)

    grounded = np.ones((H, W), bool)
    highvel_mask = np.zeros((H, W), np.float32)
    highvel_mask[H // 6: 5 * H // 6, W // 6: 5 * W // 6] = 1

    # sparse radar flight lines
    data_mask = rng.random((H, W)) < data_frac
    for r in range(0, H, 32):           # along-track lines
        data_mask[r, ::4] = True
    cond_bed = np.where(data_mask, bed_true + rng.normal(0, 10, (H, W)), np.nan)

    initial_bed = np.minimum(bed_true + rng.normal(0, 120, (H, W)),
                             surf - 5.0)
    return dict(xx=xx, yy=yy, bed_true=bed_true, surf=surf, velx=velx,
                vely=vely, dhdt=dhdt, smb=smb, grounded=grounded,
                highvel_mask=highvel_mask, data_mask=data_mask,
                cond_bed=cond_bed, initial_bed=initial_bed,
                resolution=resolution)
