"""Native production grids on the PyTorch port — no padding needed.

The reference's T1 production domain is 900x900 cells
(T1_LoadData.ipynb cells 9-11: -1600250..-1150250 x -650250..-200250 at
500 m).  The JAX package pads such a grid to an aligned shape for its TPU
kernel (``examples/07_unaligned_production_grid.py``).  The port's CUDA
kernels take any H x W, so it samples the 900x900 domain as it is: on the
card (the default) this example runs the true 900x900 grid, and with
``--device cpu`` the JAX example's 180x225 stand-in (unaligned in both
dimensions too).  It shows the three things a user must know:

  1. traces and the state's beds come back on the true domain — there is
     nothing to unpad;
  2. cells outside the update region never move;
  3. a checkpoint remembers its grid: resuming it with a sampler on
     another grid raises a clear ValueError instead of a shape crash.

Run: ``python examples/torch_port/07_native_production_grid.py [--device cpu]``
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    make_dataset,
    require,
    run_main,
)

from mcmc_tpu_torch.io import run_with_checkpointing  # noqa: E402
from mcmc_tpu_torch.models import ChainCRF  # noqa: E402
from mcmc_tpu_torch.parallel import MultiChainSampler  # noqa: E402
from mcmc_tpu_torch.utils.config import (  # noqa: E402
    BlockMenuConfig,
    RandFieldConfig,
    WeightConfig,
)
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402

# the reference's 900x900 production grid on the card; on the CPU the JAX
# example's 1/5-linear-scale stand-in (180 % 8 = 4, 225 % 128 = 97)
GRIDS = {"cuda": (900, 900), "cpu": (180, 225)}
N_CHAINS = 4
N_ITER = 400
SEGMENT = 100


def dataset(H, W):
    """The synthetic glacier with the update region kept off the east and
    south edges, as in the JAX example (the production high-velocity
    region is interior)."""
    ds = make_dataset(H=H, W=W)
    region = np.asarray(ds["highvel_mask"], np.float32).copy()
    region[-1, :] = 0.0
    region[:, -1] = 0.0
    ds["highvel_mask"] = region
    return ds


def build_chain(ds):
    res = ds["resolution"]
    chain = ChainCRF(ds["xx"], ds["yy"], ds["initial_bed"], ds["surf"],
                     ds["velx"], ds["vely"], ds["dhdt"], ds["smb"],
                     ds["cond_bed"], ds["data_mask"], ds["grounded"], res)
    chain.set_update_region(True, ds["highvel_mask"])
    chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    chain.configure_randfield(
        RandFieldConfig(10e3, 50e3, 10e3, 50e3, scale_min=50, scale_max=150,
                        nugget_max=0.0, model_name="Matern", isotropic=True,
                        smoothness=1.3),
        BlockMenuConfig(20, 32, 20, 32, steps=3),
        WeightConfig(L=2, x0=0, k=6, offset=1, max_dist=30e3,
                     resolution=res))
    chain.set_update_type("CRF_weight")
    chain.set_crf_data_weight()
    return chain


def main(device=None):
    device = resolve_device(device)
    H, W = GRIDS[device.type]
    ds = dataset(H, W)
    sampler = MultiChainSampler(build_chain(ds), n_chains=N_CHAINS,
                                device=device)
    print(f"[07] {H}x{W} domain sampled as it is on {device}: compute grid "
          f"{sampler.static.H}x{sampler.static.W}")
    require((sampler.static.H, sampler.static.W) == (H, W),
            "the compute grid is not the true domain")

    with tempfile.TemporaryDirectory() as tmp:
        ckdir = Path(tmp) / "ck"
        t0 = time.time()
        states, hist, done = run_with_checkpointing(
            sampler, N_ITER, ckdir, seeds=42, segment_size=SEGMENT,
            progress=False)
        seconds = time.time() - t0
        loss = hist["loss"]
        acc = float(hist["step"][:, 1:].mean())
        print(f"[07] {done} iters x {N_CHAINS} chains in {seconds:.1f} s: "
              f"loss {loss[:, 0].mean():.4e} -> {loss[:, -1].mean():.4e}, "
              f"acc {acc:.3f}")
        require(loss[:, -1].mean() < loss[:, 0].mean(), "loss must decay")

        # 1. traces and state are on the true domain
        final_beds = states.bed.cpu().numpy()
        require(loss.shape == (N_CHAINS, N_ITER),
                f"loss trace shape {loss.shape}")
        require(final_beds.shape == (N_CHAINS, H, W),
                f"state beds shape {final_beds.shape}")
        # 2. cells outside the update region never move
        outside = ds["highvel_mask"] == 0
        init = np.asarray(sampler.chain.initial_bed, np.float32)
        require(np.array_equal(final_beds[:, outside],
                               np.broadcast_to(init[outside],
                                               (N_CHAINS, int(outside.sum())))),
                "the bed moved outside the update region")
        print(f"[07] traces {loss.shape} and beds {final_beds.shape} on the "
              f"true domain; {int(outside.sum())} cells outside the region "
              "bitwise untouched")

        # 3. a checkpoint on another grid is refused with a clear error
        other = MultiChainSampler(build_chain(dataset(H - 4, W)),
                                  n_chains=N_CHAINS, device=device)
        try:
            run_with_checkpointing(other, 2 * N_ITER, ckdir, seeds=42,
                                   segment_size=SEGMENT, progress=False)
        except ValueError as e:
            require("checkpoint state grid" in str(e), f"raised {e}")
            rejected = str(e).splitlines()[0]
            print("[07] resume on another grid correctly rejected:")
            print(f"     {rejected}")
        else:
            raise AssertionError("a resume on another grid should raise")

        stats = {"grid": [H, W], "loss_initial": float(loss[:, 0].mean()),
                 "loss_final": float(loss[:, -1].mean()),
                 "acceptance": acc, "seconds": seconds}
        print("[07] STATS " + json.dumps(stats))

    print("[07] PASS")
    return {"device": str(device), "stats": stats, "rejected": rejected}


if __name__ == "__main__":
    sys.exit(run_main(main))
