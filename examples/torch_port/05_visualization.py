"""Visualization equivalent on the PyTorch port — posterior summaries and
diagnostics plots.

Reference workflow: visualization.ipynb — stitch per-seed results, plot
loss/acceptance traces, posterior mean/std maps, residual maps, and
variogram reproduction.  Reads example 03's checkpoint (its state onto the
device), renders to PNG (Agg backend) and prints the rank-normalized
diagnostics.  matplotlib is optional: where it is not installed the
figure is left out, said so, and the numeric summary still runs.

Run: ``python examples/torch_port/05_visualization.py [--device cpu]``
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    example_out,
    make_dataset,
    require,
    run_main,
)

from mcmc_tpu_torch.data import get_mass_conservation_residual  # noqa: E402
from mcmc_tpu_torch.geostats import experimental_variogram  # noqa: E402
from mcmc_tpu_torch.io import CheckpointManager  # noqa: E402
from mcmc_tpu_torch.parallel import (  # noqa: E402
    ess_bulk,
    ess_tail,
    rank_normalized_rhat,
)
from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402


def draw_summary(path, cum, beds, hist, ds):
    """The 2 x 3 summary figure (traces, posterior maps, residual,
    variogram reproduction) written to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    ax = axes[0, 0]
    for i in range(min(beds.shape[0], 8)):
        ax.plot(hist["loss"][i], lw=0.8)
    ax.set_title(f"loss traces ({cum} iterations)")
    ax.set_yscale("log")

    ax = axes[0, 1]
    acc = np.cumsum(hist["step"], axis=1) / np.arange(1, hist["step"].shape[1] + 1)
    for i in range(min(beds.shape[0], 8)):
        ax.plot(acc[i], lw=0.8)
    ax.set_title("running acceptance rate")

    ax = axes[0, 2]
    im = ax.imshow(beds.mean(0), cmap="gist_earth")
    plt.colorbar(im, ax=ax)
    ax.set_title("posterior mean bed")

    ax = axes[1, 0]
    im = ax.imshow(beds.std(0), cmap="magma")
    plt.colorbar(im, ax=ax)
    ax.set_title("posterior std (chain spread)")

    ax = axes[1, 1]
    res = get_mass_conservation_residual(beds[0], ds["surf"], ds["velx"],
                                         ds["vely"], ds["dhdt"], ds["smb"],
                                         ds["resolution"])
    im = ax.imshow(res, cmap="RdBu", vmin=-20, vmax=20)
    plt.colorbar(im, ax=ax)
    ax.set_title("mass-conservation residual (chain 0)")

    ax = axes[1, 2]
    m = ds["data_mask"]
    coords = np.column_stack([ds["xx"][m], ds["yy"][m]])
    for vals, label in ((ds["cond_bed"][m], "radar data"),
                        (beds[0][m], "posterior sample")):
        bins, gamma, _ = experimental_variogram(coords, vals, maxlag=30e3,
                                                n_lags=25, max_points=1500)
        ax.plot(bins / 1e3, gamma, "o-", ms=3, label=label)
    ax.set_xlabel("lag [km]")
    ax.set_ylabel("semivariance")
    ax.set_title("variogram reproduction")
    ax.legend()

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    run_dir = out / "lsc_run" / "LargeScaleChain"
    ck = (CheckpointManager(run_dir).load(device=device)
          if run_dir.exists() else None)
    require(ck is not None, "no checkpoint found — run "
            "examples/torch_port/03_large_scale_chain.py first")
    cum, states, hist, _ = ck
    beds = states.bed.cpu().numpy()
    ds = make_dataset(H=beds.shape[-2], W=beds.shape[-1])
    hist = {k: np.asarray(v) for k, v in hist.items()}
    print(f"checkpoint: {cum} iterations x {beds.shape[0]} chains, state "
          f"on {states.bed.device}")

    figure = None
    if importlib.util.find_spec("matplotlib") is None:
        print("summary.png not drawn: matplotlib is not installed")
    else:
        figure = out / "summary.png"
        draw_summary(figure, cum, beds, hist, ds)
        print("wrote", figure)

    # numeric convergence summary (needs >= 2 chains and a few samples)
    loss = hist["loss"]
    diag = {}
    if loss.shape[0] >= 2 and loss.shape[1] >= 8:
        post = loss[:, loss.shape[1] // 4:]  # drop the first quarter
        diag = {"rank_normalized_rhat": float(rank_normalized_rhat(
                    post, device=device)),
                "ess_bulk": float(ess_bulk(post, device=device)),
                "ess_tail": float(ess_tail(post, device=device))}
        print(f"rank-normalized split R-hat (loss): "
              f"{diag['rank_normalized_rhat']:.4f} (flag > 1.01)")
        print(f"ESS bulk / tail (loss): {diag['ess_bulk']:.1f} / "
              f"{diag['ess_tail']:.1f}")
        require(all(np.isfinite(v) for v in diag.values()),
                "non-finite diagnostics")
    require(np.isfinite(beds).all(), "non-finite checkpointed beds")
    return {"device": str(device), "iterations": cum,
            "n_chains": beds.shape[0],
            "figure": None if figure is None else str(figure), **diag}


if __name__ == "__main__":
    sys.exit(run_main(main))
