"""Config-file experiment runner — ``python -m mcmc_tpu_torch <config>``.

PyTorch counterpart of ``mcmc_tpu/cli.py``, with the same JSON / TOML
schema, ``--dry-run``, ``--info`` and ``--quiet``, plus ``--device``: the
farm runs on the card (``cuda``, the default) unless ``--device cpu`` asks
for the CPU (the JAX package picks its device with ``JAX_PLATFORMS``).
Launched by ``torchrun --nproc-per-node N -m mcmc_tpu_torch cfg.json`` it
runs the same config as N ranks, one card each: ``main`` joins the run
(``parallel/distributed.initialize_distributed``) before it builds
anything, the farm is sharded over the ranks, and rank 0 alone writes the
saved files and prints the summary.  Re-invoking resumes, at any number
of ranks.  ``--backend gloo --card 0`` puts every rank on card 0 (two
ranks on a one-card machine).

The reference has no CLI (SURVEY §1 L5): experiments live as ``__main__``
constant blocks inside the driver scripts
(reference largeScaleChain_multiprocessing.py:451-646 for the large-scale
chain, smallScaleChain_multiprocessing.py:403-585 for the small-scale one)
plus a phantom ``config`` module the GPU driver imports
(largeScaleChain_multiprocessing_GPU.py:19).  This module turns those
experiment blocks into a declarative config file (JSON or TOML) with one
section per reference setter, validated through the typed dataclasses in
``utils.config``, and runs the corresponding chain farm with
checkpoint/resume — re-invoking the same config resumes from the run
directory, exactly like re-running a reference driver script.

Config schema (JSON shown; TOML works identically)::

    {
      "family": "crf",                  // "crf" (T3) or "sgs" (T4)
      "dataset": "dataset.npz",         // arrays: xx yy initial_bed surf velx
                                        // vely dhdt smb cond_bed data_mask
                                        // grounded [resolution] [region] ...
      "update_region": {"in_region": true, "mask": "region"},
      "loss":   {"sigma_mc": 5.0, "mass_conv_in_region": true},
      "crf": {
        "update_type": "CRF_weight",    // or "RF"
        "randfield": {"range_min_x": 10e3, ..., "model_name": "Matern",
                       "smoothness": 1.3},
        "blocks": {"min_block_x": 50, "max_block_x": 80,
                    "min_block_y": 50, "max_block_y": 80, "steps": 5},
        "weight": {"L": 2, "x0": 0, "k": 6, "offset": 1, "max_dist": 30e3}
      },
      "sgs": {
        "variogram": {"vtype": "Matern", "range": 10e3, "sill": 1.0,
                       "nugget": 0.0, "smoothness": 1.2},
        "params": {"num_neighbors": 48, "search_radius": 30e3},
        "blocks": {"min_x": 5, "max_x": 20, "min_y": 5, "max_y": 20},
        "trend": {"gaussian_sigma": 10.0},   // or {"key": "<dataset array>"}
        "normal_transform": {"n_quantiles": 1000}
      },
      "farm": {"n_chains": 8, "n_iter": 4000, "rng_seeds": 2026,
                "output_path": "runs/exp1", "segment_size": 1000,
                "async_checkpoints": false},
      "save": {"final_beds": "beds.npy", "histories": "hist.npz"}
    }

Only the sections for the selected family are required.  ``sample_points``
(probe coordinates, reference set_sample_points_locations) and
``loss.diff_func`` (radar-misfit term) are optional extensions.
``farm.rng_seeds`` is an int master seed or, as in the JAX package's
configs, a list of per-chain seeds (``"rng_seeds": [5, 6]``, at least
``n_chains`` of them): one stream a chain, chain i's draws depending on
its own seed alone (``utils/rng.PerChainStreams``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from .utils.config import BlockMenuConfig, RandFieldConfig, WeightConfig

_DATASET_KEYS = ("xx", "yy", "initial_bed", "surf", "velx", "vely",
                 "dhdt", "smb", "cond_bed", "data_mask", "grounded")


def load_config(path) -> dict:
    """Load a JSON (.json) or TOML (.toml) experiment config."""
    path = Path(path)
    if path.suffix.lower() == ".toml":
        try:
            import tomllib
        except ModuleNotFoundError:  # Python 3.10: no stdlib tomllib
            raise RuntimeError(
                "TOML configs need Python 3.11+ (stdlib tomllib); "
                "use a JSON config on this interpreter") from None
        with open(path, "rb") as f:
            return tomllib.load(f)
    with open(path) as f:
        return json.load(f)


def _resolve(config_dir: Path, p) -> Path:
    """Resolve a config-relative path against the config file's directory."""
    p = Path(p)
    return p if p.is_absolute() else Path(config_dir) / p


def _require(section: dict, prefix: str, keys) -> None:
    missing = [k for k in keys if k not in section]
    if missing:
        raise ValueError(f"{prefix} is missing required keys: {missing}")


def load_dataset(path) -> dict:
    """Load the gridded problem arrays from an ``.npz`` archive.

    The archive is the CLI equivalent of the reference's per-glacier
    gridded CSV (T1_LoadData.ipynb cell 64-65) — the column set maps to
    same-named 2D arrays.  ``resolution`` may be stored as a 0-d array;
    if absent it is inferred from the x coordinate grid.
    """
    with np.load(Path(path), allow_pickle=False) as z:
        ds = {k: z[k] for k in z.files}
    missing = [k for k in _DATASET_KEYS if k not in ds]
    if missing:
        raise ValueError(f"dataset is missing required arrays: {missing}")
    if "resolution" in ds:
        ds["resolution"] = float(np.asarray(ds["resolution"]).reshape(()))
    else:
        ds["resolution"] = float(ds["xx"][0, 1] - ds["xx"][0, 0])
    return ds


def _region_mask(cfg: dict, ds: dict):
    reg = cfg.get("update_region", {})
    in_region = bool(reg.get("in_region", False))
    mask = None
    if in_region:
        key = reg.get("mask")
        if key is None:
            raise ValueError("update_region.in_region=true requires "
                             "update_region.mask (a dataset array name)")
        if key not in ds:
            raise ValueError(f"update_region.mask {key!r} not in dataset")
        mask = ds[key]
    return in_region, mask


def build_chain(cfg: dict, ds: dict):
    """Build + configure a ChainCRF / ChainSGS from the config sections."""
    family = cfg.get("family")
    if family not in ("crf", "sgs"):
        raise ValueError(f"family must be 'crf' or 'sgs', got {family!r}")

    args = [ds[k] for k in _DATASET_KEYS] + [ds["resolution"]]
    if family == "crf":
        from .models.chain_crf import ChainCRF

        chain = ChainCRF(*args)
    else:
        from .models.chain_sgs import ChainSGS

        chain = ChainSGS(*args)

    chain.set_update_region(*_region_mask(cfg, ds))

    loss = dict(cfg.get("loss", {}))
    if "sigma_mc" not in loss:
        raise ValueError("loss.sigma_mc is required")
    kw = dict(sigma_mc=loss["sigma_mc"],
              massConvInRegion=loss.get("mass_conv_in_region", True))
    if family == "crf" and loss.get("diff_func") is not None:
        kw.update(diff_func=loss["diff_func"],
                  sigma_data=loss.get("sigma_data", -1),
                  dataDiffInRegion=loss.get("data_diff_in_region", False))
    chain.set_loss_type(**kw)

    if cfg.get("sample_points"):
        chain.set_sample_points_locations(
            np.asarray(cfg["sample_points"], np.float64))

    if family == "crf":
        _configure_crf(chain, cfg, ds)
    else:
        _configure_sgs(chain, cfg, ds)
    return chain


def _configure_crf(chain, cfg: dict, ds: dict):
    sec = cfg.get("crf")
    if not sec:
        raise ValueError("family='crf' requires a 'crf' config section")
    for part in ("randfield", "blocks", "weight"):
        if part not in sec:
            raise ValueError(f"crf.{part} section is required")
    rf = RandFieldConfig(**sec["randfield"])
    blocks = BlockMenuConfig(**sec["blocks"])
    weight = dict(sec["weight"])
    weight.setdefault("resolution", ds["resolution"])
    chain.configure_randfield(rf, blocks, WeightConfig(**weight))
    chain.set_update_type(sec.get("update_type", "CRF_weight"))


def _configure_sgs(chain, cfg: dict, ds: dict):
    sec = cfg.get("sgs")
    if not sec:
        raise ValueError("family='sgs' requires an 'sgs' config section")
    for part in ("variogram", "params", "blocks"):
        if part not in sec:
            raise ValueError(f"sgs.{part} section is required")

    # trend: smoothed initial bed (the reference production recipe,
    # smallScaleChain_multiprocessing.py:486) or a dataset array
    trend_cfg = sec.get("trend")
    trend = None
    if trend_cfg:
        if "key" in trend_cfg:
            trend = np.asarray(ds[trend_cfg["key"]], np.float32)
        elif "gaussian_sigma" in trend_cfg:
            from scipy.ndimage import gaussian_filter

            trend = gaussian_filter(
                ds["initial_bed"], sigma=float(trend_cfg["gaussian_sigma"])
            ).astype(np.float32)
        else:
            raise ValueError("sgs.trend needs 'key' or 'gaussian_sigma'")
    chain.set_trend(trend, detrend_map=trend is not None)

    # normal-score transform fitted on the detrended initial bed
    # (reference smallScaleChain_multiprocessing.py:489-497)
    nst_cfg = sec.get("normal_transform")
    if nst_cfg is not None and nst_cfg.get("on", True):
        from .ops.transforms import NormalScoreTransform

        resid = (ds["initial_bed"] - (trend if trend is not None else 0.0))
        nst = NormalScoreTransform.fit(
            resid.ravel(), n_quantiles=int(nst_cfg.get("n_quantiles", 1000)))
        chain.set_normal_transformation(nst, do_transform=True)
    else:
        chain.set_normal_transformation(None, do_transform=False)

    v = dict(sec["variogram"])
    _require(v, "sgs.variogram", ("vtype", "range"))
    vrange = v.get("range")
    isotropic = bool(v.get("isotropic", not isinstance(vrange, (list, tuple))))
    chain.set_variogram(v["vtype"], vrange, v.get("sill", 1.0),
                        v.get("nugget", 0.0), isotropic=isotropic,
                        vario_smoothness=v.get("smoothness"),
                        vario_azimuth=v.get("azimuth"))
    p = sec["params"]
    _require(p, "sgs.params", ("num_neighbors", "search_radius"))
    chain.set_sgs_param(int(p["num_neighbors"]), float(p["search_radius"]),
                        sgs_rand_dropout_on=bool(p.get("rand_dropout_on", False)),
                        dropout_rate=float(p.get("dropout_rate", 0.0)))
    b = sec["blocks"]
    _require(b, "sgs.blocks", ("min_x", "max_x", "min_y", "max_y"))
    chain.set_block_sizes(b["min_x"], b["max_x"], b["min_y"], b["max_y"])


def _load_initial_beds(farm: dict, ds: dict, config_dir: Path):
    spec = farm.get("initial_beds")
    if spec is None:
        return None
    if isinstance(spec, str) and spec in ds:
        beds = ds[spec]
    else:
        beds = np.load(_resolve(config_dir, spec))
    n = int(farm.get("n_chains", 1))
    if beds.ndim == 3 and beds.shape[0] < n:
        raise ValueError(
            f"initial_beds has {beds.shape[0]} beds for n_chains={n}")
    return beds[:n] if beds.ndim == 3 else beds


def build_experiment(cfg: dict, config_dir: Path = Path(".")):
    """Validate the config and build everything short of sampling.

    Returns ``(chain, ds, initial_beds)``; this is also the --dry-run body,
    so a config that passes it has had every section (including dataset and
    initial-bed paths) resolved and checked.
    """
    ds = load_dataset(_resolve(config_dir, cfg["dataset"]))
    chain = build_chain(cfg, ds)
    beds = _load_initial_beds(dict(cfg.get("farm", {})), ds, config_dir)
    return chain, ds, beds


def run(cfg: dict, config_dir: Path = Path("."), quiet: bool = False,
        device="cuda"):
    """Execute (or resume) the experiment described by ``cfg`` on
    ``device``.

    Relative paths in the config resolve against the config file's
    directory.  Returns the per-chain result tuples from the farm driver.
    """
    chain, ds, initial_beds = build_experiment(cfg, config_dir)
    # every rank returns the same results: rank 0 writes and prints them
    from .parallel.distributed import world

    emit = world()[0] == 0

    farm = dict(cfg.get("farm", {}))
    n_chains = int(farm.get("n_chains", 1))
    n_iter = int(farm.get("n_iter", 1000))
    seeds = farm.get("rng_seeds")
    out = _resolve(config_dir, farm.get("output_path", "mcmc_tpu_run"))
    common = dict(
        n_chains=n_chains, n_iter=n_iter, output_path=out,
        initial_beds=initial_beds,
        segment_size=int(farm.get("segment_size", 1000)),
        checkpoint_every=farm.get("checkpoint_every"),
        async_checkpoints=bool(farm.get("async_checkpoints", False)),
        progress=not quiet, quiet=quiet, device=device)

    if cfg["family"] == "crf":
        from .drivers import large_scale_chain_farm

        results = large_scale_chain_farm(chain, rng_seeds=seeds, **common)
    else:
        from .drivers import small_scale_chain_farm

        results = small_scale_chain_farm(
            chain, ssc_rng_seeds=seeds,
            lsc_rng_seed=farm.get("lsc_rng_seed"), **common)

    save = cfg.get("save", {}) if emit else {}
    if save.get("final_beds"):
        np.save(_resolve(config_dir, save["final_beds"]),
                np.stack([r[0] for r in results]))
    if save.get("histories"):
        np.savez_compressed(
            _resolve(config_dir, save["histories"]),
            loss_mc=np.stack([r[1] for r in results]),
            loss_data=np.stack([r[2] for r in results]),
            loss=np.stack([r[3] for r in results]),
            steps=np.stack([r[4] for r in results]),
            resampled_times=np.stack([r[5] for r in results]),
            blocks_used=np.stack([r[6] for r in results]))

    if not quiet and emit:
        _print_summary(results, device)
    return results


def info(cfg: dict, config_dir: Path = Path(".")) -> int:
    """Print the experiment's resume status without building or sampling.

    Lists the complete checkpoints (and trace-history coverage) that a
    re-invocation of the same config would resume from — the readable
    counterpart of the reference's ``current_iter.txt`` protocol.
    """
    from .io.checkpoint import CheckpointManager

    farm = dict(cfg.get("farm", {}))
    n_iter = int(farm.get("n_iter", 1000))
    out = Path(_resolve(config_dir, farm.get("output_path", "mcmc_tpu_run")))
    if cfg["family"] == "crf":
        run_dir = out / "LargeScaleChain"
    else:
        tag = farm.get("lsc_rng_seed")
        tag = str(tag) if tag is not None else "root"
        run_dir = out / "LargeScaleChain" / tag / "SmallScaleChain"
    print(f"[mcmc-tpu-torch] family={cfg['family']} "
          f"n_chains={int(farm.get('n_chains', 1))} "
          f"target n_iter={n_iter}")
    print(f"[mcmc-tpu-torch] run dir: {run_dir}")
    man = (CheckpointManager(run_dir).manifest() if run_dir.is_dir()
           else {"checkpoints": [], "history_spans": []})
    if not man["checkpoints"]:
        print("[mcmc-tpu-torch] no complete checkpoint — a run starts from "
              "iteration 0")
        return 0
    import datetime

    for c in man["checkpoints"]:
        when = datetime.datetime.fromtimestamp(c["mtime"]).isoformat(
            sep=" ", timespec="seconds")
        print(f"[mcmc-tpu-torch] checkpoint @ iter {c['iter']}: {c['layout']}, "
              f"{len(c['files'])} file(s), {c['bytes'] / 1e6:.1f} MB, "
              f"{when}")
    if man["history_spans"]:
        rows = ", ".join(f"{a}..{b}" for a, b in man["history_spans"])
        print(f"[mcmc-tpu-torch] trace history rows: {rows}")
    latest = man["checkpoints"][-1]["iter"]
    if latest >= n_iter:
        print(f"[mcmc-tpu-torch] resume: complete ({latest}/{n_iter})")
    else:
        print(f"[mcmc-tpu-torch] resume: {latest}/{n_iter} done, "
              f"{n_iter - latest} remaining")
    return 0


def _print_summary(results, device):
    """The run's loss, acceptance and loss R-hat, the R-hat computed on
    the run's ``device``."""
    losses = np.stack([r[3] for r in results])
    steps = np.stack([r[4] for r in results])
    print(f"[mcmc-tpu-torch] loss: {losses[:, 0].mean():.6e} -> "
          f"{losses[:, -1].mean():.6e}")
    print(f"[mcmc-tpu-torch] acceptance: {steps.mean(axis=1).round(3)}")
    # >= 5 so the post-burn slice [:, 1:] still yields half-chains of
    # length >= 2 (ddof=1 variance of a single sample is NaN)
    if losses.shape[0] >= 2 and losses.shape[1] >= 5:
        from .parallel.diagnostics import rank_normalized_rhat

        rhat = float(rank_normalized_rhat(losses[:, 1:], device=device))
        print(f"[mcmc-tpu-torch] rank-normalized split R-hat (loss): "
              f"{rhat:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mcmc-tpu-torch",
        description="Run a gstatsMCMC-style chain-farm experiment from a "
                    "JSON/TOML config (re-invoke the same config to resume).")
    ap.add_argument("config", help="experiment config (.json or .toml)")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the config and build the chain, "
                         "but do not sample")
    ap.add_argument("--info", action="store_true",
                    help="print the run directory's resume status "
                         "(checkpoints, trace coverage) and exit")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress and summary output")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the ranks' backend (default: "
                         "nccl on the card, gloo on the CPU)")
    ap.add_argument("--card", type=int, default=None,
                    help="under torchrun: the card every rank binds "
                         "(default: its LOCAL_RANK); with --backend gloo "
                         "several ranks may share one card")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the farm (default: cuda, the "
                         "card; 'cpu' runs the kernels' plain versions)")
    ns = ap.parse_args(argv)

    # under torchrun: join the run before anything touches a device (a
    # no-op without torchrun's variables)
    from .parallel.distributed import initialize_distributed

    initialize_distributed(
        local_device_ids=None if ns.card is None else [ns.card],
        backend=ns.backend, device=ns.device)

    cfg_path = Path(ns.config)
    cfg = load_config(cfg_path)
    if ns.info:
        return info(cfg, config_dir=cfg_path.parent)
    if ns.dry_run:
        _, ds, _ = build_experiment(cfg, config_dir=cfg_path.parent)
        if not ns.quiet:
            print(f"[mcmc-tpu-torch] config OK: family={cfg['family']} "
                  f"grid={ds['xx'].shape} "
                  f"n_chains={cfg.get('farm', {}).get('n_chains', 1)}")
        return 0
    run(cfg, config_dir=cfg_path.parent, quiet=ns.quiet, device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
