"""The PyTorch port's tutorial workflow (``examples/torch_port/``, examples
01-05, 08 and 09) on the CPU, each held against its JAX example.

Every port example runs in quick mode with ``--device cpu`` in a
subprocess whose interpreter blocks JAX (``tests/torch_example_runs.py``);
the JAX examples run on the CPU as ``tests/test_examples_pipeline.py``
runs them.  01 -> 05 run as a pipeline into one output directory, so the
file handoffs are part of the check: 03 writes the checkpoint and the
final beds, 04 refines those beds through the seed-listed SGS farm, 05
reads 03's checkpoint.  Against the JAX package: 01's CSV byte for byte,
02's printed variogram fits and its SGS bed (within the 2e-2 m of
``tests/test_torch_geostats.py``), 03's initial loss row (rtol 1e-6), and
08's config text.  08 resumes through the CLI bitwise; 09 runs two gloo
ranks under torchrun and checks (a)-(c) of the JAX example.
"""

import numpy as np
import pytest

from tests.torch_example_runs import run_jax, run_port

PIPELINE = ("01_load_data.py", "02_statistical_analysis.py",
            "03_large_scale_chain.py", "04_small_scale_chain.py",
            "05_visualization.py")


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Port 01 -> 05 and JAX 01 -> 03, quick, each package into its own
    output directory: {"port"|"jax": (out_dir, {example: stdout})}."""
    runs = {}
    for pkg, run, names in (("port", run_port, PIPELINE),
                            ("jax", run_jax, PIPELINE[:3])):
        out = tmp_path_factory.mktemp(f"{pkg}_out")
        runs[pkg] = (out, {n[:2]: run(n, out) for n in names})
    return runs


def _checkpoint_history(pkg, out):
    run_dir = out / "lsc_run" / "LargeScaleChain"
    if pkg == "port":
        from mcmc_tpu_torch.io import CheckpointManager

        return CheckpointManager(run_dir).load(device="cpu")[2]
    from mcmc_tpu.io import CheckpointManager

    return CheckpointManager(run_dir).load()[2]


def test_01_csv_is_the_jax_examples_bytes(pipeline):
    port, jax = pipeline["port"][0], pipeline["jax"][0]
    stdout = pipeline["port"][1]["01"]
    assert "bed>surface picks: 0" in stdout
    csv = (port / "GlacierDataGridded.csv").read_bytes()
    assert csv == (jax / "GlacierDataGridded.csv").read_bytes()
    assert csv.count(b"\n") == 64 * 64 + 1


def _fit_lines(stdout):
    return [ln for ln in stdout.splitlines()
            if ln.split(" ", 1)[0] in ("gaussian", "exponential",
                                       "spherical", "matern")]


def test_02_variogram_fits_print_alike(pipeline):
    port = _fit_lines(pipeline["port"][1]["02"])
    assert len(port) == 4
    assert port == _fit_lines(pipeline["jax"][1]["02"])


def test_02_sgs_bed_matches_jax(pipeline):
    port = np.load(pipeline["port"][0] / "sgs_initial_bed_0.npy")
    jax = np.load(pipeline["jax"][0] / "sgs_initial_bed_0.npy")
    assert port.shape == jax.shape == (64, 64)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, jax, rtol=0, atol=2e-2)


def test_03_initial_loss_row_matches_jax(pipeline):
    port = _checkpoint_history("port", pipeline["port"][0])
    jax = _checkpoint_history("jax", pipeline["jax"][0])
    assert port["loss"].shape == np.asarray(jax["loss"]).shape == (2, 200)
    np.testing.assert_allclose(port["loss"][:, 0],
                               np.asarray(jax["loss"])[:, 0], rtol=1e-6)
    assert "split R-hat" in pipeline["port"][1]["03"]
    assert (pipeline["port"][0] / "lsc_final_beds.npy").exists()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_03_acceptance_in_band(pipeline, pkg):
    hist = _checkpoint_history(pkg, pipeline[pkg][0])
    acc = np.asarray(hist["step"])[:, 1:].mean(axis=1)
    assert acc.shape == (2,)
    assert np.all((acc > 0.05) & (acc < 0.95)), acc


def test_04_refines_03s_beds(pipeline):
    out, stdout = pipeline["port"][0], pipeline["port"][1]["04"]
    assert "initial beds: example 03's final beds" in stdout
    beds = np.load(out / "ssc_final_beds.npy")
    assert beds.shape == (2, 64, 64) and np.isfinite(beds).all()
    run_dir = (out / "ssc_run" / "LargeScaleChain" / "2026"
               / "SmallScaleChain")
    assert any(run_dir.glob("checkpoint_80*.npz")), sorted(run_dir.iterdir())


def test_05_draws_the_summary_from_03s_checkpoint(pipeline):
    out, stdout = pipeline["port"][0], pipeline["port"][1]["05"]
    assert "checkpoint: 200 iterations x 2 chains, state on cpu" in stdout
    assert (out / "summary.png").stat().st_size > 0
    assert "rank-normalized split R-hat (loss)" in stdout
    assert "ESS bulk / tail (loss)" in stdout


def test_08_cli_experiment_resumes_bitwise(tmp_path):
    port, jax = tmp_path / "port", tmp_path / "jax"
    stdout = run_port("08_cli_experiment.py", port)
    run_jax("08_cli_experiment.py", jax)
    assert "bitwise reused" in stdout
    assert ((port / "experiment.json").read_text()
            == (jax / "experiment.json").read_text())
    beds = np.load(port / "cli_final_beds.npy")
    assert beds.shape == (2, 64, 64) and np.isfinite(beds).all()
    with np.load(port / "cli_histories.npz") as p, \
            np.load(jax / "cli_histories.npz") as j:
        assert p["loss"].shape == j["loss"].shape == (2, 200)
        np.testing.assert_allclose(p["loss"][:, 0], j["loss"][:, 0],
                                   rtol=1e-6)


def test_09_distributed_pod_on_two_gloo_ranks(tmp_path):
    stdout = run_port("09_distributed_pod.py", tmp_path)
    ranks = [(tmp_path / f"pod_rank{k}.txt").read_text() for k in range(2)]
    # (a) the same global trace on both ranks, each its own rows
    assert ranks[0].startswith("PROC0") and ranks[1].startswith("PROC1")
    assert ranks[0].split(" loss0=")[1] == ranks[1].split(" loss0=")[1]
    assert "rows=[0, 2]" in ranks[0] and "rows=[2, 4]" in ranks[1]
    # (b) one shard a rank and the marker
    names = {f.name for f in (tmp_path / "pod_run").iterdir()}
    assert {"checkpoint_60.proc0of2.npz", "checkpoint_60.proc1of2.npz",
            "checkpoint_60.ok"} <= names
    # (c) a single-process load reassembles the four chains
    assert "reassembled from shards: iter=60, beds (4, 48, 48)" in stdout
    from mcmc_tpu_torch.io import CheckpointManager

    done, states, _, meta = CheckpointManager(tmp_path / "pod_run").load(
        device="cpu")
    assert done == 60 and states.bed.shape == (4, 48, 48)
    assert meta["n_chains"] == 4
