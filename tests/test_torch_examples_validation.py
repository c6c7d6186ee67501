"""The PyTorch port's convergence validation (example 06) and native
production grid (example 07) on the CPU, each held against its JAX
example; and every port example's refusal to run without a card unless
asked for the CPU.

06 runs at the JAX example's CPU scale (8 chains on 128², 3,000 CRF and
500 SGS iterations) with its thresholds, both packages in this module:
the port must give ALL PASS and the absolute assertions of
``tests/test_convergence_smoke.py``; its deterministic initial RMSE must
be the JAX run's exactly, and its statistics must stay near the JAX run's
(acceptances within 0.03, the gap's closing ratio within a factor of 1.5,
the posterior-mean RMSE within 25 %: the two packages draw from different
random streams).  07's initial loss at 180 x 225 is the JAX example's
(which pads the grid, but traces the true domain) to rtol 1e-5.
"""

import pytest

from tests.torch_example_runs import (PORT_EXAMPLES, port_process, run_jax,
                                      run_port, stats_line)


@pytest.fixture(scope="module")
def validation(tmp_path_factory):
    """(port stdout, port STATS, JAX STATS) of example 06 on the CPU."""
    out = tmp_path_factory.mktemp("validation")
    port = run_port("06_convergence_validation.py", out, quick=False)
    jax = run_jax("06_convergence_validation.py", out, quick=False)
    return port, stats_line(port, "[validate]"), stats_line(jax, "[validate]")


def test_06_all_pass_at_the_cpu_scale(validation):
    stdout, s, _ = validation
    assert "CRF: 3000 iters x 8 chains" in stdout
    assert "SGS: 500 iters x 8 chains" in stdout
    assert "[validate] ALL PASS" in stdout, stdout
    # tests/test_convergence_smoke.py's assertions, unchanged
    assert 0.05 < s["crf_acceptance"] < 0.95
    assert 0.05 < s["sgs_acceptance"] < 0.99
    assert s["gap_final"] < 0.1 * s["gap_initial"]
    assert s["rmse_posterior_mean"] < s["rmse_initial"]
    assert s["variogram_ratio_min"] > 1 / 3
    assert s["variogram_ratio_max"] < 3


def test_06_stats_name_the_device_and_rates(validation):
    _, s, _ = validation
    assert s["device"] == "cpu"
    assert s["crf_chain_it_s"] > 0 and s["sgs_chain_it_s"] > 0


def test_06_initial_rmse_is_the_jax_examples(validation):
    _, s, j = validation
    assert s["rmse_initial"] == j["rmse_initial"]


@pytest.mark.parametrize("key", ["crf_acceptance", "sgs_acceptance"])
def test_06_acceptance_near_jax(validation, key):
    _, s, j = validation
    assert abs(s[key] - j[key]) <= 0.03, (s[key], j[key])


def test_06_gap_closure_near_jax(validation):
    _, s, j = validation
    port = s["gap_final"] / s["gap_initial"]
    jax = j["gap_final"] / j["gap_initial"]
    assert 1 / 1.5 <= port / jax <= 1.5, (port, jax)


def test_06_posterior_rmse_near_jax(validation):
    _, s, j = validation
    assert (abs(s["rmse_posterior_mean"] - j["rmse_posterior_mean"])
            <= 0.25 * j["rmse_posterior_mean"]), (s, j)


def test_07_native_grid_matches_the_padded_jax_run(tmp_path):
    port = run_port("07_native_production_grid.py", tmp_path, quick=False)
    jax = run_jax("07_unaligned_production_grid.py", tmp_path, quick=False)
    assert "[07] PASS" in port, port
    assert "compute grid 180x225" in port
    assert "checkpoint state grid (180, 225) != sampler grid" in port
    s, j = stats_line(port, "[07]"), stats_line(jax, "[07]")
    assert s["grid"] == [180, 225]
    assert abs(s["loss_initial"] - j["loss_initial"]) <= (
        1e-5 * abs(j["loss_initial"]))
    assert s["loss_final"] < s["loss_initial"]
    assert 0.02 < s["acceptance"] < 0.98


@pytest.mark.parametrize("name", sorted(
    p.name for p in PORT_EXAMPLES.glob("0*.py")))
def test_example_needs_a_card_or_device_cpu(tmp_path, name):
    """With no ``--device`` an example runs on the card; on this machine
    (no card) it raises through ``resolve_device`` before writing
    anything, and never moves to the CPU by itself."""
    (tmp_path / "out").mkdir()
    out = port_process(name, tmp_path / "out")
    assert out.returncode != 0, out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr, out.stderr
    assert "pass device='cpu'" in out.stderr
    assert not any((tmp_path / "out").iterdir())
