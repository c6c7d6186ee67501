"""The port's multi-chain sampler and diagnostics.

``MultiChainSampler.run`` on the CPU (the plain window op): trace layout
against the JAX sampler's, chain behaviour, and seeded determinism.  The
diagnostics run on host numpy and are held against
``mcmc_tpu.parallel.diagnostics`` on the same numpy traces to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.parallel import diagnostics as jdiag
from mcmc_tpu.parallel.sampler import init_states as jinit_states
from mcmc_tpu.parallel.sampler import run_chains as jrun_chains
from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.parallel import diagnostics as tdiag
from tests.conftest import make_synthetic_problem
from tests.test_torch_chain_crf import _jax_chain, _port_chain

N = 4
N_ITER = 301
SEGMENT = 150


@pytest.fixture(scope="module")
def chains():
    p = make_synthetic_problem(H=64, W=64)
    jchain = _jax_chain(p, "crf_matern")
    return jchain, _port_chain(p, jchain)


@pytest.fixture(scope="module")
def run(chains):
    sampler = MultiChainSampler(chains[1], N, device="cpu")
    states0 = sampler.init(seeds=7)
    bed0 = states0.bed.clone()
    calls = []
    states, traces = sampler.run(
        states0, N_ITER, segment_size=SEGMENT, progress=False,
        segment_callback=lambda done, st, tr: calls.append(
            (done, tr["loss"].shape)))
    return dict(sampler=sampler, bed0=bed0, states=states, traces=traces,
                calls=calls)


def test_trace_layout_matches_jax(chains, run):
    """Keys, shapes and kinds of the JAX sampler's traces for the same
    chain: time-major (n_steps, N, ...) segments from ``run_chains``,
    returned chain-major with the initial row first.  Evaluated abstractly,
    so no JAX random key is drawn."""
    static, consts = chains[0].build()
    beds = jnp.zeros((N, static.H, static.W), jnp.float32)

    def segment():
        keys = jax.random.split(jax.random.key(0), N)
        return jrun_chains(static, consts, jinit_states(beds, keys, consts),
                           N_ITER - 1)[1]

    want = jax.eval_shape(segment)
    got = run["traces"]
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k].shape == (N, N_ITER) + spec.shape[2:], k
        assert got[k].dtype.kind == np.dtype(spec.dtype).kind, k


def test_chains_behave(run):
    tr, states = run["traces"], run["states"]
    loss = tr["loss"]
    assert np.isfinite(loss).all()
    assert loss[:, -1].mean() < loss[:, 0].mean()
    acc = tr["step"][:, 1:].mean()
    assert 0.02 < acc < 0.98, acc
    assert not tr["step"][:, 0].any() and np.isnan(tr["block"][:, 0]).all()
    np.testing.assert_array_equal(tr["step"].sum(axis=1),
                                  states.accepted.numpy())
    np.testing.assert_allclose(tr["loss_mc"][:, -1], states.loss_mc.numpy())
    consts = run["sampler"].consts
    outside = ~(consts.update_mask > 0)
    assert torch.equal(states.bed[:, outside], run["bed0"][:, outside])
    assert (states.bed[:, ~outside] != run["bed0"][:, ~outside]).any()
    probes = consts.sample_ij
    np.testing.assert_array_equal(
        tr["samples"][:, -1], states.bed[:, probes[:, 0], probes[:, 1]])


def test_segments_and_callback(run):
    """The callback sees each segment's time-major numpy traces, the
    first with the initial row, as the JAX sampler passes them."""
    assert run["calls"] == [(SEGMENT + 1, (SEGMENT + 1, N)),
                            (N_ITER, (SEGMENT, N))]


def test_same_seed_same_traces(chains, run):
    sampler = MultiChainSampler(chains[1], N, device="cpu")
    _, again = sampler.run(sampler.init(seeds=7), N_ITER,
                           segment_size=100, progress=False)
    for k, v in run["traces"].items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    _, other = sampler.run(sampler.init(seeds=8), 21, progress=False)
    assert not np.array_equal(other["loss"], run["traces"]["loss"][:, :21])


def test_single_iteration_records_only_the_initial_state(chains):
    sampler = MultiChainSampler(chains[1], 2, device="cpu")
    states = sampler.init(seeds=1)
    _, tr = sampler.run(states, 1, progress=False)
    assert tr["loss"].shape == (2, 1)
    np.testing.assert_array_equal(tr["loss"][:, 0],
                                  (states.loss_mc + states.loss_data).numpy())
    with pytest.raises(ValueError, match="n_iter"):
        sampler.run(states, 0)


def test_init_options(chains):
    chain = chains[1]
    sampler = MultiChainSampler(chain, 3, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        sampler.run_segment(None, 1)
    beds = np.stack([chain.initial_bed - 1.0 * i for i in range(3)])
    st = sampler.init(initial_beds=beds, seeds=0)
    for i in range(3):
        np.testing.assert_array_equal(st.bed[i].numpy(), beds[i])
    shared = sampler.init(initial_beds=chain.initial_bed, seeds=0)
    assert torch.equal(shared.bed[2], shared.bed[0])
    with pytest.raises(ValueError, match="n_chains"):
        sampler.init(initial_beds=beds[:2], seeds=0)
    with pytest.raises(NotImplementedError, match="Philox"):
        sampler.init(seeds=[1, 2, 3])


def test_impl_is_checked(chains):
    with pytest.raises(ValueError, match="impl"):
        MultiChainSampler(chains[1], 2, device="cpu", impl="xla")
    assert MultiChainSampler(chains[1], 2, device="cpu").impl == "auto"


def test_sampler_diagnostics_match_jax(run):
    """The summary of the run's own traces, key by key, against the JAX
    diagnostics that ``mcmc_tpu``'s ``MultiChainSampler.diagnostics``
    composes (jitted here: eager JAX compiles op by op).  The probes' R-hat
    and ESS are taken over bed values near -150 that move by a few metres
    in 300 steps: float32 loses ~1e-5 of them to the mean subtraction
    before the variances, so those keys are held to 2e-4.  The rank-based
    keys and the loss keys are held to 1e-5."""
    tr = run["traces"]
    got = run["sampler"].diagnostics(tr, elapsed_seconds=2.0)
    samp, loss = jnp.asarray(tr["samples"]), jnp.asarray(tr["loss"])

    def j(name, x):
        return np.asarray(jax.jit(getattr(jdiag, name))(x))

    want = {"acceptance_rate": j("acceptance_rate", jnp.asarray(tr["step"])),
            "rhat": j("split_rhat", samp), "ess": j("ess", samp),
            "rhat_rank": j("rank_normalized_rhat", samp),
            "ess_bulk": j("ess_bulk", samp), "ess_tail": j("ess_tail", samp),
            "rhat_loss": j("split_rhat", loss), "ess_loss": j("ess", loss),
            "rhat_rank_loss": j("rank_normalized_rhat", loss),
            "chain_iters_per_sec": N_ITER * N / 2.0}
    want["ess_per_sec"] = want["ess_loss"] / 2.0
    want["ess_per_sec_probes"] = want["ess"] / 2.0
    assert set(got) == set(want)
    for k in want:
        rtol = 2e-4 if k in ("rhat", "ess", "ess_per_sec_probes") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def _ar1(seed, shape, phi=0.8):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=shape).astype(np.float32)
    x = np.empty_like(e)
    x[:, 0] = e[:, 0]
    for t in range(1, shape[1]):
        x[:, t] = phi * x[:, t - 1] + e[:, t]
    # a chain offset so R-hat sees between-chain variance
    x += np.linspace(0.0, 0.3, shape[0], dtype=np.float32).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    return x


@pytest.mark.parametrize("name", ["split_rhat", "ess", "rank_normalized_rhat",
                                  "ess_bulk", "ess_tail", "acceptance_rate"])
@pytest.mark.parametrize("shape", [(4, 200), (4, 201, 3), (1, 300)])
def test_diagnostics_match_jax(name, shape):
    x = _ar1(len(shape) * 10 + shape[0], shape)
    if name == "acceptance_rate":
        x = x > 0.5
    got = getattr(tdiag, name)(x)
    want = np.asarray(jax.jit(getattr(jdiag, name))(jnp.asarray(x)))
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_rank_normalization_averages_ties_like_jax():
    """MH traces repeat a value on every rejection: tied values share
    their average rank, in both packages."""
    rng = np.random.default_rng(12)
    x = np.repeat(rng.normal(size=(3, 40)).astype(np.float32), 5, axis=1)
    got = tdiag._rank_normalize(x[None])
    want = np.asarray(jax.jit(jdiag._rank_normalize)(jnp.asarray(x[None])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[0, :, ::5] == got[0, :, 4::5])
