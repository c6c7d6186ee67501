"""The port's multi-chain sampler and diagnostics.

``MultiChainSampler.run`` on the CPU (the plain window op): trace layout
against the JAX sampler's, chain behaviour, and seeded determinism.  The
diagnostics run with torch on the traces' device (here ``device="cpu"``)
and are held against ``mcmc_tpu.parallel.diagnostics`` on the same numpy
traces to rtol 1e-5.
"""

import dataclasses

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
    """At n_iter = 1 the callback fires once, as the JAX sampler's does,
    with the initial row and an empty segment."""
    sampler = MultiChainSampler(chains[1], 2, device="cpu")
    states = sampler.init(seeds=1)
    calls = []
    _, tr = sampler.run(states, 1, progress=False,
                        segment_callback=lambda done, st, t: calls.append(
                            (done, {k: v.shape for k, v in t.items()})))
    assert tr["loss"].shape == (2, 1)
    np.testing.assert_array_equal(tr["loss"][:, 0],
                                  (states.loss_mc + states.loss_data).numpy())
    assert len(calls) == 1 and calls[0][0] == 1
    assert calls[0][1]["loss"] == (1, 2)
    assert calls[0][1]["samples"] == (1, 2, tr["samples"].shape[-1])
    with pytest.raises(ValueError, match="n_iter"):
        sampler.run(states, 0)


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_one_iteration_farm_matches_jax(tmp_path, family):
    """Both packages' drivers at n_iter = 1, each in a fresh run
    directory: one-row traces holding the initial state, row 0's loss_mc
    equal to rtol 1e-5 (the JAX farm takes a seed list, the port one int
    master seed)."""
    from mcmc_tpu import drivers as jdrivers
    from mcmc_tpu_torch import drivers as tdrivers
    from tests.test_torch_chain_sgs import chain_pair

    p = make_synthetic_problem(H=48, W=48)
    kw = dict(n_chains=2, n_iter=1, segment_size=5, progress=False,
              quiet=True)
    if family == "crf":
        jchain = _jax_chain(p, "crf_matern")
        want = jdrivers.large_scale_chain_farm(
            jchain, rng_seeds=[3, 4], output_path=tmp_path / "jax", **kw)
        got = tdrivers.large_scale_chain_farm(
            _port_chain(p, jchain), rng_seeds=3,
            output_path=tmp_path / "port", device="cpu", **kw)
    else:
        jchain, pchain = chain_pair(p, "transform_detrend", neighbors=16,
                                    radius=10e3)
        want = jdrivers.small_scale_chain_farm(
            jchain, ssc_rng_seeds=[3, 4], output_path=tmp_path / "jax", **kw)
        got = tdrivers.small_scale_chain_farm(
            pchain, ssc_rng_seeds=3, output_path=tmp_path / "port",
            device="cpu", **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for i in (1, 2, 3, 4, 6):  # loss_mc, loss_data, loss, steps, blocks
            assert g[i].shape[0] == w[i].shape[0] == 1
        assert not g[4].any() and np.isnan(g[6]).all()
        np.testing.assert_allclose(g[1][0], w[1][0], rtol=1e-5)
        np.testing.assert_array_equal(g[0].shape, w[0].shape)


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
    # a per-chain seed list, by the JAX sampler's rules: at least
    # n_chains seeds, the first n_chains used
    with pytest.raises(ValueError, match="n_chains"):
        sampler.init(seeds=[1, 2])
    listed = sampler.init(initial_beds=beds, seeds=[1, 2, 3, 4])
    assert sampler.generator.n_chains == 3
    assert torch.equal(listed.bed, st.bed)


def test_impl_is_checked(chains):
    with pytest.raises(ValueError, match="impl"):
        MultiChainSampler(chains[1], 2, device="cpu", impl="xla")
    assert MultiChainSampler(chains[1], 2, device="cpu").impl == "auto"


def test_sampler_diagnostics_match_jax(run):
    """The summary of the run's own traces, key by key, against the JAX
    diagnostics that ``mcmc_tpu``'s ``MultiChainSampler.diagnostics``
    composes (jitted here: eager JAX compiles op by op), run in float64 so
    that the reference is exact rather than one more float32 rounding
    (the JAX functions' own float32 error reaches 1.4e-5 on these loss
    traces).  The probes' R-hat and ESS are taken over bed values near
    -150 that move by a few metres in 300 steps: float32 loses ~1e-5 of
    them to the mean subtraction before the variances, so those keys are
    held to 2e-4.  The rank-based keys and the loss keys are held to
    1e-5."""
    tr = run["traces"]
    got = run["sampler"].diagnostics(tr, elapsed_seconds=2.0,
                                      device="cpu")
    samp, loss = tr["samples"], tr["loss"]

    def j(name, x):
        with jax.enable_x64(True):
            x64 = jnp.asarray(np.asarray(x, np.float64))
            return np.asarray(jax.jit(getattr(jdiag, name))(x64))

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
    got = getattr(tdiag, name)(x, device="cpu")
    want = np.asarray(jax.jit(getattr(jdiag, name))(jnp.asarray(x)))
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_rank_normalization_averages_ties_like_jax():
    """MH traces repeat a value on every rejection: tied values share
    their average rank, in both packages."""
    rng = np.random.default_rng(12)
    x = np.repeat(rng.normal(size=(3, 40)).astype(np.float32), 5, axis=1)
    got = tdiag._rank_normalize(torch.from_numpy(x[None])).numpy()
    want = np.asarray(jax.jit(jdiag._rank_normalize)(jnp.asarray(x[None])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[0, :, ::5] == got[0, :, 4::5])


def test_entry_points_run_on_the_card_unless_asked(chains, monkeypatch):
    """With no CUDA device, the default device (the card) raises, naming
    device='cpu'; asked for the CPU, the sampler runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiChainSampler(chains[1], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiChainSampler(chains[1], 2, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chains[1].build()
    sampler = MultiChainSampler(chains[1], 2, device="cpu")
    assert sampler.device == torch.device("cpu")
    _, tr = sampler.run(sampler.init(seeds=1), 3, progress=False)
    assert tr["loss"].shape == (2, 3)


def _runner_chain(family):
    """A small chain of the family, for the functional runners."""
    from tests.test_torch_chain_sgs import chain_pair

    p = make_synthetic_problem(H=48, W=48)
    if family == "crf":
        return _port_chain(p, _jax_chain(p, "crf_matern"))
    case = "no_transform" if family == "sgs_plain" else "transform_detrend"
    return chain_pair(p, case, neighbors=16, radius=10e3)[1]


def _copy(states):
    return dataclasses.replace(states, **{
        f.name: getattr(states, f.name).clone()
        for f in dataclasses.fields(states)})


@pytest.mark.parametrize("seeding", ["int", "list"])
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_run_chains_is_the_sampler_segment(family, seeding):
    """``parallel.run_chains`` on the sampler's static, consts and a fresh
    stream of the same seed gives ``run_segment``'s states and traces bit
    for bit, beds included; the stream ends at the same step."""
    from mcmc_tpu_torch.parallel import run_chains
    from mcmc_tpu_torch.utils.rng import PerChainStreams, make_generator

    sampler = MultiChainSampler(_runner_chain(family), 3, device="cpu")
    seeds = 5 if seeding == "int" else [5, 6, 7]
    states = sampler.init(seeds=seeds)
    start = _copy(states)
    got_states, got = sampler.run_segment(states, 4, save_beds=True)
    rng = (make_generator(5, "cpu") if seeding == "int"
           else PerChainStreams.from_seeds(seeds, "cpu"))
    want_states, want = run_chains(sampler.static, sampler.consts, start, 4,
                                   True, rng=rng)
    assert set(got) == set(want) and "bed" in got
    for k in want:
        assert got[k].shape[:2] == (4, 3), k
        assert torch.equal(got[k].nan_to_num(), want[k].nan_to_num()), k
    for f in dataclasses.fields(want_states):
        assert torch.equal(getattr(got_states, f.name),
                           getattr(want_states, f.name)), f.name
    if seeding == "list":
        assert torch.equal(sampler.generator.step, rng.step)


@pytest.mark.parametrize("family", ["crf", "sgs", "sgs_plain"])
def test_init_states_is_the_sampler_init(family):
    """``parallel.init_states`` equals ``sampler.init`` bit for bit, on the
    chain's own bed and on three per-chain beds (an SGS chain's
    preprocessed, its z-plane from the host transform, or the detrended
    bed itself for a chain without a transform).  An SGS chain's call
    without its z-plane raises, whether the chain transforms or not."""
    from mcmc_tpu_torch.parallel import init_states

    chain = _runner_chain(family)
    sampler = MultiChainSampler(chain, 3, device="cpu")
    full = chain.initial_bed
    beds = np.stack([full - 2.0 * i for i in range(3)]).astype(np.float32)
    if family == "crf":  # (sampler's initial_beds, init_states' args)
        cases = ((None, full, 3, None), (beds, beds, None, None))
    else:
        pre = chain.preprocess_beds(beds)
        own = chain._initial_detrended
        if family == "sgs":
            z_own, z_pre = chain._initial_z, chain.host_transform(pre)
        else:
            assert chain._initial_z is None
            z_own, z_pre = own, pre
        cases = ((None, own, 3, z_own), (beds, pre, None, z_pre))
        with pytest.raises(ValueError, match="needs z0"):
            init_states(own, sampler.consts, 3)
    for initial, bed, n, z0 in cases:
        got = sampler.init(initial_beds=initial, seeds=1)
        want = init_states(bed, sampler.consts, n, z0=z0)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name),
                               getattr(want, f.name)), f.name
