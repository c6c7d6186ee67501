"""The port's convergence diagnostics (``mcmc_tpu_torch.parallel.
diagnostics``), run with torch on ``device="cpu"``.

The JAX package's behavioural tests of its module (``tests/test_parallel.
py``'s ``TestDiagnostics`` and ``TestRankNormalizedDiagnostics``) on the
port, then the places where a plain torch translation goes wrong: the
folded statistic's median of an even pooled count, ``ess_tail``'s
quantiles by numpy's ``linear`` rule, average ranks over ties, the clamp
of the top rank, the per-probe transforms, and where the work runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtri as ndtri_np
from scipy.stats import rankdata

from mcmc_tpu.parallel import diagnostics as jdiag
from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.parallel import diagnostics as tdiag
from mcmc_tpu_torch.parallel import (ess, ess_bulk, ess_tail,
                                     rank_normalized_rhat, split_rhat)
from tests.torch_helpers import small_chain, small_problem

CPU = dict(device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _ar1(rng, shape, phi):
    """AR(1) rows along axis 1, float64."""
    eps = rng.normal(size=shape)
    x = np.zeros(shape)
    for t in range(1, shape[1]):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return x


# -- the JAX package's behavioural tests, on the port -----------------------


def test_rhat_converged_vs_not(rng):
    good = rng.normal(size=(8, 500))
    assert float(split_rhat(good, **CPU)) == pytest.approx(1.0, abs=0.05)
    bad = good + np.arange(8)[:, None] * 5.0
    assert float(split_rhat(bad, **CPU)) > 1.5


def test_ess_iid_vs_correlated(rng):
    e_iid = float(ess(rng.normal(size=(4, 1000)), **CPU))
    assert e_iid > 2000  # ~ m*n for iid
    e_ar = float(ess(_ar1(rng, (4, 1000), 0.95), **CPU))
    assert e_ar < 0.25 * e_iid


def test_rank_normalize_matches_scipy_with_ties(rng):
    """Quantized values, heavy ties like an MH trace with rejections: the
    scores are scipy's average ranks through the Blom offset."""
    x = np.round(rng.normal(size=(4, 100)) * 2) / 2
    z = tdiag._rank_normalize(torch.as_tensor(x, dtype=torch.float32))
    S = x.size
    want = ndtri_np((rankdata(x.ravel(), method="average") - 0.375)
                    / (S + 0.25)).reshape(x.shape)
    np.testing.assert_allclose(z.numpy(), want, atol=1e-5)


def test_iid_calibration(rng):
    x = rng.normal(size=(8, 1000))
    assert float(rank_normalized_rhat(x, **CPU)) == pytest.approx(1.0,
                                                                  abs=0.02)
    assert 0.5 * 8000 < float(ess_bulk(x, **CPU)) < 1.6 * 8000
    assert float(ess_tail(x, **CPU)) > 0.25 * 8000


def test_mean_shift_detected(rng):
    bad = rng.normal(size=(8, 500)) + np.arange(8)[:, None] * 3.0
    assert float(rank_normalized_rhat(bad, **CPU)) > 1.3


def test_variance_mismatch_caught_by_folding_missed_by_classic(rng):
    """One chain with the right mean but 5x the spread inflates W and
    drags classic split R-hat below 1; the folded statistic flags it."""
    x = rng.normal(size=(8, 500))
    x[0] *= 5.0
    assert float(split_rhat(x, **CPU)) < 1.01
    assert float(rank_normalized_rhat(x, **CPU)) > 1.05


def test_multiparam_shapes(rng):
    x = rng.normal(size=(4, 300, 3))
    for fn in (split_rhat, ess, rank_normalized_rhat, ess_bulk, ess_tail):
        out = fn(x, **CPU)
        assert isinstance(out, np.ndarray) and out.shape == (3,)
        assert out.dtype == np.float32, fn.__name__


def test_large_pooled_sample_stays_finite(rng):
    """1.2e7 pooled samples: without the clamp the top rank's u rounds to
    1.0 in float32 and ndtri(1.0) = +inf makes R-hat NaN."""
    x = rng.normal(size=(2000, 6000)).astype(np.float32)
    r = float(rank_normalized_rhat(x, **CPU))
    assert np.isfinite(r)
    assert r == pytest.approx(1.0, abs=0.02)


def test_real_chain_traces_finite():
    """A genuine MH loss trace of the port's 4-chain farm (constant runs
    from rejections: the tie-heavy case)."""
    s = MultiChainSampler(small_chain(small_problem(H=64, W=64)), 4,
                          device="cpu")
    _, tr = s.run(s.init(seeds=3), n_iter=200, segment_size=200,
                  progress=False)
    loss = tr["loss"]
    assert np.isfinite(float(rank_normalized_rhat(loss, **CPU)))
    assert float(ess_bulk(loss, **CPU)) > 1.0
    assert float(ess_tail(loss, **CPU)) > 1.0
    d = s.diagnostics(tr, elapsed_seconds=1.0)
    assert np.isfinite(d["rhat_rank_loss"])
    assert d["rhat_rank_loss"] >= 1.0 - 1e-3


# -- the traps of a plain torch translation ---------------------------------


@pytest.mark.parametrize("shape", [(4, 250), (6, 101), (6, 7)])
def test_folded_statistic_on_an_even_pool_matches_jax(rng, shape):
    """An even pooled count: ``torch.median`` would take the lower middle
    value where ``jnp.median`` averages the two, and the folded statistic
    depends on it.  Chains of the right mean and unequal spread make the
    folded half the larger one, so it is what comes back."""
    x = (rng.normal(size=shape) * np.linspace(1.0, 3.0, shape[0])[:, None]
         ).astype(np.float32)
    assert x.size % 2 == 0
    srt = torch.sort(torch.from_numpy(x).reshape(1, -1), dim=-1).values
    med = float(tdiag._median(srt)[0])
    assert med == float(np.median(x)) == float(jnp.median(x))
    assert med != float(torch.median(torch.from_numpy(x)))
    got = rank_normalized_rhat(x, **CPU)
    bulk = tdiag._split_rhat(tdiag._rank_normalize(
        torch.from_numpy(x)[None]).movedim(0, -1))[0]
    assert got > float(bulk)
    want = np.asarray(jax.jit(jdiag.rank_normalized_rhat)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("S", [7, 800, 804, 1001, 12_345, 2 ** 20 + 3])
@pytest.mark.parametrize("q", [0.0, 0.05, 0.3, 0.5, 0.95, 1.0])
def test_quantiles_follow_numpys_linear_rule(rng, S, q):
    """``ess_tail``'s thresholds, read off the pooled sort (``torch.
    quantile`` refuses more than 2^24 values), are numpy's ``linear``
    quantiles of the float32 values bit for bit; ties included."""
    v = rng.normal(size=(3, S)).astype(np.float32)
    v[:, ::3] = np.round(v[:, ::3], 1)
    srt = torch.sort(torch.from_numpy(v), dim=-1).values
    want = np.quantile(v, q, axis=-1)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(tdiag._quantile(srt, q).numpy(), want)


def test_ess_tail_matches_jax_with_ties(rng):
    """An MH-like trace (each value held over a run of rejections) through
    ``ess_tail`` in both packages: the exceedance indicators agree."""
    x = _ar1(rng, (4, 600, 2), 0.9).astype(np.float32)
    held = rng.random(size=x.shape[:2]) < 0.7
    for t in range(1, x.shape[1]):
        x[held[:, t], t] = x[held[:, t], t - 1]
    got = ess_tail(x, **CPU)
    want = np.asarray(jax.jit(jdiag.ess_tail)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_average_ranks_are_the_jax_searchsorted_ranks(rng):
    """The ranks (left + right + 1) / 2 from the sorted values' own
    searches are the JAX function's searches of the unsorted values on a
    tie-heavy pool: the scores agree to ndtri's float32 rounding."""
    x = np.round(rng.normal(size=(2, 3, 400)), 1).astype(np.float32)
    flat = x.reshape(2, -1)
    srt = np.sort(flat, axis=-1)
    left = np.stack([np.searchsorted(s, f) for s, f in zip(srt, flat)])
    right = np.stack([np.searchsorted(s, f, side="right")
                      for s, f in zip(srt, flat)])
    rank = (0.5 * (left + right + 1)).astype(np.float32)
    u = np.clip((rank - np.float32(0.375)) / np.float32(flat.shape[1] + 0.25),
                np.float32(1e-10), np.float32(1.0) - np.float32(1.2e-7))
    want = ndtri_np(u.astype(np.float64)).astype(np.float32)
    got = tdiag._rank_normalize(torch.from_numpy(x)).numpy().reshape(2, -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jz = np.asarray(jax.jit(jdiag._rank_normalize)(jnp.asarray(x)))
    np.testing.assert_allclose(got, jz.reshape(2, -1), rtol=1e-5, atol=1e-6)


def test_top_rank_is_clamped_inside_the_unit_interval():
    """At S = 2^24 + 2 the top rank's u rounds to 1.0 in float32: the
    clamp keeps its score finite, as in the JAX function."""
    S = 2 ** 24 + 2
    srt = torch.arange(S, dtype=torch.float32).reshape(1, S)
    order = torch.arange(S).reshape(1, S)
    z = tdiag._normal_scores(srt, order)
    assert torch.isfinite(z).all()
    assert float(z[0, -1]) == pytest.approx(float(ndtri_np(
        np.float32(1.0) - np.float32(1.2e-7))), rel=1e-6)


def test_each_probe_is_transformed_alone(rng):
    """A probes trace is transformed one probe at a time: each probe's
    autocovariance equals that of the probe alone, bit for bit."""
    x = torch.from_numpy(rng.normal(size=(3, 5, 301)).astype(np.float32))
    acov = tdiag._autocov_fft(x)
    for p in range(3):
        assert torch.equal(acov[p], tdiag._autocov_fft(x[p:p + 1])[0])
    want = np.asarray(jax.jit(jdiag._autocov_fft)(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(acov.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["split_rhat", "ess", "rank_normalized_rhat",
                                  "ess_bulk", "ess_tail", "acceptance_rate"])
def test_a_tensor_keeps_its_device(rng, name, monkeypatch):
    """A tensor is computed on its own device with no ``device`` given (a
    CPU tensor on this machine without a card, where an array would go
    to the card and raise); ``device`` names another; the result is numpy
    either way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rng.normal(size=(4, 200)).astype(np.float32)
    if name == "acceptance_rate":
        x = x > 0.0
    fn = getattr(tdiag, name)
    got = fn(torch.from_numpy(x))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, fn(x, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(torch.from_numpy(x), device="cuda")


def test_sampler_diagnostics_take_device_tensors():
    """``MultiChainSampler.diagnostics`` on ``run``'s chain-major numpy
    traces and on the same traces as tensors (time-major, transposed as
    ``run_chains`` gives them): the same numbers."""
    s = MultiChainSampler(small_chain(small_problem(H=48, W=48)), 3,
                          device="cpu")
    _, tr = s.run(s.init(seeds=1), n_iter=60, segment_size=30,
                  progress=False)
    as_np = s.diagnostics(tr, elapsed_seconds=1.0)
    as_t = s.diagnostics({k: torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(v, 1, 0))).transpose(0, 1)
        for k, v in tr.items()}, elapsed_seconds=1.0)
    assert set(as_np) == set(as_t)
    for k in as_np:
        np.testing.assert_array_equal(as_np[k], as_t[k], err_msg=k)
