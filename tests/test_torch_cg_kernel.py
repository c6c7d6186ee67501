"""The plain version of the mixture-system CG (what the CUDA kernel
computes) and the port's kriging solves against the JAX package's.

Tolerances as tests/test_kriging.py states them: against
``lanes_mix_masked_cg(interpret=True)`` rtol/atol 2e-4 (the same CG
iterations with float32 sums in another order and another exp); against
a float64 solve of the masked subsystem rtol/atol 2e-3 (CG truncation at
a well-conditioned system).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops import kriging as jkr
from mcmc_tpu.ops.cg_kernel import lanes_mix_masked_cg
from mcmc_tpu.ops.covariance import CovarianceSpec, fit_cov_mixture
from mcmc_tpu_torch.ops import kriging as tkr
from mcmc_tpu_torch.ops.cg_kernel import (_kernel_order_sum, mix_masked_cg,
                                          mix_masked_cg_reference, mix_params)
from mcmc_tpu_torch.ops.covariance import eval_mixture_static

C, K, SB = 5, 48, 40
# tests/test_kriging.py:222: non-dyadic rates, both families
MIX_NON_DYADIC = ((0.5, 0.3), (0.01, 0.002), (0.4,), (0.05,), (1.0, 0.1, 1.2))


def _fitted_mix():
    """A dyadic matérn mixture over a short range (a well-conditioned
    system, so a 64-iteration CG converges)."""
    ag, bg, ae, be, _ = fit_cov_mixture(CovarianceSpec("matern", s=1.3), 1.0,
                                        0.0, 40.0 * 0.25 * 1.5,
                                        target_err=1e-3)
    q = 0.25 ** 2
    return tuple(tuple(float(v) for v in np.asarray(a, np.float32))
                 for a in (ag, bg, ae, be, (q, 0.0, q)))


def _system(rng, mix, K=K):
    idx = np.stack([rng.permutation(SB * SB)[:K] for _ in range(C)])
    ia = (idx // SB).astype(np.float32)
    ja = (idx % SB).astype(np.float32)
    mask = (rng.random((C, K)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    rhs = rng.normal(size=(C, K)).astype(np.float32)
    eps = np.linspace(1e-3, 3e-3, C).astype(np.float32)
    return ia, ja, mask, rhs, eps


def _sigma(mix, ia, ja):
    q = mix[4]
    dif = ia[:, :, None] - ia[:, None, :]
    djf = ja[:, :, None] - ja[:, None, :]
    h2 = q[0] * djf * djf + q[1] * djf * dif + q[2] * dif * dif
    return eval_mixture_static(mix, torch.from_numpy(h2)).numpy()


@pytest.mark.parametrize("which", ["fitted_dyadic", "non_dyadic",
                                   "fitted_dyadic_k96"])
def test_mix_cg_matches_pallas_and_f64(which):
    """Per-chain eps and masked slots; C = 5 chains, K = 48, and K = 96
    (three 32-row slots in the kernel's sums)."""
    mix = MIX_NON_DYADIC if which == "non_dyadic" else _fitted_mix()
    assert len(mix[0]) >= 2
    ia, ja, mask, rhs, eps = _system(np.random.default_rng(7), mix,
                                     96 if which.endswith("k96") else K)
    n_iters = 96 if which == "non_dyadic" else 64
    want = np.asarray(lanes_mix_masked_cg(
        jnp.asarray(ia), jnp.asarray(ja), jnp.asarray(mask),
        jnp.asarray(rhs), jnp.asarray(eps), mix, n_iters, interpret=True))
    args = [torch.from_numpy(a) for a in (ia, ja, mask, rhs, eps)]
    got = mix_masked_cg_reference(*args, mix, n_iters).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.all(got[mask == 0] == 0.0)
    before = mix_masked_cg.launches
    np.testing.assert_array_equal(mix_masked_cg(*args, mix, n_iters).numpy(),
                                  got)
    assert mix_masked_cg.launches == before
    S = _sigma(mix, ia, ja).astype(np.float64)
    for c in range(C):
        sel = np.where(mask[c] > 0)[0]
        sub = S[c][np.ix_(sel, sel)] + float(eps[c]) * np.eye(len(sel))
        np.testing.assert_allclose(got[c, sel],
                                   np.linalg.solve(sub, rhs[c, sel]),
                                   rtol=2e-3, atol=2e-3)


def test_mix_params_layout():
    """The kernel's by-value parameters hold the plain evaluation's terms:
    dyadic (k, a) by rising k, non-dyadic negated rates in order."""
    mix = ((0.3, 0.2), (6.0, 1.5), (0.4, 0.1), (0.05, 0.3), (1.0, 0.5, 2.0))
    p = mix_params(mix)
    assert p.n_fam == 2
    g, e = p.fam[0], p.fam[1]
    assert (g.in_h, g.dyadic, g.n) == (0, 1, 2)
    assert g.nb0 == np.float32(-1.5)
    assert list(g.k[:2]) == [0, 2]
    np.testing.assert_array_equal(np.array(g.amp[:2], np.float32),
                                  np.float32([0.2, 0.3]))
    assert (e.in_h, e.dyadic, e.n) == (1, 0, 2)
    np.testing.assert_array_equal(np.array(e.nrate[:2], np.float32),
                                  np.float32([-0.05, -0.3]))
    np.testing.assert_array_equal(np.array(p.q, np.float32),
                                  np.float32([1.0, 0.5, 2.0]))


@pytest.mark.parametrize("n", [20, 48, 64, 96, 200])
def test_kernel_order_sum_matches_the_stated_order(n):
    """The plain CGs' dot products sum as the kernels do: rows in slots of
    32 (at least two), per slot the butterfly lane l += lane l + off for
    off = 16, 8, 4, 2, 1, then the slots' sums in rising order; here by a
    float32 loop written out, bit for bit.  For K <= 64 that is a
    64-thread CTA's warp 0 plus warp 1."""
    v = np.random.default_rng(n).normal(size=(6, n)).astype(np.float32)
    slots = max(2, -(-n // 32))
    want = np.empty(6, np.float32)
    for c in range(6):
        w = np.zeros(32 * slots, np.float32)
        w[:n] = v[c]
        sums = []
        for r in range(slots):
            lane = w[32 * r:32 * r + 32].copy()
            for off in (16, 8, 4, 2, 1):
                for i in range(off):
                    lane[i] = np.float32(lane[i] + lane[i + off])
            sums.append(lane[0])
        s = np.float32(sums[0] + sums[1])
        for r in range(2, slots):
            s = np.float32(s + sums[r])
        want[c] = s
    got = _kernel_order_sum(torch.from_numpy(v))
    assert got.shape == (6, 1)
    np.testing.assert_array_equal(got[:, 0].numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("batched_eps", [False, True])
def test_masked_cg_and_spd_solve_match_jax(batched_eps):
    rng = np.random.default_rng(3)
    n = 24
    idx = np.stack([rng.permutation(SB * SB)[:n] for _ in range(C)])
    ia, ja = (idx // SB).astype(np.float32), (idx % SB).astype(np.float32)
    Sigma = _sigma(MIX_NON_DYADIC, ia, ja)
    mask = (rng.random((C, n)) < 0.7).astype(np.float32)
    rhs = rng.normal(size=(C, n)).astype(np.float32)
    eps = (np.linspace(1e-3, 2e-3, C).astype(np.float32) if batched_eps
           else np.float32(1e-3))

    def jax_cg(S, m, b, e):
        return jkr.masked_cg_solve(S, m, b, e, 48)

    want_cg = np.asarray(jax.vmap(jax_cg)(
        jnp.asarray(Sigma), jnp.asarray(mask), jnp.asarray(rhs),
        jnp.broadcast_to(jnp.asarray(eps), (C,))))
    want_spd = np.asarray(jax.vmap(jkr.masked_spd_solve)(
        jnp.asarray(Sigma), jnp.asarray(mask), jnp.asarray(rhs),
        jnp.broadcast_to(jnp.asarray(eps), (C,))))
    teps = torch.as_tensor(eps) if batched_eps else float(eps)
    got_cg = tkr.masked_cg_solve(torch.from_numpy(Sigma),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(rhs), teps, 48).numpy()
    got_spd = tkr.masked_spd_solve(torch.from_numpy(Sigma),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(rhs), teps).numpy()
    np.testing.assert_allclose(got_cg, want_cg, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_spd, want_spd, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_cg, got_spd, rtol=2e-3, atol=2e-3)
    assert np.all(got_spd[mask == 0] == 0.0)


def test_production_cg_budget_stops_short():
    """A property of the reference the port keeps (ROADMAP Queue 3): with
    the production matérn (nu = 1.3, 10 km on 500 m cells) the packed
    systems are ill-conditioned, and the fixed 64 CG iterations leave the
    float32 solution more than 0.5 % from a float64 solve, while 512
    iterations of the same CG land within 2e-3."""
    from mcmc_tpu_torch.models import chain_sgs as sgs
    from tests.conftest import make_synthetic_problem
    from tests.torch_helpers import small_sgs_chain

    chain = small_sgs_chain(make_synthetic_problem(H=64, W=64),
                            vario=("Matern", 10e3, 1.0, 0.0, 1.3))
    static, consts = chain.build("cpu")
    assert static.cg_iters == 64 and static.Mg > 2
    n = 4
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, n)
    d = sgs.draw(torch.Generator().manual_seed(0), static, consts, n)
    geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
    windows = sgs.window_extract_reference(consts.stacked, state.fields,
                                           geo.sx32, geo.sy32, static.SB)
    prep = sgs.prepare(static, consts, windows, geo, d.noise)
    args = (prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p, prep.eps, static.mix)
    w_prod = mix_masked_cg_reference(*args, static.cg_iters).double()
    w_conv = mix_masked_cg_reference(*args, 512).double()
    S = _sigma(static.mix, prep.iaf.numpy(), prep.jaf.numpy())
    worst = 0.0
    for i in range(n):
        sel = prep.sel[i].numpy()
        A = S[i][np.ix_(sel, sel)].astype(np.float64) + prep.eps * np.eye(
            sel.sum())
        w64 = np.linalg.solve(A, prep.rhs_p[i].numpy()[sel])
        worst = max(worst, np.abs(w_prod[i].numpy()[sel] - w64).max()
                    / np.abs(w64).max())
        np.testing.assert_allclose(w_conv[i].numpy()[sel], w64, rtol=2e-3,
                                   atol=2e-3)
    assert worst > 5e-3, worst
