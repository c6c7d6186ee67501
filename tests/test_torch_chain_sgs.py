"""The port's SGS chain against the JAX package's, piece by piece and as a
whole slice.

Constants and states cross over through ``mcmc_tpu_torch.interop`` as
numpy arrays, and every step feeds both packages the same numpy draws
(centre cell, block size, the real white noise of the draw, dropout
uniforms, u) through the parity seam: ``jax.vmap(make_sgs_kernel)`` on one
side, the port's batched ``make_sgs_kernel(impl="eager")`` on the other.
JAX keys only ride along in the JAX state (pinned to threefry); none is
drawn from.

Tolerances: accept flags equal; losses and the bed and z planes to rtol
2e-4 / atol 2e-2 (the JAX package's own bound between its CG paths,
tests/test_chain_sgs.py:565: the CG's float32 sums run in another order,
and the FFTs are pocketfft in both but batched differently); the resample
count exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, maximum_filter

from mcmc_tpu.models import chain_sgs as jsgs
from mcmc_tpu.ops.transforms import NormalScoreTransform as JNST
from mcmc_tpu_torch import ChainSGS, MultiChainSampler, NormalScoreTransform
from mcmc_tpu_torch.interop import sgs_consts_from_numpy, sgs_state_from_numpy
from mcmc_tpu_torch.models import chain_sgs as tsgs
from tests import reference_impl as ref
from tests.conftest import make_synthetic_problem

N = 4
STEPS = 10
RTOL, ATOL = 2e-4, 2e-2
KEY = jax.random.key(0, impl="threefry2x32")  # carried, never drawn from

# name -> (variogram, transform, detrend, dropout, nugget)
CASES = {
    "transform_detrend": (("Matern", 2.5e3, 1.0, 0.0, 1.3), True, True, 0.0),
    "no_transform": (("Exponential", 5e3, 1.0, 0.0, None), False, False,
                     0.0),
    "dropout": (("Exponential", 5e3, 1.0, 0.0, None), True, True, 0.3),
    "nugget": (("Exponential", 5e3, 1.0, 0.3, None), True, True, 0.0),
}


def configure(chain, p, vario, transform, detrend, dropout, nst_cls,
              blocks=(5, 12), neighbors=48, radius=30e3):
    """The same configuration through either package's setters."""
    chain.set_update_region(True, p["region"])
    chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    if detrend:
        trend = gaussian_filter(p["initial_bed"], sigma=10).astype(
            np.float32)
        chain.set_trend(trend, detrend_map=True)
    else:
        chain.set_trend(None, detrend_map=False)
    if transform:
        resid = (p["initial_bed"] - (chain.trend if detrend else 0)).ravel()
        chain.set_normal_transformation(nst_cls.fit(resid, n_quantiles=500),
                                        do_transform=True)
    else:
        chain.set_normal_transformation(None, do_transform=False)
    vtype, vrange, sill, nugget, smooth = vario
    chain.set_variogram(vtype, vrange, sill, nugget, vario_smoothness=smooth)
    chain.set_sgs_param(neighbors, radius, sgs_rand_dropout_on=dropout > 0,
                        dropout_rate=dropout)
    chain.set_block_sizes(blocks[0], blocks[1], blocks[0], blocks[1])
    return chain


def chain_pair(p, case, **kw):
    """(JAX chain, port chain) of one configuration."""
    args = (p["xx"], p["yy"], p["initial_bed"], p["surf"], p["velx"],
            p["vely"], p["dhdt"], p["smb"], p["cond_bed"], p["data_mask"],
            p["grounded"], p["resolution"])
    vario, transform, detrend, dropout = CASES[case]
    return (configure(jsgs.ChainSGS(*args), p, vario, transform, detrend,
                      dropout, JNST, **kw),
            configure(ChainSGS(*args), p, vario, transform, detrend, dropout,
                      NormalScoreTransform, **kw))


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=64, W=64)


# --- build ------------------------------------------------------------------

def assert_same_sizes(ps, js):
    """The static configuration: every size and switch equal, and the
    covariance spec."""
    for f in ("H", "W", "SB", "BMX", "BMY", "M", "K", "NE", "NA", "Mg", "Me",
              "cg_iters", "n_region", "P", "use_transform", "detrend",
              "dropout", "has_nugget"):
        assert getattr(js, f) == getattr(ps, f), f
    assert (ps.spec.vtype, ps.spec.s) == (js.spec.vtype, js.spec.s)
    if js.spec.matern_table is not None:
        np.testing.assert_array_equal(ps.spec.matern_table,
                                      js.spec.matern_table)
    assert len(ps.mix) == len(js.mix)


@pytest.mark.parametrize("case", list(CASES))
def test_build_parity(problem, case):
    """Equal sizes and mixture support; spectra, stamp and mixture within
    rtol 1e-5 (the host covariance runs in float32 on both sides, with an
    exp that may differ by an ulp); planes and LUT tables equal."""
    jc, pc = chain_pair(problem, case)
    js, jk = jc.build()
    ps, pk = pc.build("cpu")
    assert_same_sizes(ps, js)
    for a, b in zip(js.mix, ps.mix):
        np.testing.assert_allclose(b, a, rtol=1e-5)
    for name in ("cov_stamp", "embed_spec", "embed_sqrt"):
        want = np.asarray(getattr(jk, name))
        np.testing.assert_allclose(getattr(pk, name).numpy(), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(pk.stacked.numpy(), np.asarray(jk.stacked))
    np.testing.assert_array_equal(pk.region_cells.numpy(),
                                  np.asarray(jk.region_cells))
    np.testing.assert_allclose(pk.rot.numpy(), np.asarray(jk.rot), rtol=1e-6)
    np.testing.assert_allclose(pk.qcoef.numpy(), np.asarray(jk.qcoef),
                               rtol=1e-6)
    if js.use_transform:
        for t in ("fwd_table", "inv_table"):
            np.testing.assert_array_equal(getattr(pk.nst, t).numpy(),
                                          np.asarray(getattr(jk.nst, t)))
        for s in ("fwd_lo", "fwd_scale", "inv_lo", "inv_scale"):
            assert getattr(pk.nst, s) == float(getattr(jk.nst, s)), s
    for k in ("sill", "nugget", "sigma_mc", "resolution", "dropout_rate",
              "search_radius", "mean_z"):
        assert getattr(pk, k) == float(np.float32(getattr(jk, k))), k
    np.testing.assert_array_equal(pc._initial_detrended,
                                  jc._initial_detrended)
    if js.use_transform:
        np.testing.assert_array_equal(pc._initial_z, jc._initial_z)


def test_init_state_parity(problem):
    jc, pc = chain_pair(problem, "transform_detrend")
    _, jk = jc.build()
    _, pk = pc.build("cpu")
    jst = jsgs.sgs_init_state(jc._initial_detrended, KEY, jk,
                              z0=jc._initial_z, use_transform=True)
    pst = tsgs.sgs_init_state(pc._initial_detrended, pk, pc._initial_z,
                              True, n_chains=3)
    assert pst.fields.shape == (3, 4, 64, 64)
    for i in range(3):
        np.testing.assert_allclose(pst.fields[i].numpy(),
                                   np.asarray(jst.fields), rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_allclose(pst.loss_mc.numpy(),
                               np.full(3, float(jst.loss_mc)), rtol=1e-5)
    assert pst.accepted.dtype == torch.int32 and not pst.accepted.any()


# --- pieces of the step -------------------------------------------------------

def test_halfspec_noise_equals_jax():
    NE = 24
    noise = np.random.default_rng(0).standard_normal(
        (3, NE * NE)).astype(np.float32)
    want = np.stack([np.asarray(jsgs.halfspec_noise(jnp.asarray(v), NE))
                     for v in noise])
    got = tsgs.halfspec_noise(torch.from_numpy(noise), NE).numpy()
    assert got.shape == (3, NE, NE // 2 + 1) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)


def test_halfspec_noise_is_white():
    """irfft2 of halfspec_noise is an iid standard-normal field (the
    torch analogue of tests/test_chain_sgs.py::test_halfspec_noise_is_white;
    any mis-scaled bin shows up as a cell variance != 1)."""
    NE, NS = 16, 30000
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn((NS, NE * NE), generator=gen)
    z = torch.fft.irfft2(tsgs.halfspec_noise(noise, NE), s=(NE, NE)).numpy()
    var = z.var(axis=0)
    assert abs(z.mean()) < 0.01
    np.testing.assert_allclose(var, np.ones((NE, NE)), atol=0.05)
    flat = z.reshape(NS, -1)
    for a, b in ((0, 1), (0, NE), (3, 200), (17, 91)):
        c = np.mean(flat[:, a] * flat[:, b])
        assert abs(c) < 0.05, (a, b, c)


@pytest.mark.parametrize("density", [0.5, 0.02, 0.0])
def test_k_nearest_packed_equals_jax(density):
    """Equal idx and sel over random block geometries and candidate masks;
    sparse masks give fewer than K candidates, so sel has a False tail."""
    rng = np.random.default_rng(int(density * 100))
    SB, K, n = 24, 16, 24
    r = np.arange(SB)
    cands, rds, cds = [], [], []
    for _ in range(n):
        a0, a1 = np.sort(rng.integers(0, SB, 2))
        b0, b1 = np.sort(rng.integers(0, SB, 2))
        rds.append(np.maximum(np.maximum(a0 - r, r - a1), 0))
        cds.append(np.maximum(np.maximum(b0 - r, r - b1), 0))
        cands.append(rng.random((SB, SB)) < density)
    cand, rd, cd = np.stack(cands), np.stack(rds), np.stack(cds)
    idx, sel = tsgs.k_nearest_packed(torch.from_numpy(cand),
                                     torch.from_numpy(rd),
                                     torch.from_numpy(cd), K)
    for i in range(n):
        jidx, jsel = jsgs.k_nearest_packed(
            jnp.asarray(cand[i]), jnp.asarray(rd[i], jnp.int32),
            jnp.asarray(cd[i], jnp.int32), K)
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
    if density < 0.1:
        assert not sel.all()


def test_prepare_small_search_radius_equals_jax(problem):
    """A search radius of ~1 cell leaves fewer than K candidates, so the
    packed selection has a False tail.  The port's prepare (gather-form
    selection) against the JAX package's (one-hot packing) on the same
    state and draws: the same selected slots in the same order, the same
    packed coordinates, and the right-hand side to rtol 1e-5 / atol 1e-5
    (the unconditional draw's inverse FFT)."""
    jc, _ = chain_pair(problem, "no_transform", neighbors=48, radius=600.0)
    js, jk = jc.build()
    assert js.M == 2
    ps, pk = sgs_consts_from_numpy(jax.tree.map(np.asarray, jk),
                                   dataclasses.asdict(js), device="cpu")
    jstates = jax.vmap(lambda k: jsgs.sgs_init_state(
        jc._initial_detrended, k, jk, use_transform=False))(
            jax.random.split(KEY, 8))
    pstate = sgs_state_from_numpy(jax.tree.map(
        np.asarray, dataclasses.replace(jstates, key=None)), device="cpu")
    d = numpy_draws(np.random.default_rng(2), js, jk, 8)
    jprepare = jsgs.make_sgs_stages(js)[0]
    _, (_, jm, jrhs, _, jia, jja) = jax.jit(jax.vmap(
        jprepare, in_axes=(None,) + (0,) * 7))(
        jk, jstates, *(jnp.asarray(d[k]) for k in (
            "cx", "cy", "bsx", "bsy", "noise", "drop_u")))
    geo = tsgs.window_start(ps, *(torch.as_tensor(d[k]) for k in (
        "cx", "cy", "bsx", "bsy")))
    windows = tsgs.window_extract_reference(pk.stacked, pstate.fields,
                                            geo.sx32, geo.sy32, ps.SB)
    prep = tsgs.prepare(ps, pk, windows, geo, torch.as_tensor(d["noise"]))
    sel = prep.sel.numpy()
    assert (~sel).any(), "expected a False tail"
    np.testing.assert_array_equal(prep.m_sel.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(prep.iaf.numpy()[sel], np.asarray(jia)[sel])
    np.testing.assert_array_equal(prep.jaf.numpy()[sel], np.asarray(jja)[sel])
    np.testing.assert_allclose(prep.rhs_p.numpy(), np.asarray(jrhs),
                               rtol=1e-5, atol=1e-5)
    assert (prep.rhs_p[~prep.sel] == 0).all()


# --- the parity seam ------------------------------------------------------------

def numpy_draws(rng, static, consts, n):
    """One step's draws for both packages, from numpy."""
    cells = np.asarray(consts.region_cells)
    cidx = rng.integers(0, static.n_region, n)
    bmin_x, bmax_x = int(consts.block_min_x), int(consts.block_max_x)
    bmin_y, bmax_y = int(consts.block_min_y), int(consts.block_max_y)
    n_noise = static.NE ** 2 + (static.SB ** 2 if static.has_nugget else 0)
    return dict(
        cx=cells[cidx, 0], cy=cells[cidx, 1],
        bsx=rng.integers(bmin_x, bmax_x, n), bsy=rng.integers(bmin_y, bmax_y,
                                                              n),
        noise=rng.standard_normal((n, n_noise)).astype(np.float32),
        drop_u=(rng.random((n, static.SB, static.SB)).astype(np.float32)
                if static.dropout
                else np.ones((n, static.SB, static.SB), np.float32)),
        u=rng.random(n).astype(np.float32))


@pytest.mark.parametrize(
    "case,neighbors",
    [(case, 48) for case in CASES]
    + [("transform_detrend", 96)],
    ids=list(CASES) + ["transform_detrend-k96"])
def test_seam_parity(problem, case, neighbors):
    """10 steps of the port's batched update against the JAX package's
    vmapped one, fed the same state (via interop) and the same draws;
    each side advances on its own result.  Also at 96 neighbours (K = 96,
    three 32-row slots in the CG's sums) with the short-range Matérn and
    its 64 iterations.  The exponential cases run 32 iterations at K = 96
    and stop ~5e-5 of max |w| from a float64 solve, where the two
    packages' orders of the float32 sums leave a few bed cells (4 of
    16,384) up to 0.04 apart, past the tolerance above."""
    jc, _ = chain_pair(problem, case, neighbors=neighbors)
    js, jk = jc.build()
    assert js.K == neighbors
    ps, pk = sgs_consts_from_numpy(jax.tree.map(np.asarray, jk),
                                   dataclasses.asdict(js), device="cpu")
    assert_same_sizes(ps, js)
    assert ps.mix == js.mix
    beds = np.random.default_rng(3).normal(
        jc._initial_detrended, 2.0, (N, 64, 64)).astype(np.float32)
    beds = jc.preprocess_beds(beds + (jc.trend if js.detrend else 0.0))
    z0 = jc.host_transform(beds)
    jstates = jax.vmap(lambda b, z: jsgs.sgs_init_state(
        b, KEY, jk, z0=z, use_transform=js.use_transform))(
            jnp.asarray(beds), None if z0 is None else jnp.asarray(z0))
    pstate = sgs_state_from_numpy(jax.tree.map(
        np.asarray, dataclasses.replace(jstates, key=None)), device="cpu")
    jkernel = jax.jit(jax.vmap(jsgs.make_sgs_kernel(js),
                               in_axes=(None,) + (0,) * 9))
    pkernel = tsgs.make_sgs_kernel(ps, "eager")
    rng = np.random.default_rng(11)
    keys = jax.random.split(KEY, N)
    n_acc = 0
    for it in range(STEPS):
        d = numpy_draws(rng, js, jk, N)
        jstates, jtr = jkernel(jk, jstates, *(jnp.asarray(d[k]) for k in (
            "cx", "cy", "bsx", "bsy", "noise", "drop_u", "u")), keys)
        pstate, ptr = pkernel(
            pk, pstate, *(torch.as_tensor(d[k]) for k in (
                "cx", "cy", "bsx", "bsy", "noise")),
            torch.as_tensor(d["drop_u"]) if ps.dropout else None,
            torch.as_tensor(d["u"]))
        msg = f"{case} step {it}"
        np.testing.assert_array_equal(ptr["step"].numpy(),
                                      np.asarray(jtr["step"]), msg)
        np.testing.assert_allclose(ptr["loss"].numpy(),
                                   np.asarray(jtr["loss"]), rtol=RTOL,
                                   atol=ATOL, err_msg=msg)
        np.testing.assert_allclose(ptr["block"].numpy(),
                                   np.asarray(jtr["block"]), err_msg=msg)
        jf = np.asarray(jstates.fields)
        pf = pstate.fields.numpy()
        for plane in (0, 3):
            np.testing.assert_allclose(pf[:, plane], jf[:, plane], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{msg} {plane}")
        np.testing.assert_array_equal(pf[:, 2], jf[:, 2], msg)
        np.testing.assert_array_equal(pstate.accepted.numpy(),
                                      np.asarray(jstates.accepted))
        n_acc += int(ptr["step"].sum())
    assert 0 < n_acc < STEPS * N, n_acc


def test_empty_mixture_runs_the_stamp_gather_on_cpu(problem):
    """A spherical variogram admits no mixture fit: the packed solve
    gathers S_CC from the stamp and runs the CG on that Sigma, on the CPU
    its plain version ``masked_cg_reference`` (the CUDA kernel's sums in
    its order); the seam still matches the JAX package's vmapped
    ``masked_cg_solve``."""
    from mcmc_tpu_torch.ops import cg_kernel

    jc, pc = chain_pair(problem, "no_transform")
    jc.set_variogram("Spherical", 8e3, 1.0, 0.0)
    js, jk = jc.build()
    assert js.Mg + js.Me == 0
    ps, pk = sgs_consts_from_numpy(jax.tree.map(np.asarray, jk),
                                   dataclasses.asdict(js), device="cpu")
    jstates = jax.vmap(lambda k: jsgs.sgs_init_state(
        jc._initial_detrended, k, jk, use_transform=False))(
            jax.random.split(KEY, N))
    pstate = sgs_state_from_numpy(jax.tree.map(
        np.asarray, dataclasses.replace(jstates, key=None)), device="cpu")
    d = numpy_draws(np.random.default_rng(5), js, jk, N)
    jstates, jtr = jax.jit(jax.vmap(jsgs.make_sgs_kernel(js),
                                    in_axes=(None,) + (0,) * 9))(
        jk, jstates, *(jnp.asarray(d[k]) for k in (
            "cx", "cy", "bsx", "bsy", "noise", "drop_u", "u")),
        jax.random.split(KEY, N))
    calls = []
    reference = cg_kernel.masked_cg_reference

    def spy(*args):
        calls.append(args[0].shape)
        return reference(*args)

    cg_kernel.masked_cg_reference = spy
    try:
        pstate, ptr = tsgs.make_sgs_kernel(ps, "auto")(
            pk, pstate, *(torch.as_tensor(d[k]) for k in (
                "cx", "cy", "bsx", "bsy", "noise")), None,
            torch.as_tensor(d["u"]))
    finally:
        cg_kernel.masked_cg_reference = reference
    assert calls == [(N, ps.K, ps.K)]
    np.testing.assert_array_equal(ptr["step"].numpy(), np.asarray(jtr["step"]))
    np.testing.assert_allclose(pstate.fields[:, 0].numpy(),
                               np.asarray(jstates.fields)[:, 0], rtol=RTOL,
                               atol=ATOL)


# --- the slice as a whole ---------------------------------------------------------

def reach_mask(region, static):
    """Cells any block can touch: the region's centre cells dilated by the
    largest half block."""
    size = (2 * (static.BMX // 2) + 1, 2 * (static.BMY // 2) + 1)
    return maximum_filter(region > 0, size=size)


def test_sampler_runs_the_sgs_slice(problem):
    """MultiChainSampler(ChainSGS, 4) on the CPU for 120 iterations: the
    loss is finite and falls, acceptance is sane, the patched state
    residual equals a full-grid recompute (as tests/test_chain_sgs.py:
    51-55), loss_mc its recompute, and the bed beyond every block's reach
    is unchanged."""
    _, pc = chain_pair(problem, "transform_detrend")
    pc.set_sample_points_locations(np.array([[8000.0, 9000.0]]))
    sampler = MultiChainSampler(pc, N, device="cpu")
    states = sampler.init(seeds=0)
    bed0 = states.bed.clone()
    states, traces = sampler.run(states, 120, segment_size=60,
                                 progress=False)
    loss = traces["loss"]
    assert loss.shape == (N, 120) and traces["samples"].shape == (N, 120, 1)
    assert np.isfinite(loss).all()
    assert loss[:, -1].mean() < loss[:, 0].mean()
    acc = traces["step"][:, 1:].mean()
    assert 0.01 < acc < 0.99, acc
    np.testing.assert_array_equal(states.accepted.numpy(),
                                  traces["step"].sum(axis=1))
    trend = pc.trend
    for i in range(N):
        full = ref.mass_conservation_residual(
            states.bed[i].numpy().astype(np.float64) + trend, problem["surf"],
            problem["velx"], problem["vely"], problem["dhdt"],
            problem["smb"], problem["resolution"])
        np.testing.assert_allclose(states.mc_res[i].numpy(), full,
                                   rtol=2e-3, atol=2e-2)
        recomputed = ref.masked_gaussian_loss(
            states.mc_res[i].numpy(), pc.mc_region_mask, 5.0)
        np.testing.assert_allclose(float(states.loss_mc[i]), recomputed,
                                   rtol=1e-3)
    outside = ~reach_mask(problem["region"], sampler.static)
    assert outside.any()
    assert torch.equal(states.bed[:, outside], bed0[:, outside])
    # the probes trace the trend-restored bed
    np.testing.assert_allclose(
        traces["samples"][:, -1, 0],
        (states.bed[:, 18, 16] + trend[18, 16]).numpy(), rtol=1e-6)


def test_fused_impl_and_cuda_without_mixture_refuse(problem):
    """impl='fused' on the CPU refuses; a spherical chain's solve on the
    CPU runs the plain given-Sigma CG on the stamp gather, launching no
    kernel (before the given-Sigma CG kernel existed, the card refused
    such a chain)."""
    from mcmc_tpu_torch.ops.cg_kernel import (masked_cg, masked_cg_reference,
                                              mix_masked_cg)

    _, pc = chain_pair(problem, "no_transform")
    with pytest.raises(ValueError, match="CUDA"):
        MultiChainSampler(pc, 2, device="cpu", impl="fused")
    pc.set_variogram("Spherical", 8e3, 1.0, 0.0)
    static, consts = pc.build("cpu")
    assert static.Mg + static.Me == 0 and static.mix == ()
    state = tsgs.sgs_init_state(pc._initial_detrended, consts, None, False,
                                n_chains=3)
    d = tsgs.draw(torch.Generator().manual_seed(1), static, consts, 3)
    geo = tsgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
    windows = tsgs.window_extract_reference(consts.stacked, state.fields,
                                            geo.sx32, geo.sy32, static.SB)
    prep = tsgs.prepare(static, consts, windows, geo, d.noise)
    before = (masked_cg.launches, mix_masked_cg.launches)
    w = tsgs.solve(static, consts, prep, "auto")
    assert (masked_cg.launches, mix_masked_cg.launches) == before
    Sigma = tsgs.stamp_sigma(static, consts, prep)
    K = static.K
    assert Sigma.shape == (3, K, K)
    # entry (a, b) is the stamp at the wrapped offset of neighbours a, b
    ia, ja = prep.iaf.long(), prep.jaf.long()
    assert float(Sigma[1, 2, 5]) == float(consts.cov_stamp[
        (ia[1, 2] - ia[1, 5]) % static.NE, (ja[1, 2] - ja[1, 5]) % static.NE])
    assert torch.equal(w, masked_cg_reference(Sigma, prep.m_sel, prep.rhs_p,
                                              prep.eps, static.cg_iters))
    assert torch.equal(tsgs.solve(static, consts, prep, "eager"), w)


@pytest.mark.parametrize("save_beds", [False, True])
def test_run_sgs_chain_layout_matches_jax(problem, save_beds):
    """``models.run_sgs_chain`` against the JAX ``run_sgs_chain`` on the
    same one-chain state, carried by ``interop``: the same trace keys,
    each of the JAX shape (leading dim n_iter, no chain axis) and kind;
    row 0 the initial state's (losses, no step, a NaN block, the
    trend-restored probes and bed) to float32 rtol 1e-6 (the same float32
    additions).  The later rows come from the two packages' own random
    streams."""
    n_iter = 3
    jc, _ = chain_pair(problem, "transform_detrend", neighbors=16,
                       radius=10e3)
    js, jk = jc.build()
    ps, pk = sgs_consts_from_numpy(jax.tree.map(np.asarray, jk),
                                   dataclasses.asdict(js), device="cpu")
    jstate = jsgs.sgs_init_state(jc._initial_detrended, KEY, jk,
                                 z0=jc._initial_z, use_transform=True)
    pstate = sgs_state_from_numpy(jax.tree.map(
        np.asarray, dataclasses.replace(jstate, key=None)), device="cpu")
    _, jtr = jsgs.run_sgs_chain(js, jk, jstate, n_iter, save_beds)
    _, ptr = tsgs.run_sgs_chain(ps, pk, pstate, n_iter, save_beds,
                                rng=torch.Generator().manual_seed(4))
    assert set(ptr) == set(jtr) == ({"loss_mc", "loss_data", "loss", "step",
                                     "block", "samples"}
                                    | ({"bed"} if save_beds else set()))
    for k, want in jtr.items():
        want = np.asarray(want)
        got = ptr[k].numpy()
        assert got.shape == want.shape, k
        assert got.dtype.kind == want.dtype.kind, k
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, err_msg=k)
    assert not ptr["step"][0] and torch.isnan(ptr["block"][0]).all()
