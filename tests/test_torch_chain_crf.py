"""The port's CRF chain against the JAX package's, as a whole slice.

Constants and initial state cross over through ``mcmc_tpu_torch.interop``
as numpy arrays.  Each step feeds both packages the same numpy draws
(half-spectrum noise, size index, scale, range, centre index, u): the JAX
side finishes the proposal with its own ``spectral_field_from_noise``,
``standardize_masked`` and edge mask and runs ``vmap(make_kernel)``; the
port's ``propose`` synthesizes the raw field and its window op finishes
it (with a nugget, ``propose`` finishes it).  No JAX random keys are
drawn: the keys only ride along in the JAX state.

Tolerances (as tests/test_window_kernel.py): accept flags equal, the
Kahan-summed losses to rtol 1e-6, fields to rtol 5e-5 / atol 1e-3 (float32
gradient arithmetic in another order on O(20) residuals).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.models.chain_crf import ChainCRF as JChainCRF
from mcmc_tpu.models.chain_crf import init_state as jinit_state
from mcmc_tpu.models.chain_crf import make_kernel as jmake_kernel
from mcmc_tpu.ops import spectral as jsp
from mcmc_tpu_torch import (BlockMenuConfig, ChainCRF, RandFieldConfig,
                            WeightConfig)
from mcmc_tpu_torch.interop import consts_from_numpy, state_from_numpy
from mcmc_tpu_torch.models.chain_crf import (Draws, init_state, make_kernel,
                                             make_step, propose)
from mcmc_tpu_torch.ops.physics import (masked_gaussian_loss,
                                        mass_conservation_residual)
from mcmc_tpu_torch.utils.rng import make_generator
from tests.conftest import make_synthetic_problem
from tests.test_chain_crf import build_small_chain

N = 4
H = W = 64
CPU = torch.device("cpu")
# (block type, production Matérn model, data-misfit term, nugget)
CASES = {
    "rf_gaussian": ("RF", False, False, False),
    "crf_matern": ("CRF_weight", True, False, False),
    "crf_matern_data": ("CRF_weight", True, True, False),
    "crf_matern_nugget": ("CRF_weight", True, False, True),
}
PROBES = np.array([[5000.0, 6000.0], [20000.0, 15500.0], [16000.0, 24000.0]])


def _jax_chain(p, case):
    block_type, matern, data_loss, nugget = CASES[case]
    chain = build_small_chain(p, block_type=block_type)
    if matern:
        chain._rf_cfg = dataclasses.replace(chain._rf_cfg,
                                            model_name="Matern",
                                            smoothness=1.3)
    if nugget:
        chain._rf_cfg = dataclasses.replace(chain._rf_cfg, nugget_max=25.0)
    if data_loss:
        chain.set_loss_type(sigma_mc=5.0, diff_func="sumsquare",
                            sigma_data=20.0)
    chain.set_sample_points_locations(PROBES)
    return chain


def _port_chain(p, jchain):
    """The same chain through the port's own API and config classes."""
    chain = ChainCRF(p["xx"], p["yy"], p["initial_bed"], p["surf"],
                     p["velx"], p["vely"], p["dhdt"], p["smb"],
                     p["cond_bed"], p["data_mask"], p["grounded"],
                     p["resolution"])
    chain.set_update_region(True, p["region"])
    if jchain.use_data_loss:
        chain.set_loss_type(sigma_mc=5.0, diff_func="sumsquare",
                            sigma_data=20.0)
    else:
        chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    chain.configure_randfield(
        RandFieldConfig(**dataclasses.asdict(jchain._rf_cfg)),
        BlockMenuConfig(**dataclasses.asdict(jchain._block_cfg)),
        WeightConfig(**dataclasses.asdict(jchain._weight_cfg)))
    chain.set_update_type(jchain.block_type)
    chain.set_sample_points_locations(PROBES)
    return chain


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=H, W=W)


@pytest.fixture(scope="module", params=list(CASES))
def built(request, problem):
    """JAX chain build, its numpy form, and the port's consts via interop."""
    jchain = _jax_chain(problem, request.param)
    jstatic, jconsts = jchain.build()
    pstatic, pconsts = consts_from_numpy(jax.tree.map(np.asarray, jconsts),
                                         dataclasses.asdict(jstatic))
    beds = np.random.default_rng(3).normal(
        problem["initial_bed"], 5.0, (N, H, W)).astype(np.float32)
    beds = np.minimum(beds, problem["surf"] - 5.0).astype(np.float32)
    return dict(case=request.param, jchain=jchain, jstatic=jstatic,
                jconsts=jconsts, pstatic=pstatic, pconsts=pconsts, beds=beds)


def _jax_states(b):
    key0 = jax.random.key(0)  # carried in the state, never drawn from
    return jax.vmap(lambda bed: jinit_state(bed, key0, b["jconsts"]))(
        jnp.asarray(b["beds"]))


def _numpy_state(jstates):
    """The JAX states with numpy leaves; the key stays behind (a typed key
    has no numpy form, and the port keeps no per-chain key)."""
    return jax.tree.map(np.asarray, dataclasses.replace(jstates, key=None))


def test_port_build_matches_jax_build(problem, built):
    pchain = _port_chain(problem, built["jchain"])
    static, consts = pchain.build(CPU)
    assert static == built["pstatic"]
    ref = built["pconsts"]
    for name in ("stacked", "region_cells", "sample_ij"):
        assert torch.equal(getattr(consts, name), getattr(ref, name)), name
    assert torch.equal(consts.rf.pairs, ref.rf.pairs)
    assert torch.equal(consts.rf.edge_masks, ref.rf.edge_masks)
    for name in ("sigma_mc", "sigma_data", "resolution"):
        assert getattr(consts, name) == getattr(ref, name)
    assert static.P == len(PROBES)


def test_init_state_matches_jax(built):
    js = _numpy_state(_jax_states(built))
    st = init_state(built["beds"], built["pconsts"])
    scale = np.abs(js.fields[:, 1]).max()
    np.testing.assert_allclose(st.fields.numpy(), js.fields, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(st.loss_mc.numpy(), js.loss_mc, rtol=1e-5)
    np.testing.assert_allclose(st.loss_data.numpy(), js.loss_data,
                               rtol=1e-5)
    assert st.accepted.dtype == torch.int32 and int(st.accepted.sum()) == 0
    # the interop copy of the JAX state is the same state
    via = state_from_numpy(js)
    assert torch.equal(via.fields, torch.from_numpy(np.array(js.fields)))
    assert torch.equal(via.loss_mc, torch.from_numpy(np.array(js.loss_mc)))


def test_init_state_shared_bed_is_copied_per_chain(built):
    st = init_state(built["beds"][0], built["pconsts"], n_chains=3)
    one = init_state(built["beds"][:1], built["pconsts"])
    assert st.fields.shape == (3, 3, H, W) and st.fields.is_contiguous()
    for i in range(3):
        assert torch.equal(st.fields[i], one.fields[0])
    st.fields[0, 0, 0, 0] += 1.0  # the chains do not share storage
    assert st.fields[1, 0, 0, 0] == one.fields[0, 0, 0, 0]


def _draws(rng, pstatic, pconsts):
    rf = pstatic.rf
    B = rf.B
    nh = (N, B, B // 2 + 1)
    return dict(
        noise=(rng.normal(size=nh) + 1j * rng.normal(size=nh)).astype(
            np.complex64),
        size_idx=rng.integers(0, rf.n_sizes, N),
        scale=(rng.uniform(pconsts.rf.scale_min, pconsts.rf.scale_max, N)
               / 3.0).astype(np.float32),
        range=rng.uniform(pconsts.rf.range_min_x, pconsts.rf.range_max_x,
                          N).astype(np.float32),
        cidx=rng.integers(0, pstatic.n_region, N),
        u=rng.uniform(0.0, 1.0, N).astype(np.float32),
        nug=rng.uniform(0.0, pconsts.rf.nugget_max, N).astype(np.float32),
        nugget_noise=rng.normal(size=(N, B, B)).astype(np.float32))


def _port_draws(d):
    """The same numpy draws as the port's injection seam."""
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    return Draws(noise=t["noise"], size_idx=t["size_idx"], scale=t["scale"],
                 range_x=t["range"], range_y=t["range"], cidx=t["cidx"],
                 u=t["u"], nug=t["nug"], nugget_noise=t["nugget_noise"])


def _jax_finished(d, jstatic, jconsts):
    """Proposal fields finished as mcmc_tpu/models/randfield.draw_block
    finishes them."""
    rf, B = jstatic.rf, jstatic.rf.B
    pairs = np.asarray(jconsts.rf.pairs)
    out = []
    for i in range(N):
        raw = jsp.spectral_field_from_noise(
            jnp.asarray(d["noise"][i]), (B, B), rf.resolution, rf.model_name,
            d["range"][i], d["range"][i], rf.smoothness)
        w, h = pairs[0, d["size_idx"][i]], pairs[1, d["size_idx"][i]]
        bm = (np.arange(B)[:, None] < h) & (np.arange(B)[None, :] < w)
        f = jsp.standardize_masked(raw, jnp.asarray(bm)) * d["scale"][i]
        if rf.has_nugget:
            f = f + d["nugget_noise"][i] * jnp.sqrt(d["nug"][i])
        f = f * jnp.asarray(bm, jnp.float32)
        out.append(f * jconsts.rf.edge_masks[d["size_idx"][i]])
    return jnp.stack(out)


@pytest.mark.parametrize("impl", ["auto", "eager"])
def test_ten_steps_match_vmapped_make_kernel(built, impl):
    jstatic, jconsts = built["jstatic"], built["jconsts"]
    pstatic, pconsts = built["pstatic"], built["pconsts"]
    jstep = jax.jit(jax.vmap(jmake_kernel(jstatic),
                             in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0)))
    pstep = make_kernel(pstatic, impl)
    jstates = _jax_states(built)
    pstates = state_from_numpy(_numpy_state(jstates))
    region = np.asarray(jconsts.region_cells)
    pairs = np.asarray(jconsts.rf.pairs)
    rng = np.random.default_rng(17)
    n_acc = 0
    for it in range(10):
        d = _draws(rng, pstatic, pconsts)
        cx, cy = region[d["cidx"], 0], region[d["cidx"], 1]
        w, h = pairs[0, d["size_idx"]], pairs[1, d["size_idx"]]
        jstates, jtr = jstep(jconsts, jstates,
                             _jax_finished(d, jstatic, jconsts),
                             jnp.asarray(h), jnp.asarray(w), jnp.asarray(cx),
                             jnp.asarray(cy), jnp.asarray(d["u"]),
                             jstates.key)
        # raw fields, or with a nugget fields finished by the port
        pd = _port_draws(d)
        pstates, ptr = pstep(pconsts, pstates, propose(pstatic, pconsts, pd),
                             pd.size_idx, pd.scale, torch.as_tensor(cx),
                             torch.as_tensor(cy), pd.u)
        msg = f"{built['case']} step {it}"
        np.testing.assert_array_equal(ptr["step"].numpy(),
                                      np.asarray(jtr["step"]), err_msg=msg)
        for k in ("loss_mc", "loss_data", "loss"):
            np.testing.assert_allclose(ptr[k].numpy(), np.asarray(jtr[k]),
                                       rtol=1e-6, err_msg=f"{msg} {k}")
        np.testing.assert_allclose(pstates.fields.numpy(),
                                   np.asarray(jstates.fields), rtol=5e-5,
                                   atol=1e-3, err_msg=msg)
        np.testing.assert_array_equal(ptr["block"].numpy(),
                                      np.asarray(jtr["block"]), err_msg=msg)
        np.testing.assert_allclose(ptr["samples"].numpy(),
                                   np.asarray(jtr["samples"]), rtol=5e-5,
                                   atol=1e-3, err_msg=msg)
        np.testing.assert_array_equal(pstates.accepted.numpy(),
                                      np.asarray(jstates.accepted))
        n_acc += int(ptr["step"].sum())
    assert 0 < n_acc < 10 * N, n_acc


def test_kahan_ledger_tracks_the_full_loss(built):
    """After many steps the ledger equals the loss recomputed from the
    patched residual plane (the stale ring is part of both)."""
    pstatic, pconsts = built["pstatic"], built["pconsts"]
    state = init_state(built["beds"], pconsts)
    step = make_step(pstatic)
    gen = make_generator(4, CPU)
    for _ in range(60):
        state, _ = step(pconsts, state, gen)
    assert int(state.accepted.sum()) > 0
    ledger = masked_gaussian_loss(state.mc_res, pconsts.mc_mask,
                                  pconsts.sigma_mc)
    np.testing.assert_allclose(state.loss_mc.numpy(), ledger.numpy(),
                               rtol=1e-5)
    # and the patched residual matches a fresh one inside the blocks the
    # chains moved (the ring outside them is deliberately stale)
    fresh = mass_conservation_residual(
        state.bed, pconsts.surf, pconsts.velx, pconsts.vely,
        pconsts.forcing, 0.0, pconsts.resolution)
    moved = state.resampled > 0
    err = (fresh - state.mc_res).abs()[moved]
    assert float(err.max()) < 1e-3 * float(fresh.abs().max())


def test_chain_api_matches_jax(problem):
    jchain = _jax_chain(problem, "crf_matern")
    pchain = _port_chain(problem, jchain)
    jchain.set_crf_data_weight()
    pchain.set_crf_data_weight()
    np.testing.assert_array_equal(pchain.crf_data_weight,
                                  jchain.crf_data_weight)
    rng = np.random.default_rng(8)
    res = rng.normal(0.0, 3.0, (H, W))
    assert pchain.loss(res) == jchain.loss(res)
    for bad, err in (("CRF_rbf", NotImplementedError), ("nope", ValueError)):
        with pytest.raises(err):
            pchain.set_update_type(bad)
        with pytest.raises(err):
            jchain.set_update_type(bad)


def test_build_refuses_unconfigured_chains(problem):
    p = problem
    args = (p["xx"], p["yy"], p["initial_bed"], p["surf"], p["velx"],
            p["vely"], p["dhdt"], p["smb"], p["cond_bed"], p["data_mask"],
            p["grounded"], p["resolution"])
    for cls in (ChainCRF, JChainCRF):
        with pytest.raises(ValueError, match="set_loss_type"):
            cls(*args).build()
    with pytest.raises(ValueError, match="shape"):
        ChainCRF(*args[:2], p["initial_bed"][:10], *args[3:])


def test_make_kernel_refuses_unknown_impl(built):
    with pytest.raises(ValueError, match="impl"):
        make_kernel(built["pstatic"], "xla")
