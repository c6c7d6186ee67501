"""The port's gstools-SRF generation method against the JAX package's.

The JAX functions draw from their keys; the port's take injected draws.
So each parity test takes a JAX key, reads from it the exact values the
JAX function draws (the same splits; ``jax.random.uniform(k)`` gives the
unit draws that ``uniform(k, maxval=2 pi)`` scales), and hands those
values to the port:

- ``sample_wavevectors``: elementwise float32 arithmetic on both sides;
  each wavevector within 1e-5 of its length (the JAX rotation is a 2 x 2
  matrix product, summed in another order);
- ``srf_field``: the harmonic sum (the SRF kernel's plain version on the
  CPU) within 1e-4 on the unit-variance field for the Matérn and
  Gaussian models; the sums run over 1000 terms in another order.  The
  Exponential model's Cauchy-like radial tail puts some phases at 1e4 to
  1e8 rad, where float32 rounding of the phase decides the cosine in
  every implementation: parity there counts the cells beyond the same
  1e-4 and holds that count to at most 1 % of the grid;
- the SRF proposal block (``randfield.finish_block_srf``) and the CRF
  step at the seam, on a JAX SRF chain carried across by
  ``interop.consts_from_numpy``: the JAX ``make_kernel`` on the JAX
  package's own SRF blocks against the port's ``propose`` and
  ``make_kernel`` on the same draws, to ``test_torch_chain_crf.py``'s
  tolerances.  Before the port honoured ``spectral=False`` the carried
  static ran the spectral proposal, standardized, without a word.

The port's own generator is held statistically, as tests/test_srf.py
holds the JAX package's: ensemble variance and correlogram against the
port's ``covariance_norm``, no standardization, and anisotropy rotating
the correlation.  Its entry points with ``spectral=False`` (the farm,
seed lists, ``ChainCRF.run``, ``RandField``, the drivers and the CLI)
are held to their own contracts and to the JAX package's result
formats.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.models import randfield as jrf
from mcmc_tpu.models.chain_crf import init_state as jinit_state
from mcmc_tpu.models.chain_crf import make_kernel as jmake_kernel
from mcmc_tpu.ops import spectral as jsp
from mcmc_tpu.ops import srf as jsrf
from mcmc_tpu.utils.config import BlockMenuConfig as JBlockMenuConfig
from mcmc_tpu.utils.config import RandFieldConfig as JRandFieldConfig
from mcmc_tpu.utils.config import WeightConfig as JWeightConfig
from mcmc_tpu_torch import MultiChainSampler, RandFieldConfig
from mcmc_tpu_torch.interop import consts_from_numpy, state_from_numpy
from mcmc_tpu_torch.models import chain_crf as crf
from mcmc_tpu_torch.models import randfield as trf
from mcmc_tpu_torch.ops import srf as tsrf
from mcmc_tpu_torch.ops import srf_kernel as tsk
from mcmc_tpu_torch.ops.covariance import CovarianceSpec, covariance_norm
from mcmc_tpu_torch.utils.rng import PerChainStreams, make_generator
from tests.conftest import make_synthetic_problem
from tests.test_chain_crf import build_small_chain

M = tsrf.N_MODES
RES = 500.0
CPU = torch.device("cpu")
MODELS = [("Gaussian", None), ("Exponential", None), ("Matern", 1.3)]
WAVE_RTOL = 1e-5
FIELD_ATOL = 1e-4
EXP_EXCESS_MAX = 0.01    # share of Exponential cells beyond FIELD_ATOL
N_CHAINS = 4
H = W = 64


def _t(a):
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def _srf_key_draws(key):
    """The values ``mcmc_tpu.ops.srf.srf_field(key, ...)`` draws: (u,
    theta as unit uniforms, z1, z2), each (M,) numpy float32."""
    k_vec, k_z1, k_z2 = jax.random.split(key, 3)
    k_r, k_a = jax.random.split(k_vec)
    return tuple(np.asarray(v) for v in (
        jax.random.uniform(k_r, (M,)), jax.random.uniform(k_a, (M,)),
        jax.random.normal(k_z1, (M,)), jax.random.normal(k_z2, (M,))))


def _port_wavevectors(u, theta, model, smoothness, rx, ry, angle=None):
    return tsrf.sample_wavevectors(
        _t(u)[None], _t(theta)[None], model,
        torch.tensor([rx], dtype=torch.float32),
        torch.tensor([ry], dtype=torch.float32), smoothness,
        None if angle is None else torch.tensor([angle],
                                                dtype=torch.float32))[0]


# --- ops/srf.py against mcmc_tpu/ops/srf.py ----------------------------------

@pytest.mark.parametrize("rotated", [False, True], ids=["isotropic", "rotated"])
@pytest.mark.parametrize("model,smoothness", MODELS)
def test_sample_wavevectors_matches_jax(model, smoothness, rotated):
    key = jax.random.key(11)
    k_vec = jax.random.split(key, 3)[0]
    u, theta, _, _ = _srf_key_draws(key)
    rx, ry = np.float32(6e3), np.float32(2.5e3 if rotated else 6e3)
    angle = np.float32(0.7) if rotated else None
    want = np.asarray(jsrf.sample_wavevectors(
        k_vec, M, model, rx, ry, smoothness,
        angle if rotated else 0.0))
    got = _port_wavevectors(u, theta, model, smoothness, rx, ry,
                            angle).numpy()
    assert got.shape == want.shape == (2, M) and got.dtype == np.float32
    length = np.hypot(want[0], want[1])
    assert np.all(np.abs(got - want) <= WAVE_RTOL * length), model
    assert np.isfinite(got).all()


@pytest.mark.parametrize("shape", [(20, 20), (48, 48)], ids=["20", "48"])
@pytest.mark.parametrize("model,smoothness", MODELS)
def test_srf_field_matches_jax(model, smoothness, shape):
    key = jax.random.key(3)
    rx = np.float32(6e3)
    want = np.asarray(jsrf.srf_field(key, shape, RES, model, rx, rx,
                                     smoothness))
    u, theta, z1, z2 = _srf_key_draws(key)
    kv = _port_wavevectors(u, theta, model, smoothness, rx, rx)
    got = tsrf.srf_field(kv[None], _t(z1)[None], _t(z2)[None], shape,
                         RES)[0].numpy()
    assert got.shape == shape and got.dtype == np.float32
    err = np.abs(got - want)
    if model == "Exponential":
        assert (err > FIELD_ATOL).mean() <= EXP_EXCESS_MAX, err.max()
    else:
        assert err.max() <= FIELD_ATOL, err.max()


def test_harmonics_dispatcher_and_batch_invariance():
    """On the CPU the dispatcher is the plain version; a chain's field
    does not depend on the chains sharing the call (the plain version's
    chunks depend on the grid alone), nor does the kernel's launch
    counter move; bad operands are refused."""
    rng = np.random.default_rng(0)
    n, ny, nx = 3, 9, 13
    kv = _t(rng.normal(0.0, 1e-3, (n, 2, M)).astype(np.float32))
    z1 = _t(rng.normal(size=(n, M)).astype(np.float32))
    z2 = _t(rng.normal(size=(n, M)).astype(np.float32))
    before = tsk.srf_harmonics.launches
    got = tsk.srf_harmonics(kv, z1, z2, ny, nx, RES)
    assert tsk.srf_harmonics.launches == before
    assert torch.equal(got, tsk.srf_harmonics_reference(kv, z1, z2, ny, nx,
                                                        RES))
    for i in range(n):
        one = tsk.srf_harmonics(kv[i:i + 1], z1[i:i + 1], z2[i:i + 1], ny,
                                nx, RES)
        assert torch.equal(one[0], got[i]), i
    # a direct float64 sum of the same harmonics
    x = np.arange(nx, dtype=np.float32) * np.float32(RES)
    y = np.arange(ny, dtype=np.float32) * np.float32(RES)
    k = kv.numpy().astype(np.float64)
    phase = (y[:, None, None] * k[0, 1] + x[None, :, None] * k[0, 0])
    f64 = (np.cos(phase) @ z1[0].double().numpy()
           + np.sin(phase) @ z2[0].double().numpy()) / np.sqrt(M)
    np.testing.assert_allclose(got[0].numpy(), f64, atol=1e-5)
    with pytest.raises(ValueError, match=r"z1 must be \(3, 1000\)"):
        tsk.srf_harmonics(kv, z1[:, :5], z2, ny, nx, RES)
    with pytest.raises(TypeError, match="float32"):
        tsk.srf_harmonics(kv.double(), z1, z2, ny, nx, RES)


# --- randfield: the SRF block ------------------------------------------------

def _rf_configs(model="Matern", smoothness=1.3, nugget_max=0.0,
                isotropic=True):
    kw = dict(range_min_x=3e3, range_max_x=8e3, range_min_y=1.5e3,
              range_max_y=4e3, scale_min=20.0, scale_max=60.0,
              nugget_max=nugget_max, model_name=model, isotropic=isotropic,
              smoothness=smoothness, spectral=False)
    blocks = dict(min_block_x=12, max_block_x=20, min_block_y=10,
                  max_block_y=18, steps=3)
    weights = dict(L=2.0, x0=0.0, k=6.0, offset=1.0, max_dist=5e3,
                   resolution=RES)
    return kw, blocks, weights


def _jax_block_draws(key, static, arrays):
    """Every value ``mcmc_tpu.models.randfield.draw_block(key, ...)``
    draws by the SRF method, as numpy."""
    k_size, k_params, k_field, k_nug = jax.random.split(key, 4)
    size_idx = jax.random.randint(k_size, (), 0, static.n_sizes)
    scale, nug, rx, ry = jsp.sample_field_params(
        k_params, arrays.scale_min, arrays.scale_max, arrays.nugget_max,
        arrays.range_min_x, arrays.range_max_x, arrays.range_min_y,
        arrays.range_max_y, static.isotropic)
    k_field, k_ang = jax.random.split(k_field)
    angle = (None if static.isotropic else
             jax.random.uniform(k_ang, (), minval=0.0, maxval=jnp.pi))
    u, theta, z1, z2 = _srf_key_draws(k_field)
    nz = jax.random.normal(k_nug, (static.B, static.B))
    return {k: None if v is None else np.asarray(v) for k, v in dict(
        size_idx=size_idx, scale=scale, nug=nug, range_x=rx, range_y=ry,
        angle=angle, wave_u=u, wave_theta=theta, z1=z1, z2=z2,
        nugget_noise=nz).items()}


def _port_block(d, static, arrays, impl="auto"):
    """The port's SRF block from the stacked draws ``d`` (leading chain
    axis): wavevectors, the harmonic sum, ``finish_block_srf``."""
    t = {k: None if v is None else _t(v) for k, v in d.items()}
    kv = tsrf.sample_wavevectors(t["wave_u"], t["wave_theta"],
                                 static.model_name, t["range_x"],
                                 t["range_y"], static.smoothness, t["angle"])
    raw = tsrf.srf_field(kv, t["z1"], t["z2"], (static.B, static.B),
                         static.resolution, impl)
    nugget = static.has_nugget
    return trf.finish_block_srf(raw, t["size_idx"], t["scale"], arrays,
                                t["nugget_noise"] if nugget else None,
                                t["nug"] if nugget else None)


def _stack(draws):
    return {k: (None if draws[0][k] is None
                else np.stack([d[k] for d in draws])) for k in draws[0]}


@pytest.mark.parametrize("isotropic", [True, False],
                         ids=["isotropic", "anisotropic"])
@pytest.mark.parametrize("nugget_max", [0.0, 25.0], ids=["plain", "nugget"])
def test_srf_draw_block_matches_jax(nugget_max, isotropic):
    kw, blocks, weights = _rf_configs(nugget_max=nugget_max,
                                      isotropic=isotropic)
    jstatic, jarrays = jrf.build_randfield(JRandFieldConfig(**kw),
                                           JBlockMenuConfig(**blocks),
                                           JWeightConfig(**weights))
    tstatic, tarrays = trf.build_randfield(RandFieldConfig(**kw),
                                           trf.BlockMenuConfig(**blocks),
                                           trf.WeightConfig(**weights),
                                           device="cpu")
    assert dataclasses.asdict(tstatic) == dataclasses.asdict(jstatic)
    assert not tstatic.spectral
    keys = jax.random.split(jax.random.key(5), 6)
    want = np.stack([np.asarray(jrf.draw_block(k, jstatic, jarrays)[0])
                     for k in keys])
    d = _stack([_jax_block_draws(k, jstatic, jarrays) for k in keys])
    got = _port_block(d, tstatic, tarrays).numpy()
    # the block's values are O(scale) = O(20); 1e-4 on the unit field
    scale = d["scale"][:, None, None]
    assert np.all(np.abs(got - want) <= FIELD_ATOL * scale)
    np.testing.assert_array_equal(got == 0, want == 0)


# --- the port's own generator, statistically (tests/test_srf.py) -------------

def _port_fields(seed, n, shape, model, rx, ry, smoothness, angle=None):
    gen = make_generator(seed, CPU)
    u, theta, z1, z2, _ = tsrf.draw_srf(gen, n, True, CPU)
    kv = tsrf.sample_wavevectors(
        u, theta, model, torch.full((n,), rx), torch.full((n,), ry),
        smoothness, None if angle is None else torch.full((n,), angle))
    return tsrf.srf_field(kv, z1, z2, shape, RES).double().numpy()


@pytest.mark.parametrize("model,smoothness", MODELS)
def test_variance_and_correlogram_match_the_model(model, smoothness):
    R = 6e3
    f = _port_fields(7, 48, (48, 48), model, R, R, smoothness)
    var = f.var()
    corr = np.array([
        (np.mean(f[:, :, :-h] * f[:, :, h:])
         + np.mean(f[:, :-h, :] * f[:, h:, :])) / (2 * var)
        for h in range(1, 9)])
    # unit-variance model; ensemble variance within ~10 %
    assert var == pytest.approx(1.0, rel=0.12), var
    want = covariance_norm(CovarianceSpec(model.lower(), s=smoothness),
                           np.arange(1, 9) * RES / R, 1.0, 0.0).numpy()
    assert np.all(np.abs(corr - want) < 0.06), (model, corr, want)


def test_fields_are_not_standardized():
    """Per-realization variance is random (gstools' behaviour), unlike
    the spectral path's exact scale^2."""
    f = _port_fields(3, 24, (32, 32), "Gaussian", 8e3, 8e3, None)
    assert f.reshape(24, -1).var(axis=1).std() > 0.05


def test_anisotropy_rotates_the_correlation():
    f = _port_fields(5, 32, (48, 48), "Exponential", 12e3, 2e3, None, 0.0)
    var = f.var()
    cx = np.mean(f[:, :, :-4] * f[:, :, 4:]) / var  # x lag, major range
    cy = np.mean(f[:, :-4, :] * f[:, 4:, :]) / var  # y lag, minor range
    assert cx > cy + 0.15, (cx, cy)
    g = _port_fields(5, 32, (48, 48), "Exponential", 12e3, 2e3, None,
                     float(np.pi / 2))
    var = g.var()
    assert (np.mean(g[:, :-4, :] * g[:, 4:, :]) / var
            > np.mean(g[:, :, :-4] * g[:, :, 4:]) / var + 0.15)


# --- the RandField wrapper ---------------------------------------------------

def test_randfield_srf_method():
    rf = trf.RandField(3e3, 8e3, 3e3, 8e3, 20, 60, 4.0, "Gaussian", True,
                       rng_seed=0, device="cpu")
    rf.set_generation_method(False)
    assert rf.config.spectral is False
    X = np.arange(32) * RES
    f = rf.get_random_field(X, X)
    assert f.shape == (32, 32) and f.dtype == np.float32
    assert np.isfinite(f).all()
    three = rf.get_random_field(X, np.arange(24) * RES, n=3)
    assert three.shape == (3, 24, 32)
    # not standardized: the fields' spreads differ beyond their scales'
    again = trf.RandField(3e3, 8e3, 3e3, 8e3, 20, 60, 4.0, "Gaussian", True,
                          rng_seed=0, device="cpu")
    again.set_generation_method(False)
    np.testing.assert_array_equal(again.get_random_field(X, X), f)
    with pytest.raises(ValueError, match="square cells"):
        rf.get_random_field(X, X * 2)
    rf.set_block_sizes(12, 20, 10, 18, 3)
    rf.set_weight_param(2.0, 0.0, 6.0, 1.0, 5e3, RES)
    block = rf.get_rfblock()
    assert block.shape in [tuple(hw) for hw in rf.pairs[::-1].T]
    assert np.isfinite(block).all() and np.abs(block).max() > 0
    rf.set_generation_method(True)
    assert rf.get_random_field(X, X).shape == (32, 32)


def test_randfield_srf_fields_follow_the_jax_recipe():
    """``get_random_field`` by the SRF method is the JAX package's recipe
    (``randfield.py:317-335``), (raw + nugget noise) x scale and
    unstandardized, on the wrapper's own draws in their documented
    order: the parameters, ``draw_srf``'s, then the nugget's noise."""
    rf = trf.RandField(3e3, 8e3, 3e3, 8e3, 20, 60, 4.0, "Matern", True,
                       smoothness=1.3, rng_seed=9, device="cpu")
    rf.set_generation_method(False)
    X = np.arange(20) * RES
    got = rf.get_random_field(X, X)
    cfg = rf.config
    gen = make_generator(9, CPU)
    scale, nug, rx, ry = trf.sample_field_params(
        gen, cfg.scale_min, cfg.scale_max, cfg.nugget_max,
        cfg.range_min_x, cfg.range_max_x, cfg.range_min_y, cfg.range_max_y,
        True, n=1, device=CPU)
    u, theta, z1, z2, _ = tsrf.draw_srf(gen, 1, True, CPU)
    noise = torch.randn((1, 20, 20), generator=gen)
    port_kv = tsrf.sample_wavevectors(u, theta, "Matern", rx, ry, 1.3)
    raw = tsrf.srf_field(port_kv, z1, z2, (20, 20), RES)
    want = ((raw + noise * torch.sqrt(nug)[:, None, None])
            * scale[:, None, None])[0].numpy()
    np.testing.assert_array_equal(got, want)


# --- the CRF step at the seam: interop-carried JAX SRF chains ----------------

SEAM_CASES = {
    # model, smoothness, nugget, isotropic
    "matern": ("Matern", 1.3, 0.0, True),
    "gaussian_nugget_aniso": ("Gaussian", None, 25.0, False),
}


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=H, W=W)


@pytest.fixture(scope="module", params=list(SEAM_CASES))
def carried(request, problem):
    model, smoothness, nugget, isotropic = SEAM_CASES[request.param]
    jchain = build_small_chain(problem, blocks=(12, 20))
    jchain._rf_cfg = dataclasses.replace(
        jchain._rf_cfg, model_name=model, smoothness=smoothness,
        nugget_max=nugget, isotropic=isotropic, range_min_y=2e3,
        range_max_y=5e3, spectral=False)
    jstatic, jconsts = jchain.build()
    pstatic, pconsts = consts_from_numpy(jax.tree.map(np.asarray, jconsts),
                                         dataclasses.asdict(jstatic),
                                         device="cpu")
    beds = np.random.default_rng(3).normal(
        problem["initial_bed"], 5.0, (N_CHAINS, H, W)).astype(np.float32)
    beds = np.minimum(beds, problem["surf"] - 5.0).astype(np.float32)
    return dict(case=request.param, jstatic=jstatic, jconsts=jconsts,
                pstatic=pstatic, pconsts=pconsts, beds=beds)


def test_carried_static_keeps_the_srf_method(carried):
    """The carried static says SRF, and the port's step draws SRF draws
    (no half-spectrum noise) and hands the window op finished blocks."""
    pstatic, pconsts = carried["pstatic"], carried["pconsts"]
    assert not pstatic.rf.spectral
    d = crf.draw(make_generator(1, CPU), pstatic, pconsts, N_CHAINS)
    assert d.noise is None
    for name in ("wave_u", "wave_theta", "z1", "z2"):
        assert getattr(d, name).shape == (N_CHAINS, M), name
    assert (d.angle is None) == pstatic.rf.isotropic
    streams = PerChainStreams.from_seeds(list(range(N_CHAINS)), CPU)
    d = crf.draw(streams, pstatic, pconsts, N_CHAINS)
    assert d.noise is None and d.z1.shape == (N_CHAINS, M)
    names = [e.name for e in crf.draw_plan_entries(pstatic)]
    assert "wave_u" in names and ("angle" in names) != pstatic.rf.isotropic


@pytest.mark.parametrize("impl", ["auto", "eager"])
def test_srf_steps_at_the_seam_match_jax(carried, impl):
    """Ten steps: the JAX ``make_kernel`` on ``draw_block``'s SRF blocks
    against the port's ``propose`` + ``make_kernel`` on the same draws
    (accept flags equal, losses to rtol 1e-6, fields to rtol 5e-5 / atol
    1e-3)."""
    jstatic, jconsts = carried["jstatic"], carried["jconsts"]
    pstatic, pconsts = carried["pstatic"], carried["pconsts"]
    jstep = jax.jit(jax.vmap(jmake_kernel(jstatic),
                             in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0)))
    pstep = crf.make_kernel(pstatic, impl)
    key0 = jax.random.key(0)
    jstates = jax.vmap(lambda bed: jinit_state(bed, key0, jconsts))(
        jnp.asarray(carried["beds"]))
    pstates = state_from_numpy(jax.tree.map(
        np.asarray, dataclasses.replace(jstates, key=None)), device="cpu")
    region = np.asarray(jconsts.region_cells)
    rng = np.random.default_rng(17)
    keys = jax.random.split(jax.random.key(23), 10 * N_CHAINS).reshape(
        10, N_CHAINS)
    n_acc = 0
    for it in range(10):
        blocks = [jrf.draw_block(k, jstatic.rf, jconsts.rf)
                  for k in keys[it]]
        f = jnp.stack([b[0] for b in blocks])
        w = jnp.stack([b[2] for b in blocks])
        h = jnp.stack([b[3] for b in blocks])
        draws = _stack([_jax_block_draws(k, jstatic.rf, jconsts.rf)
                        for k in keys[it]])
        cidx = rng.integers(0, pstatic.n_region, N_CHAINS)
        u = rng.uniform(0.0, 1.0, N_CHAINS).astype(np.float32)
        cx, cy = region[cidx, 0], region[cidx, 1]
        jstates, jtr = jstep(jconsts, jstates, f, h, w, jnp.asarray(cx),
                             jnp.asarray(cy), jnp.asarray(u), jstates.key)
        t = {k: None if v is None else _t(v) for k, v in draws.items()}
        if not pstatic.rf.has_nugget:
            t["nug"] = t["nugget_noise"] = None
        d = crf.Draws(cidx=_t(cidx), u=_t(u), **t)
        pf = crf.propose(pstatic, pconsts, d, impl)
        np.testing.assert_allclose(pf.numpy(), np.asarray(f),
                                   atol=FIELD_ATOL * 20.0)
        pstates, ptr = pstep(pconsts, pstates, pf, d.size_idx, d.scale,
                             _t(cx), _t(cy), d.u)
        msg = f"{carried['case']} step {it}"
        np.testing.assert_array_equal(ptr["step"].numpy(),
                                      np.asarray(jtr["step"]), err_msg=msg)
        for k in ("loss_mc", "loss_data", "loss"):
            np.testing.assert_allclose(ptr[k].numpy(), np.asarray(jtr[k]),
                                       rtol=1e-6, err_msg=f"{msg} {k}")
        np.testing.assert_allclose(pstates.fields.numpy(),
                                   np.asarray(jstates.fields), rtol=5e-5,
                                   atol=1e-3, err_msg=msg)
        n_acc += int(ptr["step"].sum())
    assert 0 < n_acc < 10 * N_CHAINS, n_acc


# --- the entry points with spectral=False ------------------------------------

def _srf_chain(p, isotropic=True, nugget=0.0):
    from tests.torch_helpers import small_chain

    chain = small_chain(p, nugget_max=nugget)
    chain._rf_cfg = dataclasses.replace(chain._rf_cfg, spectral=False,
                                        isotropic=isotropic)
    return chain


def test_srf_farm_runs_and_falls(problem):
    sampler = MultiChainSampler(_srf_chain(problem, isotropic=False,
                                           nugget=9.0), 3, device="cpu")
    states = sampler.init(seeds=4)
    bed0 = states.bed.clone()
    states, tr = sampler.run(states, 31, segment_size=10, progress=False)
    assert np.isfinite(tr["loss"]).all()
    assert tr["loss"][:, -1].mean() < tr["loss"][:, 0].mean()
    assert 0.02 < tr["step"][:, 1:].mean() < 0.98
    outside = ~(sampler.consts.update_mask > 0)
    assert torch.equal(states.bed[:, outside], bed0[:, outside])
    _, again = sampler.run(sampler.init(seeds=4), 31, segment_size=7,
                           progress=False)
    np.testing.assert_array_equal(again["loss"], tr["loss"])


def test_srf_chain_i_depends_on_its_own_seed_alone(problem):
    """A list-seeded SRF farm: chain i's draws bitwise the 1-chain farm of
    seeds[i], one draw plan a step (no keyed spectrum); traces to rtol
    1e-6 as tests/test_torch_seeds.py holds the spectral farm."""
    seeds = [101, 202, 303]
    chain = _srf_chain(problem, isotropic=False)
    static, consts = chain.build("cpu")
    farm = PerChainStreams.from_seeds(seeds, "cpu")
    ones = [PerChainStreams.from_seeds([s], "cpu") for s in seeds]
    for _ in range(3):
        d3 = crf.draw(farm, static, consts, 3)
        for i, one in enumerate(ones):
            d1 = crf.draw(one, static, consts, 1)
            for f in dataclasses.fields(d1):
                a, b = getattr(d3, f.name), getattr(d1, f.name)
                assert (a is None) == (b is None), f.name
                if a is not None:
                    assert torch.equal(a[i], b[0]), (i, f.name)
            one.advance()
        farm.advance()
    sampler = MultiChainSampler(chain, 3, device="cpu")
    _, tr3 = sampler.run(sampler.init(seeds=seeds), 9, progress=False)
    for i, seed in enumerate(seeds):
        one = MultiChainSampler(_srf_chain(problem, isotropic=False), 1,
                                device="cpu")
        _, tr1 = one.run(one.init(seeds=[seed]), 9, progress=False)
        for k in ("step", "block"):
            np.testing.assert_array_equal(tr3[k][i], tr1[k][0], err_msg=k)
        np.testing.assert_allclose(tr3["loss"][i], tr1["loss"][0],
                                   rtol=1e-6)


def test_chain_run_adopts_an_srf_randfield(problem):
    """``ChainCRF.run(n, RF)`` with an SRF ``RandField`` is the 1-chain SRF
    farm seeded [seed], bit for bit, and differs from the spectral run."""
    chain = _srf_chain(problem)
    cfg = chain._rf_cfg
    rf = trf.RandField(cfg.range_min_x, cfg.range_max_x, cfg.range_min_y,
                       cfg.range_max_y, cfg.scale_min, cfg.scale_max,
                       cfg.nugget_max, cfg.model_name, cfg.isotropic,
                       cfg.smoothness, device="cpu")
    rf.set_generation_method(False)
    b = chain._block_cfg
    rf.set_block_sizes(b.min_block_x, b.max_block_x, b.min_block_y,
                       b.max_block_y, b.steps)
    wc = chain._weight_cfg
    rf.set_weight_param(wc.L, wc.x0, wc.k, wc.offset, wc.max_dist,
                        wc.resolution)
    spectral = _srf_chain(problem)
    spectral._rf_cfg = dataclasses.replace(cfg, spectral=True)
    plain = spectral.run(15, seed=8, device="cpu")
    out = spectral.run(15, rf, seed=8, device="cpu")
    assert spectral._rf_cfg.spectral is False
    sampler = MultiChainSampler(_srf_chain(problem), 1, device="cpu")
    _, tr = sampler.run(sampler.init(seeds=[8]), 15, progress=False)
    for k, name in (("loss", "loss"), ("step", "steps"), ("block", "blocks")):
        np.testing.assert_array_equal(out[name], tr[k][0], err_msg=k)
    assert not np.array_equal(out["loss"], plain["loss"])


def test_srf_drivers_match_the_jax_result_format(problem, tmp_path):
    """Both packages' ``large_scale_chain_farm`` on one SRF chain: per-chain
    result tuples of the same shapes and dtypes, finite."""
    from mcmc_tpu import drivers as jdrivers
    from mcmc_tpu_torch import drivers
    from tests.test_torch_chain_crf import _jax_chain, _port_chain

    jchain = _jax_chain(problem, "crf_matern")
    jchain._rf_cfg = dataclasses.replace(jchain._rf_cfg, spectral=False)
    kw = dict(n_chains=2, rng_seeds=3, n_iter=6, segment_size=3,
              progress=False, quiet=True)
    want = jdrivers.large_scale_chain_farm(jchain,
                                           output_path=tmp_path / "jax", **kw)
    pchain = _port_chain(problem, jchain)
    assert pchain._rf_cfg.spectral is False
    got = drivers.large_scale_chain_farm(pchain,
                                         output_path=tmp_path / "port",
                                         device="cpu", **kw)
    shapes = [[(np.shape(x), np.asarray(x).dtype) for x in r] for r in got]
    assert shapes == [[(np.shape(x), np.asarray(x).dtype) for x in r]
                      for r in want]
    assert all(np.isfinite(r[3]).all() for r in got)


def test_srf_cli_farm_resumes_bitwise(tmp_path):
    """A CLI config with ``"spectral": false`` runs a CRF farm, and a
    resumed run equals an uninterrupted one bit for bit."""
    from tests.test_torch_cli import (_crf_config, _main, _write_config,
                                      _write_dataset)

    _write_dataset(tmp_path)

    def cfg(n_iter, out):
        c = _crf_config(n_iter=n_iter, segment=4)
        c["crf"]["randfield"]["spectral"] = False
        c["farm"]["output_path"] = out
        c["save"] = {"final_beds": f"{out}_beds.npy",
                     "histories": f"{out}_hist.npz"}
        return c

    path = _write_config(tmp_path, cfg(8, "resumed"))
    assert _main(path) == 0
    _write_config(tmp_path, cfg(14, "resumed"))
    assert _main(path) == 0
    straight = _write_config(tmp_path, cfg(14, "straight"), "straight.json")
    assert _main(straight) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "resumed_beds.npy"),
                                  np.load(tmp_path / "straight_beds.npy"))
    with np.load(tmp_path / "resumed_hist.npz") as a, \
            np.load(tmp_path / "straight_hist.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["loss"].shape == (2, 14) and np.isfinite(a["loss"]).all()
