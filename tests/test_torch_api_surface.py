"""The port's public import surface against the JAX package's.

Code written against ``mcmc_tpu`` should run with the package name changed
to ``mcmc_tpu_torch``, except where the port deliberately has no
counterpart or one is still to come.  For the package and each of its
subpackages, the reference's ``__all__`` less the port's must equal the
exclusions listed here, exactly; each function the two share must take
the reference's parameters in its order, the random source aside (the
reference's ``key`` / ``keys``, the port's ``gen`` or keyword-only
``rng``), any the port takes by keyword only at the end, any further
parameter of the port's keyword-only or defaulted;
and a reference-style call of a function whose port has no key must fail
at once with a TypeError that names the port's form.  CPU only, small
synthetic problems.
"""

import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

import mcmc_tpu_torch
from mcmc_tpu_torch.models import chain_crf as tcrf
from mcmc_tpu_torch.models import chain_sgs as tsgs
from mcmc_tpu_torch.parallel import init_states, run_chains
from tests.conftest import make_synthetic_problem
from tests.torch_helpers import small_chain, small_sgs_chain

# The reference's exports the port leaves out, by subpackage
EXCLUDED = {
    "": set(),
    "ops": set(),
    "models": set(),
    "parallel": set(),
    "io": set(),
    "utils": {
        # deliberate (ROADMAP ground rules): JAX keys, and the TPU's
        # auto-padding of the domain
        "as_key", "split_for_chains", "aligned_shape", "pad_domain",
    },
    "geostats": set(),
}
RANDOM_SOURCES = {"key", "keys", "gen", "rng"}
# shared functions whose port takes no random source: the port's chain
# states carry no key (the runners take ``rng`` instead)
NO_RANDOM_SOURCE = {"init_state", "init_states", "sgs_init_state"}
# functions the reference defines outside any ``__all__``, by module
MODULE_FUNCTIONS = (("models.chain_sgs", "run_sgs_chain"),
                    ("models.chain_sgs", "sgs_init_state"),
                    ("models.chain_crf", "run_chain"),
                    ("models.chain_crf", "init_state"),
                    ("parallel.sampler", "run_chains"),
                    ("parallel.sampler", "init_states"))


def _module(package, sub):
    return importlib.import_module(package + ("." + sub if sub else ""))


def _shared_functions():
    out = []
    for sub in EXCLUDED:
        ref, port = _module("mcmc_tpu", sub), _module("mcmc_tpu_torch", sub)
        for name in sorted(set(ref.__all__) & set(port.__all__)):
            if inspect.isfunction(getattr(port, name)):
                out.append((sub, name))
    return out + list(MODULE_FUNCTIONS)


@pytest.mark.parametrize("sub", list(EXCLUDED))
def test_exports_match_the_reference_but_the_listed(sub):
    ref, port = _module("mcmc_tpu", sub), _module("mcmc_tpu_torch", sub)
    assert set(ref.__all__) - set(port.__all__) == EXCLUDED[sub]
    for name in port.__all__:
        assert hasattr(port, name), name


def test_import_binds_the_reference_subpackages():
    for name in ("ops", "models", "geostats", "parallel", "io", "utils"):
        assert getattr(mcmc_tpu_torch, name) is importlib.import_module(
            f"mcmc_tpu_torch.{name}")
    assert isinstance(mcmc_tpu_torch.__version__, str)


def _parameters(fn):
    """(positional names, keyword-only names, {name: has a default}) with
    ``*args`` / ``**kw`` left out."""
    params = inspect.signature(fn).parameters.values()
    pos = [p.name for p in params if p.kind in (p.POSITIONAL_ONLY,
                                                p.POSITIONAL_OR_KEYWORD)]
    kwonly = [p.name for p in params if p.kind == p.KEYWORD_ONLY]
    return pos, kwonly, {p.name: p.default is not p.empty for p in params}


@pytest.mark.parametrize("sub,name", _shared_functions())
def test_shared_functions_take_the_reference_arguments(sub, name):
    ref = getattr(_module("mcmc_tpu", sub), name)
    port = getattr(_module("mcmc_tpu_torch", sub), name)
    rpos, rkw, _ = _parameters(ref)
    ppos, pkw, defaulted = _parameters(port)
    r_rand = [i for i, p in enumerate(rpos) if p in RANDOM_SOURCES]
    p_rand = [i for i, p in enumerate(ppos) if p in RANDOM_SOURCES]
    if name in NO_RANDOM_SOURCE:
        assert r_rand and not p_rand and not set(pkw) & RANDOM_SOURCES
    elif r_rand:  # the port's random source where the reference's key is
        assert p_rand == r_rand or (not p_rand and "rng" in pkw), (rpos,
                                                                   ppos)
    rest = [p for p in rpos if p not in RANDOM_SOURCES]
    prest = [p for p in ppos if p not in RANDOM_SOURCES]
    common = rest[:len(prest)]
    assert prest[:len(common)] == common, (rpos, ppos)
    for extra in rest[len(prest):]:  # keyword-only in the port: passed
        assert extra in pkw, (name, extra)  # by position, a call fails
    for extra in prest[len(rest):]:  # never bound by a reference call
        assert defaulted[extra], (name, extra)
    assert set(rkw) <= set(pkw) | set(ppos), (rkw, pkw)


@pytest.fixture(scope="module")
def built():
    p = make_synthetic_problem(H=40, W=48)
    crf = small_chain(p, blocks=(8, 12))
    static, consts = crf.build("cpu")
    sgs = small_sgs_chain(p)
    sgs_static, sgs_consts = sgs.build("cpu")
    return dict(crf=crf, static=static, consts=consts, sgs=sgs,
                sgs_static=sgs_static, sgs_consts=sgs_consts)


def test_reference_style_init_state_names_the_port_form(built):
    key = jax.random.key(0)
    with pytest.raises(TypeError, match=r"init_state\(bed, consts, "
                                        r"n_chains=None\)"):
        tcrf.init_state(built["crf"].initial_bed, key, built["consts"])
    with pytest.raises(TypeError, match=r"init_states\(initial_beds, "
                                        r"consts, n_chains=None"):
        init_states(built["crf"].initial_bed[None], key[None],
                    built["consts"])
    with pytest.raises(TypeError, match=r"sgs_init_state\(bed_detrended, "
                                        r"consts"):
        tsgs.sgs_init_state(built["sgs"]._initial_detrended, key,
                            built["sgs_consts"])
    # the port's form works, a shared bed for one chain
    state = tcrf.init_state(built["crf"].initial_bed, built["consts"])
    assert state.fields.shape[0] == 1


def test_sgs_init_states_needs_the_z_plane(built):
    """The consts do not say whether an SGS chain transforms, so
    ``init_states`` never guesses its z-plane: without ``z0`` an SGS call
    raises at once, and a CRF call with one too."""
    with pytest.raises(ValueError, match=r"needs z0.*normal scores"):
        init_states(built["sgs"]._initial_detrended, built["sgs_consts"], 2)
    with pytest.raises(ValueError, match="a CRF chain has none"):
        init_states(built["crf"].initial_bed, built["consts"], 2,
                    z0=built["crf"].initial_bed)
    state = init_states(built["sgs"]._initial_detrended, built["sgs_consts"],
                        2, z0=built["sgs"]._initial_z)
    assert torch.equal(state.fields[:, 3],
                       torch.as_tensor(built["sgs"]._initial_z).expand(
                           2, -1, -1))


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_reference_style_runner_call_names_the_port_form(built, family):
    if family == "crf":
        static, consts = built["static"], built["consts"]
        state = tcrf.init_state(built["crf"].initial_bed, consts)
        run, form = tcrf.run_chain, r"run_chain\(static, consts, state"
    else:
        static, consts = built["sgs_static"], built["sgs_consts"]
        state = init_states(built["sgs"]._initial_detrended, consts, 1,
                            z0=built["sgs"]._initial_z)
        run, form = tsgs.run_sgs_chain, r"run_sgs_chain\(static, consts"
    with pytest.raises(TypeError, match=form + r".*rng"):
        run(static, consts, state, 3, False)
    with pytest.raises(TypeError, match=r"run_chains\(static, consts, "
                                        r"states.*rng"):
        run_chains(static, consts, state, 3, False)
    with pytest.raises(TypeError, match=r"rng must be a torch.Generator"):
        run(static, consts, state, 3, rng=jax.random.key(0))
    with pytest.raises(ValueError, match="impl must be one of"):
        run_chains(static, consts, state, 3, rng=torch.Generator(),
                   impl="xla")
    # the port's form works
    _, traces = run(static, consts, state, 3, rng=torch.Generator())
    assert traces["loss"].shape == (3,)
    assert np.isnan(traces["block"][0].numpy()).all()
