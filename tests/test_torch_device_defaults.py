"""The port's public builders run on the card unless the caller asks for
the CPU: on a machine without a card, leaving the device out raises and
names ``device="cpu"``; asking for the CPU runs there."""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcmc_tpu_torch.interop import (consts_from_numpy, sgs_consts_from_numpy,
                                    sgs_state_from_numpy, state_from_numpy)
from mcmc_tpu_torch.models.randfield import build_randfield
from mcmc_tpu_torch.ops.transforms import (NormalScoreLUT,
                                           NormalScoreTransform)
from mcmc_tpu_torch.utils.config import (BlockMenuConfig, RandFieldConfig,
                                         WeightConfig)
from tests.torch_helpers import small_chain, small_problem, small_sgs_chain


def _randfield(**kw):
    _, arrays = build_randfield(
        RandFieldConfig(3e3, 8e3, 3e3, 8e3, scale_min=20.0, scale_max=60.0,
                        nugget_max=0.0, model_name="Matern", isotropic=True,
                        smoothness=1.3),
        BlockMenuConfig(12, 20, 12, 20, steps=3),
        WeightConfig(L=2.0, x0=0.0, k=6.0, offset=1.0, max_dist=5e3,
                     resolution=500.0), **kw)
    return arrays.edge_masks


def _lut(**kw):
    data = np.random.default_rng(0).normal(100.0, 30.0, 2000)
    return NormalScoreLUT.from_transform(NormalScoreTransform.fit(data, 200),
                                         n=64, **kw).inv_table


@functools.lru_cache(maxsize=None)
def _built(family):
    """A small chain's (static, consts), built on the CPU: the port's own
    objects stand in for the JAX package's (the same attribute names)."""
    make = small_chain if family == "crf" else small_sgs_chain
    return make(small_problem(H=48, W=48)).build("cpu")


def _consts(**kw):
    static, consts = _built("crf")
    return consts_from_numpy(consts, dataclasses.asdict(static),
                             **kw)[1].stacked


def _sgs_consts(**kw):
    static, consts = _built("sgs")
    return sgs_consts_from_numpy(consts, dataclasses.asdict(static),
                                 **kw)[1].cov_stamp


def _numpy_state(sgs):
    v = np.linspace(1.0, 2.0, 3, dtype=np.float32)
    extra = {} if sgs else dict(loss_data=v, loss_data_comp=v)
    return SimpleNamespace(
        fields=np.ones((3, 4 if sgs else 3, 8, 8), np.float32), loss_mc=v,
        loss_comp=v, accepted=np.arange(3, dtype=np.int32), **extra)


def _state(**kw):
    return state_from_numpy(_numpy_state(False), **kw).fields


def _sgs_state(**kw):
    return sgs_state_from_numpy(_numpy_state(True), **kw).fields


@pytest.mark.parametrize(
    "build", [_randfield, _lut, _consts, _state, _sgs_consts, _sgs_state],
    ids=["build_randfield", "NormalScoreLUT", "consts_from_numpy",
         "state_from_numpy", "sgs_consts_from_numpy",
         "sgs_state_from_numpy"])
def test_builders_run_on_the_card_unless_asked(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(device="cuda")
    out = build(device="cpu")
    assert out.device == torch.device("cpu") and torch.isfinite(out).all()


def _sgs_grid():
    p = small_problem(H=16, W=16)
    vario = dict(major_range=3e3, minor_range=3e3, azimuth=0.0, sill=1.0,
                 nugget=0.0, vtype="Exponential")
    return (p["xx"], p["yy"], p["cond_bed"], vario), p


def _sgs(**kw):
    from mcmc_tpu_torch.geostats import sgs

    args, _ = _sgs_grid()
    return torch.as_tensor(sgs(*args, num_points=8, half_window=4, seed=1,
                               **kw))


def _krige(**kw):
    from mcmc_tpu_torch.geostats import krige

    args, _ = _sgs_grid()
    return torch.as_tensor(krige(*args, num_points=8, half_window=4,
                                 **kw)[0])


def _initial_beds(**kw):
    from mcmc_tpu_torch.geostats import generate_initial_beds

    args, p = _sgs_grid()
    return torch.as_tensor(generate_initial_beds(
        *args, surf=p["surf"], num_points=8, half_window=4, **kw)[0])


def _randfield(**kw):
    from mcmc_tpu_torch.models import RandField

    rf = RandField(3e3, 8e3, 3e3, 8e3, 20.0, 60.0, 0.0, "Matern", True, 1.3,
                   rng_seed=2, **kw)
    rf.set_block_sizes(12, 20, 12, 20, 3)
    rf.set_weight_param(2.0, 0.0, 6.0, 1.0, 5e3, 500.0)
    x = np.arange(24) * 500.0
    return torch.as_tensor(np.concatenate([rf.get_random_field(x, x).ravel(),
                                           rf.get_rfblock().ravel()]))


def _randfield_srf(**kw):
    from mcmc_tpu_torch.models import RandField

    rf = RandField(3e3, 8e3, 3e3, 8e3, 20.0, 60.0, 4.0, "Exponential", False,
                   rng_seed=2, **kw)
    rf.set_generation_method(False)
    x = np.arange(24) * 500.0
    return torch.as_tensor(rf.get_random_field(x, x))


def _run(family):
    def run(**kw):
        make = small_chain if family == "crf" else small_sgs_chain
        chain = make(small_problem(H=48, W=48))
        return torch.as_tensor(chain.run(3, seed=1, **kw)["loss"])

    return run


@pytest.mark.parametrize(
    "call", [_sgs, _krige, _initial_beds, _randfield, _randfield_srf,
             _run("crf"), _run("sgs")],
    ids=["sgs", "krige", "generate_initial_beds", "RandField",
         "RandField-srf", "ChainCRF.run", "ChainSGS.run"])
def test_new_entry_points_run_on_the_card_unless_asked(call, monkeypatch):
    """The geostats entry points, the RandField wrapper's draws (by both
    generation methods) and the single-chain runs: leaving the device out means the card, which here
    raises naming device='cpu'; asking for the CPU runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(device="cuda")
    out = call(device="cpu")
    assert out.device == torch.device("cpu") and torch.isfinite(out).all()


def test_initialize_distributed_binds_a_card_or_the_cpu(monkeypatch):
    """A rank binds the card its ``LOCAL_RANK`` names: with no card behind
    it, joining raises (naming device='cpu') and joins nothing, and a
    second rank is never moved onto card 0; ``device="cpu"`` binds the
    CPU (gloo), where the sampler then runs by default."""
    import socket

    import torch.distributed as dist

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.parallel import distributed as mdist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for var, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT",
                       str(port)), ("WORLD_SIZE", "1"), ("RANK", "0"),
                       ("LOCAL_RANK", "1")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(mdist, "_BOUND", {})
    with pytest.raises(RuntimeError, match=r"LOCAL_RANK = 1 names card 1.*"
                                           r"device='cpu'"):
        mdist.initialize_distributed()
    with pytest.raises(RuntimeError, match=r"local_device_ids = 0 names"):
        mdist.initialize_distributed(local_device_ids=[0])
    assert not dist.is_initialized() and mdist.bound_device() is None
    try:
        assert mdist.initialize_distributed(device="cpu") is False
        assert dist.get_backend() == "gloo"
        assert mdist.bound_device() == torch.device("cpu")
        assert mdist.global_chains_mesh().device == torch.device("cpu")
        sampler = MultiChainSampler(small_chain(small_problem(H=32, W=32)),
                                    2)
        assert sampler.device == torch.device("cpu")
        assert mdist.initialize_distributed() is False  # joined already
    finally:
        dist.destroy_process_group()
    assert mdist.bound_device() is None


@pytest.mark.parametrize("name", ["split_rhat", "ess", "rank_normalized_rhat",
                                  "ess_bulk", "ess_tail", "acceptance_rate"])
def test_diagnostics_run_on_the_card_unless_asked(name, monkeypatch):
    """The convergence diagnostics of a numpy trace: leaving the device
    out means the card, which here raises naming device='cpu'; asking for
    the CPU runs there."""
    from mcmc_tpu_torch.parallel import diagnostics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(diagnostics, name)
    x = np.random.default_rng(3).normal(size=(4, 100)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(x, device="cuda")
    assert np.isfinite(fn(x, device="cpu")).all()
