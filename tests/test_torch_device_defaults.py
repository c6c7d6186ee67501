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
