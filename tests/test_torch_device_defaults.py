"""The port's public builders run on the card unless the caller asks for
the CPU: on a machine without a card, leaving the device out raises and
names ``device="cpu"``; asking for the CPU runs there."""

import numpy as np
import pytest
import torch

from mcmc_tpu_torch.models.randfield import build_randfield
from mcmc_tpu_torch.ops.transforms import (NormalScoreLUT,
                                           NormalScoreTransform)
from mcmc_tpu_torch.utils.config import (BlockMenuConfig, RandFieldConfig,
                                         WeightConfig)


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


@pytest.mark.parametrize("build", [_randfield, _lut],
                         ids=["build_randfield", "NormalScoreLUT"])
def test_builders_run_on_the_card_unless_asked(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(device="cuda")
    out = build(device="cpu")
    assert out.device == torch.device("cpu") and torch.isfinite(out).all()
