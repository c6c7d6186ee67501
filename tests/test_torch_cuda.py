"""The CUDA window kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.models.chain_crf import (draw, init_state, propose,
                                             window_operands)
from mcmc_tpu_torch.ops.window_kernel import (fused_window_update,
                                              fused_window_update_reference)
from mcmc_tpu_torch.utils.rng import make_generator
from tests.torch_helpers import (assert_delta_close, block_losses,
                                 small_chain, small_problem)

N = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("data_loss,nugget", [(False, False), (True, False),
                                              (False, True)])
def test_kernel_matches_plain_version(cuda_device, data_loss, nugget):
    """Same state and draws into both; the state advances on the kernel's
    result.  nugget -> the finished-proposal (prefinished) path."""
    chain = small_chain(small_problem(), nugget_max=25.0 if nugget else 0.0,
                        data_loss=data_loss)
    static, consts = chain.build(cuda_device)
    state = init_state(chain.initial_bed, consts, N)
    gen = make_generator(5, cuda_device)
    stacked = consts.stacked.cpu().numpy()
    n_acc = 0
    for it in range(6):
        d = draw(gen, static, consts, N)
        f = propose(static, consts, d).contiguous()
        cx = consts.region_cells[d.cidx, 0]
        cy = consts.region_cells[d.cidx, 1]
        geom, fvals = window_operands(static, consts, state, d.size_idx,
                                      d.scale, cx, cy, d.u)
        old = state.fields.cpu().numpy()
        plain = state.fields.clone()
        kw = dict(use_data_loss=static.use_data_loss,
                  prefinished=static.rf.has_nugget)
        before = fused_window_update.launches
        acc_k, dk, ddk = fused_window_update(
            consts.stacked, state.fields, f, consts.rf.edge_masks, geom,
            fvals, **kw)
        acc_p, dp, ddp = fused_window_update_reference(
            consts.stacked, plain, f, consts.rf.edge_masks, geom, fvals, **kw)
        torch.cuda.synchronize()
        assert fused_window_update.launches == before + 1
        assert torch.equal(acc_k, acc_p), f"iter {it}"
        mc_l, data_l = block_losses(old, stacked, geom.cpu().numpy(), consts)
        assert_delta_close(dk.cpu(), dp.cpu().double().numpy(), mc_l,
                           f"iter {it}")
        assert_delta_close(ddk.cpu(), ddp.cpu().double().numpy(), data_l,
                           f"iter {it}")
        torch.testing.assert_close(state.fields, plain, rtol=5e-5, atol=1e-3)
        state.loss_mc = state.loss_mc + dk
        state.loss_data = state.loss_data + ddk
        n_acc += int(acc_k.sum())
    assert 0 < n_acc < 6 * N


@pytest.mark.cuda
def test_sampler_runs_the_kernel(cuda_device):
    """The sampler's main path launches the kernel once per step, and the
    fused and plain implementations sample the same distribution of
    losses from the same seed."""
    chain = small_chain(small_problem())
    fused = MultiChainSampler(chain, N, device=cuda_device, impl="fused")
    eager = MultiChainSampler(chain, N, device=cuda_device, impl="eager")
    fused_window_update.launches = 0
    s_f, tr_f = fused.run(fused.init(seeds=3), 101, segment_size=50,
                          progress=False)
    assert fused_window_update.launches == 100
    s_e, tr_e = eager.run(eager.init(seeds=3), 101, segment_size=50,
                          progress=False)
    assert fused_window_update.launches == 100
    assert np.isfinite(tr_f["loss"]).all()
    assert tr_f["loss"][:, -1].mean() < tr_f["loss"][:, 0].mean()
    # same draws: the chains agree until a borderline decision flips
    agree = (tr_f["step"] == tr_e["step"]).mean()
    assert agree > 0.99, agree


def test_fused_impl_refuses_cpu():
    chain = small_chain(small_problem(H=48, W=48))
    with pytest.raises(ValueError, match="CUDA"):
        MultiChainSampler(chain, 2, device="cpu", impl="fused")
