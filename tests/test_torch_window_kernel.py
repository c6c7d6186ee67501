"""The port's fused window update against the JAX package's Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU, as
tests/test_window_kernel.py runs it; the port runs its plain PyTorch
version, which is what the dispatcher picks for CPU tensors.  Both get the
same numpy inputs: raw fields, draws and chain state.  The CUDA kernel
itself is compared with the plain version by the ``cuda``-marked tests
in tests/test_torch_cuda.py, which runs on a card only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops.window_kernel import (fused_window_sizes,
                                        make_fused_window_update)
from mcmc_tpu_torch.interop import consts_from_numpy
from mcmc_tpu_torch.models.chain_crf import init_state
from mcmc_tpu_torch.ops.window_kernel import (fused_window_update,
                                              fused_window_update_reference,
                                              window_geometry)
from tests.conftest import make_synthetic_problem
from tests.test_chain_crf import build_small_chain
from tests.torch_helpers import assert_delta_close, block_losses

N = 4
H = W = 64


def _matern(chain):
    chain._rf_cfg = dataclasses.replace(chain._rf_cfg, model_name="Matern",
                                        smoothness=1.3)
    return chain


@pytest.fixture(scope="module")
def problems():
    """(port static, port consts, initial numpy fields) with the data loss
    off and on; CRF_weight blocks and the production Matérn model."""
    p = make_synthetic_problem(H=H, W=W)
    out = {}
    for use_data_loss in (False, True):
        chain = _matern(build_small_chain(p, block_type="CRF_weight"))
        if use_data_loss:
            chain.set_loss_type(sigma_mc=5.0, diff_func="sumsquare",
                                sigma_data=20.0)
        static, consts = chain.build()
        pstatic, pconsts = consts_from_numpy(
            jax.tree.map(np.asarray, consts), dataclasses.asdict(static))
        beds = np.random.default_rng(3).normal(
            p["initial_bed"], 5.0, (N, H, W)).astype(np.float32)
        st = init_state(beds, pconsts)
        out[use_data_loss] = (pstatic, pconsts, st.fields.numpy(),
                              (st.loss_mc + st.loss_data).numpy())
    return out


def _draws(rng, pstatic, pconsts, prefinished):
    B = pstatic.rf.B
    size_idx = rng.integers(0, pstatic.rf.n_sizes, N)
    region = pconsts.region_cells.numpy()
    cidx = rng.integers(0, region.shape[0], N)
    fraw = rng.normal(0.0, 1.0, (N, B, B)).astype(np.float32)
    if prefinished:
        fraw *= 30.0
    return dict(fraw=fraw, size_idx=size_idx, cx=region[cidx, 0],
                cy=region[cidx, 1],
                u=rng.uniform(0, 1, N).astype(np.float32),
                scale=rng.uniform(20.0, 60.0, N).astype(np.float32) / 3.0)


def _jax_geom(d, pairs, B):
    """geom rows as mcmc_tpu/models/chain_crf.py:475-498 builds them."""
    SX, SY = fused_window_sizes(H, W, B)
    w, h = pairs[0, d["size_idx"]], pairs[1, d["size_idx"]]
    cx, cy = d["cx"], d["cy"]
    bxmin = np.maximum(0, (2 * cx - h) // 2)
    bxmax = np.minimum(H, (2 * cx + h) // 2)
    bymin = np.maximum(0, (2 * cy - w) // 2)
    bymax = np.minimum(W, (2 * cy + w) // 2)
    off_x, off_y = (2 * cx - h) // 2, (2 * cy - w) // 2
    sx = (np.zeros_like(bxmin) if SX == H
          else np.clip(8 * ((bxmin - 1) // 8), 0, H - SX))
    sy = (np.zeros_like(bymin) if SY == W
          else np.clip(128 * ((bymin - 1) // 128), 0, W - SY))
    return np.stack([sx, sy, np.mod(off_x - sx, SX), np.mod(off_y - sy, SY),
                     bxmin, bxmax, bymin, bymax, h, w, d["size_idx"]],
                    axis=1).astype(np.int32)


def _fvals(d, loss_prev, pconsts):
    return np.stack([d["u"], loss_prev, np.full(N, pconsts.sigma_mc),
                     np.full(N, pconsts.resolution),
                     np.full(N, pconsts.sigma_data), d["scale"]],
                    axis=1).astype(np.float32)


def _port_geom(d, pconsts):
    pairs = pconsts.rf.pairs
    size_idx = torch.as_tensor(d["size_idx"])
    return window_geometry(torch.as_tensor(d["cx"]), torch.as_tensor(d["cy"]),
                           pairs[1, size_idx], pairs[0, size_idx], size_idx,
                           H, W)


@pytest.mark.parametrize("use_data_loss,prefinished",
                         [(False, False), (True, False), (False, True)])
def test_matches_pallas_kernel(problems, use_data_loss, prefinished):
    pstatic, pconsts, fields0, loss0 = problems[use_data_loss]
    B = pstatic.rf.B
    pairs = pconsts.rf.pairs.numpy()
    fn = jax.jit(make_fused_window_update(
        H, W, B, interpret=True, use_data_loss=use_data_loss,
        prefinished=prefinished))
    stacked = pconsts.stacked.numpy()
    edges = pconsts.rf.edge_masks.numpy()
    rng = np.random.default_rng(11)
    fj = jnp.asarray(fields0)
    ft = torch.as_tensor(fields0).clone()
    loss_prev = loss0.copy()
    n_acc = 0
    for it in range(4):
        d = _draws(rng, pstatic, pconsts, prefinished)
        fvals = _fvals(d, loss_prev, pconsts)
        ft_old = ft.numpy().copy()
        fj, acc_j, dj, ddj = fn(jnp.asarray(stacked), fj,
                                jnp.asarray(d["fraw"]), jnp.asarray(edges),
                                jnp.asarray(_jax_geom(d, pairs, B)),
                                jnp.asarray(fvals))
        acc_t, dt, ddt = fused_window_update_reference(
            pconsts.stacked, ft, torch.as_tensor(d["fraw"]),
            pconsts.rf.edge_masks, _port_geom(d, pconsts),
            torch.as_tensor(fvals), use_data_loss=use_data_loss,
            prefinished=prefinished)
        msg = f"iter {it}"
        np.testing.assert_array_equal(np.asarray(acc_j), acc_t.numpy(),
                                      err_msg=msg)
        scale_mc, scale_data = block_losses(
            ft_old, stacked, _port_geom(d, pconsts).numpy(), pconsts)
        assert_delta_close(np.asarray(dj), dt.numpy(), scale_mc, msg)
        assert_delta_close(np.asarray(ddj), ddt.numpy(), scale_data, msg)
        # f32 last-ulp differences of the same gradient arithmetic in
        # another order; ~1e-5 relative on O(20) residuals
        np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=5e-5,
                                   atol=1e-3, err_msg=msg)
        loss_prev = loss_prev + dt.numpy() + ddt.numpy()
        n_acc += int(acc_t.sum())
    assert 0 < n_acc < 4 * N


def test_geometry_floor_semantics():
    """Blocks centred near the top-left edge give negative offsets; the
    port's geometry must floor like the JAX formula, not truncate."""
    cx = torch.tensor([0, 1, 5, 63])
    cy = torch.tensor([0, 2, 5, 62])
    h = torch.tensor([11, 12, 8, 9])
    w = torch.tensor([9, 10, 12, 11])
    g = window_geometry(cx, cy, h, w, torch.zeros(4, dtype=torch.int64),
                        64, 64).numpy()
    cxn, cyn, hn, wn = (t.numpy() for t in (cx, cy, h, w))
    np.testing.assert_array_equal(g[:, 4], (2 * cxn - hn) // 2)
    np.testing.assert_array_equal(g[:, 5], (2 * cyn - wn) // 2)
    np.testing.assert_array_equal(g[:, 0], np.maximum(0, (2 * cxn - hn) // 2))
    np.testing.assert_array_equal(g[:, 1], np.minimum(64, (2 * cxn + hn) // 2))
    assert g.dtype == np.int32


def test_dispatcher_uses_plain_version_on_cpu(problems):
    pstatic, pconsts, fields0, loss0 = problems[False]
    d = _draws(np.random.default_rng(5), pstatic, pconsts, False)
    args = (pconsts.stacked, None, torch.as_tensor(d["fraw"]),
            pconsts.rf.edge_masks, _port_geom(d, pconsts),
            torch.as_tensor(_fvals(d, loss0, pconsts)))
    fa, fb = torch.as_tensor(fields0).clone(), torch.as_tensor(fields0).clone()
    before = fused_window_update.launches
    out_a = fused_window_update(args[0], fa, *args[2:])
    out_b = fused_window_update_reference(args[0], fb, *args[2:])
    assert fused_window_update.launches == before
    for a, b in zip(out_a, out_b):
        assert torch.equal(a, b)
    assert torch.equal(fa, fb)


def test_dispatcher_never_falls_back_off_the_cpu(problems):
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain-version fallback: the dispatcher raises."""
    pstatic, pconsts, fields0, loss0 = problems[False]
    d = _draws(np.random.default_rng(6), pstatic, pconsts, False)
    meta = torch.device("meta")
    args = [pconsts.stacked, torch.as_tensor(fields0), torch.as_tensor(
        d["fraw"]), pconsts.rf.edge_masks, _port_geom(d, pconsts),
        torch.as_tensor(_fvals(d, loss0, pconsts))]
    with pytest.raises(ValueError, match="no window kernel for device"):
        fused_window_update(*(a.to(meta) for a in args))
