"""The CUDA kernels against their plain PyTorch versions, on the card: the
CRF window kernel and Philox noise (and its keyed entry), the SGS window
extract and writeback, the two packed CG solves (mixture system, given
Sigma), the inverse LUT, the K-nearest selection, the per-chain draw
kernel of seed-listed farms and the SRF harmonic sum; the single-chain ``run`` on the kernels, and
``geostats.sgs`` on the card against the CPU, its captured chunks and
``krige``'s against the eager loop, and the T2 chunk's draw kernel.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.models import chain_sgs as sgs
from mcmc_tpu_torch.models.chain_crf import (draw, init_state, propose,
                                             window_operands)
from mcmc_tpu_torch.ops.cg_kernel import (cg_kernel_info, kernel_max_k,
                                          masked_cg, masked_cg_reference,
                                          mix_masked_cg,
                                          mix_masked_cg_reference)
from mcmc_tpu_torch.ops.covariance import eval_mixture_static
from mcmc_tpu_torch.ops.k_nearest_kernel import (KNearest, k_nearest,
                                                 k_nearest_kernel_info,
                                                 k_nearest_reference,
                                                 k_nearest_stages,
                                                 kernel_max_sb)
from mcmc_tpu_torch.ops.lut_kernel import lut_interp, lut_interp_reference
from mcmc_tpu_torch.ops.chain_draws import (MAX_ENTRIES, SLOTS, DrawEntry,
                                            DrawPlan, chain_draws,
                                            chain_draws_info,
                                            chain_draws_reference, entry)
from mcmc_tpu_torch.ops.noise_kernel import (batched_normal,
                                             batched_normal_keyed,
                                             batched_normal_keyed_reference,
                                             batched_normal_reference)
from mcmc_tpu_torch.ops.sgs_window_kernel import (WINDOW_KERNELS,
                                                  sgs_window_kernel_info,
                                                  window_extract,
                                                  window_extract_reference,
                                                  window_writeback,
                                                  window_writeback_reference)
from mcmc_tpu_torch.ops.window_kernel import (fused_window_update,
                                              fused_window_update_reference,
                                              window_kernel_info)
from mcmc_tpu_torch.testing import (edge_window_operands,
                                    k_nearest_operands, same_bits,
                                    sgs_window_operands)
from mcmc_tpu_torch.utils.rng import PerChainStreams, make_generator
from tests.torch_helpers import (assert_delta_close, block_losses,
                                 small_chain, small_problem, small_sgs_chain)

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
@pytest.mark.parametrize("data_loss,prefinished", [
    (False, False), (True, False), (False, True), (True, True)])
def test_kernel_matches_plain_version_at_the_edges(cuda_device, data_loss,
                                                   prefinished):
    """Blocks of both menu extremes centred on every domain edge and
    corner (clipped windows, one-sided stencils, negative offsets), every
    cell updated and in the mc mask, NaN in surf and the data at a few
    edge cells: the kernel against its plain version."""
    chain = small_chain(small_problem())
    static, consts = chain.build(cuda_device)
    state = init_state(chain.initial_bed, consts, 1)
    stacked, fields, geom, _ = edge_window_operands(consts, state.fields,
                                                    (12, 20))
    n = fields.shape[0]
    rng = np.random.default_rng(8)
    B = static.rf.B
    f = torch.as_tensor(rng.normal(0.0, 30.0 if prefinished else 1.0,
                                   (n, B, B)).astype(np.float32),
                        device=cuda_device)
    loss_prev = float(state.loss_mc[0])
    fvals = torch.as_tensor(np.stack([
        rng.uniform(0, 1, n), np.full(n, loss_prev),
        np.full(n, consts.sigma_mc), np.full(n, consts.resolution),
        np.full(n, consts.sigma_data), rng.uniform(20.0, 60.0, n) / 3.0],
        axis=1).astype(np.float32), device=cuda_device)
    kw = dict(use_data_loss=data_loss, prefinished=prefinished)
    got, want = fields.clone(), fields.clone()
    acc_k, dk, ddk = fused_window_update(stacked, got, f, consts.rf.edge_masks,
                                         geom, fvals, **kw)
    acc_p, dp, ddp = fused_window_update_reference(
        stacked, want, f, consts.rf.edge_masks, geom, fvals, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p)
    assert 0 < int(acc_k.sum()) < n
    mc_l, data_l = block_losses(fields.cpu().numpy(), stacked.cpu().numpy(),
                                geom.cpu().numpy(), consts)
    assert_delta_close(dk.cpu(), dp.cpu().double().numpy(), mc_l)
    assert_delta_close(ddk.cpu(), ddp.cpu().double().numpy(), data_l)
    torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-3,
                               equal_nan=True)


@pytest.mark.cuda
def test_window_kernel_launch_fills_the_card(cuda_device):
    """At the headline's B = 80 the launch helper's tile lets six CTAs
    share a multiprocessor (768 chains over 132 in one wave) with no
    spills; a tile too large for the card is refused before a launch."""
    info = window_kernel_info(80)
    assert info["threads"] == 256 and info["dynamic_shared_bytes"] == 27_224
    assert info["resident_ctas_per_sm"] >= 6 and info["local_bytes"] == 0
    with pytest.raises(ValueError, match="shared memory"):
        window_kernel_info(239)


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


# --- the SGS kernels ------------------------------------------------------------

SPHERICAL = ("Spherical", 6e3, 1.0, 0.0, None)


def _sgs_step_operands(device, n=N, seed=4, vario=None):
    """A small SGS chain on the card and one step's operands up to the
    packed solve."""
    chain = (small_sgs_chain(small_problem()) if vario is None
             else small_sgs_chain(small_problem(), vario=vario))
    static, consts = chain.build(device)
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, n)
    d = sgs.draw(make_generator(seed, device), static, consts, n)
    geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
    windows = window_extract_reference(consts.stacked, state.fields,
                                       geo.sx32, geo.sy32, static.SB)
    prep = sgs.prepare(static, consts, windows, geo, d.noise)
    return static, consts, state, d, geo, prep


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,SB", [
    (64, 200, 20), (64, 200, 64), (512, 512, 36), (512, 512, 512),
    (45, 67, 7), (45, 67, 37), (45, 67, 45), (45, 64, 37)])
def test_window_extract_and_writeback_kernels_bitwise(cuda_device, H, W, SB):
    """Both kernels bitwise against their plain versions: windows in one
    pass (SB^2 = 49, 400, 1,296) and in many (512^2), the window as large
    as the grid, the four clamped corners, a mixed write mask; W % 8 == 0
    takes the full-sector writeback (odd SB too), W = 67 the one within
    the window; then a fields tensor whose base is not 32-byte aligned,
    which takes the writeback within the window whatever W."""
    cons, fields, sx, sy, new_w, write = sgs_window_operands(
        H, W, SB, N, cuda_device)
    before = window_extract.launches
    got = window_extract(cons, fields, sx, sy, SB)
    assert window_extract.launches == before + 1
    assert torch.equal(got, window_extract_reference(cons, fields, sx, sy,
                                                     SB))
    k, p = fields.clone(), fields.clone()
    before = window_writeback.launches
    window_writeback(k, new_w, sx, sy, write)
    window_writeback_reference(p, new_w, sx, sy, write)
    torch.cuda.synchronize()
    assert window_writeback.launches == before + 1
    assert torch.equal(k, p)
    assert torch.equal(k[~write], fields[~write])
    k2 = torch.empty(fields.numel() + 1, device=cuda_device)[1:]
    k2 = k2.view(fields.shape).copy_(fields)
    assert k2.data_ptr() % 32 != 0
    window_writeback(k2, new_w, sx, sy, write)
    assert torch.equal(k2, p)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", WINDOW_KERNELS)
def test_window_kernels_launch(cuda_device, kernel):
    """Each window kernel's launch: 128 threads a CTA, no spills, sixteen
    CTAs (2,048 threads) resident on a multiprocessor."""
    info = sgs_window_kernel_info(kernel)
    assert info["threads"] == 128 and info["local_bytes"] == 0
    assert info["resident_ctas_per_sm"] == 16


@pytest.mark.cuda
def test_mix_cg_kernel_matches_plain_version(cuda_device):
    """Kernel against the plain version (same sums in the same order; only
    expf may round apart) at rtol/atol 2e-4, and against a float64 solve
    of the masked subsystem at 2e-3 (well-conditioned short-range
    systems)."""
    static, consts, _, _, _, prep = _sgs_step_operands(cuda_device)
    args = (prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p, prep.eps, static.mix,
            static.cg_iters)
    before = mix_masked_cg.launches
    got = mix_masked_cg(*args)
    assert mix_masked_cg.launches == before + 1
    want = mix_masked_cg_reference(*args)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert (got[prep.m_sel == 0] == 0).all()
    q = static.mix[4]
    dif = prep.iaf[:, :, None] - prep.iaf[:, None, :]
    djf = prep.jaf[:, :, None] - prep.jaf[:, None, :]
    S = eval_mixture_static(
        static.mix, q[0] * djf * djf + q[1] * djf * dif + q[2] * dif * dif
    ).double()
    for i in range(0, N, 8):
        sel = prep.sel[i]
        A = S[i][sel][:, sel] + prep.eps * torch.eye(
            int(sel.sum()), dtype=torch.float64, device=cuda_device)
        w64 = torch.linalg.solve(A, prep.rhs_p[i][sel].double())
        torch.testing.assert_close(got[i][sel].double(), w64, rtol=2e-3,
                                   atol=2e-3)
    big = kernel_max_k() + 1
    with pytest.raises(ValueError, match=f"K <= {big - 1} "):
        z = torch.zeros((2, big), device=cuda_device)
        mix_masked_cg(z, z, z, z, 1e-3, static.mix, 4)


@pytest.mark.cuda
def test_mix_cg_kernel_non_dyadic(cuda_device):
    """The per-term (non-dyadic) mixture form with both families, so the
    exponential family's sqrtf too (tests/test_kriging.py:222's mixture),
    per-chain eps and masked slots, against the plain version."""
    mix = ((0.5, 0.3), (0.01, 0.002), (0.4,), (0.05,), (1.0, 0.1, 1.2))
    rng = np.random.default_rng(7)
    n, K, SB = 16, 48, 40
    idx = np.stack([rng.permutation(SB * SB)[:K] for _ in range(n)])
    mask = (rng.random((n, K)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=cuda_device)

    args = (dev(idx // SB), dev(idx % SB), dev(mask),
            dev(rng.normal(size=(n, K))), dev(np.linspace(1e-3, 3e-3, n)),
            mix, 96)
    got = mix_masked_cg(*args)
    torch.testing.assert_close(got, mix_masked_cg_reference(*args),
                               rtol=2e-4, atol=2e-4)
    assert (got[args[2] == 0] == 0).all()


@pytest.mark.cuda
def test_lut_kernel_bitwise(cuda_device):
    """NaN, out-of-range values and the last rows included."""
    static, consts, _, _, _, prep = _sgs_step_operands(cuda_device)
    nst = consts.nst
    n = nst.inv_table.shape[0]
    gen = make_generator(2, cuda_device)
    x = torch.cat([
        torch.rand((N, static.SB, static.SB), generator=gen,
                   device=cuda_device).flatten() * 16.0 - 8.0,
        nst.inv_lo + (n - 1 - torch.tensor([0.5, 1e-3, 0.0, -3.0],
                                           device=cuda_device))
        / nst.inv_scale,
        torch.tensor([float("nan"), -1e9, 1e9, float("inf"), 0.0],
                     device=cuda_device)])
    before = lut_interp.launches
    got = lut_interp(x, nst.inv_lo, nst.inv_scale, nst.inv_table)
    assert lut_interp.launches == before + 1
    want = lut_interp_reference(x, nst.inv_lo, nst.inv_scale, nst.inv_table)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


# (chains, SB, K, k_nearest_operands' keywords): the farm's headline at
# 512 chains and at one (ChainSGS.run, one CTA); dropout with blocks on
# the window's border (the domain's edges and corners); fewer candidates
# than K; K > 64; K = SB² with and without a block; K = 1 and an odd SB;
# a window whose histogram needs the opt-in shared memory; the largest SB
# the kernel takes ("max")
K_NEAREST_CASES = [
    (512, 36, 48, {}),
    (1, 36, 48, {}),
    (64, 36, 48, dict(keep=0.5, edges=True)),
    (64, 36, 48, dict(radius_cells=1.5, block_max=4)),
    (64, 36, 48, dict(radius_cells=4.0, keep=0.7, edges=True)),
    (64, 24, 100, dict(keep=0.7, edges=True)),
    (32, 37, 1, dict(edges=True)),
    (16, 12, 144, {}),
    (16, 12, 144, dict(block=False)),
    (8, 96, 500, dict(keep=0.9, edges=True)),
    (4, "max", 48, dict(edges=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,SB,K,kw", K_NEAREST_CASES)
def test_k_nearest_kernel_bitwise(cuda_device, n, SB, K, kw):
    """The K-nearest kernel against its plain version, bitwise on all six
    outputs, one launch; a dense window leaves ties at the K-th distance
    out (the tie-break by window index is exercised)."""
    SB = kernel_max_sb(cuda_device) if SB == "max" else SB
    ops = k_nearest_operands(n, SB, cuda_device, seed=SB * 1000 + K, **kw)
    before = k_nearest.launches
    got = k_nearest(*ops, K)
    torch.cuda.synchronize()
    assert k_nearest.launches == before + 1
    want = k_nearest_reference(*ops, K)
    for name in KNearest._fields:
        assert same_bits(getattr(got, name), getattr(want, name)), name
    st = k_nearest_stages(*ops, K)
    n_cand = st["candidate"].flatten(1).sum(1)
    if n >= 64 and not kw:
        d2 = ops[1][:, :, None] ** 2 + ops[2][:, None, :] ** 2
        at_t = st["candidate"] & (d2 == st["kthvalue"][:, :, None])
        strict = st["candidate"] & (d2 < st["kthvalue"][:, :, None])
        assert (at_t.flatten(1).sum(1) > K - strict.flatten(1).sum(1)).any()
    if kw.get("radius_cells") == 1.5:
        assert (n_cand < K).all()


@pytest.mark.cuda
def test_k_nearest_eager_and_refusal(cuda_device):
    """``impl="eager"`` on CUDA tensors runs the plain version (no launch);
    an SB above the kernel's shared-memory limit is refused, naming it,
    and runs under ``impl="eager"``; the launch at the headline fits one
    wave."""
    ops = k_nearest_operands(8, 36, cuda_device)
    before = k_nearest.launches
    got = k_nearest(*ops, 48, "eager")
    assert k_nearest.launches == before
    want = k_nearest_reference(*ops, 48)
    for name in KNearest._fields:
        assert same_bits(getattr(got, name), getattr(want, name)), name
    top = kernel_max_sb(cuda_device)
    assert 36 <= top < 256
    big = k_nearest_operands(1, top + 1, cuda_device)
    with pytest.raises(ValueError, match=f"SB <= {top} "):
        k_nearest(*big, 48)
    assert k_nearest(*big, 48, "eager").sel.all()
    info = k_nearest_kernel_info(36, cuda_device)
    assert info["local_bytes"] == 0
    assert info["resident_ctas_per_sm"] * 132 >= 512


@pytest.mark.cuda
def test_sgs_sampler_launches_each_kernel_once_per_step(cuda_device):
    """impl='fused' runs all five SGS kernels once per step; the eager
    sampler, fed the same seed, launches none and agrees on the MH
    decisions until a borderline one flips."""
    chain = small_sgs_chain(small_problem())
    fused = MultiChainSampler(chain, N, device=cuda_device, impl="fused")
    ops = (window_extract, window_writeback, mix_masked_cg, lut_interp,
           k_nearest)
    for op in ops:
        op.launches = 0
    s_f, tr_f = fused.run(fused.init(seeds=3), 41, segment_size=20,
                          progress=False)
    assert [op.launches for op in ops] == [40] * 5
    eager = MultiChainSampler(chain, N, device=cuda_device, impl="eager")
    s_e, tr_e = eager.run(eager.init(seeds=3), 41, segment_size=20,
                          progress=False)
    assert [op.launches for op in ops] == [40] * 5
    assert np.isfinite(tr_f["loss"]).all()
    assert tr_f["loss"][:, -1].mean() < tr_f["loss"][:, 0].mean()
    agree = (tr_f["step"] == tr_e["step"]).mean()
    assert agree > 0.99, agree


@pytest.mark.cuda
def test_masked_cg_kernel_matches_plain_version(cuda_device):
    """The CG on a gathered Sigma (a spherical variogram: no mixture fit)
    against its plain version at rtol/atol 2e-4, and run to convergence
    against a float64 solve of the masked subsystem at 2e-3."""
    static, consts, _, _, _, prep = _sgs_step_operands(cuda_device,
                                                       vario=SPHERICAL)
    assert static.Mg + static.Me == 0 and static.cg_iters == 48
    Sigma = sgs.stamp_sigma(static, consts, prep)
    args = (Sigma, prep.m_sel, prep.rhs_p, prep.eps)
    before = masked_cg.launches
    got = masked_cg(*args, static.cg_iters)
    assert masked_cg.launches == before + 1
    torch.testing.assert_close(got, masked_cg_reference(*args,
                                                        static.cg_iters),
                               rtol=2e-4, atol=2e-4)
    assert (got[prep.m_sel == 0] == 0).all()
    conv = masked_cg(*args, 512)
    for i in range(0, N, 8):
        sel = prep.sel[i]
        A = Sigma[i][sel][:, sel].double() + prep.eps * torch.eye(
            int(sel.sum()), dtype=torch.float64, device=cuda_device)
        w64 = torch.linalg.solve(A, prep.rhs_p[i][sel].double())
        torch.testing.assert_close(conv[i][sel].double(), w64, rtol=2e-3,
                                   atol=2e-3)
    big = kernel_max_k() + 1
    with pytest.raises(ValueError, match=f"K <= {big - 1} "):
        z = torch.zeros((2, big), device=cuda_device)
        masked_cg(torch.zeros((2, big, big), device=cuda_device), z, z, 1e-3)


def _cg_operands(device, n, K, seed):
    """n chains' packed systems at K: distinct cells of a 40 x 40 window,
    80 % of the slots unmasked, per-chain eps; and an SPD Sigma."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(1600)[:K] for _ in range(n)])
    mask = (rng.random((n, K)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    G = rng.normal(size=(n, K, K))
    sigma = G @ np.swapaxes(G, 1, 2) / K + np.eye(K)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return (dev(idx // 40), dev(idx % 40), dev(mask),
            dev(rng.normal(size=(n, K))), dev(np.linspace(1e-3, 3e-3, n)),
            dev(sigma))


def _assert_mix_cg_equal(got, want):
    """Bitwise, unless the kernel's expf and PyTorch's exp round apart:
    then within rtol/atol 2e-4, as at the headline."""
    if not torch.equal(got, want):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [20, 33, 48, 64, 96, "max"])
def test_cg_kernels_bitwise_across_k(cuda_device, K):
    """Both CG kernels against their plain versions at one to seven
    32-row slots, the card's largest K included, at 13 chains (a ragged
    last CTA wherever a CTA holds several chains); the given-Sigma kernel
    bitwise, the mixture kernel bitwise unless expf rounds apart."""
    K = kernel_max_k() if K == "max" else K
    iaf, jaf, mask, rhs, eps, sigma = _cg_operands(cuda_device, 13, K, K)
    mix = ((0.5, 0.3), (0.01, 0.002), (0.4,), (0.05,), (1.0, 0.1, 1.2))
    for n_iters in (0, 1, 64):
        _assert_mix_cg_equal(
            mix_masked_cg(iaf, jaf, mask, rhs, eps, mix, n_iters),
            mix_masked_cg_reference(iaf, jaf, mask, rhs, eps, mix, n_iters))
        got = masked_cg(sigma, mask, rhs, eps, n_iters)
        assert torch.equal(got, masked_cg_reference(sigma, mask, rhs, eps,
                                                    n_iters))
        assert (got[mask == 0] == 0).all() and torch.isfinite(got).all()
    for mixed in (True, False):
        info = cg_kernel_info(K, mix=mixed)
        assert info["resident_ctas_per_sm"] >= 1
        assert info["threads"] == 32 * info["chains_per_cta"]


@pytest.mark.cuda
def test_cg_kernels_many_chains(cuda_device):
    """2,001 chains at the headline K = 48: 501 CTAs of four chains, the
    last holding one; both kernels against their plain versions, the
    mixture from a fitted dyadic chain (one expf and squarings)."""
    static = small_sgs_chain(small_problem()).build(cuda_device)[0]
    iaf, jaf, mask, rhs, eps, sigma = _cg_operands(cuda_device, 2001, 48, 1)
    assert cg_kernel_info(48)["chains_per_cta"] == 4
    _assert_mix_cg_equal(
        mix_masked_cg(iaf, jaf, mask, rhs, eps, static.mix, 64),
        mix_masked_cg_reference(iaf, jaf, mask, rhs, eps, static.mix, 64))
    assert torch.equal(masked_cg(sigma, mask, rhs, eps, 48),
                       masked_cg_reference(sigma, mask, rhs, eps, 48))


@pytest.mark.cuda
def test_cg_kernels_refuse_k_above_the_card_limit(cuda_device):
    """One above the card's largest K both dispatchers refuse, naming the
    limit; the plain versions take it."""
    lim = kernel_max_k()
    assert lim >= 160
    iaf, jaf, mask, rhs, eps, sigma = _cg_operands(cuda_device, 2, lim + 1, 5)
    mix = ((0.5,), (0.01,), (), (), (1.0, 0.0, 1.0))
    with pytest.raises(ValueError, match=f"K <= {lim} .*got K = {lim + 1}"):
        mix_masked_cg(iaf, jaf, mask, rhs, eps, mix, 4)
    with pytest.raises(ValueError, match=f"K <= {lim} .*got K = {lim + 1}"):
        masked_cg(sigma, mask, rhs, eps, 4)
    assert torch.isfinite(masked_cg_reference(sigma, mask, rhs, eps, 4)).all()


@pytest.mark.cuda
def test_spherical_sampler_launches_masked_cg_once_per_step(cuda_device):
    chain = small_sgs_chain(small_problem(), vario=SPHERICAL)
    fused = MultiChainSampler(chain, N, device=cuda_device, impl="fused")
    masked_cg.launches = mix_masked_cg.launches = 0
    _, tr = fused.run(fused.init(seeds=3), 21, segment_size=10,
                      progress=False)
    assert (masked_cg.launches, mix_masked_cg.launches) == (20, 0)
    assert np.isfinite(tr["loss"]).all()


@pytest.mark.cuda
def test_noise_kernel_matches_plain_version(cuda_device):
    """Philox normals at the CRF headline's (rows, cols) = (160, 41): the
    kernel against its plain version within 1e-5, deterministic in the
    seed, N(0, 1) moments, the tail cap."""
    seed = torch.tensor([0x123456789ABCDEF], dtype=torch.int64,
                        device=cuda_device)
    before = batched_normal.launches
    z = batched_normal(seed, N, 160, 41)
    assert batched_normal.launches == before + 1
    assert z.shape == (N, 160, 41) and z.dtype == torch.float32
    want = batched_normal_reference(seed, N, 160, 41)
    assert int(((z - want).abs() > 1e-5).sum()) == 0
    assert torch.equal(z, batched_normal(seed, N, 160, 41))
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert float(z.abs().max()) <= 5.8872
    assert not torch.equal(z, batched_normal(seed + 1, N, 160, 41))
    with pytest.raises(ValueError, match="even"):
        batched_normal(seed, N, 7, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 160, 41), (5, 18, 7), (3, 2, 300),
                                   (2, 64, 64), (70_000, 2, 2),
                                   (1, 2, 33_553_926)],
                         ids=["one-chain", "odd-pairs", "ragged-block",
                              "whole-blocks", "many-chains", "long-chain"])
def test_noise_kernel_bitwise(cuda_device, shape):
    """Bitwise against the plain version: one chain; an odd pair count (the
    scalar stores); call counts that leave the last block ragged (150) or
    fill it (1024); more chains than a grid's 65,535 rows; a chain whose
    131,070 blocks of calls are more than a grid has rows, so blocks
    stride over them."""
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64,
                        device=cuda_device)
    got = batched_normal(seed, *shape)
    assert torch.equal(got, batched_normal_reference(seed, *shape))


@pytest.mark.cuda
def test_crf_sampler_with_kernel_noise(cuda_device):
    """The CRF sampler launches the noise kernel once per step; the eager
    sampler draws the same noise from its plain version."""
    chain = small_chain(small_problem())
    fused = MultiChainSampler(chain, N, device=cuda_device)
    batched_normal.launches = 0
    _, tr_f = fused.run(fused.init(seeds=3), 41, segment_size=20,
                        progress=False)
    assert batched_normal.launches == 40
    eager = MultiChainSampler(chain, N, device=cuda_device, impl="eager")
    _, tr_e = eager.run(eager.init(seeds=3), 41, segment_size=20,
                        progress=False)
    assert batched_normal.launches == 40
    assert np.isfinite(tr_f["loss"]).all()
    assert tr_f["loss"][:, -1].mean() < tr_f["loss"][:, 0].mean()
    assert (tr_f["step"] == tr_e["step"]).mean() > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("count", [4 * 997, 4 * 997 + 1, 4 * 997 + 2,
                                   4 * 997 + 3, 1, 2, 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3],
                         ids=["aligned", "x[1:]", "x[2:]", "x[3:]"])
def test_lut_kernel_tails_and_alignment(cuda_device, count, offset):
    """Bitwise against the plain version where count % 4 leaves a tail and
    where x starts 4, 8 or 12 bytes past a 16-byte boundary (a scalar
    head; y, freshly allocated, then takes scalar stores): NaN, the
    table's ends and values beyond them included."""
    _, consts, _, _, _, _ = _sgs_step_operands(cuda_device)
    nst = consts.nst
    gen = make_generator(4, cuda_device)
    base = torch.rand((count + offset,), generator=gen,
                      device=cuda_device) * 16.0 - 8.0
    base[::7] = float("nan")
    base[1::11] = 1e9
    base[2::13] = -1e9
    x = base[offset:]
    assert x.data_ptr() % 16 == 4 * offset
    got = lut_interp(x, nst.inv_lo, nst.inv_scale, nst.inv_table)
    want = lut_interp_reference(x, nst.inv_lo, nst.inv_scale,
                                nst.inv_table)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


def _streams(seeds, step, device):
    s = PerChainStreams.from_seeds(seeds, device)
    s.step.fill_(step)
    return s


DRAW_PLANS = {
    "crf": (entry("size_idx", "index", n=25), entry("scale", "uniform"),
            entry("nugget", "uniform"), entry("range_x", "uniform"),
            entry("cidx", "index", n=222_784), entry("u", "uniform")),
    "sgs": (entry("cidx", "index", n=222_784),
            entry("bsx", "index", n=15, lo=5),
            entry("bsy", "index", n=15, lo=5),
            entry("noise", "normal", 6400 + 1296),
            entry("drop_u", "uniform", 1296), entry("u", "uniform")),
    "odd": (entry("u", "uniform", 7), entry("cidx", "index", 5, n=1000,
                                            lo=-3),
            entry("bsx", "index", 3, n=2 ** 32 - 1),
            entry("noise", "normal", 9), entry("drop_u", "uniform", 1),
            entry("nugget_noise", "normal", 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(DRAW_PLANS))
@pytest.mark.parametrize("step", [0, 7, (5 << 32) + 3])
def test_chain_draws_kernel_bitwise(cuda_device, plan, step):
    """Every value of a plan bitwise against the plain version, at steps
    whose high word is 0 and not; a chain's values its own."""
    plan = DrawPlan(DRAW_PLANS[plan])
    seeds = list(range(100, 100 + N))
    s = _streams(seeds, step, cuda_device)
    before = chain_draws.launches
    got = plan.views(*chain_draws(s.keys, s.step, plan))
    assert chain_draws.launches == before + 1
    want = plan.views(*chain_draws_reference(s.keys, s.step, plan))
    alone = _streams(seeds[5:6], step, cuda_device)
    one = plan.views(*chain_draws(alone.keys, alone.step, plan))
    for name in want:
        assert torch.equal(got[name], want[name]), name
        assert torch.equal(got[name][5:6], one[name]), name


def _many_entries():
    """MAX_ENTRIES entries of every kind, at counts that are multiples of
    neither 4 nor 2 as well as of both."""
    kinds = ("uniform", "index", "normal")
    return tuple(DrawEntry(name=f"e{k}", slot=40 + k, kind=kinds[k % 3],
                           count=(1, 7, 13, 64, 99)[k % 5] * (1 + k % 4),
                           n=(k + 3) * 1009 if k % 3 == 1 else 0,
                           lo=-k if k % 3 == 1 else 0)
                 for k in range(MAX_ENTRIES))


# (plan, chains): each grid of the kernel, the flat one (up to a wave of
# Philox calls) and the tiled one (past it), with partial last CTAs
DRAW_LAYOUTS = {
    "one-chain": ("sgs", 1),
    "odd-counts": ("odd", 333),
    "flat-partial-cta": ("crf", 769),
    "dropout-tiled": ("sgs", 300),
    "tiled-odd-chains": ("sgs", 513),
    "max-entries": ("many", 3),
    "max-entries-tiled": ("many", 800),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(DRAW_LAYOUTS))
@pytest.mark.parametrize("step", [3, (1 << 32) + 5, (1 << 40) + 1])
def test_chain_draws_kernel_layouts(cuda_device, layout, step):
    """Every value bitwise the plain version's on each grid of the kernel:
    one chain, counts of neither 4 nor 2, the dropout plan, MAX_ENTRIES
    entries, chain counts that leave the last CTA or tile partial, steps
    past 2^32; the launch takes the grid its number of calls calls for."""
    name, n = DRAW_LAYOUTS[layout]
    plan = DrawPlan(_many_entries() if name == "many"
                    else DRAW_PLANS[name])
    s = _streams(list(range(7, 7 + n)), step, cuda_device)
    got = plan.views(*chain_draws(s.keys, s.step, plan))
    want = plan.views(*chain_draws_reference(s.keys, s.step, plan))
    for key in want:
        assert torch.equal(got[key], want[key]), key
    info = chain_draws_info(n, plan.calls)
    assert info["calls_a_thread"] == (2 if n * plan.calls > 132 * 2048
                                      else 1), info
    assert info["resident_ctas_per_sm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 160, 41), (5, 18, 7), (3, 2, 300),
                                   (70_000, 2, 2)],
                         ids=["one-chain", "odd-pairs", "ragged-block",
                              "many-chains"])
def test_keyed_noise_kernel_bitwise(cuda_device, shape):
    """The keyed entry bitwise against its plain version; the single-seed
    entry's bits unchanged beside it."""
    n, rows, cols = shape
    s = _streams(list(range(n)), (1 << 32) + 11, cuda_device)
    before = batched_normal_keyed.launches
    slot = SLOTS["spectrum"]
    got = batched_normal_keyed(s.keys, s.step, slot, rows, cols)
    assert batched_normal_keyed.launches == before + 1
    assert torch.equal(got, batched_normal_keyed_reference(s.keys, s.step,
                                                           slot, rows, cols))
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64,
                        device=cuda_device)
    assert torch.equal(batched_normal(seed, *shape),
                       batched_normal_reference(seed, *shape))


@pytest.mark.cuda
def test_list_seeded_samplers_launch_the_draw_kernels(cuda_device):
    """A seed-listed farm of each family makes one draw-kernel launch a
    step (and the CRF one keyed-noise launch), and none of the single-seed
    noise entry; chain 1 of the farm draws the blocks (centres and sizes,
    drawn) of the 1-chain farm seeded with its seed."""
    seeds = [3, 1, 4, 1 + N]
    for chain, keyed in ((small_chain(small_problem()), 20),
                         (small_sgs_chain(small_problem()), 0)):
        sampler = MultiChainSampler(chain, 4, device=cuda_device)
        chain_draws.launches = batched_normal_keyed.launches = 0
        batched_normal.launches = 0
        _, tr = sampler.run(sampler.init(seeds=seeds), 21, segment_size=10,
                            progress=False)
        assert chain_draws.launches == 20
        assert batched_normal_keyed.launches == keyed
        assert batched_normal.launches == 0
        assert np.isfinite(tr["loss"]).all()
        one = MultiChainSampler(chain, 1, device=cuda_device)
        _, tr1 = one.run(one.init(seeds=seeds[1:2]), 21, segment_size=10,
                         progress=False)
        np.testing.assert_array_equal(tr["block"][1], tr1["block"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_single_chain_run_is_the_one_chain_farm(cuda_device, family):
    """``run(seed=s)`` on the card: bitwise the 1-chain farm seeded [s]
    on the kernels, with and without observers; its bed trace ends on
    the final state's bed."""
    make = small_chain if family == "crf" else small_sgs_chain
    chain = make(small_problem())
    out = chain.run(41, seed=5, save_beds=True, device=cuda_device)
    seen = chain.run(41, seed=5, save_beds=True, device=cuda_device,
                     progress_bar=True, info_per_iter=15)
    sampler = MultiChainSampler(chain, 1, device=cuda_device)
    _, tr = sampler.run(sampler.init(seeds=[5]), 41, progress=False)
    for k, name in (("loss", "loss"), ("step", "steps"),
                    ("block", "blocks")):
        np.testing.assert_array_equal(out[name], tr[k][0], err_msg=k)
        np.testing.assert_array_equal(seen[name], tr[k][0], err_msg=k)
    np.testing.assert_array_equal(out["bed"], seen["bed"])
    full = (out["final_state"].bed[0] if family == "crf"
            else sampler.full_bed(out["final_state"])[0])
    np.testing.assert_array_equal(out["bed"][-1], full.cpu().numpy())


@pytest.mark.cuda
def test_sgs_on_the_card_matches_the_cpu(cuda_device):
    """``geostats.sgs`` with the same seed on the card and on the CPU: the
    same octant picks and the same uniforms, drawn on the card in one
    launch a chunk and on the host by scipy, the beds apart only by
    float32 rounding in the kriging solves and the draws' float64
    rounding (within 5e-2 m)."""
    from mcmc_tpu_torch.geostats import sgs

    p = small_problem(H=48, W=48)
    vario = dict(major_range=5e3, minor_range=4e3, azimuth=20.0, sill=1.0,
                 nugget=0.05, vtype="Exponential")
    kw = dict(radius=10e3, num_points=32, chunk=64, half_window=12, seed=4,
              bounds=(np.full(p["xx"].shape, -900.0), p["surf"] - 1.0))
    card = sgs(p["xx"], p["yy"], p["cond_bed"], vario, device=cuda_device,
               **kw)
    host = sgs(p["xx"], p["yy"], p["cond_bed"], vario, device="cpu", **kw)
    np.testing.assert_allclose(card, host, atol=5e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("vtype", ["Exponential", "Matern"])
def test_captured_geostats_is_the_eager_loop(cuda_device, vtype, bounded,
                                             monkeypatch):
    """On the card ``sgs`` (bounded and not) and ``krige`` replay one
    captured graph a chunk and give the eager loop's bed and maps bit for
    bit: one capture a call, a replay for each full chunk after the
    first; every chunk of either bed drawn on the card, one launch of the
    draw kernel a chunk."""
    import importlib

    from mcmc_tpu_torch.geostats import krige, sgs
    from mcmc_tpu_torch.ops.bounded_draw_kernel import bounded_draw

    S = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
    p = small_problem(H=48, W=48)
    vario = dict(major_range=5e3, minor_range=4e3, azimuth=20.0, sill=1.0,
                 nugget=0.05, vtype=vtype, s=1.3)
    args = (p["xx"], p["yy"], p["cond_bed"], vario)
    kw = dict(radius=10e3, num_points=32, half_window=12)
    bounds = ((np.full(p["xx"].shape, -900.0), p["surf"] - 1.0) if bounded
              else None)
    chunks = -(-int(np.isnan(p["cond_bed"]).sum()) // 64)
    captures = []

    def capture(body, generator=None):
        captures.append(S.capture_graph(body, generator))
        return captures[-1]

    def bed():
        before = bounded_draw.launches
        out = sgs(*args, chunk=64, seed=4, bounds=bounds, device=cuda_device,
                  **kw)
        assert bounded_draw.launches - before == chunks
        return out

    monkeypatch.setattr(S, "_chunk_loops", lambda device: (
        functools.partial(S._sgs_loop_captured, capture=capture),
        functools.partial(S._krige_loop_captured, capture=capture)))
    got = (bed(),) + krige(*args, chunk=64, device=cuda_device, **kw)
    monkeypatch.setattr(S, "_chunk_loops", lambda device: (
        S._sgs_loop_eager, S._krige_loop_eager))
    want = (bed(),) + krige(*args, chunk=64, device=cuda_device, **kw)
    assert len(captures) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int64), w.view(np.int64))


@pytest.mark.cuda
def test_bounded_draw_kernel_matches_plain_and_scipy(cuda_device):
    """The kernel's quantile function (its float64 probe) over
    ``torch_helpers.ppf_grid`` against the plain version within
    ``PPF_ATOL`` max(1, |x|) and against scipy's ``truncnorm.ppf`` within
    ``scipy_ppf_tolerance``; then whole draws into a grid, bounded (point
    masses and the sd floor included) and unbounded, against the plain
    version on the card: the float32 scores within one unit in the last
    place, one launch each."""
    from scipy.stats import truncnorm

    from mcmc_tpu_torch.ops.bounded_draw_kernel import (
        bounded_draw, bounded_draw_reference, truncnorm_ppf,
        truncnorm_ppf_on_card)
    from tests.torch_helpers import (PPF_ATOL, ppf_grid,
                                     scipy_ppf_tolerance)

    q, a, b = ppf_grid()
    on_card = truncnorm_ppf_on_card(*(torch.as_tensor(v, device=cuda_device)
                                      for v in (q, a, b))).cpu().numpy()
    plain = truncnorm_ppf(*(torch.as_tensor(v) for v in (q, a, b))).numpy()
    scipy = truncnorm.ppf(q, a, b)
    assert np.isfinite(on_card).all()
    assert (np.abs(on_card - plain)
            <= PPF_ATOL * np.maximum(1, np.abs(plain))).all()
    assert (np.abs(on_card - scipy)
            <= scipy_ppf_tolerance(q, a, b, scipy)).all()

    rng = np.random.default_rng(2)
    shape, n = (300, 280), 5000
    flat = rng.choice(shape[0] * shape[1], n, replace=False)
    cells = torch.as_tensor(np.stack(np.unravel_index(flat, shape), axis=1),
                            device=cuda_device)
    est = torch.as_tensor(rng.normal(0, 1.5, n), dtype=torch.float32,
                          device=cuda_device)
    var = torch.as_tensor(rng.uniform(0, 2, n), dtype=torch.float32,
                          device=cuda_device)
    var[:7] = 0.0
    lo = torch.as_tensor(rng.uniform(-4, 1, shape), device=cuda_device)
    hi = lo + torch.as_tensor(rng.uniform(0, 3, shape), device=cuda_device)
    hi[tuple(cells[:40].T)] = lo[tuple(cells[:40].T)]
    for bounds, u in ((None, rng.standard_normal(shape)),
                      ((lo, hi), rng.uniform(size=shape))):
        u = torch.as_tensor(u, device=cuda_device)
        grids = [torch.full(shape, np.nan, dtype=torch.float32,
                            device=cuda_device) for _ in range(2)]
        before = bounded_draw.launches
        bounded_draw(grids[0], cells, est, var, u, *(bounds or (None, None)))
        assert bounded_draw.launches == before + 1
        bounded_draw_reference(grids[1], cells, est, var, u,
                               *(bounds or (None, None)))
        got, want = (g.cpu().numpy() for g in grids)
        np.testing.assert_array_max_ulp(got[tuple(cells.cpu().numpy().T)],
                                        want[tuple(cells.cpu().numpy().T)],
                                        maxulp=1)
        assert np.isnan(got).sum() == shape[0] * shape[1] - n


# --- the gstools-SRF proposal's harmonic sum ---------------------------------

SRF_ATOL = 2e-5  # a unit-variance field of 1000 modes (chip_smoke.SRF_ATOL)


def _srf_operands(device, n, model, isotropic, seed=7):
    """(kv, z1, z2) of ``n`` chains: ranges 10-50 km and, anisotropic,
    azimuths, as the farm draws them."""
    from mcmc_tpu_torch.ops.srf import draw_srf, sample_wavevectors

    gen = make_generator(seed, device)
    u, theta, z1, z2, angle = draw_srf(gen, n, isotropic, device)
    rx = 10e3 + 40e3 * torch.rand((n,), generator=gen, device=device)
    ry = rx if isotropic else 10e3 + 40e3 * torch.rand(
        (n,), generator=gen, device=device)
    return sample_wavevectors(u, theta, model, rx, ry, 1.3, angle), z1, z2


@pytest.mark.cuda
@pytest.mark.parametrize("model,isotropic,n,ny,nx", [
    ("Matern", True, 16, 80, 80), ("Gaussian", True, 3, 37, 53),
    ("Matern", True, 1, 128, 96), ("Exponential", False, 16, 80, 80),
    ("Matern", True, 1, 512, 512)])
def test_srf_kernel_matches_plain_version(cuda_device, model, isotropic, n,
                                          ny, nx):
    """The SRF kernel on the same wavevectors and normals (500 m cells) at
    a farm's canvas, an odd grid that leaves a partial tile, one field as
    ``get_random_field`` draws it, anisotropic Exponential ranges and
    azimuths, and a 512 x 512 field; one launch a call.  (i) Within
    SRF_ATOL of the float64 field on the unrounded phase a + b, every
    cell; (ii) within the phase rounding's per-cell bound plus SRF_ATOL of
    the plain version, which rounds a + b."""
    from mcmc_tpu_torch.ops.srf_kernel import (srf_harmonics,
                                               srf_harmonics_reference)
    from mcmc_tpu_torch.testing import (srf_rounding_bound,
                                        srf_separable_float64)

    kv, z1, z2 = _srf_operands(cuda_device, n, model, isotropic)
    op = (kv, z1, z2, ny, nx, 500.0)
    before = srf_harmonics.launches
    got = srf_harmonics(*op)
    assert srf_harmonics.launches == before + 1
    assert got.shape == (n, ny, nx) and got.dtype == torch.float32
    sep = srf_separable_float64(*op)
    assert float((got.double() - sep).abs().max()) <= SRF_ATOL
    err = (got - srf_harmonics_reference(*op)).double().abs()
    excess = err - srf_rounding_bound(*op)
    assert float(excess.max()) <= SRF_ATOL


@pytest.mark.cuda
def test_srf_kernel_gives_a_chain_its_bits_in_any_batch(cuda_device):
    """Chain j's field from the kernel is bitwise the same alone and in a
    batch of 768 (the CRF headline's chains), at the farm's canvas and at
    a grid of several tiles."""
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics

    kv, z1, z2 = _srf_operands(cuda_device, 768, "Matern", True, seed=9)
    for ny, nx, chains in ((80, 80, 768), (150, 97, 40)):
        batch = srf_harmonics(kv[:chains], z1[:chains], z2[:chains], ny, nx,
                              500.0)
        for j in (0, 5, chains - 1):
            one = srf_harmonics(kv[j:j + 1], z1[j:j + 1], z2[j:j + 1], ny,
                                nx, 500.0)
            assert torch.equal(one[0], batch[j]), (ny, nx, j)


@pytest.mark.cuda
def test_srf_step_on_the_kernels_matches_the_plain_step(cuda_device):
    """An SRF farm's step on the kernels (SRF, window) against the plain
    step from the same state and generator state: at most 1 % of the MH
    decisions flip over 10 steps (the harmonic sums in another order), the
    SRF and window kernels launch once a step and the noise kernel
    never."""
    import dataclasses

    from mcmc_tpu_torch.models.chain_crf import make_step
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics

    chain = small_chain(small_problem())
    chain._rf_cfg = dataclasses.replace(chain._rf_cfg, spectral=False)
    static, consts = chain.build(cuda_device)
    fused, plain = make_step(static, "auto"), make_step(static, "eager")
    state = init_state(chain.initial_bed, consts, N)
    gen = make_generator(5, cuda_device)
    srf_harmonics.launches = fused_window_update.launches = 0
    batched_normal.launches = 0
    flips = 0
    for _ in range(10):
        shadow = dataclasses.replace(state, **{
            f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(state)})
        gen_p = torch.Generator(device=cuda_device)
        gen_p.set_state(gen.get_state())
        n_srf = srf_harmonics.launches
        _, tr_p = plain(consts, shadow, gen_p)
        assert srf_harmonics.launches == n_srf
        state, tr = fused(consts, state, gen)
        flips += int((tr["step"] != tr_p["step"]).sum())
    assert srf_harmonics.launches == fused_window_update.launches == 10
    assert batched_normal.launches == 0
    assert flips <= 0.01 * 10 * N, flips


@pytest.mark.cuda
def test_one_rank_nccl_farm_is_the_meshless_farm(cuda_device, tmp_path):
    """A one-rank NCCL group on card 0 (``tests/torch_dist.py``): each
    family's farm through ``global_chains_mesh()`` gives the traces, bed
    snapshots and final state of the same farm built without a mesh, bit
    for bit."""
    import json

    from tests.torch_dist import launch

    launch("nccl", 1, tmp_path)
    assert json.loads((tmp_path / "nccl.json").read_text()) == {
        "crf": True, "sgs": True}


# --- the segment scan: run_chains replayed from a captured CUDA graph -------

def _clone_farm_state(states):
    return dataclasses.replace(states, **{
        f.name: getattr(states, f.name).clone()
        for f in dataclasses.fields(states)})


def _bytes_equal(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("seeding", ["int", "list"])
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_captured_loop_is_the_eager_loop(cuda_device, family, seeding):
    """``run_chains`` on the card replays a captured graph: over a first
    call (warm-up, capture, replays, remainder) and a second (replays of
    the graph its cache keeps) its traces, states and random stream are
    the eager loop's bit for bit, the state is the caller's object, and
    each kernel of the path counts one launch a step."""
    from mcmc_tpu_torch.parallel import sampler as ps

    p = small_problem()
    chain = small_chain(p) if family == "crf" else small_sgs_chain(p)
    sampler = MultiChainSampler(chain, N, device=cuda_device)
    st_e = sampler.init(seeds=5 if seeding == "int" else list(range(N)))
    rng_e = sampler.generator
    st_g = _clone_farm_state(st_e)
    rng_g = (PerChainStreams(keys=rng_e.keys.clone(),
                             step=rng_e.step.clone())
             if seeding == "list" else torch.Generator(device=cuda_device))
    if seeding == "int":
        rng_g.set_state(rng_e.get_state())
    kernels = ((fused_window_update,) if family == "crf"
               else (window_extract, window_writeback, lut_interp,
                     k_nearest))
    for k in kernels:
        k.launches = 0
    steps = (ps.WARM_STEPS + ps.CHUNK_STEPS + 7, 2 * ps.CHUNK_STEPS)
    graphs = ps.GraphCache()
    for n in steps:
        st_e, want = ps.run_chains_eager(sampler.static, sampler.consts,
                                         st_e, n, rng=rng_e)
        got_state, got = ps.run_chains(sampler.static, sampler.consts, st_g,
                                       n, rng=rng_g, graphs=graphs)
        assert got_state is st_g
        for k in want:
            assert _bytes_equal(got[k], want[k]), k
        for f in dataclasses.fields(st_e):
            assert _bytes_equal(getattr(st_g, f.name),
                                getattr(st_e, f.name)), f.name
    assert graphs.graph.replays == 3
    if seeding == "int":
        assert torch.equal(rng_g.get_state(), rng_e.get_state())
    else:
        assert torch.equal(rng_g.step, rng_e.step)
    for k in kernels:
        assert k.launches == 2 * sum(steps), k.__name__


@pytest.mark.cuda
def test_restored_generator_drops_the_kept_graph(cuda_device):
    """A checkpoint's generator state restored into the sampler replaces
    its generator, so the graph the sampler keeps, which draws from the
    old one, is dropped; the next segment captures anew and is the eager
    loop's from the restored stream, bit for bit."""
    from mcmc_tpu_torch.parallel import sampler as ps
    from mcmc_tpu_torch.utils.rng import restore_generator

    sampler = MultiChainSampler(small_chain(small_problem()), N,
                                device=cuda_device)
    states = sampler.init(seeds=3)
    n = ps.WARM_STEPS + ps.CHUNK_STEPS
    states, _ = sampler.run_segment(states, n)
    assert sampler.graphs.graph is not None
    kind, saved = sampler.generator_state()
    start = _clone_farm_state(states)
    sampler.run_segment(states, ps.CHUNK_STEPS)
    sampler.restore_generator(kind, saved)
    assert sampler.graphs.graph is None
    replayed = _clone_farm_state(start)
    got_state, got = sampler.run_segment(replayed, n)
    assert sampler.graphs.graph is not None
    rng = restore_generator(kind, saved, cuda_device)
    want_state, want = ps.run_chains_eager(sampler.static, sampler.consts,
                                           start, n, rng=rng)
    for k in want:
        assert _bytes_equal(got[k], want[k]), k
    for f in dataclasses.fields(want_state):
        assert _bytes_equal(getattr(got_state, f.name),
                            getattr(want_state, f.name)), f.name
    assert torch.equal(sampler.generator.get_state(), rng.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 2000, 3), (256, 20000)])
@pytest.mark.parametrize("name", ["split_rhat", "ess", "rank_normalized_rhat",
                                  "ess_bulk", "ess_tail", "acceptance_rate"])
def test_diagnostics_on_the_card_match_the_cpu(cuda_device, name, shape):
    """Each diagnostic on the card (the default for an array, and a card
    tensor kept where it is) against ``device="cpu"`` on the same AR(1)
    trace with runs of held values: the same ranks and quantiles, float32
    sums and transforms in another order, within rtol 1e-4."""
    from mcmc_tpu_torch.parallel import diagnostics

    rng = np.random.default_rng(17)
    e = rng.normal(size=(shape[1], shape[0]) + shape[2:])
    x = np.empty_like(e)
    x[0] = e[0]
    held = rng.random(size=e.shape[:2]) < 0.7
    for t in range(1, shape[1]):
        x[t] = np.where(held[t].reshape(held[t].shape + (1,) * (e.ndim - 2)),
                        x[t - 1], 0.99 * x[t - 1] + e[t])
    x = np.ascontiguousarray(np.moveaxis(x, 0, 1), dtype=np.float32)
    if name == "acceptance_rate":
        x = np.ascontiguousarray(~held.T)
    fn = getattr(diagnostics, name)
    want = fn(x, device="cpu")
    got = fn(x)
    on_card = fn(torch.as_tensor(x, device=cuda_device))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_array_equal(on_card, got)
