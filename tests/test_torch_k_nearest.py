"""The SGS step's K-nearest selection (``ops/k_nearest_kernel.py``) on the
CPU: the dispatcher's routing (CPU tensors and ``impl="eager"`` to the
plain version, which is the step's code before the kernel) and its
operand checks.  The kernel against the plain version is in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from mcmc_tpu_torch.models import chain_sgs as sgs
from mcmc_tpu_torch.ops import k_nearest_kernel as kn
from mcmc_tpu_torch.testing import (k_nearest_operands, same_bits,
                                    sgs_step_stages)
from tests.torch_helpers import small_problem, small_sgs_chain

CPU = torch.device("cpu")


@pytest.mark.parametrize("impl", ["auto", "fused", "eager"])
@pytest.mark.parametrize("n,SB,K,kw", [
    (5, 36, 48, {}),
    (9, 24, 100, dict(keep=0.6, edges=True)),
    (4, 12, 144, {}),
    (4, 12, 144, dict(block=False)),
    (6, 36, 48, dict(radius_cells=1.5, block_max=4)),
])
def test_cpu_and_eager_take_the_plain_version(impl, n, SB, K, kw):
    """CPU tensors, whatever ``impl``, run the plain version: no launch
    counted, the six outputs bitwise ``k_nearest_reference``'s and the
    packed selection ``k_nearest_ops``' on the candidates."""
    ops = k_nearest_operands(n, SB, CPU, seed=SB + K, **kw)
    before = kn.k_nearest.launches
    got = kn.k_nearest(*ops, K, impl)
    assert kn.k_nearest.launches == before
    want = kn.k_nearest_reference(*ops, K)
    for name in kn.KNearest._fields:
        assert same_bits(getattr(got, name), getattr(want, name)), name
    stages = kn.k_nearest_stages(*ops, K)
    packed = kn.k_nearest_ops(stages["candidate"], ops[1], ops[2], K)
    assert torch.equal(got.idx, packed["idx"])
    assert torch.equal(got.sel, packed["sel"])
    assert torch.equal(got.m_sel, got.sel.to(torch.float32))
    assert torch.equal(got.iaf.long() * SB + got.jaf.long(), got.idx)
    n_cand = stages["candidate"].flatten(1).sum(1)
    assert torch.equal(got.sel.sum(1), torch.clamp(n_cand, max=K))


def test_operands_cover_the_kernel_cases():
    """``k_nearest_operands`` gives what the card tests name: every cell a
    candidate without a block, fewer than K with a small radius, ties at
    the K-th distance left out, blocks against the window's border."""
    cond, rd, cd, radius, res, _, _ = k_nearest_operands(
        4, 12, CPU, block=False)
    assert cond.all()
    ops = k_nearest_operands(8, 36, CPU, radius_cells=1.5, block_max=4)
    assert (kn.k_nearest_stages(*ops, 48)["candidate"].flatten(1).sum(1)
            < 48).all()
    ops = k_nearest_operands(16, 36, CPU, seed=3)
    st = kn.k_nearest_stages(*ops, 48)
    d2 = ops[1][:, :, None] ** 2 + ops[2][:, None, :] ** 2
    ties = (st["candidate"] & (d2 == st["kthvalue"][:, :, None])).flatten(1)
    strict = (st["candidate"] & (d2 < st["kthvalue"][:, :, None])).flatten(1)
    assert (ties.sum(1) > 48 - strict.sum(1)).any()
    _, rd, cd, *_ = k_nearest_operands(9, 36, CPU, edges=True)
    assert (rd[:, 0] == 0).any() and (rd[:, -1] == 0).any()
    assert (cd[:, 0] == 0).any() and (cd[:, -1] == 0).any()


@pytest.mark.parametrize("SB,radius,resolution", [
    (36, 30e3, 500.0), (36, 750.0, 500.0), (37, 2.5 * 431.7, 431.7),
    (12, 0.0, 500.0), (12, float("nan"), 500.0), (24, 1e9, 0.5),
    (181, 60e3, 500.0), (9, 3.0, 1.0)])
def test_the_kernels_integer_test_is_the_float32_test(SB, radius,
                                                      resolution):
    """The kernel tests d2 <= D (``_max_key``, found on the host) where the
    plain version tests fl(fl(sqrt(d2))·resolution) <= radius in float32:
    the same cells, every d2 of the window; a resolution for which no
    such D exists is refused."""
    rd = cd = torch.arange(SB)[None]  # every pair of distances below SB
    radius, resolution = (float(np.float32(x)) for x in (radius, resolution))
    cond = torch.ones((1, SB, SB), dtype=torch.bool)
    z = torch.zeros((1, SB, SB))
    plain = kn.k_nearest_stages(cond, rd, cd, radius, resolution, z, z,
                                1)["candidate"]
    d2 = rd[:, :, None] ** 2 + cd[:, None, :] ** 2
    assert torch.equal(plain, d2 <= kn._max_key(SB, radius, resolution))
    with pytest.raises(ValueError, match="positive, finite resolution"):
        kn._max_key(SB, -1.0, -resolution)


def _bad(ops, K):
    """Operand sets the dispatcher must refuse, with what it names."""
    cond, rd, cd, radius, res, z_w, z_u = ops
    yield (cond.float(), rd, cd, radius, res, z_w, z_u, K), "cond_mask"
    yield (cond, rd.int(), cd, radius, res, z_w, z_u, K), "rd"
    yield (cond, rd, cd[:, :-1], radius, res, z_w, z_u, K), "cd"
    yield (cond, rd, cd, radius, res, z_w.double(), z_u, K), "z_w"
    yield (cond, rd, cd, radius, res, z_w, z_u.transpose(1, 2), K), "z_u"
    yield (cond[:-1], rd, cd, radius, res, z_w, z_u, K), "cond_mask"
    yield (cond, rd[0], cd, radius, res, z_w, z_u, K), "rd"
    yield (cond, rd, cd, radius, res, z_w, z_u, 0), "K"
    yield (cond, rd, cd, radius, res, z_w, z_u, 12 * 12 + 1), "K"
    yield (cond, rd, cd, radius, res, z_w, z_u.to("meta"), K), "z_u"


@pytest.mark.parametrize("case", range(10))
def test_operand_checks(case):
    """Wrong types, shapes, layouts, devices and K are refused on the CPU
    too, naming the operand; an unknown ``impl`` is refused."""
    ops = k_nearest_operands(3, 12, CPU)
    args, name = list(_bad(ops, 20))[case]
    with pytest.raises((TypeError, ValueError), match=name):
        kn.k_nearest(*args)
    with pytest.raises(ValueError, match="impl"):
        kn.k_nearest(*ops, 20, "kernel")


def test_prepare_packs_the_plain_selection():
    """``prepare`` hands the selection's operands on, and its packed
    system is the plain version's on them, bitwise, eager or not;
    ``sgs_step_stages`` reads the plain ops beside the step's."""
    chain = small_sgs_chain(small_problem())
    static, consts = chain.build("cpu")
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, 6)
    gen = torch.Generator().manual_seed(8)
    d = sgs.draw(gen, static, consts, 6)
    geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
    windows = sgs.window_extract_reference(consts.stacked, state.fields,
                                           geo.sx32, geo.sy32, static.SB)
    preps = [sgs.prepare(static, consts, windows, geo, d.noise, d.drop_u,
                         impl) for impl in ("auto", "eager")]
    want = kn.k_nearest_reference(
        preps[0].cond_mask, preps[0].rd, preps[0].cd, consts.search_radius,
        consts.resolution, preps[0].z_w, preps[0].z_u, static.K)
    for prep in preps:
        for name in kn.KNearest._fields:
            assert same_bits(getattr(prep, name), getattr(want, name))
    assert torch.equal(preps[0].ring_dist,
                       torch.maximum(preps[0].rd[:, :, None],
                                     preps[0].cd[:, None, :]))
    st = sgs_step_stages(static, consts, state, d)
    K = static.K
    assert torch.equal(st["packed idx, sel"][:, :K], want.idx)
    assert np.array_equal(st["searchsorted"].clamp(max=static.SB ** 2 - 1),
                          want.idx)
