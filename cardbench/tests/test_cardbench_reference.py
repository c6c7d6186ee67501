"""The plain reference held to the port's CPU path at a small size, and
the control: the reference put in the program's place in bfloat16 comes
out not correct where the program comes out correct."""

import time

import numpy as np
import pytest
import torch

from cardbench import problem, run
from cardbench.reference import judge, physics, transform


@pytest.fixture(scope="module")
def p():
    return problem.build_problem(40, 500.0, 7)


def test_residual_and_loss_match_the_port(p):
    from mcmc_tpu_torch.ops.physics import (masked_gaussian_loss,
                                            mass_conservation_residual)

    bed = np.stack([p["initial_bed"], p["initial_bed"] + 3.0])
    args = [torch.as_tensor(p[k]) for k in ("surf", "velx", "vely", "dhdt",
                                            "smb")]
    ref = physics.residual(torch.as_tensor(bed), *args, p["resolution"])
    port = mass_conservation_residual(torch.as_tensor(bed), *args,
                                      p["resolution"])
    torch.testing.assert_close(ref, port, rtol=1e-12, atol=1e-9)
    mask = torch.as_tensor(p["region"] == 1)
    torch.testing.assert_close(physics.gaussian_loss(ref, mask, 5.0),
                               masked_gaussian_loss(port, mask, 5.0),
                               rtol=1e-12, atol=0)


def test_inverse_transform_matches_the_port(p):
    from mcmc_tpu_torch import NormalScoreTransform

    data = p["initial_bed"] - problem.sgs_trend(p["initial_bed"], 3)
    nst = NormalScoreTransform.fit(data.ravel(), 200)
    q, r = transform.fit_quantiles(data, 200)
    np.testing.assert_array_equal(q, nst.quantiles)
    z = torch.linspace(-7, 7, 2001, dtype=torch.float64)
    np.testing.assert_allclose(transform.inverse(z, q, r).numpy(),
                               nst.inverse_np(z.numpy()), rtol=0,
                               atol=1e-9)


def test_block_menu_is_the_ports(small):
    from mcmc_tpu_torch.models.randfield import make_block_menu
    from mcmc_tpu_torch.utils.config import BlockMenuConfig

    cfg = small("crf900.farm")["cfg"]
    for m in (cfg["block_menu"],
              dict(min_block_x=50, max_block_x=80, min_block_y=50,
                   max_block_y=80, steps=5)):
        pairs = make_block_menu(BlockMenuConfig(**m))
        port = {(int(h), int(w)) for w, h in pairs.T}
        assert judge.crf_menu(dict(block_menu=m)) == port


@pytest.mark.parametrize("workload", ["crf900.farm", "sgs900.farm",
                                      "crf512.initbeds"])
def test_program_correct_and_control_not(small, workload):
    """On the CPU at a small size: the program's window passes every
    comparison, and the control (the reference in bfloat16 in the
    program's place, on the same window) fails one of them."""
    c = small(workload, grid=64 if "initbeds" in workload else 48)
    out = run.run_cell(c, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(),
                       control=True)
    checks = out["result"]["checks"]
    assert out["result"]["correct"], checks
    assert out["result"]["failed"] == 0
    failed = [k for k, v in out["control_checks"].items()
              if v["value"] > v["limit"]]
    assert failed, out["control_checks"]


def test_t2_reference_follows_the_program(p):
    """The port's bounded bed on the CPU, judged chunk by chunk: the
    reference's cells agree with the program's to float32 kriging's
    rounding, and its scores and sector rule are the program's."""
    from mcmc_tpu_torch.geostats import generate_initial_beds
    from mcmc_tpu_torch.ops.neighbors import octant_sector

    from cardbench.reference import t2

    vario = dict(vtype="Matern", s=1.3, major_range=30e3, minor_range=30e3,
                 azimuth=0.0, sill=1.0, nugget=0.0)
    kw = dict(radius=50e3, num_points=32, chunk=64, half_window=40)
    bed = generate_initial_beds(p["xx"], p["yy"], p["cond_bed"], vario,
                                surf=p["surf"], seed=99, device="cpu",
                                **kw)[0]
    ref = t2.T2(cond=p["cond_bed"], surf=p["surf"], resolution=500.0,
                vario=vario, **kw)
    prep = ref.prepared()
    n = -(-len(prep["cells"]) // 64)
    got_ref, got = t2.judge_bed(ref, prep, bed, 99, [0, 1, n // 2, n - 1])
    assert np.max(np.abs(got_ref - got)) < 0.05
    assert np.median(np.abs(got_ref - got)) < 1e-3
    d = np.arange(-6, 7)
    dx, dy = np.meshgrid(d, d)
    np.testing.assert_array_equal(
        t2.sector(dx, dy),
        octant_sector(torch.as_tensor(dx), torch.as_tensor(dy)).numpy())


def _farm_and_draws(small, workload):
    from cardbench import farm

    c = small(workload)
    st = farm.setup(c["cfg"], c["traffic"], 2**31 + 21, "cpu")
    s = st.sampler
    gen = torch.Generator()
    gen.set_state(s.stream().get_state())
    sgs = c["cfg"]["family"] == "sgs"
    from mcmc_tpu_torch.models import chain_crf, chain_sgs

    d = (chain_sgs if sgs else chain_crf).draw(gen, s.static, s.consts,
                                               c["cfg"]["chains"], "eager")
    inputs = judge.make_inputs(c["cfg"], st.problem, st.trend)
    return c["cfg"], st, d, inputs


def test_crf_step_reference_is_the_ports_step(small):
    """The reference's proposal is the port's finished field, and one step
    of the reference, from the port's state, takes the port's decisions
    and leaves its bed and stored residual."""
    from mcmc_tpu_torch.models import chain_crf
    from mcmc_tpu_torch.ops.spectral import block_mask, standardize_masked

    from cardbench.farm import _plain_draws
    from cardbench.reference import crf_step

    cfg, st, d, inputs = _farm_and_draws(small, "crf900.farm")
    s, n = st.sampler, cfg["chains"]
    raw = chain_crf.propose(s.static, s.consts, d, "eager")
    w = s.consts.rf.pairs[0, d.size_idx]
    h = s.consts.rf.pairs[1, d.size_idx]
    port = (standardize_masked(raw, block_mask(h, w, raw.shape[-1]))
            * d.scale[:, None, None] * s.consts.rf.edge_masks[d.size_idx])
    ref = crf_step.Step(cfg, inputs, "cpu")
    dd = _plain_draws(d, False)
    idx = torch.arange(n)
    np.testing.assert_allclose(ref.proposal(dd, idx).numpy(), port.numpy(),
                               rtol=0, atol=1e-4 * float(d.scale.max()))
    bed = st.states.fields[:, 0].double().clone()
    res = st.states.fields[:, 1].double().clone()
    step = chain_crf.make_kernel(s.static, "eager")
    cells = s.consts.region_cells[d.cidx]
    _, tr = step(s.consts, st.states, raw, d.size_idx, d.scale, cells[:, 0],
                 cells[:, 1], d.u)
    rec = ref.step(bed, res, dd, idx)
    assert torch.equal(rec["accept"], tr["step"])
    np.testing.assert_allclose(bed.numpy(), st.states.fields[:, 0].numpy(),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(res.numpy(), st.states.fields[:, 1].numpy(),
                               rtol=0, atol=1e-4)


def test_sgs_step_reference_draws_and_selects_as_the_port(small):
    """The reference's unconditional window draw is the port's from the
    same noise, and its K nearest conditioning cells are the port's."""
    from mcmc_tpu_torch.models import chain_sgs
    from mcmc_tpu_torch.ops.sgs_window_kernel import window_extract_reference

    from cardbench.reference import sgs_step

    cfg, st, d, inputs = _farm_and_draws(small, "sgs900.farm")
    s = st.sampler
    ref = sgs_step.Step(cfg, inputs, "cpu")
    assert (ref.SB, ref.M, ref.K, ref.NE) == (s.static.SB, s.static.M,
                                              s.static.K, s.static.NE)
    geo = chain_sgs.window_start(s.static, d.cx, d.cy, d.bsx, d.bsy)
    win = window_extract_reference(s.consts.stacked, st.states.fields,
                                   geo.sx32, geo.sy32, s.static.SB)
    prep = chain_sgs.prepare(s.static, s.consts, win, geo, d.noise, None)
    np.testing.assert_allclose(ref.unconditional(d.noise.double()).numpy(),
                               prep.z_u.numpy(), rtol=0, atol=2e-3)
    SB = s.static.SB
    ar = torch.arange(SB)
    rows, cols = geo.sx[:, None] + ar, geo.sy[:, None] + ar
    rd = torch.clamp(torch.maximum(geo.bxmin[:, None] - rows,
                                   rows - (geo.bxmax[:, None] - 1)), min=0)
    cd = torch.clamp(torch.maximum(geo.bymin[:, None] - cols,
                                   cols - (geo.bymax[:, None] - 1)), min=0)
    want, sel = ref.nearest(rd, cd, prep.sim_mask)
    for i in range(len(d.cx)):
        assert set(want[i][sel[i]].tolist()) == set(
            prep.idx[i][prep.sel[i]].tolist())
