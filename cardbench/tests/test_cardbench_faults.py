"""A run with its timed path broken underneath comes out not correct.

Each fault is planted in the program's step (``family_step``, which the
captured and the eager segment loops both build on) and a whole run of the
cell is driven on the CPU at a small size, the harness's look for a card
skipped.  The faults a farm cell can have: a step that returns its state
unchanged, half of the batch left out, and an answer altered where it is
produced; besides, the Metropolis rule fed no uniform inside the step, and
the uniform drawn as 0.  For the initial beds the step is a chunk
of the simulation path: its draws not written back, half of them left
out, or the bed altered as it is returned.  A cell on one card exchanges
nothing between chips, so that fault has no place here.
"""

import importlib
import time

import numpy as np
import pytest
import torch

from cardbench import run


def _unchanged(step):
    """The step's traces, but its state handed back as it came in."""
    def broken(consts, state, gen):
        before = state.fields.clone()
        _, tr = step(consts, state, gen)
        state.fields.copy_(before)
        return state, tr
    return broken


def _half_batch(step):
    """Only the first half of the chains stepped: the rest keep their
    state and record no step."""
    def broken(consts, state, gen):
        h = state.fields.shape[0] // 2
        before = state.fields[h:].clone()
        new, tr = step(consts, state, gen)
        state.fields[h:].copy_(before)
        for f in ("loss_mc", "loss_comp", "accepted"):
            getattr(new, f)[h:] = getattr(state, f)[h:]
        for f in ("loss_data", "loss_data_comp"):
            if hasattr(new, f):
                getattr(new, f)[h:] = getattr(state, f)[h:]
        tr = dict(tr)
        tr["step"] = tr["step"].clone()
        tr["step"][h:] = False
        for k in ("loss_mc", "loss"):
            tr[k] = tr[k].clone()
            tr[k][h:] = new.loss_mc[h:] + (0 if k == "loss_mc" else
                                           tr["loss_data"][h:])
        return new, tr
    return broken


def _altered(step):
    """The bed of every chain that accepted moved by one metre at the
    block's centre after the step wrote it."""
    def broken(consts, state, gen):
        new, tr = step(consts, state, gen)
        acc = tr["step"].nonzero().flatten()
        cx = tr["block"][acc, 0].long()
        cy = tr["block"][acc, 1].long()
        new.fields[acc, 0, cx, cy] += 1.0
        return new, tr
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("workload", ["crf900.farm", "sgs900.farm"])
def test_a_broken_step_is_not_correct(small, monkeypatch, workload, fault):
    from mcmc_tpu_torch.parallel import sampler

    family_step = sampler.family_step
    monkeypatch.setattr(sampler, "family_step",
                        lambda static, impl="auto":
                        fault(family_step(static, impl)))
    out = run.run_cell(small(workload), 2**31 + 9, 0.3, False, "cpu",
                       time.perf_counter())
    assert not out["result"]["correct"], out["result"]["checks"]
    assert out["result"]["failed"] > 0


def test_the_same_run_unbroken_is_correct(small):
    out = run.run_cell(small("crf900.farm"), 2**31 + 9, 0.3, False, "cpu",
                       time.perf_counter())
    assert out["result"]["correct"], out["result"]["checks"]
    assert torch.is_tensor(torch.zeros(1))


def _loop_unwritten(loop):
    """The chunk loop that draws but never writes its draws back."""
    def broken(p, zg, path, radius, chunk, draw):
        return loop(p, zg.clone(), path, radius, chunk, draw)
    return broken


def _loop_half(loop):
    """The chunk loop that leaves the second half of each chunk's cells
    undrawn."""
    def broken(p, zg, path, radius, chunk, draw):
        def half(cells, est, var):
            z = draw(cells, est, var)
            z[len(z) // 2:] = np.nan
            return z
        return loop(p, zg, path, radius, chunk, half)
    return broken


@pytest.mark.parametrize("fault", ["unwritten", "half", "altered"])
def test_a_broken_bed_is_not_correct(small, monkeypatch, fault):
    sgs_mod = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
    if fault == "altered":
        sgs = sgs_mod.sgs
        monkeypatch.setattr(sgs_mod, "sgs",
                            lambda *a, **k: sgs(*a, **k) + 1.0)
    else:
        loops = sgs_mod._chunk_loops
        wrap = _loop_unwritten if fault == "unwritten" else _loop_half
        monkeypatch.setattr(sgs_mod, "_chunk_loops", lambda device: (
            wrap(loops(device)[0]), loops(device)[1]))
    out = run.run_cell(small("crf512.initbeds", grid=64), 2**31 + 9, 0.3,
                       False, "cpu", time.perf_counter())
    assert not out["result"]["correct"], out["result"]["checks"]
    assert out["result"]["failed"] > 0


def _step_ignores_u(monkeypatch, family):
    """The Metropolis rule fed u = 0 inside the step, so that it takes
    every proposal that keeps the ice's thickness; the draws keep theirs."""
    from mcmc_tpu_torch.models import chain_crf, chain_sgs

    if family == "crf":
        ops = chain_crf.window_operands
        monkeypatch.setattr(chain_crf, "window_operands",
                            lambda *a: ops(*a[:-1], a[-1] * 0))
    else:
        commit = chain_sgs.commit_core
        monkeypatch.setattr(chain_sgs, "commit_core",
                            lambda *a: commit(*a[:-1], a[-1] * 0))


def _draws_u_zero(monkeypatch, family):
    """The MH uniform drawn as 0, so every proposal is taken."""
    import dataclasses

    from mcmc_tpu_torch.models import chain_crf, chain_sgs

    mod = chain_sgs if family == "sgs" else chain_crf
    draw = mod.draw
    monkeypatch.setattr(mod, "draw", lambda *a, **k: dataclasses.replace(
        draw(*a, **k), u=draw(*a, **k).u * 0))


@pytest.mark.parametrize("fault", [_step_ignores_u, _draws_u_zero])
@pytest.mark.parametrize("workload", ["crf900.farm", "sgs900.farm"])
def test_a_broken_rule_or_draw_is_caught(small, monkeypatch, workload,
                                         fault):
    """Not correct; except that at this size an SGS chain's uphill moves
    are too small to pass the cell's ``mh_gap`` limit, set at its own
    size, so there the fault has to lift ``mh_gap`` from the unbroken
    run's 0 far up."""
    fault(monkeypatch, "sgs" if "sgs" in workload else "crf")
    out = run.run_cell(small(workload), 2**31 + 9, 0.3, False, "cpu",
                       time.perf_counter())
    checks = out["result"]["checks"]
    if workload == "sgs900.farm" and fault is _step_ignores_u:
        assert checks["mh_gap"]["value"] > 50, checks
    else:
        assert not out["result"]["correct"], checks
