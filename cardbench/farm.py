"""The farm traffic: a ``MultiChainSampler`` driven segment after segment,
as ``MultiChainSampler.run`` drives it.

Set-up makes the problem from the seed, builds the configuration's chain
and the farm on the card, draws the initial states and runs the traffic's
warm-up segments (the kernels load from the build cache, cuFFT plans its
transforms, the segment's CUDA graph is captured).  The window then calls
``run_segment`` and copies each segment's traces to the host, nothing
else between segments, until ``seconds`` have passed; it ends with the
last segment's traces on the host.  A traced run profiles the first
``traced_segments`` segments of its window, with the harness's spans
around each call.

After the window the same farm runs ``judged_steps`` steps more through
the same ``run_segment`` (the window's captured graph replays them); the
draws of those steps are taken beforehand from a copy of the farm's
stream by the program's own ``draw``, and the copy must end where the
stream does.  The reference follows those steps (``reference/steps.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import problem
from .reference import crf_step, draws, judge, steps


@dataclasses.dataclass
class Farm:
    cfg: dict
    traffic: dict
    problem: dict
    trend: object
    sampler: object
    states: object
    setup_parts: dict
    bed_at_start: np.ndarray = None  # every chain's bed as the window opens
    loss_at_init: np.ndarray = None  # every chain's ledger as init made it


def setup(cfg: dict, traffic: dict, seed: int, device) -> Farm:
    """The farm of ``cfg`` on ``device``, warmed up with ``traffic``'s
    segments; each part of set-up timed."""
    from mcmc_tpu_torch.models.chain_crf import host_copy
    from mcmc_tpu_torch.parallel.sampler import MultiChainSampler

    parts = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    problem_seed, stream_seed = problem.seed_words(seed)
    p = problem.build_problem(cfg["grid"], cfg["resolution"], problem_seed)
    trend = (problem.sgs_trend(p["initial_bed"], cfg["trend_sigma_cells"])
             if cfg["family"] == "sgs" else None)
    mark("problem")
    chain = problem.make_chain(cfg, p, trend)
    mark("chain")
    sampler = MultiChainSampler(chain, cfg["chains"], device=device)
    mark("build")
    states = sampler.init(seeds=stream_seed)
    loss_at_init = host_copy(states.loss_mc)
    mark("init")
    for _ in range(traffic["warmup_segments"]):
        states, traces = sampler.run_segment(states,
                                             traffic["segment_steps"])
        {k: host_copy(v) for k, v in traces.items()}
    bed_at_start = host_copy(states.fields[:, 0])
    mark("warmup")
    return Farm(cfg=cfg, traffic=traffic, problem=p, trend=trend,
                sampler=sampler, states=states, setup_parts=parts,
                bed_at_start=bed_at_start, loss_at_init=loss_at_init)


def window(farm: Farm, seconds: float, trace: bool = False) -> dict:
    """The measured window.  Returns its seconds, steps, the segments'
    end times, their host traces and, traced, the profiler."""
    from mcmc_tpu_torch.models.chain_crf import host_copy

    sampler, n = farm.sampler, farm.traffic["segment_steps"]
    states = farm.states
    segments, marks = [], []
    prof = None
    profiled = farm.traffic["traced_segments"] if trace else 0
    if profiled:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        activities = [ProfilerActivity.CPU]
        if sampler.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    t_start = time.perf_counter()
    while True:
        if len(segments) < profiled:
            with record_function("cardbench.segment"):
                states, traces = sampler.run_segment(states, n)
            with record_function("cardbench.copy"):
                segments.append({k: host_copy(v) for k, v in traces.items()})
            if len(segments) == profiled:
                prof.stop()
        else:
            states, traces = sampler.run_segment(states, n)
            segments.append({k: host_copy(v) for k, v in traces.items()})
        marks.append(time.perf_counter())
        if marks[-1] - t_start >= seconds and len(segments) >= profiled:
            break
    farm.states = states
    return dict(t_start=t_start, seconds=marks[-1] - t_start,
                steps=n * len(segments), marks=marks, segments=segments,
                prof=prof, profiled=profiled)


def static_info(farm: Farm) -> dict:
    """The sizes the roofline counts read: the grid, and for an SGS chain
    its conditioning size, CG iterations and mixture terms."""
    st = farm.sampler.static
    info = dict(H=st.H, W=st.W, chains=farm.cfg["chains"])
    if farm.cfg["family"] == "sgs":
        info.update(K=st.K, cg_iters=st.cg_iters, mix_terms=st.Mg + st.Me)
    else:
        info.update(n_const=8 if st.use_data_loss else 6)
    return info


def outputs(farm: Farm, segments: list) -> dict:
    """The window's answers, taken out of the program's state: each chain's
    bed, stored residual plane, z-plane (SGS) and last ledger row, its
    bed as the window opened and its ledger as ``init`` made it, copies on
    the card."""
    fields = farm.states.fields
    out = {"bed": fields[:, 0].clone(), "res": fields[:, 1].clone(),
           "loss_mc": torch.as_tensor(segments[-1]["loss_mc"][-1]),
           "bed_at_start": torch.as_tensor(farm.bed_at_start),
           "loss_at_init": torch.as_tensor(farm.loss_at_init)}
    if farm.cfg["family"] == "sgs":
        out["z"] = fields[:, 3].clone()
    return out


def _plain_draws(d, sgs: bool) -> dict:
    keys = (("cx", "cy", "bsx", "bsy", "noise", "u") if sgs else
            ("size_idx", "scale", "range_x", "range_y", "cidx", "u", "noise"))
    return {k: getattr(d, k) for k in keys}


def judged_steps(farm: Farm) -> dict:
    """``judged_steps`` more steps of the farm through ``run_segment``:
    their draws (taken first, by the program's ``draw``, from a copy of
    the stream), whether the copy ends where the stream does, and what the
    steps produced: each step's decisions, ledger and blocks, the ledger
    before them and the planes after them.  A CRF farm runs them as one
    segment, its captured graph replayed; an SGS farm, whose redraw is
    conditioned on the bed, one step a call, its planes taken after each
    over a box about the step's block, so that the reference can start
    every step where the program did."""
    from mcmc_tpu_torch.models import chain_crf, chain_sgs

    s, sgs = farm.sampler, farm.cfg["family"] == "sgs"
    gen = s.stream()
    if not isinstance(gen, torch.Generator):
        raise TypeError("the judged steps replay a generator's draws; the "
                        f"farm's stream is a {type(gen).__name__}")
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    draw = chain_sgs.draw if sgs else chain_crf.draw
    n, T = farm.cfg["chains"], farm.traffic["judged_steps"]
    draws = [_plain_draws(draw(copy, s.static, s.consts, n, s.impl), sgs)
             for _ in range(T)]
    states = farm.states
    loss0 = states.loss_mc.clone()
    planes = {"bed": 0, "res": 1, "z": 3} if sgs else {"bed": 0, "res": 1}
    side = dict(loss0=loss0, box=0)
    if sgs:
        H, W = states.fields.shape[-2:]
        half = side["box"] = min(s.static.SB, H // 2, W // 2)
        rows, side["boxes"] = [], []
        for d in draws:
            states, tr = s.run_segment(states, 1)
            rows.append(tr)
            org = steps.box_origin(d["cx"], d["cy"], half, H, W)
            side["boxes"].append({k: steps.take_box(states.fields[:, j], org,
                                                    2 * half)
                                  for k, j in planes.items()})
        tr = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    else:
        states, tr = s.run_segment(states, T)
    side.update(taken=tr["step"].clone(), loss=tr["loss_mc"].clone(),
                block=tr["block"].clone(),
                **{k: states.fields[:, j].clone() for k, j in planes.items()})
    replayed = torch.equal(copy.get_state(), gen.get_state())
    return dict(draws=draws, side=side, replayed=replayed)


def end_to_end(farm: Farm, w: dict) -> dict:
    """Every MH iteration of every chain in the window over its seconds."""
    return {"chain_it_per_s": w["steps"] * farm.cfg["chains"] / w["seconds"]}


def rates(farm: Farm, w: dict) -> list:
    """Each window segment's chain-it/s, for the log."""
    ends = np.diff([w["t_start"]] + w["marks"])
    return [farm.traffic["segment_steps"] * farm.cfg["chains"] / d
            for d in ends]


def fill_view(farm: Farm, w: dict, view) -> None:
    """What the per-layer readers need besides the trace: the profiled
    segments' traces, their steps and the farm's sizes."""
    view.segments = w["segments"][:w["profiled"]]
    view.steps = farm.traffic["segment_steps"] * w["profiled"]
    view.chains = farm.cfg["chains"]
    view.info = static_info(farm)


def judged(farm: Farm, w: dict, limits: dict, device,
           control: bool = False) -> dict:
    """The reference's judgement of the window's chains and of the judged
    steps (and of the control's, with ``control``); the farm is dropped
    before the reference runs."""
    out = outputs(farm, w["segments"])
    js = judged_steps(farm)
    farm.sampler = farm.states = None
    _free(device)
    cfg = farm.cfg
    inputs = judge.make_inputs(cfg, farm.problem, farm.trend)
    pre = {k: out[k] for k in steps.plane_names(cfg)}

    def numbers(o, side):
        per = judge.judge(cfg, inputs, o, w["segments"], device)
        per.update(steps.judge_steps(cfg, inputs, pre, js["draws"], side,
                                     device))
        per["bad_blocks"] = per["bad_blocks"] + per.pop("step_blocks")
        return per

    per = numbers(out, js["side"])
    n = cfg["chains"]
    per["draw_replay"] = np.full(n, 0.0 if js["replayed"] else 1.0 / n)
    n_sizes = (0 if cfg["family"] == "sgs"
               else len(crf_step.menu_pairs(cfg)))
    per["bad_draws"] = np.full(n, draws.bad_draws(
        cfg, inputs, js["draws"], n_sizes) / n)
    checks, failed = judge.verdict(per, limits)
    res = dict(checks=checks, attempted=cfg["chains"],
               failed=int(failed.sum()))
    if control:
        ctrl = judge.control_outputs(cfg, inputs, out, device)
        side = steps.control_side(cfg, inputs, pre, js["draws"],
                                  js["side"]["loss0"], device,
                                  box=js["side"]["box"])
        per = numbers(ctrl, side)
        per["draw_replay"] = per["bad_draws"] = np.zeros(n)
        res["control_checks"], _ = judge.verdict(per, limits)
    return res


def _free(device):
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
