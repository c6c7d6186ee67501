"""The initial-beds traffic: ``geostats.generate_initial_beds`` called
bed after bed, as a user waits for a CRF farm's starting beds.

Set-up makes the problem from the seed and warms the chunk program up on
the cell's own shapes (a bed over the first ``warmup_cells`` cells of the
grid: the first chunk eager, the capture, replays).  The window then makes
whole beds, ``n_beds=1`` with the seed's stream word plus the bed's index,
until ``seconds`` have passed.  A traced run profiles its first
``traced_beds`` beds.  The reference judges ``judged_chunks`` chunks of
every bed, drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import problem
from .reference import t2 as t2ref
from .reference.judge import NO_NUMBER


@dataclasses.dataclass
class Beds:
    cfg: dict
    traffic: dict
    p: dict
    t2: t2ref.T2
    seed: int
    device: object
    setup_parts: dict


def _kw(cfg: dict) -> dict:
    t = cfg["t2"]
    return dict(radius=t["radius"], num_points=t["num_points"],
                chunk=t["chunk"], half_window=t["half_window"])


def variogram(cfg: dict) -> dict:
    t = cfg["t2"]
    return dict(vtype=t["vtype"], s=t["s"], major_range=t["major_range"],
                minor_range=t["minor_range"], azimuth=t["azimuth"],
                sill=t["sill"], nugget=t["nugget"])


def _bed(st: Beds, index: int, **extra):
    from mcmc_tpu_torch.geostats import generate_initial_beds

    p = st.p
    return generate_initial_beds(p["xx"], p["yy"], p["cond_bed"],
                                 variogram(st.cfg), surf=p["surf"],
                                 n_beds=1, seed=st.seed + index,
                                 device=st.device, **_kw(st.cfg),
                                 **extra)[0]


def setup(cfg: dict, traffic: dict, seed: int, device) -> Beds:
    parts = {}
    t = time.perf_counter()
    problem_seed, stream_seed = problem.seed_words(seed)
    p = problem.build_problem(cfg["grid"], cfg["resolution"], problem_seed)
    t2 = t2ref.T2(cond=p["cond_bed"], surf=p["surf"],
                  resolution=p["resolution"], vario=variogram(cfg),
                  **_kw(cfg))
    st = Beds(cfg=cfg, traffic=traffic, p=p, t2=t2, seed=stream_seed,
              device=torch.device(device), setup_parts=parts)
    parts["problem"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = np.zeros(p["cond_bed"].shape, bool)
    warm.flat[:traffic["warmup_cells"]] = True
    _bed(st, -1, sim_mask=warm)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    parts["warmup"] = time.perf_counter() - t
    return st


def window(st: Beds, seconds: float, trace: bool = False) -> dict:
    """Whole beds until ``seconds`` have passed; returns their seconds,
    the beds and their ends, and, traced, the profiler."""
    beds, marks = [], []
    prof = None
    profiled = st.traffic["traced_beds"] if trace else 0
    if profiled:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        activities = [ProfilerActivity.CPU]
        if st.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    t_start = time.perf_counter()
    while True:
        if len(beds) < profiled:
            with record_function("cardbench.bed"):
                beds.append(_bed(st, len(beds)))
            if len(beds) == profiled:
                prof.stop()
        else:
            beds.append(_bed(st, len(beds)))
        marks.append(time.perf_counter())
        if marks[-1] - t_start >= seconds and len(beds) >= profiled:
            break
    return dict(t_start=t_start, seconds=marks[-1] - t_start, beds=beds,
                marks=marks, prof=prof, profiled=profiled)


def _cells(st: Beds) -> int:
    return int(np.isnan(st.p["cond_bed"]).sum())


def end_to_end(st: Beds, w: dict) -> dict:
    """Every simulated cell of every whole bed over the beds' seconds."""
    return {"initbed_cells_per_s": _cells(st) * len(w["beds"])
            / w["seconds"]}


def rates(st: Beds, w: dict) -> list:
    return [_cells(st) / d for d in np.diff([w["t_start"]] + w["marks"])]


def fill_view(st: Beds, w: dict, view) -> None:
    chunk = st.cfg["t2"]["chunk"]
    view.steps = w["profiled"] * -(-_cells(st) // chunk)
    view.info = dict(chunks=view.steps, cells=_cells(st))


def _worst(diff) -> float:
    """The largest gap, one that is not finite read as the judge's
    ``NO_NUMBER``."""
    d = np.abs(np.asarray(diff, np.float64))
    return float(np.where(np.isfinite(d), d, NO_NUMBER).max())


def judged(st: Beds, w: dict, limits: dict, device,
           control: bool = False) -> dict:
    """Each bed of the window judged on ``judged_chunks`` chunks drawn from
    the seed, and its picks held: ``draw_gap``, the largest gap between
    the program's and the reference's scores of the judged cells (the
    scores, since a metre of bed is a very different score where the
    picks are dense than in their tails); ``data_gap_m``, between the bed
    and the radar picks at the picks."""
    prep = st.t2.prepared()
    n_chunks = -(-len(prep["cells"]) // st.t2.chunk)
    rng = np.random.default_rng(st.seed)
    cond = st.p["cond_bed"]
    picks = ~np.isnan(cond)
    gaps, data, ctrl_gaps, ctrl_data = [], [], [], []
    for i, bed in enumerate(w["beds"]):
        chunks = rng.choice(n_chunks, st.traffic["judged_chunks"],
                            replace=False)
        ref, got = t2ref.judge_bed(st.t2, prep, bed, st.seed + i, chunks)
        gaps.append(_worst(ref - got))
        data.append(_worst(bed[picks] - cond[picks]))
        if control:
            low, _ = t2ref.judge_bed(st.t2, prep, bed, st.seed + i, chunks,
                                     dtype=torch.bfloat16)
            ctrl_gaps.append(_worst(ref - low))
            z = t2ref._round(prep["z_data"][picks], torch.bfloat16)
            back = t2ref.transform.inverse(torch.as_tensor(z), prep["q"],
                                           prep["r"]).numpy()
            ctrl_data.append(_worst(back - cond[picks]))
    per_bed = {"draw_gap": np.array(gaps), "data_gap_m": np.array(data)}
    checks = {k: {"value": float(v.max()), "limit": float(limits[k])}
              for k, v in per_bed.items()}
    failed = np.zeros(len(w["beds"]), bool)
    for k, v in per_bed.items():
        failed |= v > limits[k]
    res = dict(checks=checks, attempted=len(w["beds"]),
               failed=int(failed.sum()))
    if control:
        res["control_checks"] = {
            "draw_gap": {"value": max(ctrl_gaps),
                           "limit": float(limits["draw_gap"])},
            "data_gap_m": {"value": max(ctrl_data),
                           "limit": float(limits["data_gap_m"])}}
    return res
