"""The judged steps: a farm's chains followed by the reference step by step.

After the window the harness runs the same farm ``T`` steps more through
the window's own call, and hands over the chains' planes as those steps
found them (``pre``), each step's draws, and what the steps produced
(``side``): each chain's decision and ledger a step and its planes after
the last.  The reference starts from ``pre`` in float64 and takes each
step as the chain did, so that it stays on the chain's path, recomputing
from the draws the proposal (CRF) or the conditional redraw (SGS), the
patched residual, the loss change and its own Metropolis decision.  An
SGS redraw is conditioned on the bed, so a float32 chain and the float64
reference would drift apart step by step: there the side hands in its
planes after every step over a box about the step's block, each step is
compared there, and the reference carries on from the side's box.  Per
number, the worst over chains and steps:

- ``step_dloss_gap``: over the steps a chain took, its ledger's change
  against the reference's loss change, in log-probability units (the
  Metropolis rule's own scale).
- ``mh_gap``: over the steps where the chain decided otherwise than the
  reference, how far the reference's log u + delta lies from 0, the
  rule's threshold (``NO_NUMBER`` where the reference finds the ice's
  thickness lost): 0 where every decision agrees.
- ``step_bed_gap_m``: the bed after the steps against the reference's, in
  metres.
- ``step_res_gap``: the stored residual after the steps against the
  reference's, over the chain's rms residual.
- ``step_z_gap`` (SGS): the score plane after the steps against the
  reference's.
- ``step_blocks`` (added to ``bad_blocks``): steps whose block is not the
  one the draws name.

``control_side`` is the control: the reference, in bfloat16, in the
program's place, deciding for itself.
"""

from __future__ import annotations

import numpy as np
import torch

from . import crf_step, physics, sgs_step

CHAIN_BLOCK = 64   # chains the reference follows on the card at once
NO_NUMBER = 1e300


def make_step(cfg: dict, inp, device, dtype=torch.float64):
    mod = sgs_step if cfg["family"] == "sgs" else crf_step
    return mod.Step(cfg, inp, device, dtype)


def plane_names(cfg: dict) -> tuple:
    return ("bed", "res", "z") if cfg["family"] == "sgs" else ("bed", "res")


def box_origin(cx, cy, half: int, H: int, W: int):
    """(n, 2) the first row and column of each chain's (2 half)^2 box
    about its block's centre, held inside the grid."""
    return torch.stack([(cx - half).clamp(0, H - 2 * half),
                        (cy - half).clamp(0, W - 2 * half)], dim=1)


def _box_index(origin, size: int):
    ar = torch.arange(size, device=origin.device)
    n3 = torch.arange(origin.shape[0], device=origin.device)[:, None, None]
    return (n3, (origin[:, 0, None] + ar)[:, :, None],
            (origin[:, 1, None] + ar)[:, None, :])


def take_box(plane, origin, size: int):
    """(n, size, size) each chain's box of an (n, H, W) plane."""
    return plane[_box_index(origin, size)]


def put_box(plane, origin, size: int, values) -> None:
    plane[_box_index(origin, size)] = values.to(plane.dtype)


def control_side(cfg: dict, inp, pre: dict, draws: list, loss0, device,
                 box: int = 0, dtype=torch.bfloat16) -> dict:
    """The judged steps as the reference makes them in ``dtype`` in the
    program's place: its decisions, its ledger (``loss0`` carried on in
    ``dtype``), its planes after the last step and, with ``box``, each
    step's boxes as ``judge_steps`` takes them."""
    step = make_step(cfg, inp, device, dtype)
    names = plane_names(cfg)
    n = pre["bed"].shape[0]
    H, W = pre["bed"].shape[-2:]
    out = {k: [] for k in names}
    boxes = [{k: [] for k in names} for _ in draws]
    taken, deltas = [], []
    for i in range(0, n, CHAIN_BLOCK):
        idx = torch.arange(i, min(i + CHAIN_BLOCK, n), device=device)
        planes = [pre[k][i:i + CHAIN_BLOCK].to(device, dtype) for k in names]
        rec = []
        for t, d in enumerate(draws):
            rec.append(step.step(*planes, d, idx))
            if box:
                org = box_origin(d["cx"][idx], d["cy"][idx], box, H, W)
                for k, p in zip(names, planes):
                    boxes[t][k].append(take_box(p, org, 2 * box).float())
        taken.append(torch.stack([r["taken"] & ~r["viol"] for r in rec]))
        deltas.append(torch.stack([r["delta"] for r in rec]))
        for k, p in zip(names, planes):
            out[k].append(p.float())
    taken, delta = torch.cat(taken, 1), torch.cat(deltas, 1)
    loss, ledger = [], loss0.to(device, dtype)
    for t in range(taken.shape[0]):
        ledger = torch.where(taken[t], ledger + delta[t], ledger)
        loss.append(ledger.float())
    side = {k: torch.cat(v) for k, v in out.items()}
    side.update(taken=taken, loss=torch.stack(loss), loss0=loss0,
                block=None, box=box)
    if box:
        side["boxes"] = [{k: torch.cat(v) for k, v in b.items()}
                         for b in boxes]
    return side


def judge_steps(cfg: dict, inp, pre: dict, draws: list, side: dict,
                device) -> dict:
    """Per chain, each number of the judged steps (module docstring).
    With ``side["box"]`` (a half side) the side hands in, a step, each
    chain's planes over a box about the step's block (``boxes``): each
    step is then compared there and the reference carries on from the
    side's box, so that every step starts from the side's own state."""
    step = make_step(cfg, inp, device)
    names = plane_names(cfg)
    f64 = torch.float64
    n = pre["bed"].shape[0]
    H, W = pre["bed"].shape[-2:]
    half = side.get("box", 0)
    mc = torch.as_tensor(inp.mc_mask, device=device)
    taken = side["taken"].to(device)
    loss = torch.cat([side["loss0"].to(device, f64)[None],
                      side["loss"].to(device, f64)])
    gap = {k: np.zeros(n) for k in names}
    per = {k: np.zeros(n) for k in ("step_dloss_gap", "mh_gap",
                                    "step_blocks")}
    for i in range(0, n, CHAIN_BLOCK):
        sl = slice(i, min(i + CHAIN_BLOCK, n))
        idx = torch.arange(sl.start, sl.stop, device=device)
        planes = [pre[k][sl].to(device, f64) for k in names]
        rec = []
        for t, d in enumerate(draws):
            rec.append(step.step(*planes, d, idx, taken[t, sl]))
            if not half:
                continue
            org = box_origin(d["cx"][idx], d["cy"][idx], half, H, W)
            for k, p in zip(names, planes):
                got = side["boxes"][t][k][sl].to(device, f64)
                gap[k][sl] = np.maximum(gap[k][sl], _box_gap(
                    got, take_box(p, org, 2 * half)))
                put_box(p, org, 2 * half, got)
        rec = {k: torch.stack([r[k] for r in rec]) for k in rec[0]}
        took = taken[:, sl] & ~rec["viol"]
        dl = (loss[1:, sl] - loss[:-1, sl]) - rec["delta"]
        per["step_dloss_gap"][sl] = _worst(torch.where(took, dl.abs(), 0.0))
        off = taken[:, sl] != rec["accept"]
        margin = torch.where(rec["viol"], NO_NUMBER, rec["margin"])
        per["mh_gap"][sl] = _worst(torch.where(off, margin, 0.0))
        if side.get("block") is not None:
            blk = side["block"][:, sl].to(device, f64)
            per["step_blocks"][sl] = (blk != rec["block"].to(f64)).any(-1) \
                .sum(0).cpu().numpy()
        if not half:
            for k, p in zip(names, planes):
                gap[k][sl] = _box_gap(side[k][sl].to(device, f64), p)
        rms = torch.sqrt(physics.masked_square_sum(pre["res"][sl].to(
            device, f64), mc) / mc.sum()).clamp(min=1e-30)
        gap["res"][sl] = gap["res"][sl] / rms.cpu().numpy()
    per["step_bed_gap_m"] = gap["bed"]
    per["step_res_gap"] = gap["res"]
    if "z" in names:
        per["step_z_gap"] = gap["z"]
    return per


def _worst(x) -> np.ndarray:
    """Per chain, the largest of a (T, n) tensor of gaps, a gap that is
    not finite read as ``NO_NUMBER``."""
    x = torch.nan_to_num(x, nan=NO_NUMBER, posinf=NO_NUMBER)
    return x.amax(dim=0).cpu().numpy()


def _box_gap(got, ref) -> np.ndarray:
    """Per chain, the largest gap between two (n, h, w) planes, where the
    reference's is finite; ``NO_NUMBER`` where the judged one is not."""
    gap = torch.where(torch.isfinite(ref), (got - ref).abs(), 0.0)
    return _worst(gap.flatten(1).T)
