"""The comparisons that decide ``correct`` for a chain farm.

A farm's answers are its chains: the bed, the stored residual plane and
the loss each chain ends the window with, and the blocks and decisions its
traces record.  The reference recomputes, in float64 on the card in
blocks of chains, what each answer must be, and reports per number the
worst chain:

- ``patch_gap`` (CRF): over each chain's last accepted block, the largest
  gap between the stored residual and the residual of the chain's bed,
  over the chain's rms residual.  After its last accept nothing touched
  the block's neighbourhood, so the two must agree to rounding.
- ``resid_gap`` (SGS): the same over the whole grid (the SGS step patches
  its block and ring exactly).
- ``start_gap`` (CRF): the ledger ``init`` gave each chain against the
  loss of the initial bed, relative: the start of the stored plane that
  ``ledger_gap`` trusts, checked apart.
- ``ledger_gap``: the chain's loss ledger (the last trace row) against the
  loss it must hold, relative: for the CRF chain the sum over the
  mass-conservation mask of its stored residual's squares (the upstream's
  incremental scheme leaves the ring around a block stale, so the stored
  plane is path-dependent and only the program holds it); for the SGS
  chain the loss of its bed recomputed over the whole grid.
- ``backtransform_gap_m`` (SGS): the largest gap, in metres, between the
  bed and the inverse normal-score transform of the chain's z-plane.
- ``stuck_chains``: chains that accepted no step in the window, or whose
  bed left the window as it entered it.
- ``bad_blocks``: proposals in the window whose block is not one the
  configuration allows (size off the menu, centre outside the update
  region).

A gap where the program's answer is not finite reads ``NO_NUMBER``.

``control_outputs`` puts the reference in the program's place, computed
in bfloat16: the outputs a chain would hand in if its residual, loss and
back-transform were worked out one precision below the configuration's
float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import physics, transform

CHAIN_BLOCK = 16  # chains the reference holds on the card at once
NO_NUMBER = 1e300  # what a gap reads where the program's answer is not finite


@dataclasses.dataclass
class Inputs:
    """What the harness made from the seed and handed the program too."""

    surf: np.ndarray
    velx: np.ndarray
    vely: np.ndarray
    dhdt: np.ndarray
    smb: np.ndarray
    mc_mask: np.ndarray      # bool (H, W)
    region: np.ndarray       # bool (H, W)
    data_mask: np.ndarray    # bool (H, W), the radar picks
    cond_bed: np.ndarray     # (H, W) the picks' beds, NaN elsewhere
    grounded: np.ndarray     # bool (H, W)
    resolution: float
    sigma_mc: float
    initial_bed: np.ndarray = None     # CRF: every chain's starting bed
    trend: np.ndarray = None           # SGS: the bed's trend
    quantiles: np.ndarray = None       # SGS: the normal-score fit
    references: np.ndarray = None


def make_inputs(cfg: dict, p: dict, trend=None) -> Inputs:
    """The reference's inputs for configuration ``cfg`` on problem ``p``
    (``trend``: the SGS chain's, which the harness made)."""
    region = np.asarray(p["region"]) == 1
    mc = region if cfg["loss"]["mass_conservation_in_region"] else \
        np.ones_like(region)
    inp = Inputs(surf=p["surf"], velx=p["velx"], vely=p["vely"],
                 dhdt=p["dhdt"], smb=p["smb"], mc_mask=mc, region=region,
                 data_mask=np.asarray(p["data_mask"], bool),
                 cond_bed=p["cond_bed"],
                 grounded=np.asarray(p["grounded"], bool),
                 resolution=float(p["resolution"]),
                 sigma_mc=float(cfg["loss"]["sigma_mc"]))
    if trend is None:
        inp.initial_bed = p["initial_bed"]
    else:
        inp.trend = trend
        inp.quantiles, inp.references = transform.fit_quantiles(
            p["initial_bed"] - trend, cfg["n_quantiles"])
    return inp


def _planes(inp: Inputs, device, dtype):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device
                               ).to(dtype)
    return t(inp.surf), t(inp.velx), t(inp.vely), t(inp.dhdt), t(inp.smb)


def crf_menu(cfg: dict) -> set:
    """The (h, w) block sizes the CRF configuration allows: the upstream's
    RandField.get_block_sizes, each side made even."""
    m = cfg["block_menu"]
    ws = np.linspace(m["min_block_x"], m["max_block_x"], m["steps"],
                     dtype=int) // 2 * 2
    hs = np.linspace(m["min_block_y"], m["max_block_y"], m["steps"],
                     dtype=int) // 2 * 2
    return {(int(h), int(w)) for h in hs for w in ws}


def bad_blocks(cfg: dict, inp: Inputs, traces: list) -> np.ndarray:
    """Per chain, the window's proposals whose block the configuration
    does not allow.  ``traces``: the window's segments, each a dict of
    host arrays with ``block`` (T, N, 4) = centre row, centre column and
    the two sides."""
    H, W = inp.region.shape
    if cfg["family"] == "crf":
        menu = crf_menu(cfg)
    else:
        lo_x, hi_x, lo_y, hi_y = cfg["block_sizes"]
        menu = {(h, w) for h in range(lo_x, hi_x + 1)
                for w in range(lo_y, hi_y + 1)}
    side = max(max(m) for m in menu) + 2
    allowed = np.zeros((side, side), bool)
    allowed[tuple(np.array(sorted(menu)).T)] = True
    bad = 0
    for seg in traces:
        b = seg["block"]
        whole = (b == np.round(b)).all(axis=-1)
        i = np.clip(np.nan_to_num(b), -1, max(H, W, side)).astype(np.int64)
        cx, cy, s0, s1 = np.moveaxis(i, -1, 0)
        ok = (whole & (cx >= 0) & (cx < H) & (cy >= 0) & (cy < W)
              & (s0 >= 0) & (s0 < side) & (s1 >= 0) & (s1 < side))
        ok &= inp.region[np.where(ok, cx, 0), np.where(ok, cy, 0)]
        ok &= allowed[np.where(ok, s0, 0), np.where(ok, s1, 0)]
        bad = bad + (~ok).sum(axis=0)
    return np.asarray(bad)


def last_accepted_blocks(traces: list, n: int) -> np.ndarray:
    """(N, 4) each chain's last accepted block in the window (NaN where
    the chain accepted none)."""
    last = np.full((n, 4), np.nan)
    for seg in traces:
        step, block = seg["step"], seg["block"]
        has = step.any(axis=0)
        t = step.shape[0] - 1 - np.argmax(step[::-1], axis=0)
        last[has] = block[t[has], np.flatnonzero(has)]
    return last


def moved(traces: list, n: int) -> np.ndarray:
    """Per chain, whether it accepted any step in the window."""
    out = np.zeros(n, bool)
    for seg in traces:
        out |= seg["step"].any(axis=0)
    return out


def _block_mask(blocks, H, W, device):
    """(n, H, W) bool: each row's block [floor((2cx - h)/2), floor((2cx +
    h)/2)) x [floor((2cy - w)/2), floor((2cy + w)/2)), clipped to the
    grid; empty for a NaN row."""
    b = torch.as_tensor(np.nan_to_num(blocks, nan=-1e6), device=device)
    cx, cy, h, w = b.unbind(1)
    r0 = torch.floor((2 * cx - h) / 2).clamp(min=0)
    r1 = torch.floor((2 * cx + h) / 2).clamp(max=H)
    c0 = torch.floor((2 * cy - w) / 2).clamp(min=0)
    c1 = torch.floor((2 * cy + w) / 2).clamp(max=W)
    r = torch.arange(H, device=device, dtype=b.dtype)
    c = torch.arange(W, device=device, dtype=b.dtype)
    rows = (r >= r0[:, None]) & (r < r1[:, None])
    cols = (c >= c0[:, None]) & (c < c1[:, None])
    return rows[:, :, None] & cols[:, None, :]


def _numbers(t) -> np.ndarray:
    """A tensor of gaps as host numbers, a gap that is not finite (a NaN
    or infinite answer) read as ``NO_NUMBER``."""
    return torch.nan_to_num(t, nan=NO_NUMBER, posinf=NO_NUMBER
                            ).cpu().numpy()


def _worst(values):
    v = np.asarray(values, np.float64)
    return float(np.max(v)) if v.size else 0.0


def judge(cfg: dict, inp: Inputs, out: dict, traces: list,
          device) -> dict:
    """The cell's numbers, per chain.  ``out``: the program's
    outputs, (N, ...) tensors: ``bed`` (the SGS chain's detrended),
    ``res`` the stored residual plane, ``loss_mc`` the last trace row's
    ledger and, for an SGS chain, ``z`` its z-plane.  ``traces``: the
    window's segments (host arrays).  Returns {name: (N,) values}
    (``verdict`` holds them to their limits)."""
    n = out["bed"].shape[0]
    H, W = inp.region.shape
    f64 = torch.float64
    surf, velx, vely, dhdt, smb = _planes(inp, device, f64)
    mc = torch.as_tensor(inp.mc_mask, device=device)
    sgs = cfg["family"] == "sgs"
    trend = (torch.as_tensor(np.asarray(inp.trend, np.float64),
                             device=device) if sgs else 0.0)
    last = None if sgs else last_accepted_blocks(traces, n)
    gap = np.zeros(n)
    ledger = np.zeros(n)
    back = np.zeros(n)
    still = np.zeros(n, bool)
    for i in range(0, n, CHAIN_BLOCK):
        sl = slice(i, min(i + CHAIN_BLOCK, n))
        bed = out["bed"][sl].to(device, f64)
        still[sl] = (bed == out["bed_at_start"][sl].to(device, f64)
                     ).flatten(1).all(dim=1).cpu().numpy()
        stored = out["res"][sl].to(device, f64)
        ref = physics.residual(bed + trend, surf, velx, vely, dhdt, smb,
                               inp.resolution)
        rms = torch.sqrt(physics.masked_square_sum(ref, mc)
                         / mc.sum()).clamp(min=1e-30)
        where = torch.isfinite(ref)
        if not sgs:
            where &= _block_mask(last[sl], H, W, device)
        diff = torch.where(where, (stored - ref).abs(), 0.0)
        gap[sl] = _numbers(diff.amax(dim=(-2, -1)) / rms)
        gap[sl][~torch.isfinite(bed).flatten(1).all(dim=1).cpu().numpy()] = \
            NO_NUMBER
        want = physics.gaussian_loss(ref if sgs else stored, mc,
                                     inp.sigma_mc)
        got = out["loss_mc"][sl].to(device, f64)
        ledger[sl] = _numbers((got - want).abs() / want.abs().clamp(min=1e-30))
        if sgs:
            z = out["z"][sl].to(device, f64)
            inv = transform.inverse(z, inp.quantiles, inp.references)
            back[sl] = _numbers((bed - inv).abs().amax(dim=(-2, -1)))
    stuck = ~moved(traces, n) | still
    bad = bad_blocks(cfg, inp, traces)
    per_chain = {("resid_gap" if sgs else "patch_gap"): gap}
    if not sgs:
        start = physics.gaussian_loss(physics.residual(
            torch.as_tensor(np.asarray(inp.initial_bed, np.float64),
                            device=device), surf, velx, vely, dhdt, smb,
            inp.resolution), mc, inp.sigma_mc)
        per_chain["start_gap"] = _numbers(
            (out["loss_at_init"].to(device, f64) - start).abs() / start)
    per_chain["ledger_gap"] = ledger
    if sgs:
        per_chain["backtransform_gap_m"] = back
    per_chain["stuck_chains"] = stuck.astype(np.float64)
    per_chain["bad_blocks"] = bad.astype(np.float64)
    return per_chain


COUNTS = ("stuck_chains", "bad_blocks", "draw_replay", "bad_draws")


def verdict(per_chain: dict, limits: dict) -> tuple:
    """Each number's worst chain (a count's sum) beside its limit, and the
    chains that fail one: (checks {name: {"value", "limit"}}, failed
    (N,) bool)."""
    checks = {}
    failed = None
    for name, values in per_chain.items():
        values = np.asarray(values, np.float64)
        limit = float(limits[name])
        count = name in COUNTS
        value = float(values.sum()) if count else _worst(values)
        checks[name] = {"value": value, "limit": limit}
        bad = values > (0.0 if count else limit)
        failed = bad if failed is None else failed | bad
    return checks, failed


def control_outputs(cfg: dict, inp: Inputs, out: dict, device,
                    dtype=torch.bfloat16) -> dict:
    """The outputs the reference hands in, in the program's place, when it
    computes in ``dtype``: from the program's bed, the residual plane, the
    ledger it implies and, for an SGS chain, the bed back-transformed from
    the z-plane, and for a CRF chain the initial bed's loss, each worked
    out in ``dtype``."""
    n = out["bed"].shape[0]
    sgs = cfg["family"] == "sgs"
    surf, velx, vely, dhdt, smb = _planes(inp, device, dtype)
    mc = torch.as_tensor(inp.mc_mask, device=device)
    trend = (torch.as_tensor(np.asarray(inp.trend, np.float64),
                             device=device).to(dtype) if sgs else 0.0)
    res, loss, beds = [], [], []
    for i in range(0, n, CHAIN_BLOCK):
        sl = slice(i, min(i + CHAIN_BLOCK, n))
        bed = out["bed"][sl].to(device, torch.float64)
        if sgs:
            bed = transform.inverse(out["z"][sl].to(device, torch.float64
                                                     ).to(dtype),
                                    inp.quantiles, inp.references)
        r = physics.residual(bed.to(dtype) + trend, surf, velx, vely, dhdt,
                             smb, inp.resolution)
        sq = torch.where(mc, torch.nan_to_num(r * r, nan=0.0), 0.0)
        loss.append((sq.sum(dim=(-2, -1)) / (2.0 * inp.sigma_mc ** 2)
                     ).to(dtype).to(torch.float32).cpu())
        res.append(r.to(torch.float32).cpu())
        beds.append(bed.to(torch.float32).cpu())
    ctrl = dict(out, res=torch.cat(res), loss_mc=torch.cat(loss))
    if sgs:
        ctrl["bed"] = torch.cat(beds)
    else:
        bed0 = torch.as_tensor(np.asarray(inp.initial_bed, np.float64),
                               device=device).to(dtype)
        r = physics.residual(bed0, surf, velx, vely, dhdt, smb,
                             inp.resolution)
        sq = torch.where(mc, torch.nan_to_num(r * r, nan=0.0), 0.0)
        start = (sq.sum() / (2.0 * inp.sigma_mc ** 2)).to(dtype)
        ctrl["loss_at_init"] = start.float().cpu().expand(n).clone()
    return ctrl
