"""Random-field proposal engine, batched over chains.

PyTorch counterpart of ``mcmc_tpu/models/randfield.py`` (the reference's
RandField, MCMC.py:433-778).  Host-side setup builds the discrete
block-size menu and the stacked logistic edge masks; the draws produce one
(B, B) proposal per chain from a single statically shaped FFT.  The draws
take a ``torch.Generator``; a seed-listed farm's step reads the same
values from its draw plan's views (``block_params_from``).

Only the spectral generation method is ported: the gstools-SRF method
(``spectral=False``, ``mcmc_tpu/ops/srf.py``) waits for ROADMAP Queue 1
#10, and the ``RandField`` wrapper class for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.chain_draws import entry
from ..ops.logistic import make_edge_mask
from ..ops.spectral import (block_mask, field_param_entries, field_params,
                            sample_field_params, spectral_field,
                            standardize_masked)
from ..utils.config import BlockMenuConfig, RandFieldConfig, WeightConfig
from ..utils.rng import resolve_device


def make_block_menu(cfg: BlockMenuConfig) -> np.ndarray:
    """(2, steps**2) array of (width, height) pairs, even-ified w//2*2
    (reference RandField.get_block_sizes, MCMC.py:568-581)."""
    width = np.linspace(cfg.min_block_x, cfg.max_block_x, cfg.steps, dtype=int)
    height = np.linspace(cfg.min_block_y, cfg.max_block_y, cfg.steps, dtype=int)
    w, h = np.meshgrid(width, height)
    return np.array([(w // 2 * 2).flatten(), (h // 2 * 2).flatten()],
                    dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class RandFieldStatic:
    """Plain-value part of the proposal engine."""

    model_name: str
    isotropic: bool
    smoothness: float | None
    n_sizes: int
    B: int  # canvas size >= max block dim
    resolution: float
    has_nugget: bool = True
    spectral: bool = True


@dataclasses.dataclass
class RandFieldArrays:
    """Tensor part of the proposal engine, on the chain's device."""

    pairs: torch.Tensor        # (2, n_sizes) int64: (w, h)
    edge_masks: torch.Tensor   # (n_sizes, B, B) float32, block at top-left
    scale_min: float
    scale_max: float
    nugget_max: float
    range_min_x: float
    range_max_x: float
    range_min_y: float
    range_max_y: float


def _require_spectral(spectral: bool):
    if not spectral:
        raise NotImplementedError(
            "the gstools-SRF generation method (spectral=False) is not "
            "ported yet: ROADMAP Queue 1 #10 (ops/srf.py)")


def build_randfield(rf_cfg: RandFieldConfig, blocks: BlockMenuConfig,
                    weights: WeightConfig, device=None
                    ) -> Tuple[RandFieldStatic, RandFieldArrays]:
    """Host-side setup: block menu, stacked edge masks, canvas size, on
    ``device`` (the card unless the caller asks for the CPU)."""
    _require_spectral(rf_cfg.spectral)
    device = resolve_device(device)
    pairs = make_block_menu(blocks)
    n_sizes = pairs.shape[1]
    B = int(max(pairs.max(), 2))
    edge = np.zeros((n_sizes, B, B), dtype=np.float32)
    for i in range(n_sizes):
        w, h = int(pairs[0, i]), int(pairs[1, i])
        edge[i, :h, :w] = make_edge_mask(
            h, w, weights.resolution, weights.L, weights.x0, weights.k,
            weights.offset, weights.max_dist)
    static = RandFieldStatic(
        model_name=rf_cfg.model_name, isotropic=rf_cfg.isotropic,
        smoothness=rf_cfg.smoothness, n_sizes=n_sizes, B=B,
        resolution=weights.resolution, has_nugget=rf_cfg.nugget_max > 0,
        spectral=rf_cfg.spectral)
    arrays = RandFieldArrays(
        pairs=torch.as_tensor(pairs, dtype=torch.int64, device=device),
        edge_masks=torch.as_tensor(edge, device=device),
        scale_min=float(rf_cfg.scale_min), scale_max=float(rf_cfg.scale_max),
        nugget_max=float(rf_cfg.nugget_max),
        range_min_x=float(rf_cfg.range_min_x),
        range_max_x=float(rf_cfg.range_max_x),
        range_min_y=float(rf_cfg.range_min_y),
        range_max_y=float(rf_cfg.range_max_y))
    return static, arrays


def finish_block(raw, size_idx, scale, arrays: RandFieldArrays,
                 nugget_noise=None, nug=None):
    """Standardize the raw fields over each chain's block, scale, add the
    nugget noise (when given) and apply the size's edge mask."""
    B = raw.shape[-1]
    w = arrays.pairs[0, size_idx]
    h = arrays.pairs[1, size_idx]
    bmask = block_mask(h, w, B)
    mf = bmask.to(raw.dtype)
    f = standardize_masked(raw, bmask)
    if nugget_noise is None:
        f = f * scale[:, None, None] * mf
    else:
        f = (f * scale[:, None, None]
             + nugget_noise * torch.sqrt(nug)[:, None, None]) * mf
    return f * arrays.edge_masks[size_idx]


def block_param_entries(static: RandFieldStatic):
    """A seed-listed step's draw-plan entries for ``block_params_from``:
    the size index and the variogram parameters' unit uniforms."""
    return ((entry("size_idx", "index", n=static.n_sizes),)
            + field_param_entries(static.isotropic))


def block_params_from(d, static: RandFieldStatic, arrays: RandFieldArrays):
    """``draw_block_params``' values from the views ``d`` of a draw plan
    holding ``block_param_entries`` (``ops/chain_draws.draw_plan``)."""
    scale, nug, range_x, range_y = field_params(
        lambda name: d[name][:, 0], arrays.scale_min, arrays.scale_max,
        arrays.nugget_max, arrays.range_min_x, arrays.range_max_x,
        arrays.range_min_y, arrays.range_max_y, static.isotropic)
    return d["size_idx"][:, 0], scale, nug, range_x, range_y


def draw_block_params(gen, n, static: RandFieldStatic,
                      arrays: RandFieldArrays):
    """Per-chain size index and variogram parameters:
    (size_idx, scale, nugget, range_x, range_y), each (n,)."""
    device = arrays.pairs.device
    size_idx = torch.randint(0, static.n_sizes, (n,), generator=gen,
                             device=device)
    scale, nug, range_x, range_y = sample_field_params(
        gen, n, arrays.scale_min, arrays.scale_max, arrays.nugget_max,
        arrays.range_min_x, arrays.range_max_x, arrays.range_min_y,
        arrays.range_max_y, static.isotropic, device)
    return size_idx, scale, nug, range_x, range_y


def draw_block(gen, n, static: RandFieldStatic, arrays: RandFieldArrays):
    """``n`` finished proposal blocks on the (B, B) canvas (reference
    RandField.get_rfblock, MCMC.py:742-778).  Returns (f (n, B, B),
    size_idx, w, h); cells outside each (h, w) block are zero."""
    _require_spectral(static.spectral)
    B = static.B
    size_idx, scale, nug, range_x, range_y = draw_block_params(
        gen, n, static, arrays)
    raw = spectral_field(gen, n, (B, B), static.resolution,
                         static.model_name, range_x, range_y,
                         static.smoothness)
    nugget_noise = None
    if static.has_nugget:
        nugget_noise = torch.randn((n, B, B), generator=gen,
                                   device=raw.device)
    f = finish_block(raw, size_idx, scale, arrays, nugget_noise, nug)
    return f, size_idx, arrays.pairs[0, size_idx], arrays.pairs[1, size_idx]
