"""Random-field proposal engine, batched over chains.

PyTorch counterpart of ``mcmc_tpu/models/randfield.py`` (the reference's
RandField, MCMC.py:433-778).  Host-side setup builds the discrete
block-size menu and the stacked logistic edge masks; the draws produce one
(B, B) proposal per chain from a single statically shaped FFT.  The draws
take a ``torch.Generator``; a seed-listed farm's step reads the same
values from its draw plan's views (``block_params_from``).  ``RandField``
is the reference-API wrapper over all of it.

Both of the reference's generation methods: ``spectral=True``, FFT
spectral synthesis standardized over the block (``finish_block``), and
``spectral=False``, the gstools-SRF randomization method
(``ops/srf.py``, MCMC.py:657-687): 1000 harmonics a field summed by the
port's SRF kernel, NOT standardized, the nugget's white noise added
before the scale (``finish_block_srf``).
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
from ..ops.srf import draw_srf, sample_wavevectors, srf_field
from ..utils.config import BlockMenuConfig, RandFieldConfig, WeightConfig
from ..utils.rng import make_generator, resolve_device, resolve_seed


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


def build_randfield(rf_cfg: RandFieldConfig, blocks: BlockMenuConfig,
                    weights: WeightConfig, device=None
                    ) -> Tuple[RandFieldStatic, RandFieldArrays]:
    """Host-side setup: block menu, stacked edge masks, canvas size, on
    ``device`` (the card unless the caller asks for the CPU)."""
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


def finish_block_srf(raw, size_idx, scale, arrays: RandFieldArrays,
                     nugget_noise=None, nug=None):
    """The gstools-SRF method's finishing (JAX ``randfield.py:155-171``):
    NOT standardized; the nugget's white noise (when given) added before
    the scale, then the block and the size's edge mask:
    (raw + noise * sqrt(nug)) * scale * block_mask * edge_mask."""
    B = raw.shape[-1]
    bmask = block_mask(arrays.pairs[1, size_idx], arrays.pairs[0, size_idx],
                       B)
    if nugget_noise is not None:
        raw = raw + nugget_noise * torch.sqrt(nug)[:, None, None]
    f = raw * scale[:, None, None] * bmask.to(raw.dtype)
    return f * arrays.edge_masks[size_idx]


def srf_raw(gen, n, shape, resolution, model_name, isotropic, smoothness,
            range_x, range_y):
    """``n`` raw gstools-SRF fields of ``shape`` from ``gen``
    (``ops/srf.draw_srf``'s draws, then the harmonic sum)."""
    u, theta, z1, z2, angle = draw_srf(gen, n, isotropic, range_x.device)
    kv = sample_wavevectors(u, theta, model_name, range_x, range_y,
                            smoothness, angle)
    return srf_field(kv, z1, z2, shape, resolution)


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
        gen, arrays.scale_min, arrays.scale_max, arrays.nugget_max,
        arrays.range_min_x, arrays.range_max_x, arrays.range_min_y,
        arrays.range_max_y, static.isotropic, n=n, device=device)
    return size_idx, scale, nug, range_x, range_y


def draw_block(gen, static: RandFieldStatic, arrays: RandFieldArrays, *,
               n: int):
    """``n`` finished proposal blocks on the (B, B) canvas (reference
    RandField.get_rfblock, MCMC.py:742-778), by either generation method;
    the reference's arguments in its order, ``gen`` in place of its key.
    Returns (f (n, B, B), size_idx, w, h); cells outside each (h, w)
    block are zero."""
    B = static.B
    size_idx, scale, nug, range_x, range_y = draw_block_params(
        gen, n, static, arrays)
    if static.spectral:
        raw = spectral_field(gen, (B, B), static.resolution,
                             static.model_name, range_x, range_y,
                             static.smoothness)
    else:
        raw = srf_raw(gen, n, (B, B), static.resolution, static.model_name,
                      static.isotropic, static.smoothness, range_x, range_y)
    nugget_noise = None
    if static.has_nugget:
        nugget_noise = torch.randn((n, B, B), generator=gen,
                                   device=raw.device)
    finish = finish_block if static.spectral else finish_block_srf
    f = finish(raw, size_idx, scale, arrays, nugget_noise, nug)
    return f, size_idx, arrays.pairs[0, size_idx], arrays.pairs[1, size_idx]


class RandField:
    """Reference-API wrapper over the proposal engine (the reference's
    ``RandField``, MCMC.py:433-778): constructor, ``set_generation_method``
    / ``set_block_sizes`` / ``set_weight_param``, the CRF-weight helpers
    and host-callable field and block draws.  ``ChainCRF.run(n_iter, RF)``
    adopts its configuration.

    The draws take the wrapper's own ``torch.Generator``, seeded from
    ``rng_seed`` (None: fresh entropy) and made on ``device`` (the card
    unless the caller asks for the CPU) at the first draw."""

    def __init__(self, range_min_x, range_max_x, range_min_y, range_max_y,
                 scale_min, scale_max, nugget_max, model_name, isotropic,
                 smoothness=None, rng_seed=None, *, device=None):
        self.config = RandFieldConfig(
            range_min_x=range_min_x, range_max_x=range_max_x,
            range_min_y=range_min_y, range_max_y=range_max_y,
            scale_min=scale_min, scale_max=scale_max, nugget_max=nugget_max,
            model_name=model_name, isotropic=isotropic,
            smoothness=smoothness)
        self.seed = resolve_seed(rng_seed)
        self.device = device
        self._gen = None
        self._blocks = None
        self._weights = None
        self._built = None

    def set_generation_method(self, spectral):
        """True: FFT spectral synthesis; False: the gstools-SRF
        randomization method (reference MCMC.py:514-522)."""
        self.config = dataclasses.replace(self.config,
                                          spectral=bool(spectral))
        self._built = None

    def set_block_sizes(self, min_block_x, max_block_x, min_block_y,
                        max_block_y, steps=5):
        """Discrete block-size menu, steps^2 even-ified (w//2*2) pairs
        (reference RandField.set_block_sizes, MCMC.py:524-581)."""
        self._blocks = BlockMenuConfig(min_block_x, max_block_x,
                                       min_block_y, max_block_y, steps)
        self._built = None

    def set_weight_param(self, logis_func_L, logis_func_x0, logis_func_k,
                         logis_func_offset, max_dist, resolution):
        """Logistic edge / conditioning-weight parameters (reference
        set_weight_param, MCMC.py:544-565)."""
        if self._blocks is None:
            raise Exception(
                "It seems like the set_block_sizes has not been called yet "
                "before calling set_weight_param")
        self._weights = WeightConfig(logis_func_L, logis_func_x0,
                                     logis_func_k, logis_func_offset,
                                     max_dist, resolution)
        self._built = None

    # -- derived artifacts ---------------------------------------------------

    def _generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = make_generator(self.seed,
                                       resolve_device(self.device))
        return self._gen

    def _ensure_built(self):
        if self._built is None:
            if self._blocks is None or self._weights is None:
                raise Exception(
                    "call set_block_sizes and set_weight_param first")
            self._built = build_randfield(self.config, self._blocks,
                                          self._weights, self.device)
        return self._built

    @property
    def pairs(self):
        return self._ensure_built()[1].pairs.cpu().numpy()

    def get_block_sizes(self):
        """(2, steps^2) (width, height) menu (reference MCMC.py:568-581)."""
        return make_block_menu(self._blocks)

    def get_edge_masks(self):
        """Per-block-size logistic edge-decay masks, trimmed to each
        (height, width) like the reference list (MCMC.py:583-623)."""
        _, arrays = self._ensure_built()
        masks = arrays.edge_masks.cpu().numpy()
        pairs = arrays.pairs.cpu().numpy()
        return [masks[i, :pairs[1, i], :pairs[0, i]]
                for i in range(pairs.shape[1])]

    def get_crf_weight(self, xx, yy, cond_data_mask):
        """Conditioning weight from a data mask: exact EDT distance and the
        min-shifted logistic (reference MCMC.py:689-714).  Returns
        (weight, dist, dist_rescale, dist_logi)."""
        from ..ops.distance import min_dist_from_mask

        dist = min_dist_from_mask(np.asarray(xx), np.asarray(yy),
                                  np.asarray(cond_data_mask) == 1)
        w, dr, dl = self._weight_from(dist)
        return w, dist, dr, dl

    def get_crf_weight_from_dist(self, xx, yy, dist):
        """Conditioning weight from a precomputed distance map (reference
        MCMC.py:716-740).  Returns (weight, dist, dist_rescale,
        dist_logi)."""
        w, dr, dl = self._weight_from(dist)
        return w, np.asarray(dist), dr, dl

    def _weight_from(self, dist):
        """(weight, dist_rescale, dist_logi) as float32 numpy, computed in
        float32 as the JAX package does."""
        from ..ops.logistic import crf_weight_from_dist

        wc = self._weights
        out = crf_weight_from_dist(
            torch.as_tensor(np.asarray(dist), dtype=torch.float32), wc.L,
            wc.x0, wc.k, wc.offset, wc.max_dist)
        return tuple(t.numpy() for t in out)

    def get_random_field(self, X, Y, n=1):
        """Field realizations on a (len(Y), len(X)) grid: variogram
        parameters drawn as a proposal's, then by the spectral method the
        field standardized over the grid, scaled, plus the nugget's white
        noise; by the gstools-SRF method (JAX ``randfield.py:317-335``)
        the field through the SRF kernel, the nugget's white noise added,
        then scaled, not standardized.  Returns one (ny, nx) field, or
        (n, ny, nx) when n > 1 (the reference returns only the first,
        MCMC.py:678-687)."""
        X, Y = np.asarray(X), np.asarray(Y)
        res = float(abs(X[1] - X[0])) if len(X) > 1 else 1.0
        if len(Y) > 1:
            res_y = float(abs(Y[1] - Y[0]))
            if abs(res_y - res) > 1e-6 * max(res, res_y):
                raise ValueError(
                    f"get_random_field needs square cells: X spacing {res} "
                    f"!= Y spacing {res_y}. Resample the grid or generate "
                    "on the finer spacing and subsample.")
        shape = (len(Y), len(X))
        cfg = self.config
        gen = self._generator()
        device = gen.device
        out = []
        for _ in range(int(n)):
            scale, nug, rx, ry = sample_field_params(
                gen, cfg.scale_min, cfg.scale_max, cfg.nugget_max,
                cfg.range_min_x, cfg.range_max_x, cfg.range_min_y,
                cfg.range_max_y, cfg.isotropic, n=1, device=device)
            if cfg.spectral:
                raw = spectral_field(gen, shape, res, cfg.model_name, rx, ry,
                                     cfg.smoothness)
                f = standardize_masked(raw, torch.ones(
                    shape, dtype=torch.bool, device=device))
                noise = torch.randn((1,) + shape, generator=gen,
                                    device=device)
                f = (f * scale[:, None, None]
                     + noise * torch.sqrt(nug)[:, None, None])
            else:
                raw = srf_raw(gen, 1, shape, res, cfg.model_name,
                              cfg.isotropic, cfg.smoothness, rx, ry)
                noise = torch.randn((1,) + shape, generator=gen,
                                    device=device)
                f = ((raw + noise * torch.sqrt(nug)[:, None, None])
                     * scale[:, None, None])
            out.append(f[0].cpu().numpy())
        return out[0] if n == 1 else np.stack(out)

    def get_rfblock(self):
        """One edge-masked proposal block, trimmed to its (h, w) (reference
        get_rfblock, MCMC.py:742-778)."""
        static, arrays = self._ensure_built()
        f, _, w, h = draw_block(self._generator(), static, arrays, n=1)
        return f[0, :int(h[0]), :int(w[0])].cpu().numpy()
