"""Typed configuration dataclasses.

The reference has no config system: knobs live in imperative setters
(set_update_region / set_loss_type / set_variogram / set_sgs_param /
set_block_sizes / set_weight_param / set_generation_method — reference
MCMC.py) and in ``__main__`` constant blocks
(largeScaleChain_multiprocessing.py:451-646), plus a phantom ``config``
module imported by the GPU driver that is absent from the repo
(largeScaleChain_multiprocessing_GPU.py:19,491,563,581-584).

Every knob from those sources is a first-class, validated field here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

_VALID_RF_MODELS = ("Gaussian", "Exponential", "Matern")
_VALID_VARIO = ("Gaussian", "Exponential", "Spherical", "Matern")


@dataclasses.dataclass(frozen=True)
class RandFieldConfig:
    """Random-field sampler parameters (reference RandField.__init__, MCMC.py:462-512)."""

    range_min_x: float
    range_max_x: float
    range_min_y: float
    range_max_y: float
    scale_min: float
    scale_max: float
    nugget_max: float
    model_name: str = "Matern"
    isotropic: bool = True
    smoothness: Optional[float] = None
    spectral: bool = True  # set_generation_method; spectral synthesis is the TPU path

    def __post_init__(self):
        if self.model_name not in _VALID_RF_MODELS:
            raise ValueError(
                f"model_name must be one of {_VALID_RF_MODELS}, got {self.model_name!r}"
            )
        if self.model_name == "Matern" and self.smoothness is None:
            raise ValueError("a smoothness value must be defined if model name is Matern")
        if self.range_max_x < self.range_min_x or self.range_max_y < self.range_min_y:
            raise ValueError("the maximum range must be greater or equal to the minimum range")


@dataclasses.dataclass(frozen=True)
class BlockMenuConfig:
    """Discrete block-size menu (reference RandField.set_block_sizes, MCMC.py:524-581).

    ``steps`` intervals per axis -> steps**2 (width, height) pairs, each
    even-ified with w//2*2 as in the reference.
    """

    min_block_x: int
    max_block_x: int
    min_block_y: int
    max_block_y: int
    steps: int = 5


@dataclasses.dataclass(frozen=True)
class WeightConfig:
    """Logistic conditioning-weight parameters (reference set_weight_param, MCMC.py:544-565)."""

    L: float
    x0: float
    k: float
    offset: float
    max_dist: float
    resolution: float


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss configuration (reference chain.set_loss_type, MCMC.py:950-1018).

    The production loss is the Gaussian sum-square mass-conservation loss;
    sigma_data is retained for the (reference-commented-out) data-misfit term.
    """

    sigma_mc: float
    mass_conv_in_region: bool = True
    sigma_data: float = -1.0

    def __post_init__(self):
        if self.sigma_mc <= 0:
            raise ValueError("sigma_mc must be positive")


@dataclasses.dataclass(frozen=True)
class VariogramConfig:
    """SGS variogram model (reference chain_sgs.set_variogram, MCMC.py:1505-1543)."""

    vtype: str
    major_range: float
    minor_range: float
    sill: float
    nugget: float
    azimuth: float = 0.0
    smoothness: Optional[float] = None

    def __post_init__(self):
        if self.vtype not in _VALID_VARIO:
            raise ValueError(f"vtype must be one of {_VALID_VARIO}, got {self.vtype!r}")
        if self.vtype == "Matern" and (self.smoothness is None or self.smoothness <= 0):
            raise ValueError("vario smoothness must be a positive float for Matern")

    @classmethod
    def isotropic(cls, vtype, vrange, sill, nugget, smoothness=None):
        """Isotropic model: major_range == minor_range, azimuth 0."""
        return cls(vtype=vtype, major_range=vrange, minor_range=vrange, sill=sill,
                   nugget=nugget, azimuth=0.0, smoothness=smoothness)


@dataclasses.dataclass(frozen=True)
class SGSParams:
    """SGS behavior knobs (reference chain_sgs.set_sgs_param, MCMC.py:1545-1561)."""

    num_neighbors: int
    search_radius: float
    rand_dropout_on: bool = False
    dropout_rate: float = 0.0

    def __post_init__(self):
        if not self.rand_dropout_on and self.dropout_rate != 0.0:
            object.__setattr__(self, "dropout_rate", 0.0)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run/orchestration knobs (mirrors run() args + the driver's run_param dict)."""

    n_iter: int
    only_save_last_bed: bool = True
    bed_thinning: int = 0          # >0: additionally save every k-th bed
    info_per_iter: int = 1000
    progress: bool = True
    segment_size: int = 1000       # scan segment length between host syncs


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """First-class home for the GPU driver's phantom ``config`` module fields
    (reference largeScaleChain_multiprocessing_GPU.py:19,491,563,581-584)."""

    resolution: float = 500.0
    sigma3: float = 5.0
    T3_xmin_block: int = 50
    T3_xmax_block: int = 80
    T3_ymin_block: int = 50
    T3_ymax_block: int = 80
    n_chains: int = 10
    n_iter: int = 5_000
    output_path: str = "./Data/output"
    seeds: Sequence[int] = ()
