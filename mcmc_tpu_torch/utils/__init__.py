"""Host-side helpers of the PyTorch port: typed configs and RNG plumbing."""

from .config import (BlockMenuConfig, LossConfig, RandFieldConfig,
                     WeightConfig)
from .rng import make_generator, resolve_seed

__all__ = ["BlockMenuConfig", "LossConfig", "RandFieldConfig",
           "WeightConfig", "make_generator", "resolve_seed"]
