"""Host-side helpers of the PyTorch port: typed configs, RNG plumbing and
the terminal progress block."""

from .config import (BlockMenuConfig, DriverConfig, LossConfig,
                     RandFieldConfig, RunConfig, SGSParams, VariogramConfig,
                     WeightConfig)
from .rng import (generator_state, make_generator, resolve_device,
                  resolve_seed, restore_generator)

__all__ = ["BlockMenuConfig", "DriverConfig", "LossConfig",
           "RandFieldConfig", "RunConfig", "SGSParams", "VariogramConfig",
           "WeightConfig", "generator_state", "make_generator",
           "resolve_device", "resolve_seed", "restore_generator"]
