"""The port's data layer: dataset loaders, gridding, masks and QC on the
host (numpy, scipy; pandas, xarray and pyproj imported only by the
functions that need them).

Copies of ``mcmc_tpu/data`` with the same names and ``__all__``: the
front of a user's workflow (gridding radar picks, regridding, the
high-velocity mask, radar QC, the data-prep mass-conservation residual)
without importing JAX.  Like ``mcmc_tpu``, the package ``mcmc_tpu_torch``
does not import this subpackage: ``import mcmc_tpu_torch.data``.
"""

from .interpolate import interpolate
from .topography import (
    convert_geoid,
    crop_study_area,
    filter_data_by_std,
    get_highvel_boundary,
    get_mass_conservation_residual,
    grid_data,
    load_bedmachine,
    load_bedmap,
    load_dhdt,
    load_radar,
    load_smb_racmo,
    load_vel_measures,
    make_grid,
)

__all__ = [
    "interpolate", "convert_geoid", "crop_study_area", "filter_data_by_std",
    "get_highvel_boundary", "get_mass_conservation_residual", "grid_data",
    "load_bedmachine", "load_bedmap", "load_dhdt", "load_radar",
    "load_smb_racmo", "load_vel_measures", "make_grid",
]
