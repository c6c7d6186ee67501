"""Field simulation of the port: SGS initial beds, kriging maps and
variogram fitting (counterpart of ``mcmc_tpu/geostats``)."""

from .sgs import sgs, krige, generate_initial_beds
from .variogram import (
    dists_to_cond,
    gaussian_transformation,
    experimental_variogram,
    fit_model,
    fit_variogram,
    variograms,
    MODELS,
)

__all__ = [
    "dists_to_cond",
    "gaussian_transformation",
    "sgs",
    "krige",
    "generate_initial_beds",
    "experimental_variogram",
    "fit_model",
    "fit_variogram",
    "variograms",
    "MODELS",
]
