"""Numerical operators of the port: physics, spectral synthesis, logistic
weights, distance transforms, covariance, kriging solves, the octant
neighbour search, the normal-score transform, and the kernels with their
plain versions: the CRF fused window update and Philox noise, the SGS
window extract/writeback, the two packed CG solves (mixture system, given
Sigma) and the LUT; and the port's own kernels: the seed-listed farms'
per-chain draws, the gstools-SRF proposal's harmonic sum, the T2
chunk's bounded draws (``bounded_draw_kernel``) and the SGS step's
K-nearest selection (``k_nearest_kernel``)."""

from .covariance import (CovarianceSpec, covariance_norm, make_matern_table,
                         make_rho, make_rotation_matrix, make_sigma)
from .cg_kernel import (masked_cg, masked_cg_reference, mix_masked_cg,
                        mix_masked_cg_reference)
from .distance import min_dist_from_mask
from .logistic import crf_weight_from_dist, logistic_weight, make_edge_mask
from .lut_kernel import lut_interp, lut_interp_reference
from .noise_kernel import batched_normal, batched_normal_reference
from .physics import (mass_conservation_residual, masked_gaussian_loss,
                      thickness_violations)
from .spectral import sample_field_params, spectral_density, spectral_field
from .srf_kernel import srf_harmonics, srf_harmonics_reference
from .transforms import NormalScoreTransform
from .sgs_window_kernel import (window_extract, window_extract_reference,
                                window_writeback, window_writeback_reference)
from .window_kernel import (fused_window_update,
                            fused_window_update_reference, window_geometry)

__all__ = ["CovarianceSpec", "covariance_norm", "make_matern_table",
           "make_rho", "make_rotation_matrix", "make_sigma",
           "NormalScoreTransform", "fused_window_update", "fused_window_update_reference",
           "window_geometry", "batched_normal", "batched_normal_reference",
           "masked_cg", "masked_cg_reference", "mix_masked_cg",
           "mix_masked_cg_reference", "lut_interp", "lut_interp_reference",
           "window_extract", "window_extract_reference", "window_writeback",
           "window_writeback_reference", "srf_harmonics",
           "srf_harmonics_reference", "mass_conservation_residual",
           "masked_gaussian_loss", "thickness_violations",
           "sample_field_params", "spectral_density", "spectral_field",
           "logistic_weight", "crf_weight_from_dist", "make_edge_mask",
           "min_dist_from_mask"]
