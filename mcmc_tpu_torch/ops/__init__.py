"""Numerical operators of the port: physics, spectral synthesis, logistic
weights, distance transforms, covariance, kriging solves, the normal-score
transform, and the kernels with their plain versions: the CRF fused window
update, the SGS window extract/writeback, mixture-system CG and LUT."""

from .cg_kernel import mix_masked_cg, mix_masked_cg_reference
from .lut_kernel import lut_interp, lut_interp_reference
from .sgs_window_kernel import (window_extract, window_extract_reference,
                                window_writeback, window_writeback_reference)
from .window_kernel import (fused_window_update,
                            fused_window_update_reference, window_geometry)

__all__ = ["fused_window_update", "fused_window_update_reference",
           "window_geometry", "mix_masked_cg", "mix_masked_cg_reference",
           "lut_interp", "lut_interp_reference", "window_extract",
           "window_extract_reference", "window_writeback",
           "window_writeback_reference"]
