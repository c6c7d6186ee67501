"""Numerical operators of the port: physics, spectral synthesis, logistic
weights, distance transforms and the fused window update."""

from .window_kernel import (fused_window_update,
                            fused_window_update_reference, window_geometry)

__all__ = ["fused_window_update", "fused_window_update_reference",
           "window_geometry"]
