"""The chain farm on one device and its convergence diagnostics."""

from .sampler import MultiChainSampler

__all__ = ["MultiChainSampler"]
