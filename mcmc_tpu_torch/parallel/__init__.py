"""The chain farm on one device, its functional runners and its
convergence diagnostics."""

from .diagnostics import (acceptance_rate, ess, ess_bulk, ess_tail,
                          rank_normalized_rhat, split_rhat)
from .sampler import MultiChainSampler, init_states, run_chains

__all__ = ["MultiChainSampler", "run_chains", "init_states", "split_rhat",
           "ess", "rank_normalized_rhat", "ess_bulk", "ess_tail",
           "acceptance_rate"]
