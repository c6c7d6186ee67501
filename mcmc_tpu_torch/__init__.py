"""mcmc_tpu_torch: the PyTorch / CUDA port of mcmc_tpu.

Geostatistical MCMC for subglacial topography on an NVIDIA GPU: the
large-scale CRF (random-field block proposal) chain farm, with the fused
window update as a hand-written CUDA kernel for Hopper
(``ops/csrc/window_kernel.cu``).  The JAX package ``mcmc_tpu`` is the
reference that every part of this package is tested against; this package
imports neither it nor JAX.

Main path::

    chain = ChainCRF(...); chain.set_update_region(...); ...
    sampler = MultiChainSampler(chain, n_chains, device="cuda")
    states = sampler.init(seeds=0)
    states, traces = sampler.run(states, n_iter, segment_size)
    sampler.diagnostics(traces, elapsed_seconds)
"""

from .models.chain_crf import ChainCRF
from .parallel.sampler import MultiChainSampler
from .utils.config import (BlockMenuConfig, LossConfig, RandFieldConfig,
                           WeightConfig)

__all__ = ["ChainCRF", "MultiChainSampler", "BlockMenuConfig", "LossConfig",
           "RandFieldConfig", "WeightConfig"]
