"""mcmc_tpu_torch: the PyTorch / CUDA port of mcmc_tpu.

Geostatistical MCMC for subglacial topography on an NVIDIA GPU: the
large-scale CRF (random-field block proposal) chain farm and the
small-scale SGS (block re-simulation) chain farm, their drivers,
checkpoint/resume and CLI, with every Pallas TPU kernel of the JAX
package as a hand-written CUDA kernel for Hopper (``ops/csrc/*.cu``: the
CRF window update and Philox proposal noise; the SGS window extract and
writeback, the two packed CG solves and the inverse LUT), and two of the
port's own: the seed-listed farms' per-chain draws and the gstools-SRF
proposal's harmonic sum (``spectral=False``).  The JAX
package ``mcmc_tpu`` is the reference that every part of this package is
tested against; this package imports neither it nor JAX.  Everything runs
on the card unless the caller asks for the CPU.

Main path (``ChainSGS`` the same way, with its own setters)::

    chain = ChainCRF(...); chain.set_update_region(...); ...
    sampler = MultiChainSampler(chain, n_chains)   # device="cuda"
    states = sampler.init(seeds=0)
    states, traces = sampler.run(states, n_iter, segment_size)
    sampler.diagnostics(traces, elapsed_seconds)

or, with checkpoint/resume, ``drivers.large_scale_chain_farm`` /
``small_scale_chain_farm``, or ``python -m mcmc_tpu_torch cfg.json``.
One chain: ``chain.run(n_iter, ...)`` (a one-chain farm).  The
reference's functional forms keep its arguments in its order, with the
port's random source (a ``torch.Generator`` or per-chain streams) as the
keyword-only ``rng`` in place of its keys: ``parallel.init_states`` and
``parallel.run_chains`` (both families), ``models.init_state`` /
``run_chain`` and ``models.run_sgs_chain`` (one chain).  Initial beds
(the T2 workflow): ``geostats.fit_variogram`` on the radar picks, then
``geostats.generate_initial_beds`` (SGS on the card), handed to
``sampler.init(initial_beds=...)``.  The data layer (gridding radar
picks, regridding, masks, radar QC) is ``mcmc_tpu_torch.data``, host
code that the package does not import.
"""

__version__ = "0.2.0"  # pyproject.toml's

from . import geostats, io, models, ops, parallel, utils
from .models.chain_crf import ChainCRF
from .models.chain_sgs import ChainSGS
from .ops.transforms import NormalScoreTransform
from .parallel.sampler import MultiChainSampler
from .utils.config import (BlockMenuConfig, LossConfig, RandFieldConfig,
                           SGSParams, VariogramConfig, WeightConfig)

__all__ = ["ops", "models", "geostats", "parallel", "io", "utils",
           "__version__", "ChainCRF", "ChainSGS", "MultiChainSampler",
           "NormalScoreTransform", "BlockMenuConfig", "LossConfig",
           "RandFieldConfig", "SGSParams", "VariogramConfig", "WeightConfig"]
