"""The chain farm, its functional runners and convergence diagnostics,
and the multi-GPU layer: meshes of ``torch.distributed`` ranks, the farm
sharded over them, and the row-sharded grid."""

from .diagnostics import (acceptance_rate, ess, ess_bulk, ess_tail,
                          rank_normalized_rhat, split_rhat)
from .distributed import (global_chains_grid_mesh, global_chains_mesh,
                          initialize_distributed)
from .grid_sharded import (make_sharded_crf_chain, make_sharded_crf_chains,
                           make_sharded_loss, make_sharded_residual,
                           shard_grid_arrays)
from .mesh import chains_grid_mesh, chains_mesh, replicate, shard_chains
from .sampler import MultiChainSampler, init_states, run_chains

__all__ = ["chains_mesh", "chains_grid_mesh", "shard_chains", "replicate",
           "MultiChainSampler", "run_chains", "init_states", "split_rhat",
           "ess", "rank_normalized_rhat", "ess_bulk", "ess_tail",
           "acceptance_rate", "make_sharded_crf_chain",
           "make_sharded_crf_chains", "make_sharded_residual",
           "make_sharded_loss", "shard_grid_arrays",
           "initialize_distributed", "global_chains_mesh",
           "global_chains_grid_mesh"]
