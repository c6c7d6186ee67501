"""Chain models of the port: the large-scale CRF chain and its proposal
engine (with the reference-API ``RandField`` wrapper), and the small-scale
SGS chain."""

from .chain_crf import (ChainCRF, ChainState, CRFConsts, CRFStatic, Draws,
                        init_state, make_kernel, make_step, run_chain)
from .chain_sgs import (ChainSGS, SGSConsts, SGSState, SGSStatic,
                        make_sgs_kernel, make_sgs_step, run_sgs_chain,
                        sgs_init_state)
from .randfield import (RandField, RandFieldArrays, RandFieldStatic,
                        build_randfield, draw_block, make_block_menu)

__all__ = ["ChainCRF", "ChainState", "CRFConsts", "CRFStatic", "Draws",
           "init_state", "make_kernel", "make_step", "run_chain",
           "RandField", "RandFieldArrays", "RandFieldStatic",
           "build_randfield", "draw_block", "make_block_menu", "ChainSGS",
           "SGSConsts", "SGSState", "SGSStatic", "make_sgs_kernel",
           "make_sgs_step", "run_sgs_chain", "sgs_init_state"]
