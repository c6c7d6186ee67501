"""Chain models of the port: the large-scale CRF chain and its proposal
engine."""

from .chain_crf import (ChainCRF, ChainState, CRFConsts, CRFStatic, Draws,
                        init_state, make_kernel, make_step)
from .randfield import (RandFieldArrays, RandFieldStatic, build_randfield,
                        draw_block, make_block_menu)

__all__ = ["ChainCRF", "ChainState", "CRFConsts", "CRFStatic", "Draws",
           "init_state", "make_kernel", "make_step", "RandFieldArrays",
           "RandFieldStatic", "build_randfield", "draw_block",
           "make_block_menu"]
