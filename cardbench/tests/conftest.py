"""Helpers of the card benchmark's own tests (run from the repository's
root: ``python -m pytest cardbench/tests``; ``pytest tests/`` does not
collect them)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(workload: str, grid: int = 48, chains: int = 4,
               steps: int = 20) -> dict:
    """``workload``'s cell at a size the CPU runs in seconds: its own
    configuration with the grid, the farm, the blocks and the
    neighbourhood cut down, segments of ``steps`` steps (an initial-beds
    cell: the grid, its warm-up and the chunks judged)."""
    from cardbench import core

    c = core.cell(core.load_spec(), workload)
    cfg = copy.deepcopy(c["cfg"])
    cfg.update(grid=grid, chains=chains)
    if c["traffic"]["kind"] == "initbeds":
        c.update(cfg=cfg, traffic=dict(c["traffic"], warmup_cells=256,
                                       judged_chunks=4))
        return c
    if cfg["family"] == "crf":
        cfg["block_menu"] = dict(min_block_x=8, max_block_x=16,
                                 min_block_y=8, max_block_y=16, steps=3)
        cfg["randfield"].update(range_min_x=2000.0, range_max_x=5000.0,
                                range_min_y=2000.0, range_max_y=5000.0)
        cfg["weight"]["max_dist"] = 3000.0
    else:
        cfg.update(block_sizes=[3, 6, 3, 6], trend_sigma_cells=3,
                   n_quantiles=100,
                   sgs={"num_neighbors": 16, "search_radius": 3000.0})
    c["cfg"] = cfg
    c["traffic"] = dict(c["traffic"], segment_steps=steps,
                        warmup_segments=1, traced_segments=2)
    return c


@pytest.fixture
def small():
    return small_cell
