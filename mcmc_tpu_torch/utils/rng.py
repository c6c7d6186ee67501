"""Random streams for the PyTorch port.

The JAX package carries one splittable key per chain inside the chain
state (``mcmc_tpu/utils/rng.py``).  Here a sampler owns ONE explicit
``torch.Generator`` on its device, seeded from an int, and every batched
draw of a step takes it as an argument: there is no global RNG and no
per-chain key.  The two frameworks' generators give different numbers for
the same seed, so parity tests feed both packages the same numpy draws.

Per-chain Philox (seed, offset) streams, which a bitwise resume of a chain
subset needs, arrive with the port of ``io/checkpoint.py`` (ROADMAP Queue 1
#11); until then a list of per-chain seeds is refused.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_seed(seed) -> int:
    """An int seed from an int or None (None draws fresh OS entropy)."""
    if seed is None:
        return int(np.random.SeedSequence().generate_state(1)[0])
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        return int(seed)
    raise NotImplementedError(
        "only a single int master seed (or None) is supported; per-chain "
        "seed lists need per-chain Philox streams, which come with the "
        "io/checkpoint port (ROADMAP Queue 1 #11)")


def make_generator(seed, device) -> torch.Generator:
    """One explicit generator on ``device`` seeded from ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(resolve_seed(seed))
    return gen
