"""Random streams and devices for the PyTorch port.

The JAX package carries one splittable key per chain inside the chain
state (``mcmc_tpu/utils/rng.py``).  Here a sampler owns ONE explicit
``torch.Generator`` on its device, seeded from an int, and every batched
draw of a step takes it as an argument: there is no global RNG and no
per-chain key.  The two frameworks' generators give different numbers for
the same seed, so parity tests feed both packages the same numpy draws.

A checkpoint stores the generator's state beside the chain state
(``generator_state``), with its kind: ``"cuda-philox"`` (the card's
Philox seed and offset) or ``"cpu-mt19937"`` (the CPU's Mersenne
Twister).  ``restore_generator`` refuses a state of the other kind, since
neither can continue the other's stream.  A list of per-chain seeds is
refused: it needs per-chain streams, which no path of the port has yet.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device`` turns ``None`` into ``"cuda"`` and refuses a CUDA
device on a machine without one, naming ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

GENERATOR_KINDS = {"cuda": "cuda-philox", "cpu": "cpu-mt19937"}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``None`` meaning the card; a CUDA
    device on a machine without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but torch.cuda.is_available() is "
            "false: the port runs on an NVIDIA GPU; pass device='cpu' to "
            "run on the CPU")
    return device


def resolve_seed(seed) -> int:
    """An int seed from an int or None (None draws fresh OS entropy)."""
    if seed is None:
        return int(np.random.SeedSequence().generate_state(1)[0])
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        return int(seed)
    raise NotImplementedError(
        "only a single int master seed (or None) is supported; per-chain "
        "seed lists need per-chain Philox streams, which the port does not "
        "have yet")


def make_generator(seed, device) -> torch.Generator:
    """One explicit generator on ``device`` seeded from ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(resolve_seed(seed))
    return gen


def generator_kind(device) -> str:
    """The kind of generator a device's sampler owns."""
    dev = torch.device(device)
    if dev.type not in GENERATOR_KINDS:
        raise ValueError(f"no generator kind for device {dev}")
    return GENERATOR_KINDS[dev.type]


def generator_state(gen: torch.Generator):
    """``(kind, state)``: the generator's kind and its full state as a
    uint8 numpy array (``get_state``)."""
    return (generator_kind(gen.device),
            gen.get_state().numpy().astype(np.uint8, copy=True))


def restore_generator(kind: str, state, device) -> torch.Generator:
    """A generator on ``device`` continuing the stream ``(kind, state)``
    describes; a state of another kind than the device's raises."""
    want = generator_kind(device)
    if kind != want:
        raise ValueError(f"the generator state is {kind!r}, but a sampler "
                         f"on {torch.device(device)} owns a {want!r} "
                         "generator: a stream cannot move between them")
    gen = torch.Generator(device=torch.device(device))
    gen.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))
    return gen
