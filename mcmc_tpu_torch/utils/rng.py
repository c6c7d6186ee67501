"""Random streams and devices for the PyTorch port.

Two kinds of stream, as the JAX package's two ways of seeding a farm
(``mcmc_tpu/utils/rng.py``: ``split_for_chains`` and
``keys_from_seed_list``):

- **An int master seed** (or ``None``): a sampler owns ONE explicit
  ``torch.Generator`` on its device, and every batched draw of a step
  takes it as an argument, so a chain's draws depend on the whole farm.
- **A list of per-chain seeds**: one stream per chain
  (``PerChainStreams``).  Chain i's key is the two 32-bit words of
  SplitMix64(seeds[i] mod 2^64), computed on the host; with a step
  counter kept on the device, every draw value is a pure function of
  (key i, step, slot, index), ``slot`` naming the draw site
  (``ops/chain_draws.SLOTS``).  Chain i's draws then depend on
  ``seeds[i]`` and the step alone, as chain i of the JAX package's farm
  depends on its own key alone.  The draws come from the per-chain
  Philox kernels (``ops/chain_draws.py``, ``ops/noise_kernel.py``).

The two frameworks' generators give different numbers for the same seed,
so parity tests feed both packages the same numpy draws.

A farm sharded over ranks (``parallel/sampler.py``) keeps chain i's draws
whatever the number of ranks, as the JAX package does by splitting one
key a chain before it shards.  Per-chain streams give that for free: a
rank holds its chains' keys (``PerChainStreams.rows``) and the shared
step.  An int-seeded farm's rank holds the whole farm's generator,
seeded alike on every rank, inside a ``RowSlice``: at each draw site it
draws the whole batch and keeps its own rows, so its bits are those of
the one-rank farm.  ``join_stream_states`` joins the ranks' stream
states of a sharded checkpoint into the whole farm's.

A checkpoint stores the stream's state beside the chain state
(``generator_state``), with its kind: ``"cuda-philox"`` (the card's
Philox seed and offset), ``"cpu-mt19937"`` (the CPU's Mersenne Twister)
or ``"philox-per-chain"`` (the per-chain keys and the step, on either
device).  ``restore_generator`` refuses a state of another kind than the
sampler's, since none can continue another's stream.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device`` turns ``None`` into ``"cuda"`` and refuses a CUDA
device on a machine without one, naming ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GENERATOR_KINDS = {"cuda": "cuda-philox", "cpu": "cpu-mt19937"}
PER_CHAIN_KIND = "philox-per-chain"
M64 = (1 << 64) - 1


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


def is_seed_list(seed) -> bool:
    """Whether ``seed`` is a list (or array) of per-chain seeds."""
    return (seed is not None and not isinstance(seed, (int, np.integer))
            and not isinstance(seed, (str, bytes)) and np.ndim(seed) == 1)


def _int_seed(seed) -> int:
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        return int(seed)
    raise TypeError(f"a seed must be an int, got {seed!r}")


def resolve_seed(seed, n_chains=None):
    """An int seed from an int or None (None draws fresh OS entropy), or a
    tuple of ints from a list of per-chain seeds.  With ``n_chains`` a
    list must hold at least that many seeds (else ``ValueError``) and
    its first ``n_chains`` are used, as the JAX package's
    ``MultiChainSampler.init`` does."""
    if seed is None:
        return int(np.random.SeedSequence().generate_state(1)[0])
    if not is_seed_list(seed):
        return _int_seed(seed)
    seeds = tuple(_int_seed(s) for s in np.asarray(seed, dtype=object))
    if n_chains is not None:
        if len(seeds) < int(n_chains):
            raise ValueError(f"need at least n_chains = {n_chains} seeds, "
                             f"got {len(seeds)}")
        seeds = seeds[:int(n_chains)]
    return seeds


def splitmix64(x: int) -> int:
    """SplitMix64's output for the state ``x`` (Steele, Lea and Flood,
    OOPSLA 2014; the seeding function of Java's SplittableRandom)."""
    z = (int(x) + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def chain_keys(seeds) -> np.ndarray:
    """(N, 2) uint32 Philox keys, row i the low and high words of
    SplitMix64(seeds[i] mod 2^64)."""
    keys = np.empty((len(seeds), 2), np.uint32)
    for i, s in enumerate(seeds):
        z = splitmix64(int(s) & M64)
        keys[i] = (z & 0xFFFFFFFF, z >> 32)
    return keys


@dataclasses.dataclass
class PerChainStreams:
    """One counter-based stream per chain (module docstring): ``keys``
    (N, 2) uint32 on the device, ``step`` a (1,) int64 counter on the
    device.  The sampler calls ``advance`` once a step; the kernels read
    the counter from device memory, so no draw waits for the host."""

    keys: torch.Tensor
    step: torch.Tensor

    @classmethod
    def from_seeds(cls, seeds, device) -> "PerChainStreams":
        device = torch.device(device)
        return cls(keys=torch.from_numpy(chain_keys(seeds)).to(device),
                   step=torch.zeros((1,), dtype=torch.int64, device=device))

    @property
    def n_chains(self) -> int:
        return self.keys.shape[0]

    def advance(self) -> None:
        """Count one step, on the device."""
        self.step.add_(1)

    def state(self) -> np.ndarray:
        """uint8 bytes: the step (int64), then the keys (uint32), little
        endian."""
        step = self.step.cpu().numpy().astype("<i8")
        keys = self.keys.cpu().numpy().astype("<u4")
        return np.concatenate([step.view(np.uint8),
                               keys.reshape(-1).view(np.uint8)])

    @classmethod
    def from_state(cls, state, device) -> "PerChainStreams":
        raw = np.asarray(state, np.uint8)
        if raw.size < 8 or (raw.size - 8) % 8:
            raise ValueError(f"a {PER_CHAIN_KIND!r} state is 8 bytes of "
                             "step and 8 a chain, got "
                             f"{raw.size} bytes")
        step = raw[:8].copy().view("<i8").astype(np.int64)
        keys = raw[8:].copy().view("<u4").astype(np.uint32).reshape(-1, 2)
        device = torch.device(device)
        return cls(keys=torch.from_numpy(keys).to(device),
                   step=torch.from_numpy(step).to(device))


    def rows(self, lo: int, hi: int) -> "PerChainStreams":
        """The streams of chains [lo, hi), sharing this step counter."""
        return PerChainStreams(keys=self.keys[lo:hi].contiguous(),
                               step=self.step)


@dataclasses.dataclass(frozen=True)
class RowSlice:
    """An int-seeded farm's stream on one rank of a sharded farm (module
    docstring): ``generator`` is the whole farm's, seeded alike on every
    rank; each draw site draws the batch of ``n_total`` chains from it and
    keeps rows [lo, hi)."""

    generator: torch.Generator
    n_total: int
    lo: int
    hi: int


def draw_rows(draws, lo: int, hi: int):
    """A step's draws (a dataclass of per-chain tensors, None where the
    configuration draws nothing) cut to chains [lo, hi)."""
    return dataclasses.replace(draws, **{
        f.name: getattr(draws, f.name)[lo:hi]
        for f in dataclasses.fields(draws)
        if getattr(draws, f.name) is not None})


def make_generator(seed, device) -> torch.Generator:
    """One explicit generator on ``device`` seeded from an int ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(resolve_seed(seed))
    return gen


def generator_kind(device) -> str:
    """The kind of generator a device's sampler owns."""
    dev = torch.device(device)
    if dev.type not in GENERATOR_KINDS:
        raise ValueError(f"no generator kind for device {dev}")
    return GENERATOR_KINDS[dev.type]


def generator_state(gen):
    """``(kind, state)``: the stream's kind and its full state as a uint8
    numpy array (a generator's ``get_state``, or
    ``PerChainStreams.state``; a ``RowSlice``'s is its generator's)."""
    if isinstance(gen, PerChainStreams):
        return PER_CHAIN_KIND, gen.state()
    if isinstance(gen, RowSlice):
        gen = gen.generator
    return (generator_kind(gen.device),
            gen.get_state().numpy().astype(np.uint8, copy=True))


def restore_generator(kind: str, state, device, want=None):
    """The stream on ``device`` continuing the one ``(kind, state)``
    describes.  ``want`` is the kind the caller owns (default: the
    device's generator kind); a state of another kind raises."""
    want = generator_kind(device) if want is None else want
    if kind != want:
        raise ValueError(f"the generator state is {kind!r}, but the sampler "
                         f"on {torch.device(device)} owns a {want!r} stream: "
                         "a stream cannot move between kinds")
    if kind == PER_CHAIN_KIND:
        return PerChainStreams.from_state(state, device)
    gen = torch.Generator(device=torch.device(device))
    gen.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))
    return gen


def join_stream_states(kind: str, states) -> np.ndarray:
    """One stream state from the states of a sharded farm's ranks, in
    row order: per-chain streams' keys concatenated under their common
    step; a generator's state, which every rank holds alike, once.  States
    that should agree and do not raise."""
    states = [np.asarray(s, np.uint8) for s in states]
    if kind == PER_CHAIN_KIND:
        if any(not np.array_equal(s[:8], states[0][:8]) for s in states):
            raise ValueError("the ranks' per-chain streams are at "
                             "different steps")
        return np.concatenate([states[0][:8]] + [s[8:] for s in states])
    if any(not np.array_equal(s, states[0]) for s in states):
        raise ValueError(f"the ranks' {kind!r} generator states differ: "
                         "an int-seeded farm's ranks hold one stream")
    return states[0]

