"""Joining a multi-GPU run: one process per card, launched by ``torchrun``.

PyTorch counterpart of ``mcmc_tpu/parallel/distributed.py``.  The JAX
package runs one program per host over every device of a pod slice
(``jax.distributed.initialize``); PyTorch's idiom is one process per card,
each a rank of a ``torch.distributed`` process group::

    torchrun --nproc-per-node N -m mcmc_tpu_torch cfg.json

``initialize_distributed`` joins the group (reading torchrun's variables)
and binds the process to its card; ``global_chains_mesh`` /
``global_chains_grid_mesh`` lay every rank out in rank order, so a chain
row's grid ranks are consecutive ranks of one host, as the reference keeps
them inside one host's interconnect.  A farm's chains exchange nothing
while sampling: the ranks meet only to gather traces at the end of each
segment (``parallel/sampler.py``) and to write a checkpoint
(``io/checkpoint.py``: one file per rank and a marker); the row-sharded
grid (``parallel/grid_sharded.py``) makes two collectives a step.

The process group and the card a process binds are process-wide state,
as in ``torch.distributed`` itself: ``bound_device`` reads the device the
last ``initialize_distributed`` bound.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
_BOUND: dict = {}


def world() -> tuple:
    """(this process's rank, the number of ranks): (0, 1) outside a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def bound_device() -> Optional[torch.device]:
    """The device ``initialize_distributed`` bound this process to, or
    None outside a process group."""
    return _BOUND.get("device") if dist.is_initialized() else None


def _card(local_device_ids, process_id) -> torch.device:
    """The card of this rank: ``local_device_ids`` (one id, or a list
    holding one), else ``LOCAL_RANK``, else the rank itself (one host).
    An index with no card behind it raises; it is never wrapped."""
    if local_device_ids is not None:
        ids = ([local_device_ids] if isinstance(local_device_ids, int)
               else list(local_device_ids))
        if len(ids) != 1:
            raise ValueError("one process drives one card: local_device_ids "
                             f"must name one device, got {ids}")
        index, source = int(ids[0]), "local_device_ids"
    elif "LOCAL_RANK" in os.environ:
        index, source = int(os.environ["LOCAL_RANK"]), "LOCAL_RANK"
    else:
        index, source = int(process_id), "the rank"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= index < count:
        raise RuntimeError(
            f"{source} = {index} names card {index}, but this machine has "
            f"{count} CUDA device(s): launch at most one process a card, "
            "or pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", index)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids=None, *,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join (or start) a multi-process run; returns whether it has more
    than one rank.

    With no arguments it reads torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); with none
    of them set it is a no-op returning False, as the reference's is
    without its cluster variables.  ``coordinator_address`` "host:port"
    becomes a ``tcp://`` rendezvous (then ``num_processes`` and
    ``process_id`` are needed, from the arguments or ``WORLD_SIZE`` /
    ``RANK``).  Called again in a joined process, it returns at once.

    Each rank binds one card: ``cuda:LOCAL_RANK``, or the one card that
    ``local_device_ids`` names (several ranks may share a card that way,
    over gloo).  A rank whose card does not exist raises; it is never
    moved onto another card or the CPU.  ``device="cpu"`` binds the CPU
    instead (the tests' ranks).

    ``backend`` is the one argument the reference's call lacks: JAX picks
    its transport itself, a ``torch.distributed`` group is told.  It
    defaults to ``nccl`` for a card and ``gloo`` for the CPU, and is never
    swapped for another when it fails to start.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    elif num_processes is None and not any(v in env
                                           for v in _TORCHRUN_VARS):
        return False  # one process, no cluster variables: nothing to join
    else:
        raise ValueError("a multi-process run needs a rendezvous: pass "
                         "coordinator_address or set MASTER_ADDR and "
                         "MASTER_PORT (torchrun does)")
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    if device is not None and torch.device(device).type == "cpu":
        bound = torch.device("cpu")
    else:
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"a rank binds a card or the CPU, not {device}")
        bound = _card(local_device_ids, process_id)
        torch.cuda.set_device(bound)
    if backend is None:
        backend = "nccl" if bound.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _BOUND["device"] = bound
    return dist.get_world_size() > 1


def _ranks(devices):
    """The ranks a mesh lays out: ``devices`` (ranks, in mesh order), or
    every rank in rank order."""
    return list(range(world()[1])) if devices is None else list(devices)


def global_chains_mesh(devices=None, *, device=None) -> Mesh:
    """A ``chains`` mesh over every rank (or the ranks ``devices`` names)
    in rank order, so consecutive chains sit on one host."""
    return make_mesh(_ranks(devices), ("chains",), device)


def global_chains_grid_mesh(n_grid: int, devices=None, *,
                            device=None) -> Mesh:
    """A (chains, grid) mesh over every rank in rank order: each chain
    row's ``n_grid`` grid ranks are consecutive, so its per-step halo
    exchange stays on one host.  The ranks must divide into rows, and a
    host's ranks (torchrun's ``LOCAL_WORLD_SIZE``) into whole rows."""
    ranks = _ranks(devices)
    n_grid = int(n_grid)
    if n_grid < 1 or len(ranks) % n_grid:
        raise ValueError(f"{len(ranks)} ranks not divisible by grid axis "
                         f"{n_grid}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    if per_host % n_grid:
        raise ValueError(
            f"a host has {per_host} ranks, not divisible by n_grid="
            f"{n_grid}: grid shards would straddle hosts")
    return make_mesh([ranks[i:i + n_grid]
                      for i in range(0, len(ranks), n_grid)],
                     ("chains", "grid"), device)
