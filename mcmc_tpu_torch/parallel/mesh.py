"""Meshes of ranks: the chain farm's ``chains`` axis and the grid's
``grid`` axis over ``torch.distributed`` ranks.

PyTorch counterpart of ``mcmc_tpu/parallel/mesh.py``.  The reference's
only production parallelism is a share-nothing ``multiprocessing.Pool``
chain farm (largeScaleChain_multiprocessing.py:75-79); the JAX package
lays devices out on a ``jax.sharding.Mesh`` with a ``chains`` axis (no
communication while sampling) and an optional ``grid`` axis (row-sharded
domains with a halo exchange, ``grid_sharded.py``).  Here one rank drives
one device, and a ``Mesh`` holds the ranks laid out on those axes, this
rank's device, and, for each axis, the process group of the ranks that
share this rank's other coordinates, over which the axis's collectives
run.  An axis of one rank has no group and no collective, so a one-rank
mesh works with no process group at all, as ``chains_mesh()`` does on
one JAX device.

Where the reference places a global array's shards on devices, a rank
here holds only its own part: ``shard_chains`` keeps this rank's rows of
a chain batch, ``replicate`` puts the shared constants on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks on named axes (module docstring).

    ``ranks``: an int array, one dimension an axis; ``device``: this
    rank's device; ``groups``: axis name -> the process group along it
    through this rank (None for an axis of one rank); ``coords``: this
    rank's index on each axis, None when the mesh leaves it out."""

    ranks: np.ndarray
    axis_names: tuple
    device: torch.device
    groups: dict
    coords: Optional[tuple]

    @property
    def shape(self) -> dict:
        """Axis name -> number of ranks on it."""
        return dict(zip(self.axis_names, self.ranks.shape))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        if self.coords is None:
            raise ValueError("this rank is not in the mesh "
                             f"{self.ranks.tolist()}")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis`` through this rank (None: one
        rank, nothing to exchange)."""
        return self.groups[axis]


def _device(device) -> torch.device:
    """A mesh's device: ``device``, else the one ``initialize_distributed``
    bound, else the card; "cuda" alone names the current card."""
    from ..utils.rng import resolve_device
    from .distributed import bound_device

    dev = resolve_device(bound_device() if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(ranks, axis_names, device=None) -> Mesh:
    """A mesh of ``ranks`` (nested lists, one level an axis) on
    ``axis_names``.  In a process group every rank must call it alike:
    it creates the axes' process groups, which is collective."""
    from .distributed import world

    ranks = np.asarray(ranks, dtype=np.int64)
    axis_names = tuple(axis_names)
    if ranks.ndim != len(axis_names):
        raise ValueError(f"{ranks.ndim}-d ranks for axes {axis_names}")
    me, size = world()
    flat = ranks.ravel().tolist()
    if len(set(flat)) != len(flat) or not all(0 <= r < size for r in flat):
        raise ValueError(f"need {ranks.size} distinct ranks of 0..{size - 1}"
                         f", got {flat}")
    groups = {}
    for ax, name in enumerate(axis_names):
        groups[name] = None
        if ranks.shape[ax] == 1:
            continue
        for line in np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax]):
            # a process group orders its members by rank, so a collective's
            # results come in mesh order only if the ranks rise along it
            if np.any(np.diff(line) <= 0):
                raise ValueError(f"ranks {line.tolist()} along axis {name!r} "
                                 "must rise: a process group orders its "
                                 "members by rank")
            group = (dist.group.WORLD if line.size == size
                     else dist.new_group(line.tolist()))
            if me in line:
                groups[name] = group
    coords = (tuple(int(i) for i in np.argwhere(ranks == me)[0])
              if me in flat else None)
    return Mesh(ranks=ranks, axis_names=axis_names, device=_device(device),
                groups=groups, coords=coords)


def chains_mesh(n_devices: Optional[int] = None, devices=None, *,
                device=None) -> Mesh:
    """1D mesh over a ``chains`` axis: the ranks ``devices`` names (all,
    in rank order, by default), the first ``n_devices`` of them."""
    from .distributed import world

    ranks = list(range(world()[1]) if devices is None else devices)
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return make_mesh(ranks, ("chains",), device)


def chains_grid_mesh(n_chains_axis: int, n_grid_axis: int, devices=None, *,
                     device=None) -> Mesh:
    """2D mesh (chains, grid) for chain-parallel, domain-sharded runs."""
    from .distributed import world

    ranks = list(range(world()[1]) if devices is None else devices)
    need = int(n_chains_axis) * int(n_grid_axis)
    if len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    return make_mesh(np.asarray(ranks[:need]).reshape(n_chains_axis,
                                                      n_grid_axis),
                     ("chains", "grid"), device)


def _tree_map(fn, tree):
    """``fn`` on every tensor and array leaf of dicts, lists, tuples and
    dataclasses; other leaves (numbers, None) as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_chains(tree, mesh: Mesh):
    """This rank's rows of a chain-batched tree on its device: every leaf
    whose leading dimension divides over the ``chains`` axis is cut to
    this rank's contiguous block of it; any other leaf (scalars, keys
    with no batch) is kept whole, as the reference replicates it."""
    n, c = mesh.shape["chains"], mesh.index("chains")

    def put(x):
        x = torch.as_tensor(x).to(mesh.device)
        if x.dim() >= 1 and x.shape[0] > 0 and x.shape[0] % n == 0:
            k = x.shape[0] // n
            x = x[c * k:(c + 1) * k]
        return x

    return _tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    """The tree (the shared problem constants) on this rank's device."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "chains",
                dim: int = 0) -> torch.Tensor:
    """The rows of ``x`` from every rank on ``axis``, concatenated along
    ``dim`` in mesh order: a collective that every rank on the axis
    enters.  Without a group (one rank) ``x`` itself."""
    group = mesh.group(axis)
    if group is None:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out
