"""Carry constants and chain state across from the JAX package.

Both functions take numpy arrays (for example ``jax.tree.map(np.asarray,
consts)`` of the JAX package's objects) and read them by attribute name,
so nothing here imports JAX: the same inputs then reach both packages and
their results can be compared value for value.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.chain_crf import ChainState, CRFConsts, CRFStatic
from .models.randfield import RandFieldArrays, RandFieldStatic

_RF_SCALARS = ("scale_min", "scale_max", "nugget_max", "range_min_x",
               "range_max_x", "range_min_y", "range_max_y")


def consts_from_numpy(consts, static: Mapping, device="cpu"):
    """(CRFStatic, CRFConsts) of the port from the JAX package's
    ``CRFConsts`` with numpy leaves and its ``CRFStatic`` fields as plain
    values (``dataclasses.asdict(static)``)."""
    device = torch.device(device)
    fields = dict(static)
    rf_fields = dict(fields.pop("rf"))
    port_static = CRFStatic(rf=RandFieldStatic(**rf_fields), **fields)
    rf = consts.rf
    port_consts = CRFConsts(
        stacked=torch.as_tensor(np.array(consts.stacked, np.float32),
                                device=device),
        region_cells=torch.as_tensor(np.array(consts.region_cells),
                                     dtype=torch.int64, device=device),
        sample_ij=torch.as_tensor(np.array(consts.sample_ij),
                                  dtype=torch.int64, device=device),
        sigma_mc=float(consts.sigma_mc),
        sigma_data=float(consts.sigma_data),
        resolution=float(consts.resolution),
        rf=RandFieldArrays(
            pairs=torch.as_tensor(np.array(rf.pairs), dtype=torch.int64,
                                  device=device),
            edge_masks=torch.as_tensor(np.array(rf.edge_masks, np.float32),
                                       device=device),
            **{k: float(getattr(rf, k)) for k in _RF_SCALARS}))
    return port_static, port_consts


def state_from_numpy(state, device="cpu") -> ChainState:
    """The port's batched ``ChainState`` from the JAX package's chain state
    with numpy leaves: batched (leading chain axis, as from ``vmap``) or a
    single chain."""
    device = torch.device(device)
    fields = np.array(state.fields, np.float32)
    single = fields.ndim == 3

    def vec(a, dtype):
        a = np.array(a)
        return torch.as_tensor(a[None] if single else a, dtype=dtype,
                               device=device)

    return ChainState(
        fields=torch.as_tensor(fields[None] if single else fields,
                               device=device).contiguous(),
        loss_mc=vec(state.loss_mc, torch.float32),
        loss_comp=vec(state.loss_comp, torch.float32),
        loss_data=vec(state.loss_data, torch.float32),
        loss_data_comp=vec(state.loss_data_comp, torch.float32),
        accepted=vec(state.accepted, torch.int32))
