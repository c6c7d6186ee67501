"""Carry constants and chain state across from the JAX package.

Every function takes numpy arrays (for example ``jax.tree.map(np.asarray,
consts)`` of the JAX package's objects) and read them by attribute name,
so nothing here imports JAX: the same inputs then reach both packages and
their results can be compared value for value.  Like every entry point of
the port, each lands its tensors on the card unless the caller asks for
the CPU (``device="cpu"``); without a card it raises
(``utils/rng.resolve_device``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.chain_crf import ChainState, CRFConsts, CRFStatic
from .models.chain_sgs import SGSConsts, SGSState, SGSStatic
from .models.randfield import RandFieldArrays, RandFieldStatic
from .ops.covariance import CovarianceSpec
from .ops.transforms import NormalScoreLUT
from .utils.rng import resolve_device

_RF_SCALARS = ("scale_min", "scale_max", "nugget_max", "range_min_x",
               "range_max_x", "range_min_y", "range_max_y")


def consts_from_numpy(consts, static: Mapping, device=None):
    """(CRFStatic, CRFConsts) of the port from the JAX package's
    ``CRFConsts`` with numpy leaves and its ``CRFStatic`` fields as plain
    values (``dataclasses.asdict(static)``)."""
    device = resolve_device(device)
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


def state_from_numpy(state, device=None) -> ChainState:
    """The port's batched ``ChainState`` from the JAX package's chain state
    with numpy leaves: batched (leading chain axis, as from ``vmap``) or a
    single chain."""
    device = resolve_device(device)
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


def sgs_consts_from_numpy(consts, static: Mapping, device=None):
    """(SGSStatic, SGSConsts) of the port from the JAX package's
    ``SGSConsts`` with numpy leaves (its nested ``NormalScoreLUT`` too)
    and its ``SGSStatic`` fields as plain values
    (``dataclasses.asdict(static)``, the nested ``CovarianceSpec`` a dict
    too)."""
    device = resolve_device(device)
    fields = dict(static)
    spec = dict(fields.pop("spec"))
    table = spec.get("matern_table")
    fields["spec"] = CovarianceSpec(
        spec["vtype"], s=spec.get("s"),
        matern_table=None if table is None else np.asarray(table))
    fields["mix"] = tuple(tuple(float(v) for v in part)
                          for part in fields["mix"])
    port_static = SGSStatic(**fields)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def scalar(a):
        return float(np.float32(np.asarray(a)))

    nst = consts.nst
    port_consts = SGSConsts(
        stacked=f32(consts.stacked),
        region_cells=torch.as_tensor(np.array(consts.region_cells),
                                     dtype=torch.int64, device=device),
        sample_ij=torch.as_tensor(np.array(consts.sample_ij),
                                  dtype=torch.int64, device=device),
        nst=NormalScoreLUT(
            fwd_lo=scalar(nst.fwd_lo), fwd_scale=scalar(nst.fwd_scale),
            fwd_table=f32(nst.fwd_table), inv_lo=scalar(nst.inv_lo),
            inv_scale=scalar(nst.inv_scale), inv_table=f32(nst.inv_table)),
        cov_stamp=f32(consts.cov_stamp), embed_spec=f32(consts.embed_spec),
        embed_sqrt=f32(consts.embed_sqrt), rot=f32(consts.rot),
        **{k: scalar(getattr(consts, k)) for k in (
            "sill", "nugget", "sigma_mc", "resolution", "dropout_rate",
            "search_radius", "mean_z")},
        **{k: int(np.asarray(getattr(consts, k))) for k in (
            "block_min_x", "block_max_x", "block_min_y", "block_max_y")},
        **{k: f32(getattr(consts, k)) for k in (
            "mix_ag", "mix_bg", "mix_ae", "mix_be", "qcoef")})
    return port_static, port_consts


def sgs_state_from_numpy(state, device=None) -> SGSState:
    """The port's batched ``SGSState`` from the JAX package's SGS state
    with numpy leaves: batched (leading chain axis) or a single chain.
    The JAX key is not read."""
    device = resolve_device(device)
    fields = np.array(state.fields, np.float32)
    single = fields.ndim == 3

    def vec(a, dtype):
        a = np.array(a)
        return torch.as_tensor(a[None] if single else a, dtype=dtype,
                               device=device)

    return SGSState(
        fields=torch.as_tensor(fields[None] if single else fields,
                               device=device).contiguous(),
        loss_mc=vec(state.loss_mc, torch.float32),
        loss_comp=vec(state.loss_comp, torch.float32),
        accepted=vec(state.accepted, torch.int32))
