"""The device mesh and the data-parallel sharded checker.

The batched checker is data-parallel over histories: the batch axis of
every encoded array is cut over the mesh's batch axes, each shard is
checked on its own device by the single-device kernel (K1, through
``ops.linearize.get_kernel``: the CUDA kernel on a card, the plain
version on the CPU), and the outputs are gathered in row order. A mesh
is a grid of ``torch.device``s driven from this one process; the same
device may fill several cells (``jepsen_torch.provision``), so the one
card of a host runs the same program as a host of several.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A named grid of devices: ``devices`` is an object array of
    ``torch.device``s with one axis per name in ``axis_names``;
    ``shape[name]`` is that axis's size and ``size`` the number of
    cells."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self.size = int(devices.size)


def shard_min_rows() -> int:
    """$JT_SHARD_MIN_ROWS: per-device row floor for the batch-sharded
    (dataN) route, ops.linearize.MIN_ROWS_PER_DEVICE by default (the
    scheduler's knob ``shard_min_rows``). A sharded dispatch whose
    per-device slice drops below it pays more in per-device launches
    than the split saves, so the dataN route falls back to the
    single-device kernel below it (should_shard)."""
    from ..ops.schedule import knob
    return knob("shard_min_rows")


def should_shard(rows: int, mesh: Optional[Mesh]) -> bool:
    """Whether a ``rows``-row batch takes the batch-sharded (dataN) route
    on ``mesh``: False without a mesh, or when the per-device slice
    would drop below ``shard_min_rows()``."""
    if mesh is None:
        return False
    return rows >= mesh.shape["data"] * shard_min_rows()


def _device_list(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    from ..provision import devices as provisioned
    return provisioned()


def checker_mesh(n_data: Optional[int] = None, n_frontier: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "frontier") mesh over ``devices`` (default: the
    provisioned devices, else the CUDA cards). Defaults to every device
    on the data axis."""
    devices = _device_list(devices)
    if n_data is None:
        n_data = len(devices) // n_frontier
    need = n_data * n_frontier
    if n_data < 1 or need > len(devices):
        raise ValueError(f"checker_mesh({n_data=}, {n_frontier=}) needs "
                         f"{max(need, n_frontier)} devices, have "
                         f"{len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_data, n_frontier), ("data", "frontier"))


def multihost_mesh(n_hosts: int, n_data: Optional[int] = None,
                   n_frontier: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ("dcn", "data", "frontier") mesh: the leading axis spans hosts,
    the inner two stay within one. The batch shards over ("dcn",
    "data"); histories are independent, so the only cross-host traffic
    is the final verdict reduction (summarize_verdicts). Here it is a
    grid in one process, which checks the same program's layout."""
    devices = _device_list(devices)
    per_host = len(devices) // n_hosts
    if n_data is None:
        n_data = per_host // n_frontier
    need = n_hosts * n_data * n_frontier
    if n_data < 1 or need > len(devices):
        # Fail at construction, not deep inside a dispatch.
        raise ValueError(
            f"multihost_mesh({n_hosts=}, {n_data=}, {n_frontier=}) "
            f"needs {max(need, n_hosts * n_frontier)} devices, "
            f"have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_hosts, n_data, n_frontier),
                ("dcn", "data", "frontier"))


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the history batch shards over: every axis except
    the frontier (mask) axis — ("data",) on a flat mesh, ("dcn",
    "data") on a multi-host one."""
    return tuple(n for n in mesh.axis_names if n != "frontier")


def batch_cells(mesh: Mesh) -> np.ndarray:
    """The device grid as [batch shards, frontier devices]: row i holds
    the frontier devices of batch shard i, in the batch axes' order."""
    axes = _batch_axes(mesh) + tuple(a for a in ("frontier",)
                                     if a in mesh.axis_names)
    cells = mesh.devices.transpose([mesh.axis_names.index(a) for a in axes])
    return cells.reshape(-1, mesh.shape.get("frontier", 1))


def to_device(x, device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(device).contiguous()


def shard_rows(B: int, n: int, what: str) -> int:
    if B % n:
        raise ValueError(f"{what}: {B} rows do not divide over {n} batch "
                         "shards")
    return B // n


def data_sharded_kernel(V: int, W: int, mesh: Mesh,
                        shared_target: bool = False,
                        w_live: Optional[int] = None):
    """The batched checker with the batch axis sharded over the mesh's
    batch axes. Returns check(ev_type [B,N], ev_slot [B,N],
    ev_slots [B,N,W], target) -> (valid [B], bad [B],
    frontier [B, words(V), 2^W]), the contract of the single-device
    kernel (ops.linearize.get_kernel), gathered on the mesh's first
    device; B must divide by the batch shards. ``target`` is one
    [K+1, V] table for every row when ``shared_target``, else
    [B, K+1, V]. Inputs may be numpy arrays or tensors on any device:
    each shard's rows go to its device, where its launch is queued
    before the next shard's, so devices run side by side."""
    from ..ops.linearize import get_kernel
    kern = get_kernel(V, W, w_live=w_live)
    cells = batch_cells(mesh)
    out_dev = cells[0, 0]

    def check(ev_type, ev_slot, ev_slots, target):
        B = ev_type.shape[0]
        rows = shard_rows(B, len(cells), "data_sharded_kernel")
        outs = []
        for i, row in enumerate(cells):
            dev = row[0]
            sl = slice(i * rows, (i + 1) * rows)
            tgt = target if shared_target else target[sl]
            outs.append(kern(*(to_device(a[sl], dev)
                               for a in (ev_type, ev_slot, ev_slots)),
                             to_device(tgt, dev)))
        return tuple(torch.cat([o[j].to(out_dev) for o in outs])
                     for j in range(3))

    return check


def summarize_verdicts(valid) -> dict:
    """Global verdict reduction: total, invalid count, first invalid
    row (2^31 - 1 when none)."""
    v = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor)
                   else valid, bool)
    rows = np.flatnonzero(~v)
    return {"histories": int(v.shape[0]), "invalid": int(rows.size),
            "first_invalid_row": int(rows[0]) if rows.size
            else 2**31 - 1}
