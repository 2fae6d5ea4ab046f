"""Frontier-sharded WGL checking: the mask axis of one history's frontier
split over devices.

One history's WGL configuration frontier (packed words over 2^W masks,
ops.linearize) outgrows one device when the pending window W is large.
The reference's answer (``jepsen_tpu/parallel/frontier.py``), kept here:
split the mask axis over D = 2^k devices, so frontier device d holds the
configurations whose top k mask bits equal d, the local masks m of the
WL = W - k low bits (global mask d * 2^WL + m).

  * applies on slots < WL touch only local mask bits: no communication;
  * an apply on top slot b maps the configurations of the devices with
    bit b clear to their partner d | 2^b: the image of the slice, copied
    to the partner's device and ORed in there (``_top_apply``);
  * a completion on top slot b moves the surviving words from the
    bit-set devices to their bit-clear partners (``_top_complete``);
  * emptiness is an OR over the frontier axis of each shard's flag, and
    the closure's convergence an OR of what the exchanges added
    (``_pbool``).

The mesh is driven from this one process: the host walks the events and,
per event, runs rounds of close -> images -> exchange on every shard
until no shard of any row gains a configuration (one host read of the
flags a round; an event whose live slots are all local needs one close),
then the completion. The closure's least fixpoint does not depend on the
order of its steps, so the result is the single-device kernel's (K1) bit
for bit. Each shard's part runs through ``ops.cuda_shard``: on a CUDA
tensor its hand-written kernels (K3, ``csrc/wgl_shard.cu``), on a CPU
tensor their plain versions. The encoder allocates low slots first, so a
history whose live window stays under WL never touches the top bits and
pays one close and one commit a shard an event.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import cuda_shard
from ..ops.cuda_wgl import n_state_words
from ..ops.encode import EV_CLOSE, EV_FUSED, EV_OK
from ..ops.faults import INT32_MAX
from .mesh import Mesh, batch_cells, shard_rows, to_device

# Host rounds of the exchange loop (one flag read each) in this process;
# callers reset it to 0 and read it back.
ROUNDS = 0

# The three entries of one shard's step, as ``ops.cuda_shard`` names
# them; a caller may pass others with the same signatures (``ops=``).
OPS = ("shard_close", "shard_image", "shard_commit")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Shard:
    """One cell of a batch shard's frontier axis: its device, its slice
    of the frontier and latch, its copy of the verdicts, and the
    exchange buffers it sends from (top bits clear in d) and receives
    into (top bits set)."""

    def __init__(self, d, dev, rows, NW, M, ev, target):
        self.d, self.dev = d, dev
        self.ev = [to_device(a, dev) for a in ev]
        self.target = to_device(target, dev)
        self.F = torch.zeros((rows, NW, M), dtype=torch.int32, device=dev)
        if d == 0:
            # The initial configuration (state 0, mask 0) lives on
            # frontier device 0 only.
            self.F[:, 0, 0] = 1
        self.Fbad = torch.zeros_like(self.F)
        self.valid = torch.ones(rows, dtype=torch.bool, device=dev)
        self.bad = torch.full((rows,), int(INT32_MAX), dtype=torch.int32,
                              device=dev)
        self.send: dict = {}
        self.recv: dict = {}
        self.kept = self.changed = None

    def buffer(self, kind: str, b: int) -> torch.Tensor:
        table = self.send if kind == "send" else self.recv
        if b not in table:
            table[b] = torch.empty_like(self.F)
        return table[b]


class _Group:
    """One batch shard: its rows' host-side event plan and D shards."""

    def __init__(self, ev_type, ev_slot, ev_slots, target, devices, V, W,
                 WL):
        NW, M, k = n_state_words(V), 1 << WL, W - WL
        typ = _host(ev_type).astype(np.int64)
        self.rows, self.N = typ.shape
        live = np.isin(typ, (EV_OK, EV_FUSED, EV_CLOSE))
        ok = np.isin(typ, (EV_OK, EV_FUSED))
        slot = np.clip(_host(ev_slot).astype(np.int64), 0, W - 1)
        tgt = _host(target)
        K1 = tgt.shape[-2]
        kinds = _host(ev_slots)[:, :, WL:W].astype(np.int64)
        kinds = np.clip(np.where(kinds < 0, kinds + K1, kinds), 0, K1 - 1)
        reach = (tgt >= 0).any(-1)                  # [K1] or [rows, K1]
        if reach.ndim == 1:
            top_reach = reach[kinds]
        else:
            top_reach = np.take_along_axis(
                reach[:, None, :], kinds.reshape(self.rows, 1, -1), 2
            ).reshape(kinds.shape)
        bits = 1 << np.arange(k, dtype=np.int64)
        # Per event: any live row; the top bits some live row's slot
        # reaches a state through (their exchange rounds); the top bits
        # an OK row completes on (their survivors' move).
        self.live_rows = live.sum(0)
        self.ok_rows = ok.sum(0)
        self.top_live = np.bitwise_or.reduce(
            (top_reach & live[:, :, None]) * bits, axis=(0, 2))
        done = ok & (slot >= WL)
        self.top_done = np.bitwise_or.reduce(
            np.where(done, 1 << np.clip(slot - WL, 0, None), 0), axis=0)
        ev = (ev_type, ev_slot, ev_slots)
        self.shards = [_Shard(d, dev, self.rows, NW, M, ev, target)
                       for d, dev in enumerate(devices)]


def _bits(mask: int) -> List[int]:
    return [b for b in range(int(mask).bit_length()) if (mask >> b) & 1]


def _top_apply(g: _Group, b: int, e: int, ops, geom: dict) -> None:
    """Close one step under the op in top slot ``b``: every shard with bit
    b clear sends the image of its slice to its partner d | 2^b, where it
    lands in the partner's receive buffer (ORed in by its next close)."""
    bit = 1 << b
    for s in g.shards:
        if s.d & bit:
            continue
        img = ops["shard_image"](s.F, *s.ev, s.target, s.valid, e=e, b=b,
                                 d=s.d, send=s.buffer("send", b), **geom)
        g.shards[s.d | bit].buffer("recv", b).copy_(img)


def _top_complete(g: _Group, bits: Sequence[int]) -> List[list]:
    """OK-completion on top slots ``bits``: each bit-clear shard receives
    its bit-set partner's closure (the survivors, with the bit cleared).
    Returns each shard's ``top`` list for its commit."""
    k = len(g.shards).bit_length() - 1
    tops = [[None] * k for _ in g.shards]
    for b in bits:
        bit = 1 << b
        for s in g.shards:
            if not s.d & bit:
                buf = s.buffer("send", b)
                buf.copy_(g.shards[s.d | bit].F)
                tops[s.d][b] = buf
    return tops


def _pbool(flags: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """The OR over the frontier axis of each shard's int32 [rows] flags,
    on each shard's device."""
    acc = flags[0].clone()
    for f in flags[1:]:
        acc |= f.to(acc.device)
    return [acc.to(dev) for dev in devices]


def _walk(V: int, W: int, D: int, groups: List[_Group], ops=None) -> None:
    """Drive every group's shards over the events, in lockstep so that a
    round's flags come back in one host read (counted in ROUNDS)."""
    global ROUNDS
    ops = ops or {n: getattr(cuda_shard, n) for n in OPS}
    k = D.bit_length() - 1
    geom = dict(WL=W - k, W=W, V=V)
    N = groups[0].N if groups else 0
    for e in range(N):
        live = [g for g in groups if g.live_rows[e]]
        for g in live:
            for s in g.shards:
                s.changed, s.kept = ops["shard_close"](
                    s.F, [None] * k, *s.ev, s.target, s.valid, e=e, d=s.d,
                    first_round=True, **geom)
        pending = [g for g in live if g.top_live[e]]
        while pending:
            for g in pending:
                tl = int(g.top_live[e])
                for b in _bits(tl):
                    _top_apply(g, b, e, ops, geom)
                for s in g.shards:
                    recv = [s.recv[b] if (s.d >> b) & 1 and (tl >> b) & 1
                            else None for b in range(k)]
                    if all(r is None for r in recv):
                        s.changed = None    # nothing to merge: unchanged
                        continue
                    s.changed, s.kept = ops["shard_close"](
                        s.F, recv, *s.ev, s.target, s.valid, e=e, d=s.d,
                        first_round=False, **geom)
            out = pending[0].shards[0].dev
            flags = torch.stack([
                torch.stack([s.changed.to(out) for s in g.shards
                             if s.changed is not None]).any()
                for g in pending]).tolist()
            ROUNDS += 1
            pending = [g for g, f in zip(pending, flags) if f]
        for g in live:
            if not g.ok_rows[e]:
                continue            # EV_CLOSE keeps its closure
            nonempty = _pbool([s.kept for s in g.shards],
                              [s.dev for s in g.shards])
            tops = _top_complete(g, _bits(int(g.top_done[e])))
            for s, ne, top in zip(g.shards, nonempty, tops):
                ops["shard_commit"](s.F, s.Fbad, top, *s.ev, s.target,
                                    s.valid, s.bad, ne, e=e, idx=e, d=s.d,
                                    **geom)


def _result(g: _Group, out) -> tuple:
    """A group's (valid, bad, frontier [rows, NW, D * 2^WL]) on ``out``:
    each shard's final frontier, or its latch where the row failed, in
    global mask order."""
    s0 = g.shards[0]
    valid = s0.valid.to(out)
    front = torch.cat([torch.where(s.valid[:, None, None], s.F, s.Fbad)
                       .to(out) for s in g.shards], dim=2)
    return valid, s0.bad.to(out), front


def _local_width(V: int, W: int, D: int) -> int:
    """WL = W - log2 D, after checking V, W and D."""
    if V > cuda_shard.MAX_STATES:
        raise ValueError(f"V={V} exceeds the packed kernel's "
                         f"{cuda_shard.MAX_STATES} states")
    k = D.bit_length() - 1
    if D < 1 or 1 << k != D:
        raise ValueError(f"frontier axis size {D} is not a power of two")
    if W - k < 1:
        raise ValueError(f"W={W} leaves no local slot on {D} devices")
    return W - k


def make_frontier_kernel(V: int, W: int, D: int):
    """The checker of one batch shard with the frontier split over D
    devices: ``check(ev_type [B,N], ev_slot [B,N], ev_slots [B,N,W],
    target, devices, ops=None) -> (valid [B], bad [B],
    frontier [B, words(V), 2^W])``, ``devices`` the D frontier devices
    in axis order (the outputs land on the first). W is the global slot
    count; each device holds 2^(W - log2 D) local masks."""
    WL = _local_width(V, W, D)

    def check(ev_type, ev_slot, ev_slots, target, devices, ops=None):
        devices = list(devices)
        if len(devices) != D:
            raise ValueError(f"{len(devices)} devices for a {D}-way "
                             "frontier axis")
        g = _Group(ev_type, ev_slot, ev_slots, target, devices, V, W, WL)
        _walk(V, W, D, [g], ops)
        return _result(g, devices[0])

    return check


def frontier_sharded_kernel(V: int, W: int, mesh: Mesh,
                            shared_target: bool = False):
    """Batched checker over a ("data", "frontier") mesh (or ("dcn",
    "data", "frontier")): batch rows shard over the batch axes, each
    row's frontier splits over "frontier". Returns check(ev_type [B,N],
    ev_slot [B,N], ev_slots [B,N,W], target, ops=None) ->
    (valid [B], bad [B], frontier [B, words(V), 2^W]) on the mesh's
    first device, the contract of the single-device kernel
    (ops.linearize.get_kernel), so dispatch and counterexample decoding
    are route-agnostic. ``shared_target``: one [K+1, V] table for every
    row instead of a per-row batch. Inputs may be numpy arrays or
    tensors; B must divide by the batch shards."""
    cells = batch_cells(mesh)
    D = cells.shape[1]
    WL = _local_width(V, W, D)
    out = cells[0, 0]

    def check(ev_type, ev_slot, ev_slots, target, ops=None):
        B = ev_type.shape[0]
        rows = shard_rows(B, len(cells), "frontier_sharded_kernel")
        groups = []
        for i, devs in enumerate(cells):
            sl = slice(i * rows, (i + 1) * rows)
            groups.append(_Group(ev_type[sl], ev_slot[sl], ev_slots[sl],
                                 target if shared_target else target[sl],
                                 list(devs), V, W, WL))
        _walk(V, W, D, groups, ops)
        parts = [_result(g, out) for g in groups]
        return tuple(torch.cat([p[j] for p in parts]) for j in range(3))

    return check
