"""History → event tensor lowering for the device linearizability kernel.

A prepared history (client ops, completion-propagated, failure-free — see
jepsen_torch.checkers.linearizable.prepare_history) lowers to a sequence
of *completion events*. Only ok-completions require device work (the WGL
closure + filter); everything else — pending-slot allocation, the table
of which op kind occupies which slot — is deterministic bookkeeping the
host precomputes:

  * INVOKE: allocate a pending slot (low slots first; LIFO reuse keeps
    indices < peak-live), record the op kind in the slot table.
  * OK: emit one device event: (slot, snapshot of the slot table); the
    op must be linearized by now, and its slot frees afterwards.
  * INFO / crashed (no completion): the slot stays occupied to the end —
    "may linearize at any later point or never" (knossos semantics,
    core.clj:185-205). Exception: ops whose transition is the *total
    identity* (e.g. a timed-out read that observed nothing) constrain no
    configuration and never require completion, so they are dropped
    entirely instead of pinning a slot forever — this keeps the pending
    window W, whose cost is 2^W, proportional to real concurrency.

Slots are a bounded window: the kernel's frontier is [V states, 2^W
subsets], so W and the state bound V are static costs chosen here.
Histories exceeding the bounds are flagged for host fallback rather than
mis-checked.

This is the exact, unfused encoding: one device event per ok completion
plus a final close. ``bucket_encode`` lowers Op lists; ``encode_columnar``
lowers a ColumnarOps batch (history.columnar) with one vectorised walk
over the line axis. Event fusion and state renumbering are not part of
this package yet; asking for either raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..history.ops import Op, INVOKE, OK, INFO
from ..models.core import Model
from .statespace import (StateSpace, StateSpaceExplosion, enumerate_statespace,
                         history_kinds, op_kind)

# Event type codes (kernel-side contract). EV_CLOSE is the final "flush"
# event: it closes the frontier under the end-of-history pending table
# (crashed/indeterminate ops) so the surviving config set matches the
# host engine's exactly; it never filters. EV_FUSED is device-side
# identical to EV_OK (close + filter on the event's slot); encoders that
# fuse single-candidate runs mark those steps with it.
EV_PAD = 0
EV_OK = 2
EV_CLOSE = 3
EV_FUSED = 4

# Slot-table entry for an empty slot; remapped to the all-invalid sentinel
# row of the padded transition table at stacking time.
EMPTY = -1


@dataclass
class EncodedHistory:
    """One history lowered to kernel inputs (unpadded lengths)."""

    ev_type: np.ndarray    # [n] int32 — EV_OK, final EV_CLOSE
    ev_slot: np.ndarray    # [n] int32 — completing slot per ok event
    ev_slots: np.ndarray   # [n, max_live] int32 — slot-table snapshot
                           #   (op-kind index per slot, EMPTY when free)
    ev_opidx: np.ndarray   # [n] int32 — history index of the source op
    space: StateSpace
    max_live: int          # peak number of concurrently-pending slots
    n_events: int

    @property
    def n_states(self) -> int:
        return self.space.n_states

    @property
    def n_kinds(self) -> int:
        return self.space.n_kinds


@dataclass
class EncodeFailure:
    reason: str


def completion_types(prepared: Sequence[Op]) -> Dict[int, str]:
    """Map invocation position -> its completion's type (missing when the
    op never completes). One walk, shared by the encoder, the replay
    helper, and the host engine's drop rule."""
    out: Dict[int, str] = {}
    open_inv: Dict[object, int] = {}
    for pos, o in enumerate(prepared):
        if o.type == INVOKE:
            open_inv[o.process] = pos
        elif o.is_completion and o.process in open_inv:
            out[open_inv.pop(o.process)] = o.type
    return out


def dropped_invocations(space: StateSpace, prepared: Sequence[Op],
                        completion: Optional[Dict[int, str]] = None) -> set:
    """Positions of invocations that never complete ok and whose
    transition is the total identity over the reachable space (e.g. a
    timed-out read that observed nothing). They constrain no
    configuration — firing one changes no state, and no completion ever
    filters on it — so every engine drops them: the device encoder to
    keep the pending window W (cost 2^W) proportional to real
    concurrency, the host engine to keep config sets identical across
    engines."""
    identity = space.identity_kinds
    if not identity:
        return set()
    if completion is None:
        completion = completion_types(prepared)
    return {pos for pos, o in enumerate(prepared)
            if o.type == INVOKE
            and space.kind_index.get(op_kind(o)) in identity
            and completion.get(pos) != OK}


def encode_history(model: Model, prepared: List[Op], *,
                   max_states: int = 64,
                   max_slots: int = 16,
                   space_cache: Optional[dict] = None,
                   fuse: bool = False):
    """Lower one prepared history. Returns EncodedHistory or EncodeFailure.

    ``prepared`` must already be completion-propagated and failure-free;
    op indices must be assigned (history.core.index). ``space_cache``
    memoizes the state-space BFS across a batch of histories sharing an
    op vocabulary. ``fuse=True`` (event fusion) is not ported yet and
    raises NotImplementedError rather than encoding unfused.
    """
    if fuse:
        raise NotImplementedError(
            "event fusion is not part of jepsen_torch yet; encode with "
            "fuse=False")
    kinds = history_kinds(prepared)
    key = (model, tuple(kinds))
    space = space_cache.get(key) if space_cache is not None else None
    if space is None:
        try:
            space = enumerate_statespace(model, kinds, max_states)
        except StateSpaceExplosion as e:
            return EncodeFailure(str(e))
        if space_cache is not None:
            space_cache[key] = space
    dropped = dropped_invocations(space, prepared)

    ev_type: List[int] = []
    ev_slot: List[int] = []
    ev_slots: List[List[int]] = []
    ev_opidx: List[int] = []

    table = [EMPTY] * max_slots
    free = (1 << max_slots) - 1   # bitmask; lowest-free-first allocation
    slot_of: Dict[object, int] = {}
    live = 0
    max_live = 0

    for pos, o in enumerate(prepared):
        if o.type == INVOKE:
            if pos in dropped:
                continue
            if not free:
                return EncodeFailure(
                    f"more than {max_slots} concurrently-pending ops")
            slot = (free & -free).bit_length() - 1
            free &= free - 1
            slot_of[o.process] = slot
            table[slot] = space.kind_index[op_kind(o)]
            live += 1
            max_live = max(max_live, live)
        elif o.type == OK:
            slot = slot_of.pop(o.process, None)
            if slot is None:
                continue  # completion with no open invocation
            ev_type.append(EV_OK)
            ev_slot.append(slot)
            ev_slots.append(table.copy())   # snapshot WITH the op pending
            ev_opidx.append(o.index if o.index is not None else pos)
            table[slot] = EMPTY
            free |= 1 << slot
            live -= 1
        elif o.type == INFO:
            # Indeterminate: stays pending to the end; slot stays pinned.
            slot_of.pop(o.process, None)

    # Final flush: close the frontier under the end-of-history pending
    # table (pinned info/crashed ops) so the surviving config set matches
    # the host engine's final closure exactly.
    ev_type.append(EV_CLOSE)
    ev_slot.append(0)
    ev_slots.append(table.copy())
    ev_opidx.append(-1)

    n = len(ev_slot)
    w = max(max_live, 1)
    return EncodedHistory(
        ev_type=np.asarray(ev_type, dtype=np.int32),
        ev_slot=np.asarray(ev_slot, dtype=np.int32),
        ev_slots=np.asarray(ev_slots, dtype=np.int32)[:, :w],
        ev_opidx=np.asarray(ev_opidx, dtype=np.int32),
        space=space,
        max_live=max_live,
        n_events=n,
    )


def slot_ops_at_event(space: StateSpace, prepared: List[Op],
                      event_index: Optional[int] = None, *,
                      max_slots: int = 32,
                      predropped: bool = False,
                      op_index: Optional[int] = None) -> Dict[int, int]:
    """Replay the encode walk to recover ``{slot: op history-index}`` —
    the pending table as of encoded event ``event_index`` (the snapshot
    the device saw, including the completing op), or the final pending
    table when ``event_index`` is None. Host-side, O(n); used only to
    decode frontier masks into config samples for result reporting.

    ``max_slots`` defaults to 32, the frontier mask width — allocation
    picks the lowest free slot, so a larger pool assigns the same slots
    as any smaller pool the history actually fit in. ``predropped``
    marks streams whose identity-droppable invocations were already
    removed, sparing the per-op state-space recompute. ``op_index``
    locates the event by the completing op's history index instead of
    its ordinal.
    """
    dropped = (set() if predropped
               else dropped_invocations(space, prepared))

    table_op: Dict[int, int] = {}
    free = (1 << max_slots) - 1
    slot_of: Dict[object, int] = {}
    e = 0
    for pos, o in enumerate(prepared):
        if o.type == INVOKE:
            if pos in dropped or not free:
                continue
            slot = (free & -free).bit_length() - 1
            free &= free - 1
            slot_of[o.process] = slot
            table_op[slot] = o.index if o.index is not None else pos
        elif o.type == OK:
            slot = slot_of.pop(o.process, None)
            if slot is None:
                continue
            # op_index is the COMPLETION op's history index (what the
            # encoder records in ev_opidx / callers report as the bad
            # op), so match the OK line itself, not the invoke index
            # the table holds.
            if (event_index is not None and e == event_index) or \
                    (op_index is not None
                     and (o.index if o.index is not None else pos)
                     == op_index):
                return dict(table_op)
            del table_op[slot]
            free |= 1 << slot
            e += 1
        elif o.type == INFO:
            slot_of.pop(o.process, None)
    return dict(table_op)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class EncodedBatch:
    """A batch of encoded histories padded to shared static bounds.

    Array shapes (B = batch, N = padded events, V = padded states,
    K = padded op kinds, W = slot-window width):
      ev_type  — int8  [B, N]: EV_OK, EV_CLOSE or EV_PAD
      ev_slot  — int8  [B, N]
      ev_slots — int8 (int32 when K >= 127) [B, N, W]: slot tables;
                 empty slots point at the all-invalid sentinel row K of
                 ``target``
      ev_opidx — int32 [B, N] (host-side only, never shipped to device)
      target   — int32 [B, K + 1, V]; final row = all-invalid sentinel
    Event arrays are deliberately narrow (host→device bytes are a real
    cost); the kernel widens as it reads. ``shared_target`` marks every
    row sharing one transition table (one [K+1, V] transfer instead of
    B). ``indices`` maps batch rows back to positions in the caller's
    history list; ``spaces`` holds each row's StateSpace (for result
    decoding); ``failures`` lists (position, reason) needing host
    fallback.
    """

    ev_type: np.ndarray
    ev_slot: np.ndarray
    ev_slots: np.ndarray
    ev_opidx: np.ndarray
    target: np.ndarray
    V: int
    W: int
    indices: List[int]
    failures: List[Tuple[int, str]]
    spaces: List[StateSpace] = None
    shared_target: bool = False
    # Max exact pending window over the rows: the kernel's closure and
    # completion only touch this many slots even when the mask axis is
    # wider (0 = W).
    w_live: int = 0
    # True event counts per row ([B] int32, close included); set by the
    # columnar encoder, None from bucket_encode.
    orig_n_events: Optional[np.ndarray] = None

    @property
    def batch(self) -> int:
        return int(self.ev_type.shape[0])

    @property
    def n_events(self) -> int:
        return int(self.ev_type.shape[1])

    @property
    def eff_w_live(self) -> int:
        return self.w_live or self.W


def encode_all(model: Model, prepared_histories: Sequence[List[Op]], *,
               max_states: int = 64, max_slots: int = 16):
    """Encode each history (shared state-space cache). Returns
    (list of (position, EncodedHistory), list of (position, reason))."""
    encs: List[Tuple[int, EncodedHistory]] = []
    failures: List[Tuple[int, str]] = []
    space_cache: dict = {}
    for i, h in enumerate(prepared_histories):
        e = encode_history(model, h, max_states=max_states,
                           max_slots=max_slots, space_cache=space_cache)
        if isinstance(e, EncodeFailure):
            failures.append((i, e.reason))
        else:
            encs.append((i, e))
    return encs, failures


def stack_encoded(encs: Sequence[Tuple[int, EncodedHistory]],
                  failures: Sequence[Tuple[int, str]] = (), *,
                  min_v: int = 8, min_w: int = 4,
                  pad_batch_to: Optional[int] = None) -> EncodedBatch:
    """Stack encoded histories into one padded batch; bounds are the
    maxima over the group, V and N rounded up to multiples of 8."""
    failures = list(failures)
    if not encs:
        z8 = np.zeros((0, 0), np.int8)
        return EncodedBatch(z8, z8, np.zeros((0, 0, min_w), np.int8),
                            np.zeros((0, 0), np.int32),
                            target=np.zeros((0, 1, min_v), np.int32),
                            V=min_v, W=min_w, indices=[], failures=failures,
                            spaces=[])

    V = _round_up(max(max(e.n_states for _, e in encs), min_v), 8)
    W = max(max(max(e.max_live for _, e in encs), min_w), 1)
    K = max(max(e.n_kinds for _, e in encs), 1)
    N = _round_up(max(max(e.n_events for _, e in encs), 1), 8)
    B = len(encs)
    Bp = pad_batch_to if pad_batch_to else B

    ev_type = np.zeros((Bp, N), np.int8)
    ev_slot = np.zeros((Bp, N), np.int8)
    ev_slots = np.full((Bp, N, W), K,
                       np.int8 if K < 127 else np.int32)  # K = sentinel
    ev_opidx = np.full((Bp, N), -1, np.int32)
    target = np.full((Bp, K + 1, V), -1, np.int32)

    for row, (_, e) in enumerate(encs):
        n, w = e.n_events, e.ev_slots.shape[1]
        ev_type[row, :n] = e.ev_type
        ev_slot[row, :n] = e.ev_slot
        snap = e.ev_slots.astype(np.int64)
        ev_slots[row, :n, :w] = np.where(snap == EMPTY, K, snap)
        ev_opidx[row, :n] = e.ev_opidx
        target[row] = e.space.padded_target(V, K)

    return EncodedBatch(ev_type=ev_type, ev_slot=ev_slot, ev_slots=ev_slots,
                        ev_opidx=ev_opidx, target=target, V=V, W=W,
                        indices=[i for i, _ in encs], failures=failures,
                        spaces=[e.space for _, e in encs], w_live=W)


def batch_encode(model: Model, prepared_histories: Sequence[List[Op]], *,
                 max_states: int = 64, max_slots: int = 16,
                 min_v: int = 8, min_w: int = 4,
                 pad_batch_to: Optional[int] = None) -> EncodedBatch:
    """Encode many prepared histories into one padded batch (single cost
    class; use ``bucket_encode`` for heterogeneous histories)."""
    encs, failures = encode_all(model, prepared_histories,
                                max_states=max_states, max_slots=max_slots)
    return stack_encoded(encs, failures, min_v=min_v, min_w=min_w,
                         pad_batch_to=pad_batch_to)


def bucket_encode(model: Model, prepared_histories: Sequence[List[Op]], *,
                  max_states: int = 64, max_slots: int = 16,
                  min_v: int = 8, min_w: int = 4) -> List[EncodedBatch]:
    """Encode histories grouped into (V, W) cost-class buckets.

    Kernel cost scales with 2^W * events: one info-heavy history (large
    pending window W) must not inflate the frontier of thousands of
    clean ones, so each bucket pads only to its own class. W buckets are
    exact — every extra pending slot doubles frontier cost. V (which
    only sets the transition width) rounds to multiples of 8. Failures
    ride on the first bucket."""
    encs, failures = encode_all(model, prepared_histories,
                                max_states=max_states, max_slots=max_slots)
    groups: Dict[Tuple[int, int], List[Tuple[int, EncodedHistory]]] = {}
    for i, e in encs:
        key = (_round_up(max(e.n_states, min_v), 8),
               max(e.max_live, min_w))
        groups.setdefault(key, []).append((i, e))
    out = []
    for j, (key, group) in enumerate(sorted(groups.items())):
        out.append(stack_encoded(group, failures if j == 0 else (),
                                 min_v=key[0], min_w=key[1]))
    if not out and failures:
        out.append(stack_encoded([], failures, min_v=min_v, min_w=min_w))
    return out


def encode_columnar(space: StateSpace, cols, *, max_slots: int = 16,
                    min_v: int = 8, min_w: int = 4, fuse: bool = False,
                    renumber: bool = False
                    ) -> Tuple[List[EncodedBatch], List[Tuple[int, str]]]:
    """Vectorised twin of ``bucket_encode`` for a ColumnarOps batch: the
    slot walk runs once over the line axis in numpy lockstep (every row
    advances one line per step), then rows bucket by exact pending
    window W. Returns (buckets, failures), failures being (row, reason)
    pairs for histories overflowing ``max_slots``: callers route those
    to a host engine via ``columnar_to_ops``.

    ``space`` must be enumerated over ``cols.kinds`` (index-aligned).
    The columnar contract (history.columnar) has already applied
    failure removal, value propagation and the identity-drop rule, so
    every line maps 1:1 onto the walk. ``fuse`` and ``renumber`` (event
    fusion, per-alphabet state renumbering) are not ported yet and
    raise."""
    from ..history.columnar import C_INVOKE, C_OK
    if fuse or renumber:
        raise NotImplementedError(
            "event fusion and state renumbering are not part of "
            "jepsen_torch yet; encode with fuse=False, renumber=False")
    B, N = cols.type.shape
    S = max_slots
    if not 1 <= S <= 32:
        raise ValueError(f"max_slots={S} outside 1..32 (the slot mask is "
                         "32 bits)")
    K = space.n_kinds
    P = int(cols.process.max(initial=0)) + 1

    table = np.full((B, S), K,
                    np.int8 if K < 127 else np.int32)  # K = empty sentinel
    free = np.full(B, (1 << S) - 1, np.uint32)
    slot_of = np.full((B, P), -1, np.int8)
    live = np.zeros(B, np.int32)
    max_live = np.zeros(B, np.int32)
    cnt = np.zeros(B, np.int32)
    overflow = np.zeros(B, bool)

    # ok events + close, rounded up so the per-bucket event axis (also
    # rounded to 8) can never exceed the buffer width
    E = _round_up(N // 2 + 1, 8)
    slot_dtype = np.int8 if K < 127 else np.int32
    ev_slot = np.zeros((B, E), np.int8)
    ev_slots = np.full((B, E, S), K, slot_dtype)
    ev_opidx = np.full((B, E), -1, np.int32)

    rows = np.arange(B)
    for j in range(N):
        t = cols.type[:, j]
        sel = (t == C_INVOKE) & ~overflow
        if sel.any():
            i = rows[sel]
            fm = free[i]
            of = fm == 0
            overflow[i[of]] = True
            i, fm = i[~of], fm[~of]
            bit = fm & (~fm + np.uint32(1))      # lowest free slot
            slot = np.log2(bit).astype(np.int8)
            free[i] = fm & ~bit
            p = cols.process[i, j]
            slot_of[i, p] = slot
            table[i, slot] = cols.kind[i, j]
            live[i] += 1
            max_live[i] = np.maximum(max_live[i], live[i])
        sel = (t == C_OK) & ~overflow
        if sel.any():
            i = rows[sel]
            p = cols.process[i, j]
            slot = slot_of[i, p]
            ok = slot >= 0
            i, p, slot = i[ok], p[ok], slot[ok]
            c = cnt[i]
            ev_slot[i, c] = slot
            ev_slots[i, c, :] = table[i, :]
            ev_opidx[i, c] = j
            table[i, slot] = K
            free[i] |= np.uint32(1) << slot.astype(np.uint32)
            slot_of[i, p] = -1
            cnt[i] += 1
            live[i] -= 1
        # C_INFO lines change nothing the walk tracks: the pending slot
        # stays pinned (allocated at invoke) and the process is free to
        # invoke again, which overwrites slot_of.

    # Trailing close/flush event per row.
    ev_slots[rows, cnt, :] = table
    n_events = cnt + 1
    return _bucket_encoded(space, ev_slot, ev_slots, ev_opidx, max_live,
                           n_events, overflow, min_v, min_w, max_slots)


def _bucket_encoded(space, ev_slot, ev_slots, ev_opidx, max_live,
                    n_events, overflow, min_v, min_w, max_slots):
    """Bucket walked rows by exact pending window W; every bucket shares
    the one transition table. Buckets come sorted by (V, W), and the
    overflow failures ride on the first."""
    rows = np.arange(len(n_events))
    failures = [(int(r), f"more than {max_slots} concurrently-pending ops")
                for r in rows[overflow]]
    gr = rows[~overflow]
    out: List[EncodedBatch] = []
    if len(gr):
        K = space.n_kinds
        V = _round_up(max(space.n_states, min_v), 8)
        padded_target = space.padded_target(V, K)
        g_slots = ev_slots[gr].astype(np.int8 if K < 127 else np.int32,
                                      copy=False)
        g_slot, g_opidx, g_nev = ev_slot[gr], ev_opidx[gr], n_events[gr]
        cnt = g_nev - 1
        W_row = np.maximum(max_live[gr], min_w)
        for W in sorted(set(W_row.tolist())):
            sel = np.flatnonzero(W_row == W)
            r = gr[sel]
            Nev = _round_up(int(g_nev[sel].max()), 8)
            ar = np.arange(Nev)
            etype = np.full((len(r), Nev), EV_PAD, np.int8)
            etype[ar[None, :] < cnt[sel, None]] = EV_OK
            etype[np.arange(len(r)), cnt[sel]] = EV_CLOSE
            # Every row shares one transition table: a zero-copy
            # broadcast view, shipped to the device once.
            tgt = np.broadcast_to(padded_target, (len(r), K + 1, V))
            out.append(EncodedBatch(
                ev_type=etype, ev_slot=g_slot[sel, :Nev],
                ev_slots=g_slots[sel][:, :Nev, :W],
                ev_opidx=g_opidx[sel, :Nev],
                target=tgt, V=V, W=int(W), indices=r.tolist(),
                failures=[], spaces=[space] * len(r), shared_target=True,
                w_live=int(W), orig_n_events=g_nev[sel].astype(np.int32)))
    out.sort(key=lambda b: (b.V, b.W))
    if out:
        out[0].failures = failures
    return out, failures


def take_rows(batch: EncodedBatch, rows: Sequence[int]) -> EncodedBatch:
    """Row-subset of a batch at arbitrary positions, keeping the
    survivors' encoding and their caller-level indices."""
    rows = list(rows)
    if len(rows) == batch.batch:
        return batch
    r = np.asarray(rows, np.int64)
    return EncodedBatch(
        ev_type=batch.ev_type[r], ev_slot=batch.ev_slot[r],
        ev_slots=batch.ev_slots[r], ev_opidx=batch.ev_opidx[r],
        target=batch.target if batch.shared_target else batch.target[r],
        V=batch.V, W=batch.W,
        indices=[batch.indices[i] for i in rows],
        failures=list(batch.failures),
        spaces=([batch.spaces[i] for i in rows] if batch.spaces
                else batch.spaces),
        shared_target=batch.shared_target, w_live=batch.w_live,
        orig_n_events=(batch.orig_n_events[r]
                       if batch.orig_n_events is not None else None))
