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
mis-checked. ``bucket_encode`` lowers Op lists; ``encode_columnar``
lowers a ColumnarOps batch (history.columnar) with one vectorised walk
over the line axis.

Two host-side shrink passes ride on top of the walk (both off by
default; the scheduler paths turn them on, and the exact ``scheduler=
False`` flow stays the unfused parity oracle):

  * **event fusion** (``fuse_walked``): maximal runs of
    *single-candidate* OK events — snapshots with exactly one occupied
    slot, i.e. sequential, info-free stretches — collapse into one
    EV_FUSED step whose "op kind" is the host-composed state map of the
    whole run. Entering such a run every frontier mask is provably
    empty (the previous event's live==1 completion cleared the only
    settable bit, or the history just started), so the step is a pure
    V→V map and composition is exact. A fused step that empties the
    frontier reports the run's FIRST op index; the entry points
    re-derive the exact first bad op and counterexample of those (rare)
    rows through the host engine.
  * **state renumbering** (encode_columnar ``renumber``): rows whose
    snapshots only ever name a subset of the batch vocabulary re-encode
    against the subset's reachable sub-space
    (statespace.restrict_statespace) when that drops a whole packed
    32-state word, so V shrinks to the live alphabet. (The per-history
    path already enumerates per-history kinds, so it is born
    renumbered.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..history.ops import Op, INVOKE, OK, INFO
from ..models.core import Model
from .statespace import (StateSpace, StateSpaceExplosion, enumerate_statespace,
                         history_kinds, op_kind, restrict_statespace)

# Event type codes (kernel-side contract). EV_CLOSE is the final "flush"
# event: it closes the frontier under the end-of-history pending table
# (crashed/indeterminate ops) so the surviving config set matches the
# host engine's exactly; it never filters. EV_FUSED is device-side
# identical to EV_OK (close + filter on the event's slot); the distinct
# code lets hosts recognize steps whose op is a composed run and whose
# bad index therefore names the run's first member.
EV_PAD = 0
EV_OK = 2
EV_CLOSE = 3
EV_FUSED = 4

# Fused-kind vocabulary budget per encode call: composed state maps
# dedup into at most this many synthetic target rows (int8 slot
# snapshots bound the index range); runs needing more stay unfused.
FUSED_KIND_CAP = 24

# Slot-table entry for an empty slot; remapped to the all-invalid sentinel
# row of the padded transition table at stacking time.
EMPTY = -1


@dataclass
class EncodedHistory:
    """One history lowered to kernel inputs (unpadded lengths)."""

    ev_type: np.ndarray    # [n] int32 — EV_OK/EV_FUSED, final EV_CLOSE
    ev_slot: np.ndarray    # [n] int32 — completing slot per ok event
    ev_slots: np.ndarray   # [n, max_live] int32 — slot-table snapshot
                           #   (op-kind index per slot, EMPTY when free)
    ev_opidx: np.ndarray   # [n] int32 — history index of the source op
    space: StateSpace
    max_live: int          # peak number of concurrently-pending slots
    n_events: int
    fused_rows: Optional[np.ndarray] = None  # [F, V] composed target
                           #   rows; snapshot kind ids n_kinds + j
    orig_events: int = 0   # pre-fusion event count (== n_events unfused)

    @property
    def n_states(self) -> int:
        return self.space.n_states

    @property
    def n_kinds(self) -> int:
        return self.space.n_kinds

    @property
    def n_kinds_eff(self) -> int:
        """Kind rows the stacked target table must hold for this row:
        the vocabulary plus any fused composed rows."""
        return self.n_kinds + (0 if self.fused_rows is None
                               else len(self.fused_rows))


@dataclass
class EncodeFailure:
    reason: str


# ------------------------------------------------------------ event fusion

def _compose_rows(target: np.ndarray, ks: Sequence[int],
                  ext: Optional[np.ndarray] = None) -> np.ndarray:
    """The state map of applying kinds ``ks`` in order: one synthetic
    transition row for a fused run. -1 (inconsistent) propagates — a
    state from which any member dies is dead under the composition.
    ``ext`` is ``target`` with a -1 column appended, when the caller
    already has it: indexing a row by -1 then reads -1, so each member
    is one gather."""
    if ext is None:
        ext = _dead_column(target)
    out = ext[ks[0], :-1]
    for k in ks[1:]:
        out = ext[k, out]
    return out.astype(np.int32)


def _dead_column(target: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [target, np.full((target.shape[0], 1), -1, target.dtype)], axis=1)


def _fusable_runs(cand: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Inclusive event ranges [f, b] that may fuse into one step, for
    every row of ``cand`` [R, E] at once: ``(row, f, b)`` arrays in row
    order, then event order.

    ``cand[r, e]`` marks single-candidate OK events (exactly one
    occupied slot in the snapshot — necessarily the completing one).
    Within a maximal run [a, b] of candidates, every event from a+1 on
    enters with provably-empty masks (event before it completed at
    live==1, clearing the only settable bit); event ``a`` itself
    qualifies only at history start, where the initial frontier is
    (s0, {}). Only segments of >= 2 events save a step."""
    edge = np.diff(np.pad(cand, ((0, 0), (1, 1))).astype(np.int8), axis=1)
    row, a = np.nonzero(edge == 1)
    b = np.nonzero(edge == -1)[1] - 1
    f = np.where(a == 0, a, a + 1)
    keep = b - f + 1 >= 2
    return row[keep], f[keep], b[keep]


def fuse_walked(ev_slot: np.ndarray, ev_slots: np.ndarray,
                ev_opidx: np.ndarray, n_events: np.ndarray,
                target: np.ndarray, *, sentinel: int, fused_start: int,
                cap: int = FUSED_KIND_CAP,
                extra: Tuple[np.ndarray, ...] = (),
                registry: Optional[dict] = None) -> Tuple:
    """Collapse single-candidate runs across a walked batch.

    Arrays are [R, E(, S)] walk outputs (``sentinel`` marks empty slot
    entries; kind ids index ``target`` rows). Each fused segment's
    first event survives as the fused step — snapshot rewritten to the
    composed kind (id ``fused_start + j``) alone in its completing
    slot, op index kept (the run's first member anchors bad-index
    reporting) — and the remaining members are compacted away.

    Returns ``(ev_slot, ev_slots, ev_opidx, n_events, fused_mask,
    fused_rows, extra)`` where ``fused_rows`` is [F, V] composed target
    rows (F <= cap; runs past the budget stay unfused). Inputs are
    never mutated; when anything fused the returned arrays are
    compacted copies, otherwise they alias the (read-only) inputs.
    ``registry`` (an empty dict on first use) carries the composed
    vocabulary across calls: streamed encode groups then assign STABLE
    ids with append-only content, which is what lets merge_batches keep
    one shared target table across groups. Segments take ids in row
    order, then event order, as the reference's row loop does. Pure
    numpy, host-side.
    """
    R, E = ev_slot.shape[:2]
    cnt = np.asarray(n_events) - 1              # OK events; close excluded
    live = (ev_slots != sentinel).sum(axis=2)
    ok_mask = np.arange(E)[None, :] < cnt[:, None]
    cand = ok_mask & (live == 1)
    # Cheap prefilter: a fusable segment needs two adjacent candidates.
    rows = np.flatnonzero((cand[:, :-1] & cand[:, 1:]).any(axis=1))

    if registry is None:
        registry = {}
    fused_rows = registry.setdefault("rows", [])
    by_seq = registry.setdefault("by_seq", {})
    by_map = registry.setdefault("by_map", {})

    def stacked():
        return (np.stack(fused_rows).astype(np.int32) if fused_rows
                else np.zeros((0, target.shape[1]), np.int32))

    if rows.size == 0:
        # Nothing can fuse (the fully-concurrent common case): skip the
        # copies — callers treat the returns as read-only.
        return (ev_slot, ev_slots, ev_opidx, np.asarray(n_events).copy(),
                np.zeros((R, E), bool), stacked(), extra)

    # The completing kind of every event of the candidate rows.
    S = ev_slots.shape[2]
    q_all = np.clip(ev_slot[rows], 0, S - 1).astype(np.intp)
    kinds = np.take_along_axis(ev_slots[rows], q_all[..., None],
                               axis=2)[..., 0].tolist()
    ext = _dead_column(target)
    seg_r, seg_f, seg_b, seg_k = [], [], [], []
    for i, f, b in zip(*(x.tolist() for x in _fusable_runs(cand[rows]))):
        ks = tuple(kinds[i][f:b + 1])
        kid = by_seq.get(ks)
        if kid is None:
            row = _compose_rows(target, ks, ext)
            key = row.tobytes()
            kid = by_map.get(key)
            if kid is None:
                if len(fused_rows) >= cap:
                    continue            # budget spent: stay unfused
                kid = fused_start + len(fused_rows)
                fused_rows.append(row)
                by_map[key] = kid
            by_seq[ks] = kid
        seg_r.append(int(rows[i]))
        seg_f.append(f)
        seg_b.append(b)
        seg_k.append(kid)

    if not seg_r:
        return (ev_slot, ev_slots, ev_opidx, np.asarray(n_events).copy(),
                np.zeros((R, E), bool), stacked(), extra)

    seg_r, seg_f, seg_b = (np.asarray(x) for x in (seg_r, seg_f, seg_b))
    ev_slots = ev_slots.copy()
    q = ev_slot[seg_r, seg_f]
    ev_slots[seg_r, seg_f, :] = sentinel
    ev_slots[seg_r, seg_f, q] = np.asarray(seg_k, ev_slots.dtype)
    fused_mask = np.zeros((R, E), bool)
    fused_mask[seg_r, seg_f] = True
    # Members after each segment's first event drop: +1 where a drop run
    # starts, -1 past its end (segments of a row never overlap).
    run = np.zeros((R, E + 1), np.int32)
    np.add.at(run, (seg_r, seg_f + 1), 1)
    np.add.at(run, (seg_r, seg_b + 1), -1)
    keep = np.cumsum(run, axis=1)[:, :E] == 0

    newpos = np.cumsum(keep, axis=1) - 1
    rr, ee = np.nonzero(keep)
    dst = newpos[rr, ee]

    def compact(a, fill):
        out = np.full_like(a, fill)
        out[rr, dst] = a[rr, ee]
        return out

    n_events2 = keep.sum(axis=1) - (E - np.asarray(n_events))
    return (compact(ev_slot, 0), compact(ev_slots, sentinel),
            compact(ev_opidx, -1), n_events2.astype(n_events.dtype),
            compact(fused_mask, False), stacked(),
            tuple(compact(a, 0) for a in extra))


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
    op vocabulary. ``fuse`` collapses single-candidate runs into
    EV_FUSED steps (see fuse_walked); the default keeps the exact
    one-event-per-completion oracle encoding.
    """
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
    a_type = np.asarray(ev_type, dtype=np.int32)
    a_slot = np.asarray(ev_slot, dtype=np.int32)
    a_slots = np.asarray(ev_slots, dtype=np.int32)[:, :w]
    a_opidx = np.asarray(ev_opidx, dtype=np.int32)
    fused_rows = None
    orig = n
    if fuse and n > 2:
        (s1, ss1, op1, nev1, fmask, frows, (t1,)) = fuse_walked(
            a_slot[None], a_slots[None], a_opidx[None],
            np.array([n], np.int32), space.target,
            sentinel=EMPTY, fused_start=space.n_kinds,
            extra=(a_type[None],))
        if len(frows):
            n = int(nev1[0])
            a_slot, a_slots, a_opidx = s1[0, :n], ss1[0, :n], op1[0, :n]
            a_type = np.where(fmask[0, :n], EV_FUSED, t1[0, :n])
            fused_rows = frows
    return EncodedHistory(
        ev_type=a_type,
        ev_slot=a_slot,
        ev_slots=a_slots,
        ev_opidx=a_opidx,
        space=space,
        max_live=max_live,
        n_events=n,
        fused_rows=fused_rows,
        orig_events=orig,
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
      ev_type  — int8  [B, N]: EV_OK, EV_FUSED, EV_CLOSE or EV_PAD
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
    # Pre-fusion true event counts per row ([B] int32, close included):
    # the numerator of the scheduler's fusion_ratio.
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
               max_states: int = 64, max_slots: int = 16,
               fuse: bool = False):
    """Encode each history (shared state-space cache). Returns
    (list of (position, EncodedHistory), list of (position, reason))."""
    encs: List[Tuple[int, EncodedHistory]] = []
    failures: List[Tuple[int, str]] = []
    space_cache: dict = {}
    for i, h in enumerate(prepared_histories):
        e = encode_history(model, h, max_states=max_states,
                           max_slots=max_slots, space_cache=space_cache,
                           fuse=fuse)
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
    K = max(max(e.n_kinds_eff for _, e in encs), 1)
    N = _round_up(max(max(e.n_events for _, e in encs), 1), 8)
    B = len(encs)
    Bp = pad_batch_to if pad_batch_to else B

    ev_type = np.zeros((Bp, N), np.int8)
    ev_slot = np.zeros((Bp, N), np.int8)
    ev_slots = np.full((Bp, N, W), K,
                       np.int8 if K < 127 else np.int32)  # K = sentinel
    ev_opidx = np.full((Bp, N), -1, np.int32)
    target = np.full((Bp, K + 1, V), -1, np.int32)
    orig = np.zeros(Bp, np.int32)

    for row, (_, e) in enumerate(encs):
        n, w = e.n_events, e.ev_slots.shape[1]
        ev_type[row, :n] = e.ev_type
        ev_slot[row, :n] = e.ev_slot
        snap = e.ev_slots.astype(np.int64)
        ev_slots[row, :n, :w] = np.where(snap == EMPTY, K, snap)
        ev_opidx[row, :n] = e.ev_opidx
        target[row] = e.space.padded_target(V, K)
        if e.fused_rows is not None:
            nk, nv = e.n_kinds, e.fused_rows.shape[1]
            target[row, nk:nk + len(e.fused_rows), :nv] = e.fused_rows
        orig[row] = e.orig_events or e.n_events

    return EncodedBatch(ev_type=ev_type, ev_slot=ev_slot, ev_slots=ev_slots,
                        ev_opidx=ev_opidx, target=target, V=V, W=W,
                        indices=[i for i, _ in encs], failures=failures,
                        spaces=[e.space for _, e in encs], w_live=W,
                        orig_n_events=orig)


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
                  min_v: int = 8, min_w: int = 4,
                  fuse: bool = False) -> List[EncodedBatch]:
    """Encode histories grouped into (V, W) cost-class buckets.

    Kernel cost scales with 2^W * events: one info-heavy history (large
    pending window W) must not inflate the frontier of thousands of
    clean ones, so each bucket pads only to its own class. W buckets are
    exact — every extra pending slot doubles frontier cost. V (which
    only sets the transition width) rounds to multiples of 8. Failures ride
    on the first bucket. ``fuse`` enables event fusion per history
    (encode_history); state renumbering is inherent here — each history
    enumerates only its own kind vocabulary."""
    encs, failures = encode_all(model, prepared_histories,
                                max_states=max_states, max_slots=max_slots,
                                fuse=fuse)
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
                    min_v: int = 8, min_w: int = 4, native: bool = True,
                    fuse: bool = False, renumber: bool = False,
                    fuse_registry: Optional[dict] = None
                    ) -> Tuple[List[EncodedBatch], List[Tuple[int, str]]]:
    """Vectorised twin of ``bucket_encode`` for a ColumnarOps batch: the
    slot walk runs once over the line axis, then rows bucket by exact
    pending window W. Returns (buckets, failures), failures being (row,
    reason) pairs for histories overflowing ``max_slots``: callers route
    those to a host engine via ``columnar_to_ops``.

    ``native=True`` (default) runs the walk in C++ with the rows spread
    over threads (``native.encode_walk``, built at first use; a library
    that cannot be built or loaded raises). ``native=False`` runs the
    numpy lockstep walk (every row advances one line per step), the
    oracle: both give the same arrays bit for bit.

    ``space`` must be enumerated over ``cols.kinds`` (index-aligned).
    The columnar contract (history.columnar) has already applied
    failure removal, value propagation and the identity-drop rule, so
    every line maps 1:1 onto the walk.

    ``fuse`` collapses single-candidate event runs into EV_FUSED steps
    (fuse_walked); ``renumber`` regroups rows by live kind alphabet and
    re-encodes groups whose sub-space drops a packed state word
    (restrict_statespace). Both default off — the exact-W oracle
    encoding; the scheduler paths turn them on. ``fuse_registry`` (a
    caller-held dict) keeps the composed-kind vocabulary stable across
    streamed encode groups so their shared target tables stay
    merge-compatible (schedule.iter_columnar_groups threads one
    through)."""
    from ..history.columnar import C_INVOKE, C_OK
    B, N = cols.type.shape
    S = max_slots
    if not 1 <= S <= 32:
        raise ValueError(f"max_slots={S} outside 1..32 (the slot mask is "
                         "32 bits)")
    K = space.n_kinds
    # ok events + close, rounded up so the per-bucket event axis (also
    # rounded to 8) can never exceed the buffer width
    E = _round_up(N // 2 + 1, 8)
    if native:
        from ..native import encode_walk
        walked = encode_walk(cols.type, cols.process, cols.kind, E, S, K)
        return _bucket_encoded(space, *walked, min_v, min_w, max_slots,
                               fuse=fuse, renumber=renumber,
                               fuse_registry=fuse_registry)
    P = int(cols.process.max(initial=0)) + 1

    table = np.full((B, S), K,
                    np.int8 if K < 127 else np.int32)  # K = empty sentinel
    free = np.full(B, (1 << S) - 1, np.uint32)
    slot_of = np.full((B, P), -1, np.int8)
    live = np.zeros(B, np.int32)
    max_live = np.zeros(B, np.int32)
    cnt = np.zeros(B, np.int32)
    overflow = np.zeros(B, bool)

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
                           n_events, overflow, min_v, min_w, max_slots,
                           fuse=fuse, renumber=renumber,
                           fuse_registry=fuse_registry)


def _alphabet_groups(space, ev_slots, rows, K, min_v, renumber):
    """Group rows for state renumbering: yield (space, row_ids, lut).

    Rows whose snapshots only ever name a kind subset re-encode under
    the subset's reachable sub-space when that drops a whole packed
    32-state word (a shorter transition walk and a smaller shared-memory
    frontier; a shrink within one word changes neither). ``lut`` maps
    full kind ids to the group's ids (None = no renumbering).
    """
    def words(n_states):
        return (_round_up(max(n_states, min_v), 8) + 31) // 32

    full_words = words(space.n_states)
    if not renumber or full_words <= 1 or not len(rows):
        if len(rows):
            yield space, rows, None
        return
    flat = ev_slots[rows].reshape(len(rows), -1)   # values in [0, K]
    present = np.zeros((len(rows), K + 1), bool)
    present[np.arange(len(rows))[:, None], flat] = True
    present = present[:, :K]               # drop the sentinel column
    sig_rows: Dict[bytes, List[int]] = {}
    for i, sig in enumerate(np.packbits(present, axis=1)):
        sig_rows.setdefault(sig.tobytes(), []).append(i)
    default_rows: List[int] = []
    for _, idxs in sorted(sig_rows.items()):
        kind_idx = np.flatnonzero(present[idxs[0]])
        if len(kind_idx) == K:
            default_rows.extend(idxs)
            continue
        sub, lut = restrict_statespace(space, kind_idx)
        if words(sub.n_states) < full_words:
            yield sub, rows[np.asarray(idxs)], lut
        else:
            default_rows.extend(idxs)
    if default_rows:
        yield space, rows[np.asarray(sorted(default_rows))], None


def _bucket_encoded(space, ev_slot, ev_slots, ev_opidx, max_live,
                    n_events, overflow, min_v, min_w, max_slots,
                    fuse=False, renumber=False, fuse_registry=None):
    """Bucket walked rows by exact pending window W, optionally fusing
    single-candidate event runs and renumbering per-alphabet row groups
    first. Buckets come sorted by (V, W), and the overflow failures ride
    on the first."""
    K = space.n_kinds
    rows = np.arange(len(n_events))
    failures = [(int(r), f"more than {max_slots} concurrently-pending ops")
                for r in rows[overflow]]
    keep = ~overflow

    out: List[EncodedBatch] = []
    for gspace, gr, lut in _alphabet_groups(space, ev_slots, rows[keep],
                                            K, min_v, renumber):
        Kg = gspace.n_kinds
        g_slots = ev_slots[gr]
        if lut is not None:
            lut_s = lut.copy()
            lut_s[K] = Kg                  # walk sentinel -> group's
            g_slots = lut_s[g_slots.astype(np.int64)]
        g_slot = ev_slot[gr]
        g_opidx = ev_opidx[gr]
        g_nev = n_events[gr]
        orig_nev = g_nev.astype(np.int32)
        fused_mask = None
        fused_rows = np.zeros((0, gspace.n_states), np.int32)
        cap = max(0, min(FUSED_KIND_CAP, 126 - Kg)) if fuse else 0
        if cap:
            # The registry entry holds a reference to its space: ids of
            # live objects are unique, so pinning gspace for the
            # registry's lifetime rules out id recycling handing one
            # space's composed rows to another after a memo eviction.
            reg = (fuse_registry.setdefault(id(gspace),
                                            {"space": gspace})
                   if fuse_registry is not None else None)
            (g_slot, g_slots, g_opidx, g_nev, fused_mask, fused_rows,
             _) = fuse_walked(g_slot, g_slots, g_opidx, g_nev,
                              gspace.target, sentinel=Kg,
                              fused_start=Kg + 1, cap=cap,
                              registry=reg)
            # Final table layout: [base kinds | cap fused rows |
            # sentinel]. Padding the fused block to the cap keeps one
            # table shape across streamed encode groups; remap walk ids
            # to it.
            g_slots = np.where(g_slots == Kg, Kg + cap,
                               np.where(g_slots > Kg, g_slots - 1,
                                        g_slots))
        Ks = Kg + cap                      # sentinel row index
        V = _round_up(max(gspace.n_states, min_v), 8)
        padded_target = gspace.padded_target(V, Ks)
        if len(fused_rows):
            padded_target[Kg:Kg + len(fused_rows), :gspace.n_states] = \
                fused_rows
        slot_dtype = np.int8 if Ks < 127 else np.int32
        g_slots = g_slots.astype(slot_dtype, copy=False)
        cnt = g_nev - 1
        W_row = np.maximum(max_live[gr], min_w)
        for W in sorted(set(W_row.tolist())):
            sel = np.flatnonzero(W_row == W)
            r = gr[sel]
            Nev = _round_up(int(g_nev[sel].max()), 8)
            ar = np.arange(Nev)
            etype = np.full((len(r), Nev), EV_PAD, np.int8)
            etype[ar[None, :] < cnt[sel, None]] = EV_OK
            if fused_mask is not None:
                etype[fused_mask[sel][:, :Nev]] = EV_FUSED
            etype[np.arange(len(r)), cnt[sel]] = EV_CLOSE
            # Every row shares one transition table: a zero-copy
            # broadcast view, shipped to the device once.
            tgt = np.broadcast_to(padded_target, (len(r), Ks + 1, V))
            out.append(EncodedBatch(
                ev_type=etype, ev_slot=g_slot[sel, :Nev],
                ev_slots=g_slots[sel][:, :Nev, :W],
                ev_opidx=g_opidx[sel, :Nev],
                target=tgt, V=V, W=int(W), indices=r.tolist(),
                failures=[], spaces=[gspace] * len(r), shared_target=True,
                w_live=int(W), orig_n_events=orig_nev[sel]))
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


def widen_batch(batch: EncodedBatch, W: int) -> EncodedBatch:
    """Re-target an encoded batch at a wider W class (W >= batch.W).

    Semantics-preserving by construction: the new slots are empty in
    every snapshot (they point at the all-invalid sentinel row, whose
    packed target rows are all-zero), so closing under them is a no-op,
    no completion ever names them, and no frontier mask can acquire
    their bits — the surviving config set over the original slots is
    bit-identical, just embedded in a 2^W mask axis. Cost is what
    changes: the frontier doubles per extra slot, which is why class
    targeting is a scheduling decision (ops.schedule), not an encoding
    default."""
    assert W >= batch.W, (W, batch.W)
    if W == batch.W:
        return batch
    b, n, w = batch.batch, batch.n_events, batch.ev_slots.shape[2]
    K = batch.target.shape[1] - 1          # sentinel row index
    ev_slots = np.full((b, n, W), K, batch.ev_slots.dtype)
    ev_slots[:, :, :w] = batch.ev_slots
    return EncodedBatch(
        ev_type=batch.ev_type, ev_slot=batch.ev_slot, ev_slots=ev_slots,
        ev_opidx=batch.ev_opidx, target=batch.target, V=batch.V, W=W,
        indices=list(batch.indices), failures=list(batch.failures),
        spaces=batch.spaces, shared_target=batch.shared_target,
        w_live=batch.eff_w_live, orig_n_events=batch.orig_n_events)


def merge_batches(batches: Sequence[EncodedBatch],
                  W: Optional[int] = None) -> EncodedBatch:
    """Stack several encoded batches (one V, any W <= the class W) into
    one class bucket: slot windows widen to the class W (widen_batch's
    no-op padding), event axes pad to the group max, and kind
    vocabularies merge by padding each batch's target table to the
    widest K and re-pointing its empty-slot sentinel entries at the new
    sentinel row. ``shared_target`` survives only when every input
    shares one table, or tables that may be unioned (below); otherwise
    the merged bucket carries per-row targets."""
    batches = [b for b in batches if b.batch]
    assert batches, "merge_batches needs at least one non-empty batch"
    V = batches[0].V
    assert all(b.V == V for b in batches), "one V per class group"
    Wc = W if W is not None else max(b.W for b in batches)
    assert all(b.W <= Wc for b in batches)
    if len(batches) == 1:
        return widen_batch(batches[0], Wc)

    K = max(b.target.shape[1] - 1 for b in batches)
    N = max(b.n_events for b in batches)
    B = sum(b.batch for b in batches)
    shared_union = None
    if all(b.shared_target for b in batches) and \
            all(b.target.shape[1] - 1 == K for b in batches):
        # Bit-identical tables always merge shared. Tables that DIFFER
        # may only be unioned when every batch encodes against the SAME
        # StateSpace: then the base kind rows are identical and the
        # fused block comes from one append-only registry, so a row is
        # either filled with identical content everywhere or still the
        # all -1 undiscovered form — the union (each row's non-sentinel
        # content) is valid for every batch. Across DIFFERENT spaces
        # that test is unsound: a legitimately dead kind row (all -1,
        # e.g. an unreachable read in one renumbered sub-alphabet) is
        # indistinguishable from "undiscovered", and grafting another
        # space's live row into it rewrites that kind's semantics —
        # wrong verdicts. Those fall back to per-row targets.
        sp0 = batches[0].spaces[0] if batches[0].spaces else None
        one_space = sp0 is not None and all(
            b.spaces and all(s is sp0 for s in b.spaces)
            for b in batches)
        shared_union = batches[0].target[0].copy()
        for b in batches[1:]:
            t = b.target[0]
            if np.array_equal(t, shared_union):
                continue
            if not one_space:
                shared_union = None
                break
            a_s = (shared_union == -1).all(axis=1)
            b_s = (t == -1).all(axis=1)
            if not (a_s | b_s | (shared_union == t).all(axis=1)).all():
                shared_union = None
                break
            shared_union = np.where(a_s[:, None], t, shared_union)
    shared = shared_union is not None

    slot_dtype = np.int8 if K < 127 else np.int32
    ev_type = np.zeros((B, N), np.int8)
    ev_slot = np.zeros((B, N), np.int8)
    ev_slots = np.full((B, N, Wc), K, slot_dtype)
    ev_opidx = np.full((B, N), -1, np.int32)
    if shared:
        target = np.broadcast_to(shared_union, (B, K + 1, V))
    else:
        target = np.full((B, K + 1, V), -1, np.int32)

    row = 0
    indices: List[int] = []
    failures: List[Tuple[int, str]] = []
    spaces: List[StateSpace] = []
    orig = np.zeros(B, np.int32)
    any_orig = any(b.orig_n_events is not None for b in batches)
    for b in batches:
        n, w, Kb = b.n_events, b.ev_slots.shape[2], b.target.shape[1] - 1
        sl = slice(row, row + b.batch)
        ev_type[sl, :n] = b.ev_type
        ev_slot[sl, :n] = b.ev_slot
        snap = b.ev_slots.astype(slot_dtype, copy=(Kb != K))
        if Kb != K:                 # re-point the empty-slot sentinel
            snap[snap == Kb] = K
        ev_slots[sl, :n, :w] = snap
        ev_opidx[sl, :n] = b.ev_opidx
        if not shared:
            target[sl, :Kb + 1] = b.target
        indices.extend(b.indices)
        failures.extend(b.failures)
        spaces.extend(b.spaces or [None] * b.batch)
        if any_orig:
            orig[sl] = (b.orig_n_events if b.orig_n_events is not None
                        else (b.ev_type != EV_PAD).sum(axis=1))
        row += b.batch
    return EncodedBatch(ev_type=ev_type, ev_slot=ev_slot, ev_slots=ev_slots,
                        ev_opidx=ev_opidx, target=target, V=V, W=Wc,
                        indices=indices, failures=failures, spaces=spaces,
                        shared_target=shared,
                        w_live=max(b.eff_w_live for b in batches),
                        orig_n_events=orig if any_orig else None)
