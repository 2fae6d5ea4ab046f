"""Columnar histories: a batch of prepared histories as padded arrays.

At batch scale (10,000 histories of 1,000 ops) per-op Python objects
dominate the wall clock. A ``ColumnarOps`` holds a *batch* as padded 2-D
arrays, one row per history, and the host pipeline (synthesis, encode,
device tensors) runs as vectorised array code over the batch axis.

Contract: a ColumnarOps is already *prepared* in the sense of
checkers.linearizable.prepare_history —

  * failed ops never happened: both their lines are PAD;
  * observed values are propagated: each invocation line carries the
    final op-kind index (e.g. ("read", observed-value)) in ``kind``;
  * never-ok total-identity ops (timed-out unconstrained reads) are
    dropped: PAD (the rule shared by every engine,
    ops.encode.dropped_invocations).

Producers: the device generators (ops.synth_device), the legacy host
stream (workloads.synth.synth_cas_columnar) and ``ops_to_columnar``;
``columnar_to_ops`` converts a row back to an Op
list (for tests and for routing single rows to the host engine). The
same code as the reference package's, so one batch converts to the same
arrays in both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ops import Op, invoke_op, ok_op, info_op

# Line type codes.
PAD = -1
C_INVOKE = 0
C_OK = 1
C_INFO = 2


@dataclass
class ColumnarOps:
    """A prepared batch of histories as padded columnar arrays.

    type    — int8  [B, N]: C_INVOKE / C_OK / C_INFO / PAD
    process — int16 [B, N]: logical process per line (< n_procs)
    kind    — int32 [B, N]: op-kind index into ``kinds`` (invoke lines;
              -1 elsewhere)
    kinds   — the shared op-kind vocabulary, index-aligned with the
              transition table callers build via
              ops.statespace.enumerate_statespace(model, kinds, ...)
    index   — optional int32 [B, N]: each line's index in the history it
              was converted from (-1 on PAD); present on converted
              batches (``ops_to_columnar``) so verdict line positions
              map back to original op indices
    key     — optional int32 [B, N]: independent-key id per line; -1
              marks unkeyed lines. Present only on keyed batches
              (``n_keys > 1``), which this package does not check yet.
    meta    — optional generator-side metadata (ops.synth_device.
              SynthMeta): per-history (and per-key) peak pending windows.
              Purely advisory; every consumer behaves identically with
              meta=None.
    """

    type: np.ndarray
    process: np.ndarray
    kind: np.ndarray
    kinds: List[Tuple]
    index: Optional[np.ndarray] = None
    key: Optional[np.ndarray] = None
    meta: Optional[object] = None

    @property
    def batch(self) -> int:
        return int(self.type.shape[0])

    @property
    def n_lines(self) -> int:
        return int(self.type.shape[1])

    def op_index(self, row: int, line: int) -> int:
        """Original-history op index for a line (the line itself when the
        batch was synthesized rather than converted)."""
        if self.index is None:
            return int(line)
        return int(self.index[row, line])


def _kind_value(kind: Tuple):
    f, cv = kind
    return list(cv) if isinstance(cv, tuple) else cv


def _walk_py(histories: Sequence[Sequence[Op]], vocab: dict,
             all_kinds: List[Tuple]):
    """The ingest walk: pairing, failure retraction and value
    propagation over recorded histories, emitting flat line buffers."""
    from ..ops.statespace import canonical_value

    code: List[int] = []
    proc: List[int] = []
    kind: List[int] = []
    oidx: List[int] = []
    okflag: List[int] = []
    link: List[int] = []
    rowlen: List[int] = []
    for h in histories:
        rowstart = len(code)
        open_line: dict = {}     # process -> flat invoke-line index
        open_fv: dict = {}       # process -> (f, value)
        dense: dict = {}         # process -> per-row dense id
        for pos, op in enumerate(h):
            p = op.process
            if not isinstance(p, int):
                continue
            t = op.type
            if t == "invoke":
                open_line[p] = len(code)
                open_fv[p] = (op.f, op.value)
                code.append(C_INVOKE)
                proc.append(dense.setdefault(p, len(dense)))
                kind.append(-1)
                oidx.append(op.index if op.index is not None else pos)
                okflag.append(0)
                link.append(-1)
            elif t == "ok" or t == "info":
                j = open_line.pop(p, None)
                if j is None:
                    continue
                f, v = open_fv.pop(p)
                if v is None and t == "ok":
                    # Only ok completions propagate observations
                    # (history.core.complete semantics): an info op's
                    # value is not an observation.
                    v = op.value
                k = (f, canonical_value(v))
                ki = vocab.get(k)
                if ki is None:
                    ki = vocab[k] = len(all_kinds)
                    all_kinds.append(k)
                kind[j] = ki
                if t == "ok":
                    okflag[j] = 1
                    code.append(C_OK)
                    link.append(-1)
                else:
                    code.append(C_INFO)
                    link.append(j)
                proc.append(proc[j])
                kind.append(-1)
                oidx.append(op.index if op.index is not None else pos)
                okflag.append(0)
            elif t == "fail":
                # Definitely didn't happen: retract the invoke line.
                j = open_line.pop(p, None)
                open_fv.pop(p, None)
                if j is not None:
                    code[j] = PAD
        # Crashed invocations (no completion): kind from the invoke.
        for p, j in open_line.items():
            f, v = open_fv[p]
            k = (f, canonical_value(v))
            ki = vocab.get(k)
            if ki is None:
                ki = vocab[k] = len(all_kinds)
                all_kinds.append(k)
            kind[j] = ki
        rowlen.append(len(code) - rowstart)
    return (np.asarray(code, np.int8), np.asarray(proc, np.int32),
            np.asarray(kind, np.int32), np.asarray(oidx, np.int32),
            np.asarray(okflag, np.int8), np.asarray(link, np.int32),
            np.asarray(rowlen, np.int64))


def _pack_walk(model, arrays, all_kinds: List[Tuple],
               max_states: int) -> ColumnarOps:
    """Post-pass over the walk's flat buffers: identity-drop and padding
    into a ColumnarOps (the second half of ops_to_columnar)."""
    from ..ops.statespace import enumerate_statespace

    code, proc, kind, oidx, okflag, link, rowlen = arrays
    space = enumerate_statespace(model, all_kinds, max_states)
    identity = space.identity_kinds

    drop = code == PAD
    if identity:
        # Never-ok total-identity invocations and their info lines.
        ident_mask = np.zeros(len(all_kinds) + 1, bool)
        ident_mask[list(identity)] = True
        inv_ident = (code == C_INVOKE) & ident_mask[kind] & (okflag == 0)
        drop |= inv_ident
        linked = link >= 0
        drop |= linked & inv_ident[np.where(linked, link, 0)]
    keep = ~drop

    B = len(rowlen)
    rid = np.repeat(np.arange(B), rowlen)[keep]
    counts = np.bincount(rid, minlength=B)
    N = int(counts.max()) if B else 0
    starts = np.zeros(B, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    posin = np.arange(rid.size, dtype=np.int64) - starts[rid]

    typ = np.full((B, max(N, 1)), PAD, np.int8)
    procs = np.zeros((B, max(N, 1)), np.int16)
    kinds_arr = np.full((B, max(N, 1)), -1, np.int32)
    index = np.full((B, max(N, 1)), -1, np.int32)
    typ[rid, posin] = code[keep]
    procs[rid, posin] = proc[keep].astype(np.int16)
    kinds_arr[rid, posin] = kind[keep]
    index[rid, posin] = oidx[keep]
    return ColumnarOps(type=typ, process=procs, kind=kinds_arr,
                       kinds=all_kinds, index=index)


def _from_bufs(bufs):
    """The native walk's byte buffers as typed arrays (an empty buffer
    comes back as None)."""
    return (np.frombuffer(bufs[0] or b"", np.int8),
            np.frombuffer(bufs[1] or b"", np.int32),
            np.frombuffer(bufs[2] or b"", np.int32).copy(),
            np.frombuffer(bufs[3] or b"", np.int32),
            np.frombuffer(bufs[4] or b"", np.int8),
            np.frombuffer(bufs[5] or b"", np.int32),
            np.frombuffer(bufs[6] or b"", np.int64))


def _seed_vocab(kinds: Optional[List[Tuple]]):
    vocab: dict = {}
    all_kinds: List[Tuple] = []
    for k in (kinds or []):
        if k not in vocab:
            vocab[k] = len(all_kinds)
            all_kinds.append(k)
    return vocab, all_kinds


def ops_to_columnar(model, histories: Sequence[Sequence[Op]], *,
                    kinds: Optional[List[Tuple]] = None,
                    max_states: int = 64,
                    native: bool = True) -> ColumnarOps:
    """Convert recorded Op-list histories into one prepared ColumnarOps.

    One walk per history applies the full prepared-history contract
    (checkers.linearizable.prepare_history plus the identity-drop rule
    of ops.encode.dropped_invocations):

      * non-client ops are skipped;
      * failed ops never happened — neither line is emitted;
      * observed values are propagated — each invoke line carries the
        final (f, value) op-kind (a read's observation, not None);
      * never-ok total-identity invocations (and their info completions)
        are dropped, keeping the pending window proportional to real
        concurrency.

    ``kinds`` seeds the shared vocabulary (indices preserved); new kinds
    found in the histories are appended. ``model`` decides which kinds
    are identity transitions; a state space past ``max_states`` raises
    StateSpaceExplosion. Per-line op indices land in ``.index`` so
    invalid verdicts map back to original ops. Process ids are densified
    per row. ``native=True`` (default) runs the walk in the C++ extension
    (``native.ingest``, built at first use; a build or load failure
    raises); ``native=False`` runs the Python walk, the oracle, which
    gives the same arrays. The identity-drop and padding pass is
    vectorised numpy either way."""
    vocab, all_kinds = _seed_vocab(kinds)
    if native:
        from ..native import ingest
        histories = [h if isinstance(h, (list, tuple)) else list(h)
                     for h in histories]
        arrays = _from_bufs(ingest().walk(histories, vocab, all_kinds))
    else:
        arrays = _walk_py(histories, vocab, all_kinds)
    return _pack_walk(model, arrays, all_kinds, max_states)


def columnar_to_ops(cols: ColumnarOps, row: int,
                    propagated: bool = False) -> List[Op]:
    """One row as an indexed Op-list history (host-engine routing and
    oracle tests). Invoke values are un-propagated where the semantics
    require (a read invokes with value None, observes on completion);
    ``propagated=True`` keeps the columnar kinds' already-propagated
    values on the invokes instead — the decode path's form, sparing a
    full history.core.complete() copy pass per row. Op indices are the
    row's line positions, or the original-history op indices when the
    batch was converted (``cols.index``)."""
    out: List[Op] = []
    pending = {}
    for j in range(cols.n_lines):
        t = int(cols.type[row, j])
        if t == PAD:
            continue
        p = int(cols.process[row, j])
        if t == C_INVOKE:
            kind = cols.kinds[int(cols.kind[row, j])]
            f, v = kind[0], _kind_value(kind)
            pending[p] = (f, v)
            op = invoke_op(p, f,
                           None if f == "read" and not propagated else v)
        elif t == C_OK:
            f, v = pending.pop(p)
            op = ok_op(p, f, v)
        else:
            f, v = pending.pop(p)
            op = info_op(p, f, None if f == "read" else v, error="timeout")
        op.index = cols.op_index(row, j)
        out.append(op)
    return out
