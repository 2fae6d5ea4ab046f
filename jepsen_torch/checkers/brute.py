"""Brute-force linearizability oracle — an independent second algorithm.

Every other engine of the package (host Python, native C++, the CUDA
kernel) runs the same Wing–Gong/JIT configuration-set walk, written
from one spec. A shared misunderstanding of the semantics would
sail through their mutual parity gates. This module decides
linearizability by a *different* method so verdicts can be
cross-derived: it reduces the history to operations with real-time
intervals and searches directly over permutations (linear extensions
of the interval order), stepping the sequential model along each
candidate ordering. No event walk, no pending windows, no slot
encoding, no frontier — none of the WGL machinery.

Semantics implemented independently from the raw history (deliberately
NOT reusing history.core.complete/without_failures, so a bug in those
transforms is also visible here):

- an ``ok`` operation definitely happened and must linearize at some
  point between its invocation and its completion;
- a ``fail`` operation definitely did not happen — excluded entirely;
- an ``info`` (indeterminate) or crashed (never-completed) operation
  may linearize at any point after its invocation, or never;
- real-time order: if operation *i* completed before operation *j*
  was invoked, *i* precedes *j* in any linearization;
- ``ok`` observations propagate onto the operation (a read invoked
  with value None takes the completion's observed value).

The history is linearizable iff some choice of (a) a subset of the
optional operations and (b) a linear extension of the interval order
over the chosen operations is accepted by the model.

The search is exponential and intended for SMALL histories (the
batched independent checker's spot check, independent.py); ``max_ops``
guards against misuse. The reference's analog of an independently-derived verdict is
Knossos itself (jepsen/src/jepsen/checker.clj:82-107) — an external
codebase this environment can't run, hence this in-tree oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from ..history.ops import Op, INVOKE, OK, FAIL, INFO
from ..models.core import Model, is_inconsistent
from .core import Checker


@dataclass
class _Operation:
    """One client operation with its real-time interval."""
    op: Op                 # the invocation, with observed value folded in
    inv: int               # event position of the invocation
    comp: float            # event position of the ok completion, or +inf
    required: bool         # ok ops must appear in any linearization


def _operations(history: List[Op]) -> List[_Operation]:
    """Pair invocations with completions straight off the raw history.

    Nemesis events and unattributable completions (no open invocation
    for that process) are ignored, matching the runtime's discipline;
    failed operations are excluded entirely.
    """
    out: List[_Operation] = []
    open_by_process: dict = {}
    pos = 0
    for ev in history:
        if not isinstance(ev.process, int):
            continue                       # nemesis / non-client events
        if ev.type == INVOKE:
            open_by_process[ev.process] = len(out)
            out.append(_Operation(op=ev, inv=pos, comp=math.inf,
                                  required=False))
            pos += 1
        elif ev.type in (OK, FAIL, INFO):
            i = open_by_process.pop(ev.process, None)
            if i is None:
                pos += 1
                continue
            if ev.type == OK:
                rec = out[i]
                rec.comp = pos
                rec.required = True
                if rec.op.value is None and ev.value is not None:
                    rec.op = rec.op.with_(value=ev.value)
            elif ev.type == FAIL:
                out[i] = None              # never happened
            # INFO: interval stays [inv, inf), optional
            pos += 1
    return [o for o in out if o is not None]


def brute_check(model: Model, history: List[Op],
                max_ops: int = 14) -> dict:
    """Exact linearizability verdict by permutation search.

    Returns {"valid": bool} (plus {"order": [...]} witness indices for
    valid histories). Raises ValueError when the history holds more
    than ``max_ops`` operations — this is a small-history oracle, not
    a production checker; use the WGL engines for real histories.
    """
    ops = _operations(history)
    n = len(ops)
    if n > max_ops:
        raise ValueError(
            f"brute-force oracle capped at {max_ops} operations, got {n}")

    # pred[i]: bitmask of operations that must precede i (those whose
    # completion strictly precedes i's invocation).
    pred = [0] * n
    for i in range(n):
        for j in range(n):
            if i != j and ops[j].comp < ops[i].inv:
                pred[i] |= 1 << j

    required_mask = 0
    for i, o in enumerate(ops):
        if o.required:
            required_mask |= 1 << i

    # DFS over linear extensions; memoize failed (model-state, chosen)
    # pairs. Models are immutable and hashable by construction
    # (models/core.py), so the memo is sound.
    dead = set()

    def dfs(state: Model, mask: int, order: list) -> bool:
        if mask & required_mask == required_mask:
            return True          # optional leftovers may simply never happen
        key = (state, mask)
        if key in dead:
            return False
        for i in range(n):
            bit = 1 << i
            if mask & bit or pred[i] & ~mask:
                continue
            nxt = state.step(ops[i].op)
            if is_inconsistent(nxt):
                continue
            order.append(i)
            if dfs(nxt, mask | bit, order):
                return True
            order.pop()
        dead.add(key)
        return False

    order: list = []
    if dfs(model, 0, order):
        witness = [ops[i].op.index for i in order
                   if ops[i].op.index is not None]
        return {"valid": True, "order": witness}
    return {"valid": False}


class BruteChecker(Checker):
    """Checker wrapper so the oracle slots into compose()d suites and
    the recheck registry like any engine. Small histories only."""

    def __init__(self, max_ops: int = 14):
        self.max_ops = max_ops

    def check(self, test, model, history, opts=None) -> dict:
        return brute_check(model, history, max_ops=self.max_ops)


def brute(max_ops: int = 14) -> Checker:
    return BruteChecker(max_ops=max_ops)
