"""Pure history transforms the checkers need.

Semantics follow the reference framework (invoke/completion pairing at
jepsen/src/jepsen/util.clj:554-588, completion semantics used by knossos
and jepsen.checker).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .ops import Op, INVOKE, OK, FAIL


def index(history: List[Op]) -> List[Op]:
    """Assign sequential indices in place; returns the history."""
    for i, op in enumerate(history):
        op.index = i
    return history


def pairs(history: List[Op]) -> List[Tuple[Op, Optional[Op]]]:
    """Match invocations with their completions, in invocation order.

    Returns (invoke, completion-or-None) tuples. A process has at most one
    outstanding op, so pairing is a per-process scan.
    """
    open_: Dict[object, int] = {}
    out: List[Tuple[Op, Optional[Op]]] = []
    for op in history:
        if op.type == INVOKE:
            open_[op.process] = len(out)
            out.append((op, None))
        elif op.is_completion and op.process in open_:
            i = open_.pop(op.process)
            out[i] = (out[i][0], op)
    return out


def complete(history: List[Op]) -> List[Op]:
    """Propagate completion values back onto invocations.

    For each ok completion whose invoke recorded no value (e.g. a read),
    fill the invoke's value from the completion — the semantics knossos'
    ``history/complete`` provides.
    """
    out = [op.with_() for op in history]
    open_: Dict[object, int] = {}
    for i, op in enumerate(out):
        if op.type == INVOKE:
            open_[op.process] = i
        elif op.is_completion and op.process in open_:
            j = open_.pop(op.process)
            if op.type == OK:
                if out[j].value is None:
                    out[j].value = op.value
                elif op.value is None:
                    op.value = out[j].value
    return out


def without_failures(history: List[Op]) -> List[Op]:
    """Drop failed ops and their invocations.

    A fail completion means the op definitely did not take effect, so
    neither event constrains correctness (knossos semantics).
    """
    drop = set()
    open_: Dict[object, int] = {}
    for i, op in enumerate(history):
        if op.type == INVOKE:
            open_[op.process] = i
        elif op.is_completion and op.process in open_:
            j = open_.pop(op.process)
            if op.type == FAIL:
                drop.add(i)
                drop.add(j)
    return [op for i, op in enumerate(history) if i not in drop]
