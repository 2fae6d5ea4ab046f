"""Single-pass O(n) invariant checkers: the host oracles of the fold
checkers.

Semantics mirror jepsen/src/jepsen/checker.clj:109-374 (set, queue,
total-queue, unique-ids, counter) including edge-case behavior the
reference's unit tests pin down (lost/duplicated/unexpected/recovered
accounting, counter invoke/ok bound windows). They share no machinery
with the batch folds of ``jepsen_torch.ops.folds``, which are held
against them field for field; the counter fold also detours here for
rows whose arithmetic could leave int32.
"""
from __future__ import annotations

from collections import Counter
from typing import List

from ..history.core import complete
from ..history.ops import INVOKE, OK, Op
from ..models.core import is_inconsistent
from ..utils.core import fraction, integer_interval_set_str
from .core import Checker


class SetChecker(Checker):
    """:add ops followed by a final :read of the whole set
    (checker.clj:131-178)."""

    def check(self, test, model, history, opts=None) -> dict:
        attempts = {op.value for op in history
                    if op.is_invoke and op.f == "add"}
        adds = {op.value for op in history if op.is_ok and op.f == "add"}
        final_read = None
        for op in history:
            if op.is_ok and op.f == "read":
                final_read = op.value
        if final_read is None:
            return {"valid": "unknown", "error": "Set was never read"}
        final_read = set(final_read)
        ok = final_read & attempts
        unexpected = final_read - attempts
        lost = adds - final_read
        recovered = ok - adds
        return {
            "valid": not lost and not unexpected,
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
            "ok-frac": fraction(len(ok), len(attempts)),
            "unexpected-frac": fraction(len(unexpected), len(attempts)),
            "lost-frac": fraction(len(lost), len(attempts)),
            "recovered-frac": fraction(len(recovered), len(attempts)),
        }


def set_checker() -> Checker:
    return SetChecker()


class QueueChecker(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded, only ok dequeues succeeded, and fold the model
    (checker.clj:109-129). Use with an unordered or a FIFO queue
    model."""

    def check(self, test, model, history, opts=None) -> dict:
        m = model
        for op in history:
            if op.f == "enqueue" and op.is_invoke:
                m = m.step(op)
            elif op.f == "dequeue" and op.is_ok:
                m = m.step(op)
            if is_inconsistent(m):
                return {"valid": False, "error": m.msg}
        return {"valid": True, "final-queue": m}


def queue_checker() -> Checker:
    return QueueChecker()


def expand_queue_drain_ops(history: List[Op]) -> List[Op]:
    """Expand ok :drain ops (value = list of elements) into dequeue
    invoke/ok pairs (checker.clj:180-212)."""
    out: List[Op] = []
    for op in history:
        if op.f != "drain":
            out.append(op)
        elif op.is_invoke or op.is_fail:
            continue
        elif op.is_ok:
            for element in op.value:
                out.append(op.with_(type=INVOKE, f="dequeue", value=None))
                out.append(op.with_(type=OK, f="dequeue", value=element))
        else:
            raise ValueError(
                f"Not sure how to handle a crashed drain operation: {op}")
    return out


class TotalQueueChecker(Checker):
    """What goes in must come out (checker.clj:214-271)."""

    def check(self, test, model, history, opts=None) -> dict:
        history = expand_queue_drain_ops(history)
        attempts = Counter(op.value for op in history
                           if op.is_invoke and op.f == "enqueue")
        enqueues = Counter(op.value for op in history
                           if op.is_ok and op.f == "enqueue")
        dequeues = Counter(op.value for op in history
                           if op.is_ok and op.f == "dequeue")
        ok = dequeues & attempts
        unexpected = Counter({v: n for v, n in dequeues.items()
                              if v not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        n_attempts = sum(attempts.values())
        return {
            "valid": not lost and not unexpected,
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
            "ok-frac": fraction(sum(ok.values()), n_attempts),
            "unexpected-frac": fraction(sum(unexpected.values()), n_attempts),
            "duplicated-frac": fraction(sum(duplicated.values()), n_attempts),
            "lost-frac": fraction(sum(lost.values()), n_attempts),
            "recovered-frac": fraction(sum(recovered.values()), n_attempts),
        }


def total_queue_checker() -> Checker:
    return TotalQueueChecker()


class UniqueIdsChecker(Checker):
    """All acknowledged :generate ops must return distinct ids
    (checker.clj:273-318)."""

    def check(self, test, model, history, opts=None) -> dict:
        attempted = sum(1 for op in history
                        if op.is_invoke and op.f == "generate")
        acks = [op.value for op in history
                if op.is_ok and op.f == "generate"]
        counts = Counter(acks)
        dups = {k: n for k, n in counts.items() if n > 1}
        rng = [min(acks), max(acks)] if acks else [None, None]
        top_dups = dict(sorted(dups.items(), key=lambda kv: -kv[1])[:48])
        return {
            "valid": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": top_dups,
            "range": rng,
        }


def unique_ids_checker() -> Checker:
    return UniqueIdsChecker()


class CounterChecker(Checker):
    """Monotonically-increasing counter bounds checker
    (checker.clj:321-374): each ok read must lie within
    [sum of ok adds at invoke, sum of attempted adds at completion].
    Expects a *completed* history (read invokes know their value)."""

    def check(self, test, model, history, opts=None) -> dict:
        lower = 0          # sum of definitely-applied increments
        upper = 0          # sum of possibly-applied increments
        pending = {}       # process -> [lower-at-invoke, read-value]
        reads = []         # [lower, value, upper]
        for op in complete(history):
            key = (op.type, op.f)
            if key == (INVOKE, "read"):
                pending[op.process] = [lower, op.value]
            elif key == (OK, "read"):
                r = pending.pop(op.process, None)
                if r is not None:
                    reads.append([r[0], r[1], upper])
            elif key == (INVOKE, "add"):
                upper += op.value
            elif key == (OK, "add"):
                lower += op.value
        errors = [r for r in reads
                  if r[1] is None or not (r[0] <= r[1] <= r[2])]
        return {"valid": not errors, "reads": reads, "errors": errors}


def counter_checker() -> Checker:
    return CounterChecker()
