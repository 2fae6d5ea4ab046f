"""Linearizability checking.

The host engine is an exact Wing–Gong/JIT-style state-space search over
*configurations* ``(model-state, frozenset-of-linearized-pending-ops)`` —
the same search the reference delegates to Knossos
(jepsen/src/jepsen/checker.clj:82-107), reformulated so the configuration
set is a set of small immutable tuples:

- walking the history in real-time order, any subset of currently-pending
  ops may linearize between two events (computed as a closure);
- an op that completes ``ok`` must already be linearized at its completion;
- ``fail`` ops never happened (dropped);
- ``info`` (indeterminate) ops stay pending to the end of the history —
  configurations may or may not include them.

The history is linearizable iff the configuration set is non-empty after
every completion. This exact formulation is also the spec for the CUDA
path (jepsen_torch.ops.linearize), which represents the same
configuration set densely as a bitset tensor ``[states, 2^pending]``.

Backends:
  host — this module's pure-Python engine (reference oracle).
  cuda — the batched device path (jepsen_torch.ops.linearize.check_one);
         histories beyond the kernel's static bounds go to the host engine.
"""
from __future__ import annotations

from typing import List, Optional

from ..history.core import complete, without_failures
from ..history.ops import Op, INVOKE, OK, INFO
from ..models.core import Model, is_inconsistent
from .core import Checker


def prepare_history(history: List[Op]) -> List[Op]:
    """Completion-propagated, failure-free client ops — the event stream
    the search (and the device encoder) consumes."""
    h = [op for op in history if op.is_client]
    h = complete(h)
    h = without_failures(h)
    return h


def _droppable_invocations(model: Model, h: List[Op],
                           space_cache: Optional[dict] = None) -> set:
    """Never-ok total-identity invocations (ops.encode.dropped_invocations
    — the shared rule that keeps every engine's config sets identical).
    Empty when the state space is unbounded (those histories never reach
    the device path, so parity is moot); ``space_cache`` memoizes the
    enumeration (None = exploded) across a batch sharing one op
    vocabulary."""
    from ..ops.encode import dropped_invocations
    from ..ops.statespace import (StateSpaceExplosion, enumerate_statespace,
                                  history_kinds)
    kinds = history_kinds(h)
    key = (model, tuple(kinds))
    if space_cache is not None and key in space_cache:
        space = space_cache[key]
    else:
        try:
            space = enumerate_statespace(model, kinds, 64)
        except StateSpaceExplosion:
            space = None
        if space_cache is not None:
            space_cache[key] = space
    return dropped_invocations(space, h) if space is not None else set()


# Default memo for the droppable-invocation state-space enumeration:
# callers that don't thread their own cache still pay the enumeration at
# most once per (model, op-vocabulary) instead of once per call.
_DEFAULT_SPACE_CACHE: dict = {}


def wgl_check(model: Model, history: List[Op],
              max_configs: int = 2_000_000,
              space_cache: Optional[dict] = None) -> dict:
    """Exact linearizability decision for one history.

    Returns {"valid": bool|"unknown", "op": first-impossible-op,
             "configs": sample of surviving configs before failure}.

    Divergence from the reference's Knossos output: invocations that can
    never linearize to an observable effect (the identity-drop rule,
    ops.encode.dropped_invocations) are removed before the search, so
    they do not appear in reported ``pending`` config samples. Validity
    verdicts are unaffected — only the config-sample cosmetics differ.
    """
    h = prepare_history(history)
    if space_cache is None:
        space_cache = _DEFAULT_SPACE_CACHE
    dropped = _droppable_invocations(model, h, space_cache)

    configs = {(model, frozenset())}
    pending: dict = {}            # op-id -> op (with observed value)
    open_by_process: dict = {}    # process -> op-id

    def closure(configs):
        work = list(configs)
        seen = set(configs)
        while work:
            m, s = work.pop()
            for oid, op in pending.items():
                if oid in s:
                    continue
                m2 = m.step(op)
                if is_inconsistent(m2):
                    continue
                c2 = (m2, s | {oid})
                if c2 not in seen:
                    seen.add(c2)
                    work.append(c2)
            if len(seen) > max_configs:
                raise MemoryError("config-set explosion")
        return seen

    try:
        for pos, op in enumerate(h):
            if op.type == INVOKE:
                if pos in dropped:
                    continue
                oid = op.index if op.index is not None else id(op)
                pending[oid] = op
                open_by_process[op.process] = oid
                configs = closure(configs)
            elif op.type == OK:
                oid = open_by_process.pop(op.process, None)
                if oid is None:
                    continue
                survivors = {(m, s - {oid}) for (m, s) in configs if oid in s}
                del pending[oid]
                if not survivors:
                    return {
                        "valid": False,
                        "op": op.to_dict(),
                        "configs": _sample_configs(configs),
                    }
                configs = closure(survivors)
            elif op.type == INFO:
                # Stays pending until the end; nothing changes now.
                open_by_process.pop(op.process, None)
    except MemoryError as e:
        return {"valid": "unknown", "error": str(e)}

    return {"valid": True, "configs": _sample_configs(configs)}


def _sample_configs(configs, n: int = 10):
    """Bounded, deterministic config sample (the reference truncates
    equivalent output to 10 — checker.clj:104-107). Sorted so the host
    and device engines produce comparable samples."""
    out = [{"model": repr(m), "pending": sorted(s)} for m, s in configs]
    out.sort(key=lambda c: (c["model"], c["pending"]))
    return out[:n]


class LinearizableChecker(Checker):
    """Validates linearizability. ``backend`` picks the engine: "host" is
    the exact Python search above; "native" its C++ twin
    (jepsen_torch.native.wgl_check_native: the same verdict and bad op,
    no configuration sample; built at first use, and a library that
    cannot be built raises); "cuda" checks on the card through
    ``ops.linearize.check_one`` (keyword arguments such as ``device``
    pass through), with histories past the kernel's static bounds
    decided by the host engine."""

    def __init__(self, backend: str = "host", **kw):
        if backend not in ("host", "native", "cuda"):
            raise ValueError(f"unknown linearizability backend {backend!r}")
        self.backend = backend
        self.kw = kw

    def check(self, test, model, history, opts=None) -> dict:
        if self.backend == "host":
            return wgl_check(model, history, **self.kw)
        if self.backend == "native":
            from ..native import wgl_check_native
            return wgl_check_native(model, history, **self.kw)
        from ..ops.linearize import check_one
        return check_one(model, history, **self.kw)


def linearizable(backend: str = "host", **kw) -> Checker:
    return LinearizableChecker(backend=backend, **kw)
