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

Backends (``LinearizableChecker``): host, this module's pure-Python
engine (the reference oracle); native, its C++ twin; cuda, the batched
device path (jepsen_torch.ops.linearize.check_one); competition, native
and cuda raced; brute, the permutation-search oracle.
"""
from __future__ import annotations

import atexit
import threading
import time
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


# Seconds the interpreter's exit waits, in all, for "competition" racers
# that lost and still run: a racer left inside a launch, a copy or a
# thread pool while the interpreter tears torch down can abort the exit.
# Past this the exit goes on without them.
RACER_EXIT_WAIT_S = 5.0

_racers: set = set()
_racers_lock = threading.Lock()
_racers_drain_armed = False


def _track_racer(t: threading.Thread) -> None:
    global _racers_drain_armed
    with _racers_lock:
        _racers.add(t)
        if not _racers_drain_armed:
            atexit.register(_drain_racers)
            _racers_drain_armed = True


def _drain_racers() -> None:
    deadline = time.monotonic() + RACER_EXIT_WAIT_S
    with _racers_lock:
        live = list(_racers)
    for t in live:
        t.join(max(0.0, deadline - time.monotonic()))


class LinearizableChecker(Checker):
    """Validates linearizability. ``backend`` picks the engine:

    - "host": the exact Python search above;
    - "native": its C++ twin (jepsen_torch.native.wgl_check_native: the
      same verdict and bad op, no configuration sample; built at first
      use, and a library that cannot be built raises);
    - "cuda": the card, through ``ops.linearize.check_one`` (keyword
      arguments such as ``device`` pass through), with histories past
      the kernel's static bounds decided by the host engine;
    - "competition": races "native" against "cuda" and returns whichever
      finishes first, the knossos :competition analog (the reference
      exposes competition/linear/wgl at checker.clj:90-94; every WGL
      engine here runs the same algorithm, so the race is across
      hardware, not algorithms). Each racer receives only the keyword
      arguments its engine accepts;
    - "brute": the independent permutation-search oracle
      (checkers/brute.py), a different algorithm, for small histories.

    "cuda" and "competition" resolve their device when the checker is
    made: with no ``device`` keyword and no CUDA device they raise."""

    def __init__(self, backend: str = "host", **kw):
        if backend not in ("host", "native", "cuda", "competition",
                           "brute"):
            raise ValueError(f"unknown linearizability backend {backend!r}")
        if backend in ("cuda", "competition"):
            from ..ops.device import resolve_device
            resolve_device(kw.get("device"))
        self.backend = backend
        self.kw = kw
        # Engine wins of the "competition" backend, by engine name.
        self.wins: dict = {}

    def _compete(self, model, history) -> dict:
        """First engine to finish wins (knossos.competition semantics).
        The loser runs out on a daemon thread: neither engine can be
        interrupted mid-search. At exit the interpreter waits for lost
        racers still running, at most RACER_EXIT_WAIT_S in all, so a
        wedged loser delays the exit by that much and no more. The
        card's racer launches on a stream of its own, so a lost racer
        still inside a launch or a copy neither holds up nor shares a
        stream with the caller's later launches. A racer that raises
        falls through to the other."""
        import inspect
        import queue

        from ..native import wgl_check_native
        from ..ops.linearize import check_one

        def accepted(fn):
            params = inspect.signature(fn).parameters
            if any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()):
                return dict(self.kw)     # **kw: everything passes through
            return {k: v for k, v in self.kw.items() if k in params}

        def on_side_stream(fn):
            import torch

            from ..ops.device import resolve_device
            dev = resolve_device(self.kw.get("device"))
            if dev.type != "cuda":
                return fn

            def run(*a, **kw):
                with torch.cuda.device(dev), \
                        torch.cuda.stream(torch.cuda.Stream(dev)):
                    out = fn(*a, **kw)
                    torch.cuda.current_stream(dev).synchronize()
                return out
            return run

        results: "queue.Queue" = queue.Queue()

        def race(name, fn, kw):
            try:
                results.put((name, fn(model, list(history), **kw), None))
            except BaseException as e:   # noqa: BLE001 — relayed below
                results.put((name, None, e))
            finally:
                with _racers_lock:
                    _racers.discard(threading.current_thread())

        for name, fn in (("native", wgl_check_native),
                         ("cuda", check_one)):
            t = threading.Thread(target=race,
                                 args=(name, on_side_stream(fn)
                                       if name == "cuda" else fn,
                                       accepted(fn)),
                                 name=f"compete-{fn.__name__}",
                                 daemon=True)
            _track_racer(t)
            t.start()
        name, r, err = results.get()
        if err is None:
            self.wins[name] = self.wins.get(name, 0) + 1
            return r
        # The first finisher crashed: fall through to the other.
        name2, r2, err2 = results.get()
        if err2 is None:
            self.wins[name2] = self.wins.get(name2, 0) + 1
            return r2
        raise err

    def check(self, test, model, history, opts=None) -> dict:
        # Seeded batch mode: the runner may have pooled this unit's
        # verdict into one cross-run device dispatch (runtime.LinearPool);
        # a pool miss computes normally. The brute backend never consults
        # the pool: its purpose is an independently derived verdict, and
        # the pool holds WGL results.
        pooled = (None if self.backend == "brute"
                  else _pooled_result(test, opts))
        if pooled is not None:
            r = pooled
        elif self.backend == "host":
            r = wgl_check(model, history, **self.kw)
        elif self.backend == "native":
            from ..native import wgl_check_native
            r = wgl_check_native(model, history, **self.kw)
        elif self.backend == "cuda":
            from ..ops.linearize import check_one
            r = check_one(model, history, **self.kw)
        elif self.backend == "competition":
            r = self._compete(model, history)
        else:
            from .brute import brute_check
            r = brute_check(model, history, **self.kw)
        # Invalid analyses render to linear.svg in the run dir when a
        # store is attached (checker.clj:98-103's knossos render). A
        # render failure never alters the verdict: check_safe would
        # otherwise downgrade a found violation to "unknown".
        try:
            from .linear_report import write_analysis
            write_analysis(test, model, history, r, opts)
        except Exception:
            import logging
            logging.getLogger("jepsen.checker").warning(
                "linear.svg render failed", exc_info=True)
        return r


def _pooled_result(test, opts) -> Optional[dict]:
    """This check's unit in the seeded-batch LinearPool, if one is armed
    on the test map. The unit key is the independent key when this
    checker runs lifted under independent.checker (threaded via opts),
    else None for the whole history. Returns a copy (LinearPool.take)
    so consumers never alias the pool."""
    pool = test.get("_linear_pool") if isinstance(test, dict) else None
    if pool is None:
        return None
    return pool.take(test, (opts or {}).get("independent_key"))


def linearizable(backend: str = "host", **kw) -> Checker:
    return LinearizableChecker(backend=backend, **kw)
