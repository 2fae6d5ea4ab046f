"""Checker protocol, safety wrapper, and composition.

A checker validates a history against a model and returns a result dict
with at least ``{"valid": True | False | "unknown"}``. Composition merges
sub-results under the priority lattice true < unknown < false — a single
false dominates (mirrors jepsen/src/jepsen/checker.clj:23-44,376-388).
"""
from __future__ import annotations

import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

VALID_PRIORITIES = {True: 0, "unknown": 0.5, False: 1}


def merge_valid(valids) -> object:
    """The merged verdict of several sub-results: the highest-priority
    ``valid`` value among them (True when there are none)."""
    out = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid value")
        if VALID_PRIORITIES[v] > VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    """Base checker. Subclasses implement ``check``.

    ``opts`` may carry:
      subdirectory — directory within the test's store dir for output files.
      store        — a store handle for writing artifacts (may be None).
    """

    def check(self, test: dict, model, history: list,
              opts: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, model, history, opts=None) -> dict:
        return self.check(test, model, history, opts)


class FnChecker(Checker):
    def __init__(self, fn: Callable, name: str = "fn"):
        self.fn = fn
        self.name = name

    def check(self, test, model, history, opts=None) -> dict:
        return self.fn(test, model, history, opts)


def out_path(test, opts, name) -> Optional[str]:
    """Resolve an artifact path in the run dir (store from opts or the
    test map, honoring the independent checker's per-key subdirectory).
    None when no store is attached: the seam every artifact-writing
    checker (linear.svg) uses."""
    store = (opts or {}).get("store") or test.get("store_handle")
    if store is None:
        return None
    sub = list((opts or {}).get("subdirectory", []))
    return store.path(*sub, name)


def check(checker, test, model, history, opts=None) -> dict:
    if callable(checker) and not isinstance(checker, Checker):
        checker = FnChecker(checker)
    return checker.check(test, model, history, opts or {})


def check_safe(checker, test, model, history, opts=None) -> dict:
    """Like check, but maps exceptions to {"valid": "unknown"}
    (checker.clj:63-74)."""
    try:
        return check(checker, test, model, history, opts)
    except Exception:
        return {"valid": "unknown", "error": traceback.format_exc()}


class AlwaysValid(Checker):
    """Accepts any history unconditionally: a placeholder checker for
    wiring tests before a real checker exists."""

    def check(self, test, model, history, opts=None) -> dict:
        return {"valid": True}


def always_valid() -> Checker:
    return AlwaysValid()


class Compose(Checker):
    """Run several checkers over one history (on a thread pool when
    ``parallel``) and merge their verdicts under the priority lattice;
    each sub-result lands under its name."""

    def __init__(self, checker_map: Dict[str, Checker], parallel: bool = True):
        self.checker_map = dict(checker_map)
        self.parallel = parallel

    def check(self, test, model, history, opts=None) -> dict:
        items = list(self.checker_map.items())
        if self.parallel and len(items) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(items))) as ex:
                futures = [(k, ex.submit(check_safe, c, test, model,
                                         history, opts))
                           for k, c in items]
                results = {k: f.result() for k, f in futures}
        else:
            results = {k: check_safe(c, test, model, history, opts)
                       for k, c in items}
        results["valid"] = merge_valid(
            r["valid"] for k, r in results.items() if k != "valid")
        return results


def compose(checker_map: Dict[str, Checker], parallel: bool = True) -> Checker:
    return Compose(checker_map, parallel)
