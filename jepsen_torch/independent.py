"""Independent keys: the (key, value) wrapper, the per-key strainer and
the lifted checkers.

A single-register test lifts to a *map* of keys (jepsen/src/jepsen/
independent.clj:1-8): keyed sub-tests run concurrently, every client
value is wrapped as ``KV(key, value)``, and the recorded history strains
into per-key subhistories that check independently.

``IndependentChecker`` lifts any checker over the keys, one subhistory
at a time. ``BatchLinearizableChecker`` decides every key in one
dispatch: where the reference framework pmaps a checker over keys, the
per-key strainer is a batch builder, and all per-key subhistories go to
``ops.linearize.check_batch_columnar`` at once: the batch axis of the
frontier kernel on the card.

The keyed generators (the reference's ``sequential_generator`` and
``concurrent_generator``) drive a cluster test and need the generator
library, which is not ported yet; they are left out.
"""
from __future__ import annotations

from typing import List, Sequence

from .checkers.core import Checker, check_safe, merge_valid
from .history.ops import Op

DIR = "independent"


class KV(tuple):
    """A (key, value) tuple marking values produced by independent
    generators (independent.clj:20-28)."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"KV({self[0]!r}, {self[1]!r})"


def is_kv(v) -> bool:
    return isinstance(v, KV)


def tuple_(k, v) -> KV:
    return KV(k, v)


def history_keys(history: Sequence[Op]) -> List:
    """Distinct KV keys in a history, in first-seen order
    (independent.clj:221-231)."""
    seen, out = set(), []
    for op in history:
        v = op.value
        if isinstance(v, KV) and v.key not in seen:
            seen.add(v.key)
            out.append(v.key)
    return out


def subhistory(k, history: Sequence[Op]) -> List[Op]:
    """All ops without a *differing* key, KV values unwrapped — unkeyed
    ops (nemesis, logging) appear in every subhistory
    (independent.clj:233-244)."""
    out = []
    for op in history:
        v = op.value
        if not isinstance(v, KV):
            out.append(op)
        elif v.key == k:
            out.append(op.with_(value=v.value))
    return out


def _key_subdir(opts, k) -> list:
    """The per-key artifact directory, nested under any enclosing
    subdirectory (so lifted checkers compose)."""
    return list((opts or {}).get("subdirectory", [])) + [DIR, str(k)]


def _write_key_artifacts(test, opts, k, h, r, *, render=False,
                         model=None) -> None:
    """Per-key store artifacts: results.json and the subhistory (and the
    counterexample render when the caller did not already produce one
    through the lifted checker). Artifact IO never alters an already
    computed verdict: any failure here is logged and swallowed."""
    store = (opts or {}).get("store") or test.get("store_handle")
    if store is None:
        return
    try:
        sub = _key_subdir(opts, k)
        store.write_json(sub + ["results.json"], r)
        store.write_history(sub + ["history"], h)
        if render:
            from .checkers.linear_report import write_analysis
            write_analysis(test, model, h, r,
                           {"store": store, "subdirectory": sub})
    except Exception:
        import logging
        logging.getLogger("jepsen.independent").warning(
            "per-key artifact write failed for key %r", k, exc_info=True)


class IndependentChecker(Checker):
    """Lift a checker over v-values to one over KV-valued histories
    (independent.clj:246-295): check each key's subhistory; valid iff
    all sub-results are; writes per-key artifacts when a store handle is
    present in opts."""

    def __init__(self, checker: Checker):
        self.checker = checker

    def check(self, test, model, history, opts=None) -> dict:
        opts = opts or {}
        results = {}
        for k in history_keys(history):
            h = subhistory(k, history)
            sub_opts = {**opts, "subdirectory": _key_subdir(opts, k),
                        "independent_key": k}
            r = check_safe(self.checker, test, model, h, sub_opts)
            _write_key_artifacts(test, opts, k, h, r)
            results[k] = r
        failures = [k for k, r in results.items()
                    if r.get("valid") is not True]
        return {
            "valid": merge_valid(r["valid"] for r in results.values())
            if results else True,
            "results": results,
            "failures": failures,
        }


def checker(sub_checker: Checker) -> Checker:
    return IndependentChecker(sub_checker)


class BatchLinearizableChecker(Checker):
    """Batched independent linearizability: strains the history into
    per-key subhistories and decides all keys in one dispatch per cost
    bucket on ``device`` (the card unless the caller names another; made
    without a device and without a card, the checker raises). The
    reference's per-key pmap (independent.clj:263-280) becomes the batch
    axis of the frontier kernel. Subhistories ride the columnar path
    (``ops.linearize.check_batch_columnar``); the reference's
    ``columnar=False`` Op-list route is not ported.

    The pool (``runtime.LinearPool``) holds verdicts computed with
    ``check_batch_columnar``'s defaults, so a checker made with engine
    keyword arguments of its own (``**kw``: ``max_slots``,
    ``scheduler_opts``, ...) never reads it and computes every key
    itself. ``device`` is not an engine argument:
    it changes where the verdicts are computed, not what they are, and
    a checker on any device reads the pool."""

    def __init__(self, oracle_spot: int = 2, device=None, **kw):
        from .ops.device import resolve_device
        self.device = resolve_device(device)
        # Production tripwire: re-derive up to this many small keys'
        # verdicts with the algorithm-independent brute oracle
        # (checkers/brute.py) every run. A disagreement is a checker
        # bug, not a system violation: it raises, and check_safe
        # surfaces the run as valid:"unknown" with the error.
        self.oracle_spot = oracle_spot
        self.kw = kw

    def check(self, test, model, history, opts=None) -> dict:
        from .ops.linearize import check_batch_columnar
        from .ops.partition import partition_histories
        # One strainer for the lifted checker and the engines' own
        # pre-encode partition (ops.partition wraps subhistory).
        parts = partition_histories([history], force=True)
        if parts is None:
            ks, subs = [], []
        else:
            subs, _, ks = parts
        pool = (test.get("_linear_pool")
                if isinstance(test, dict) and not self.kw else None)
        rs = ([pool.take(test, k) for k in ks]
              if pool is not None else None)
        if rs is None or any(r is None for r in rs):
            rs = check_batch_columnar(model, subs, device=self.device,
                                      **self.kw)
        spot = self._oracle_spot_check(model, ks, subs, rs)
        results = dict(zip(ks, rs))
        failures = [k for k, r in results.items()
                    if r.get("valid") is not True]
        # Per-key artifacts when a store is attached, as the lifted
        # checker writes them, plus the counterexample render for
        # invalid keys (checker.clj:98-103's seam).
        for k, sub, r in zip(ks, subs, rs):
            _write_key_artifacts(test, opts, k, sub, r,
                                 render=True, model=model)
        out = {
            "valid": merge_valid(r["valid"] for r in results.values())
            if results else True,
            "results": results,
            "failures": failures,
        }
        if spot is not None:
            out["oracle-spot"] = spot
        return out

    def _oracle_spot_check(self, model, ks, subs, rs):
        """Cross-derive up to ``oracle_spot`` small keys' verdicts with
        the independent permutation-search oracle. Returns a summary
        dict, or None when disabled or no key is small enough. A
        disagreement raises: the engines and the oracle disagreeing
        means the checker is broken, and check_safe turns that into
        valid:"unknown" rather than a false verdict either way."""
        if not self.oracle_spot:
            return None
        from .checkers.brute import brute_check
        checked = []
        for k, sub, r in zip(ks, subs, rs):
            if len(checked) >= self.oracle_spot:
                break
            if r.get("valid") not in (True, False):
                continue
            n_invocations = sum(1 for op in sub if op.is_invoke)
            if n_invocations > 12:
                continue
            want = brute_check(model, sub)["valid"]
            got = r["valid"] is True
            if want is not got:
                raise AssertionError(
                    f"checker self-check failed: key {k!r} engine="
                    f"{r['valid']} oracle={want} — the WGL engine and "
                    f"the independent oracle disagree")
            checked.append(k)
        return {"keys": checked, "agree": True} if checked else None


def batch_checker(**kw) -> Checker:
    return BatchLinearizableChecker(**kw)
