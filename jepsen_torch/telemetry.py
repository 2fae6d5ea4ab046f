"""Span tracing and the metrics registry, trimmed to what the online
daemon, the WAL and a stored run's results report through.

A copy of the reference's ``telemetry.py`` core:

  * **metrics registry** (``REGISTRY``): counters, gauges and histograms
    with labels, lock-protected, always on; ``snapshot()`` is
    deterministic (sorted keys, rounded floats), so two snapshots of the
    same state compare equal, and its names are the reference's
    (``online.checks``, ``online.delta_ops{tenant=...}``,
    ``wal.flush_ms``), so the two packages' snapshots compare field for
    field.
  * **span tracer**: a thread-local span stack whose completed spans
    land in an in-process ring (the newest ``RING_SIZE`` survive).
    ``$JT_TRACE`` set to anything but ``0`` turns it on; off, ``span()``
    returns a shared no-op and records nothing.
  * **correlation ids**: ``correlation_scope`` stamps every span opened
    inside it with the unit of work it belongs to (the daemon's tenant
    key and WAL incarnation).

The reference also writes traces to a JSONL sink and exports Chrome
traces, merges traces across processes, analyses dispatch gaps, renders
OpenMetrics, and keeps durable metric series and SLO alerts
(``series.py``, ``alerts.py``); the port does none of that yet.
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

#: Completed spans the ring keeps (the reference's default).
RING_SIZE = 65536

_CONF_LOCK = threading.Lock()
_ENABLED = False
_RING: deque = deque(maxlen=RING_SIZE)
_CONFIGURED = False

# Trace epoch: timestamps are monotonic ns relative to this.
_EPOCH_NS = time.monotonic_ns()

_TLS = threading.local()
_IDS = iter(range(1, 1 << 62)).__next__
_ID_LOCK = threading.Lock()


def correlation() -> Optional[str]:
    """The innermost ``correlation_scope`` id on this thread, or None."""
    stack = getattr(_TLS, "corr", None)
    return stack[-1] if stack else None


@contextmanager
def correlation_scope(cid: Optional[str]):
    """Thread-local correlation id for every span opened inside."""
    stack = getattr(_TLS, "corr", None)
    if stack is None:
        stack = _TLS.corr = []
    stack.append(cid)
    try:
        yield
    finally:
        stack.pop()


def _next_id() -> int:
    with _ID_LOCK:
        return _IDS()


def configure(trace=None) -> None:
    """(Re)configure the tracer: ``trace`` truthy turns it on, False,
    None or "0" off, "env" re-reads ``$JT_TRACE``. A fresh ring
    replaces the old one."""
    global _ENABLED, _RING, _CONFIGURED
    with _CONF_LOCK:
        if trace == "env":
            trace = os.environ.get("JT_TRACE")
        _ENABLED = trace not in (None, False, "", "0")
        _RING = deque(maxlen=RING_SIZE)
        _CONFIGURED = True


def enabled() -> bool:
    """Is the span tracer on?"""
    if not _CONFIGURED:
        configure("env")
    return _ENABLED


class Span:
    """One in-flight interval; ``end`` (or leaving the ``with``) records
    it in the ring."""

    __slots__ = ("name", "cat", "t0", "attrs", "sid", "parent", "corr",
                 "_done")

    def __init__(self, name: str, cat: str, attrs: Optional[dict],
                 parent: Optional[int]):
        self.name = name
        self.cat = cat
        self.t0 = time.monotonic_ns()
        self.attrs = attrs
        self.sid = _next_id()
        self.parent = parent
        self.corr = correlation()
        self._done = False

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        t1 = time.monotonic_ns()
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        rec = {"ph": "X", "name": self.name, "cat": self.cat,
               "ts": (self.t0 - _EPOCH_NS) / 1e3,
               "dur": (t1 - self.t0) / 1e3,
               "tid": threading.get_ident(), "id": self.sid}
        if self.parent is not None:
            rec["parent"] = self.parent
        if self.corr is not None:
            rec["corr"] = self.corr
        if self.attrs:
            rec["args"] = self.attrs
        _RING.append(rec)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NopSpan:
    """What ``span()`` returns with the tracer off: records nothing."""

    __slots__ = ()

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOP = _NopSpan()


def span(name: str, /, cat: str = "host", **attrs):
    """``with telemetry.span("dispatch", cat="device", W=9): ...``;
    nested spans record their parent on this thread."""
    if not enabled():
        return NOP
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    sp = Span(name, cat, attrs or None, stack[-1].sid if stack else None)
    stack.append(sp)
    return sp


def spans() -> List[dict]:
    """The ring's current contents, oldest first."""
    enabled()
    return list(_RING)


def reset() -> None:
    """Drop recorded spans (the configuration stays)."""
    enabled()
    _RING.clear()


# ---------------------------------------------------- metrics registry

def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Counter:
    __slots__ = ("_reg", "_k")

    def __init__(self, reg, k):
        self._reg, self._k = reg, k

    def inc(self, n=1) -> None:
        with self._reg._lock:
            self._reg._counters[self._k] = \
                self._reg._counters.get(self._k, 0) + n


class _Gauge:
    __slots__ = ("_reg", "_k")

    def __init__(self, reg, k):
        self._reg, self._k = reg, k

    def set(self, v) -> None:
        with self._reg._lock:
            self._reg._gauges[self._k] = v


#: Histogram bucket upper bounds (log-spaced over the latency range);
#: a snapshot carries cumulative ``le`` counts, the reservoir p50/p99.
HIST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)


class _Histogram:
    __slots__ = ("_reg", "_k")

    RESERVOIR = 4096

    def __init__(self, reg, k):
        self._reg, self._k = reg, k

    def observe(self, v) -> None:
        v = float(v)
        with self._reg._lock:
            h = self._reg._hists.get(self._k)
            if h is None:
                h = self._reg._hists[self._k] = {
                    "count": 0, "sum": 0.0, "min": v, "max": v,
                    "_res": deque(maxlen=self.RESERVOIR),
                    "_b": [0] * (len(HIST_BUCKETS) + 1)}
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            h["_res"].append(v)
            h["_b"][bisect.bisect_left(HIST_BUCKETS, v)] += 1


class Registry:
    """Lock-protected metrics store; handles are cheap stateless views
    and every mutation takes the one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, object] = {}
        self._hists: Dict[str, dict] = {}

    def counter(self, name: str, **labels) -> _Counter:
        return _Counter(self, _key(name, labels))

    def gauge(self, name: str, **labels) -> _Gauge:
        return _Gauge(self, _key(name, labels))

    def histogram(self, name: str, **labels) -> _Histogram:
        return _Histogram(self, _key(name, labels))

    def get(self, name: str, **labels):
        k = _key(name, labels)
        with self._lock:
            if k in self._counters:
                return self._counters[k]
            if k in self._gauges:
                return self._gauges[k]
            h = self._hists.get(k)
            return dict(h, _res=None) if h is not None else None

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def snapshot(self) -> dict:
        """JSON-friendly deterministic state; {} when nothing was ever
        recorded."""
        def _pct(xs: List[float], p: float):
            if not xs:
                return None
            i = min(len(xs) - 1,
                    max(0, int(round(p / 100.0 * len(xs) + 0.5)) - 1))
            return round(xs[i], 6)

        with self._lock:
            out: dict = {}
            if self._counters:
                out["counters"] = {k: self._counters[k]
                                   for k in sorted(self._counters)}
            if self._gauges:
                out["gauges"] = {k: self._gauges[k]
                                 for k in sorted(self._gauges)}
            if self._hists:
                hs = {}
                for k in sorted(self._hists):
                    h = self._hists[k]
                    xs = sorted(h["_res"])
                    hs[k] = {"count": h["count"],
                             "sum": round(h["sum"], 6),
                             "min": round(h["min"], 6),
                             "max": round(h["max"], 6),
                             "p50": _pct(xs, 50), "p99": _pct(xs, 99)}
                    cum, buckets = 0, {}
                    for le, n in zip(HIST_BUCKETS, h["_b"]):
                        cum += n
                        buckets[repr(le)] = cum
                    buckets["+Inf"] = h["count"]
                    hs[k]["buckets"] = buckets
                out["histograms"] = hs
            return out


REGISTRY = Registry()


def snapshot() -> dict:
    """The process-wide registry snapshot."""
    return REGISTRY.snapshot()


def metrics_prefixed(prefix: str) -> dict:
    """Flat {metric: value} slice of the registry under a name prefix:
    counters and gauges verbatim, histograms as their summary dicts."""
    snap = snapshot()
    out: dict = {}
    for kind in ("counters", "gauges", "histograms"):
        for k, v in (snap.get(kind) or {}).items():
            if k.startswith(prefix):
                out[k] = v
    return out


def counters_delta(base: Optional[dict], now: dict) -> dict:
    """``now`` with its counters re-expressed as deltas over ``base``
    (zero deltas dropped). The registry is process-cumulative; a per-run
    results.json block must not re-report earlier runs' traffic as this
    run's: ``store.StoreHandle`` captures ``base`` when it is made and
    ``save_results`` diffs against it. Gauges stay current-value;
    histograms stay process-cumulative distributions. Returns {} when
    nothing beyond stale counters remains."""
    out = dict(now)
    b = (base or {}).get("counters") or {}
    if "counters" in out:
        c = {k: v - b.get(k, 0) for k, v in out["counters"].items()
             if v - b.get(k, 0)}
        if c:
            out["counters"] = c
        else:
            del out["counters"]
    return out
