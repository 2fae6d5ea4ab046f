"""Cost-based routing of checkable units across the port's backends.

The router half of the reference's ``fleet.py``: each unit of a mixed
corpus (a linearizable history, a dependency graph, a transactional
history) is priced per backend from measured rates, and ``route_check``
sends each backend group to its checker as one batch:

  * ``wgl-device`` — the frontier search (``check_batch_columnar`` with
    ``wgl_backend="xla"``: the search alone, K1/K2f), paying ``2^W``
    frontier lanes per event;
  * ``wgl-dc`` — the same pipeline with the peel pre-filter pinned on
    (``wgl_backend="dc"``, K4), W-flat, priced only for register-class
    units and only once its rate was measured;
  * ``host-oracle`` — the exact host search in C++,
    ``native.check_batch_native`` (the twin of ``wgl_check``, as the
    reference's group runs its native engine), near W-flat per event;
  * ``graph-device`` / ``graph-host`` — the closure kernel
    (``check_graphs_batch``) or the host DFS (``check_graph_host``);
  * ``txn-device`` / ``txn-host`` — the isolation ladder
    (``certify_batch``) or its host oracle (``check_txn_host``).

Rates: defaults < probe-measured overlay (``probe_and_persist``,
``set_measured_rates``, a store's persisted per-host file) < explicit env
pins. The reference's Pallas term never prices here: its two TPU forms
of the frontier search are one CUDA kernel, and the probe reports
``pallas_lane_ops_per_s`` 0.0, as an unprobed reference does.

``CostRouter`` and ``route_check`` take ``device=``, passed on to the
dispatch-overhead probe and to every checker: the card unless the caller
names another. Leases, workers and campaigns are not part of the port
yet.
"""
from __future__ import annotations

import json
import os
import socket
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .ops.device import resolve_device

# Process-wide probe-measured rate overlay (probe_and_persist /
# set_measured_rates): defaults < measured < explicit env pins.
_MEASURED_RATES: Dict[str, float] = {}

# Rate keys and the env pins that override them.
_RATE_ENV = (("lane_ops_per_s", "JT_DISPATCH_COST_LANE_OPS_PER_S"),
             ("host_s_per_event", "JT_HOST_S_PER_EVENT"),
             ("macs_per_s", "JT_GRAPH_MACS_PER_S"),
             ("graph_host_s_per_edge", "JT_GRAPH_HOST_S_PER_EDGE"),
             ("pallas_lane_ops_per_s", "JT_PALLAS_LANE_OPS_PER_S"),
             ("dc_events_per_s", "JT_DC_EVENTS_PER_S"),
             ("ingest", "JT_INGEST_OPS_PER_S"))


def set_measured_rates(rates: Optional[Dict[str, float]]) -> None:
    """Install probe-measured per-backend rates as the process-wide
    overlay every fresh CostRouter prices from (None or {} clears). Only
    known rate keys with truthy values apply: a failed probe never
    zeroes a working default."""
    _MEASURED_RATES.clear()
    if rates:
        known = {k for k, _ in _RATE_ENV}
        _MEASURED_RATES.update({k: float(v) for k, v in rates.items()
                                if k in known and v})


def router_rates() -> Dict[str, float]:
    """The rates the router prices against. ``lane_ops_per_s`` is the
    scheduler's dispatch-cost rate; ``host_s_per_event`` the host
    oracle's near-W-flat per-event cost; ``macs_per_s`` the closure's;
    ``graph_host_s_per_edge`` the host DFS's; ``pallas_lane_ops_per_s``
    and ``dc_events_per_s`` 0 when unprobed, which prices their terms
    out; ``ingest`` is read by no router term (kept for the reference's
    rate files). Precedence: defaults < probe-measured overlay < env
    pins."""
    from .ops.schedule import DISPATCH_COST_LANE_OPS_PER_S

    out = {
        "lane_ops_per_s": DISPATCH_COST_LANE_OPS_PER_S,
        "host_s_per_event": 4e-4,
        "macs_per_s": 1e12,
        "graph_host_s_per_edge": 2e-6,
        "pallas_lane_ops_per_s": 0.0,
        "dc_events_per_s": 0.0,
        "ingest": 0.0,
    }
    out.update(_MEASURED_RATES)
    for key, env in _RATE_ENV:
        v = os.environ.get(env)
        if v is not None:
            try:
                out[key] = float(v)
            except ValueError:
                pass
    return out


# ------------------------------ probe-refreshed, store-persisted rates

ROUTER_RATES_DIR = "router-rates"

_PROBED_RATES: Optional[Dict[str, float]] = None


def _read_json(path) -> Optional[dict]:
    try:
        return json.loads(Path(path).read_text())
    except Exception:
        return None


def _atomic_write_json(path: Path, obj) -> None:
    """Write ``obj`` as JSON through a temporary file and a rename, so
    that a reader never sees half a file."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj, indent=2, sort_keys=True))
    os.replace(tmp, path)


def rates_path(store_dir, host: Optional[str] = None) -> Path:
    """This host's rate file: one file per host, so that workers on
    different hosts never race each other's calibration."""
    host = host or socket.gethostname()
    safe = "".join(c if c.isalnum() or c in "-._" else "_"
                   for c in host) or "unknown-host"
    return Path(store_dir) / ROUTER_RATES_DIR / f"{safe}.json"


def persist_rates(store_dir, rates: Dict[str, float],
                  host: Optional[str] = None) -> Path:
    """Record this host's measured rates in the store (one JSON file per
    host name); only known rate keys persist."""
    path = rates_path(store_dir, host)
    path.parent.mkdir(parents=True, exist_ok=True)
    known = {k for k, _ in _RATE_ENV}
    _atomic_write_json(path, {
        "host": host or socket.gethostname(),
        "rates": {k: float(v) for k, v in rates.items()
                  if k in known and v},
        "ts": time.time(),
    })
    return path


def load_persisted_rates(store_dir,
                         host: Optional[str] = None) -> Dict[str, float]:
    """This host's persisted rate entry (empty when it never probed:
    another host's calibration is wrong by definition on a mixed fleet,
    so there is no cross-host fallback)."""
    ent = _read_json(rates_path(store_dir, host))
    if not isinstance(ent, dict):
        return {}
    known = {k for k, _ in _RATE_ENV}
    return {k: float(v) for k, v in (ent.get("rates") or {}).items()
            if k in known and v}


def probe_and_persist(store_dir=None, *, force: bool = False,
                      device=None) -> Dict[str, float]:
    """The startup rate probe: measure the frontier search
    (``ops.linearize.probe_rates``) and the peel loop
    (``ops.dc_monitor.probe_rates``) on ``device`` (the card unless the
    caller names another), plus the host oracle's per-event cost on a
    tiny workload; install the result as the process-wide overlay
    (set_measured_rates) and persist it under this host's key when a
    store dir is given. Memoized per process; a probe that fails raises."""
    global _PROBED_RATES
    if _PROBED_RATES is None or force:
        from .checkers.linearizable import wgl_check
        from .models.core import cas_register
        from .ops.dc_monitor import probe_rates as dc_probe
        from .ops.linearize import probe_rates
        from .workloads.synth import synth_cas_history
        out = probe_rates(device=device)
        rates = {"lane_ops_per_s": out["lane_ops_per_s"],
                 "pallas_lane_ops_per_s": out["pallas_lane_ops_per_s"],
                 "dc_events_per_s":
                     dc_probe(device=device)["dc_events_per_s"]}
        hs = [synth_cas_history(7 + i, n_procs=3, n_ops=40)
              for i in range(3)]
        t0 = time.perf_counter()
        for h in hs:
            wgl_check(cas_register(), h)
        dt = time.perf_counter() - t0
        ev = sum(len(h) for h in hs)
        if ev and dt > 0:
            rates["host_s_per_event"] = dt / ev
        _PROBED_RATES = rates
    set_measured_rates(_PROBED_RATES)
    if store_dir is not None:
        persist_rates(store_dir, _PROBED_RATES)
    return dict(_PROBED_RATES)


# ------------------------------------------------------ unit features

def pending_window(history) -> int:
    """A history's peak pending window: the encoder's rule (invokes take
    a slot, only ok completions free it) as one host scan, no encode."""
    from .history.ops import INVOKE, OK

    live = peak = 0
    for op in history:
        if not op.is_client:
            continue
        if op.type == INVOKE:
            live += 1
            peak = max(peak, live)
        elif op.type == OK:
            live = max(0, live - 1)
    return peak


def estimate_w(history) -> int:
    """The unit's W after the per-key partition: KV-valued histories
    strain per key before encoding, so the device pays the widest
    per-key window, not the merged one."""
    from .independent import history_keys, subhistory

    keys = history_keys(history)
    if not keys:
        return pending_window(history)
    return max(pending_window(subhistory(k, history)) for k in keys)


def classify_history(history) -> str:
    """Which checker family decides a unit: ``txn`` for transactional
    histories (the isolation ladder), ``graph`` for list-append and
    adya-g2 vocabularies (the cycle checker), ``wgl`` for everything the
    linearizable search owns."""
    fs = {op.f for op in history if op.is_client}
    if "txn" in fs:
        return "txn"
    return "graph" if ("append" in fs or "insert" in fs) else "wgl"


# ------------------------------------------------------------ router

class CostRouter:
    """Prices each checkable unit per backend and picks the cheapest
    capable one. The device terms amortize the measured per-dispatch
    overhead (``ops.schedule.measure_dispatch_overhead_us`` on
    ``device``) over the rows that would share the dispatch. Records
    every choice for the routing summary."""

    #: W past which no frontier backend is capable (the host oracle and
    #: the peel loop stay eligible). $JT_ROUTER_MAX_W overrides.
    MAX_DEVICE_W = 22

    def __init__(self, rates: Optional[dict] = None,
                 max_device_w: Optional[int] = None,
                 store_dir=None, device=None):
        base = router_rates()
        if store_dir is not None:
            # This host's persisted probe measurements beat defaults;
            # explicit ``rates`` beat everything.
            base.update(load_persisted_rates(store_dir))
        self.rates = {**base, **(rates or {})}
        if max_device_w is not None:
            self.max_device_w = int(max_device_w)
        else:
            try:
                self.max_device_w = int(
                    os.environ.get("JT_ROUTER_MAX_W", ""))
            except ValueError:
                self.max_device_w = self.MAX_DEVICE_W
        self.device = resolve_device(device)
        self.chosen: Dict[str, int] = {}
        self.est_cost_s: Dict[str, float] = {}

    def _overhead_s(self) -> float:
        from .ops.schedule import measure_dispatch_overhead_us
        return measure_dispatch_overhead_us(self.device) * 1e-6

    # ---------------------------------------------------------- pricing
    def price_wgl(self, w: int, n_events: int,
                  rows: int = 1, *, dc: bool = False) -> Dict[str, float]:
        """Per-unit cost of a linearizable unit at window ``w`` and
        ``n_events`` history lines: the frontier search pays 2^w lanes an
        event plus its amortized dispatch overhead; the host oracle is
        near W-flat. The peel loop (``wgl-dc``) prices only when capable
        (``dc=True``: the caller sniffed a register-class unit,
        ops.dc_monitor.dc_capable_history), available ($JT_ROUTER_DC) and
        probed (``dc_events_per_s``): events / rate, no 2^w factor."""
        dev = (n_events * float(1 << min(int(w), 30))
               / self.rates["lane_ops_per_s"]
               + self._overhead_s() / max(int(rows), 1))
        host = n_events * self.rates["host_s_per_event"]
        costs = {"wgl-device": dev, "host-oracle": host}
        if dc:
            dr = float(self.rates.get("dc_events_per_s") or 0.0)
            if dr > 0:
                from .ops.dc_monitor import dc_available
                if dc_available():
                    costs["wgl-dc"] = (
                        n_events / dr
                        + self._overhead_s() / max(int(rows), 1))
        return costs

    def price_graph(self, n_vertices: int, n_edges: int,
                    rows: int = 1) -> Dict[str, float]:
        """Per-unit cost of a dependency-graph unit: the closure at
        ``mxu_op_model`` MACs for the padded vertex bucket, against the
        host DFS, linear in vertices plus edges."""
        from .ops.graph import bucket_v, mxu_op_model
        m = mxu_op_model(bucket_v(max(int(n_vertices), 1)))
        dev = (m["macs"] / self.rates["macs_per_s"]
               + self._overhead_s() / max(int(rows), 1))
        host = ((n_vertices + n_edges)
                * self.rates["graph_host_s_per_edge"])
        return {"graph-device": dev, "graph-host": host}

    def price_txn(self, n_vertices: int, n_edges: int,
                  rows: int = 1) -> Dict[str, float]:
        """Per-unit cost of a transactional unit: the ladder closure at
        ``txn_op_model`` MACs for the padded vertex bucket, against the
        host oracle, linear in vertices plus edges per plane."""
        from .ops.graph import bucket_v
        from .ops.txn_graph import N_CYC_PLANES, txn_op_model
        m = txn_op_model(bucket_v(max(int(n_vertices), 1)))
        dev = (m["macs"] / self.rates["macs_per_s"]
               + self._overhead_s() / max(int(rows), 1))
        host = (N_CYC_PLANES * (n_vertices + n_edges)
                * self.rates["graph_host_s_per_edge"])
        return {"txn-device": dev, "txn-host": host}

    def _record(self, backend: str, costs: Dict[str, float]) -> None:
        self.chosen[backend] = self.chosen.get(backend, 0) + 1
        self.est_cost_s[backend] = (self.est_cost_s.get(backend, 0.0)
                                    + costs[backend])

    def _pick_wgl(self, w: int, costs: Dict[str, float]) -> str:
        if w > self.max_device_w:
            # Past the frontier cap no 2^w backend is capable; the peel
            # loop carries no frontier, so it stays eligible.
            costs = {k: v for k, v in costs.items()
                     if k in ("host-oracle", "wgl-dc")}
        return min(costs, key=costs.get)

    def choose_wgl(self, w: int, n_events: int, rows: int = 1, *,
                   dc: bool = False) -> Tuple[str, Dict[str, float]]:
        costs = self.price_wgl(w, n_events, rows, dc=dc)
        backend = self._pick_wgl(w, costs)
        self._record(backend, costs)
        return backend, costs

    def choose_graph(self, n_vertices: int, n_edges: int,
                     rows: int = 1) -> Tuple[str, Dict[str, float]]:
        costs = self.price_graph(n_vertices, n_edges, rows)
        backend = min(costs, key=costs.get)
        self._record(backend, costs)
        return backend, costs

    def choose_txn(self, n_vertices: int, n_edges: int,
                   rows: int = 1) -> Tuple[str, Dict[str, float]]:
        costs = self.price_txn(n_vertices, n_edges, rows)
        backend = min(costs, key=costs.get)
        self._record(backend, costs)
        return backend, costs

    def wgl_check_kwargs(self, spec) -> dict:
        """Scheduler knobs for a synth batch, from the same arithmetic:
        ``min_device_batch``, the rows below which a wide bucket's
        amortized dispatch overhead makes the host engine cheaper. After
        the partition a cas spec's per-key window is bounded by its
        process count and its per-key events by 2 * n_ops / n_keys."""
        from .ops.linearize import DATA_MAX_SLOTS
        ev = max(1, 2 * spec.n_ops // max(spec.n_keys, 1))
        w = min(spec.n_procs, spec.n_ops, self.max_device_w)
        host_row = ev * self.rates["host_s_per_event"]
        dev_row = (ev * float(1 << max(int(w), DATA_MAX_SLOTS))
                   / self.rates["lane_ops_per_s"])
        if dev_row >= host_row:
            mdb = 4096                   # the host beats the scan outright
        else:
            mdb = min(4096, max(1, int(self._overhead_s()
                                       / max(host_row - dev_row, 1e-12))
                                + 1))
        return {"min_device_batch": mdb}

    def table(self, ws=(4, 8, 12, 16, 18, 20),
              events: int = 1000) -> List[dict]:
        """The router cost table: per W, each backend's price and the
        winner (the crossover made visible)."""
        out = []
        for w in ws:
            costs = self.price_wgl(w, events, dc=True)
            out.append({"W": w, "events": events,
                        "backend": self._pick_wgl(w, costs),
                        **{k: round(v, 6) for k, v in costs.items()}})
        return out

    def summary(self) -> dict:
        return {"chosen": dict(self.chosen),
                "est_cost_s": {k: round(v, 6)
                               for k, v in self.est_cost_s.items()},
                "max_device_w": self.max_device_w,
                "rates": self.rates}


def route_check(model, histories: Sequence, *,
                router: Optional[CostRouter] = None,
                details: str = "invalid",
                device=None) -> Tuple[List[dict], dict]:
    """Check a mixed corpus with every unit cost-routed: classify each
    history (wgl, graph, txn), price it, and run each backend group as
    one batch on ``device`` (the card unless the caller names another).
    Returns (per-history result dicts in input order, each tagged with
    its ``backend``, and the routing summary)."""
    device = resolve_device(device)
    router = router if router is not None else CostRouter(device=device)
    n = len(histories)
    plan: List[Tuple[int, str]] = []
    graphs: Dict[int, object] = {}
    for i, h in enumerate(histories):
        fam = classify_history(h)
        if fam == "txn":
            from .ops.txn_graph import extract_txn_graph
            g = extract_txn_graph(h)
            graphs[i] = g
            edges = sum(int(e.shape[0]) for e in g.edges.values())
            backend, _ = router.choose_txn(g.n, edges)
        elif fam == "graph":
            from .ops.graph import extract_graph
            g = extract_graph(h)
            graphs[i] = g
            edges = sum(int(e.shape[0]) for e in g.edges.values())
            backend, _ = router.choose_graph(g.n, edges)
        else:
            from .ops.dc_monitor import dc_capable_history
            backend, _ = router.choose_wgl(estimate_w(h), len(h),
                                           dc=dc_capable_history(h))
        plan.append((i, backend))
    groups: Dict[str, List[int]] = {}
    for i, backend in plan:
        groups.setdefault(backend, []).append(i)
    results: List[Optional[dict]] = [None] * n

    # The WGL device groups ride the columnar pipeline with the
    # scheduler's backend pinned to the router's group decision: letting
    # the scheduler re-price per chunk (or pick up a stray
    # JT_WGL_BACKEND) would let dispatches disagree with the plan and
    # with the results' ``backend`` tag.
    for group, forced in (("wgl-device", "xla"), ("wgl-dc", "dc")):
        if not groups.get(group):
            continue
        from .ops.linearize import check_batch_columnar
        idx = groups[group]
        rs = check_batch_columnar(
            model, [histories[i] for i in idx], details=details,
            device=device, scheduler_opts={"wgl_backend": forced})
        for i, r in zip(idx, rs):
            results[i] = r
    if groups.get("host-oracle"):
        from .native import check_batch_native
        idx = groups["host-oracle"]
        rs = check_batch_native(model, [histories[i] for i in idx])
        for i, r in zip(idx, rs):
            r.setdefault("provenance", "host-oracle")
            results[i] = r
    if groups.get("graph-device"):
        from .checkers.cycle import check_graphs_batch
        idx = groups["graph-device"]
        rs = check_graphs_batch([graphs[i] for i in idx], device=device)
        for i, r in zip(idx, rs):
            results[i] = r
    if groups.get("graph-host"):
        from .ops.graph import check_graph_host
        for i in groups["graph-host"]:
            results[i] = check_graph_host(graphs[i],
                                          provenance="host-oracle")
    if groups.get("txn-device"):
        from .isolation import certify_batch
        idx = groups["txn-device"]
        rs = certify_batch([graphs[i] for i in idx], device=device)
        for i, r in zip(idx, rs):
            results[i] = r
    if groups.get("txn-host"):
        from .ops.txn_graph import check_txn_host
        for i in groups["txn-host"]:
            results[i] = check_txn_host(graphs[i],
                                        provenance="host-oracle")
    for i, backend in plan:
        results[i]["backend"] = backend
    routing = {"units": n,
               "backends": {b: len(ix) for b, ix in groups.items()},
               **router.summary()}
    return results, routing  # type: ignore[return-value]
