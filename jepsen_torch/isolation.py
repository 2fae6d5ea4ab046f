"""Isolation-ladder certification: the txn family's batch certifier and
its Checker adapters — the port of the reference's ``isolation.py``.

``certify_batch`` is the check_graphs_batch twin for transactional
histories: one call certifies a corpus at the highest isolation level
each history satisfies (ops.txn_graph), the ladder's 5 cycle planes
closed on the card by the closure kernel's txn entry through the
parameterized ops.schedule.GraphScheduler. ``JT_TXN_DEVICE=0`` is the
restore switch: every history certifies on the host oracle
``check_txn_host`` and nothing is launched. The checker nemesis
(``faults=``) and the chunk journal (``journal=``, ``bad`` holding
``LADDER.index(level)``) ride the scheduler's degradation ladder as in
checkers.cycle; quarantined rows are re-decided by the host oracle.

``IncrementalIsolation`` is the online daemon's live monitor, a copy of
the reference's: as ops stream in it re-extracts the typed graph, feeds
only the NEW edges into per-plane incremental closures
(ops.graph.IncrementalClosure with the ladder masks, host numpy) plus a
derived-SI closure fed composed RW·N edges, and reports the strongest
level still holding. The verdict is monotone non-increasing: closures
only gain edges, and a retraction (an append chain reordering, a txn
changing status) rebuilds the closures with the reported level floored
at the worst already seen.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .checkers.core import Checker
from .ops.graph import DepGraph, IncrementalClosure
from .ops.txn_graph import (LADDER, N_CYC_PLANES, TXN_EDGE_TYPES,
                            TXN_LEVEL_TYPES, TXN_PLANES, check_txn_host,
                            close_txn_planes, encode_txn_graphs,
                            extract_txn_graph, iso_abbrev, ladder_verdict,
                            refine_txn_witness, txn_op_model, txn_result)

__all__ = ["certify_batch", "certify_host", "IsolationChecker",
           "HostIsolationChecker", "IncrementalIsolation", "iso_abbrev"]


def device_enabled() -> bool:
    """The JT_TXN_DEVICE restore switch (default on)."""
    return os.environ.get("JT_TXN_DEVICE", "1") != "0"


def _as_graphs(items) -> List[DepGraph]:
    return [g if isinstance(g, DepGraph) else extract_txn_graph(g)
            for g in items]


def _decide(g: DepGraph, cyc, provenance: str) -> dict:
    """One device row → ladder verdict + host-refined witness."""
    g1a = bool(g.meta.get("g1a_reads"))
    g1b = bool(g.meta.get("g1b_reads"))
    level, anomaly, plane = ladder_verdict(g1a, g1b, cyc)
    witness = refine_txn_witness(g, anomaly, plane)
    return txn_result(g, level, anomaly, witness, provenance)


def _rehydrate(g: DepGraph, valid, bad, prov) -> dict:
    """A journal-resumed verdict: bare (level only, no witness), as in
    checkers.cycle."""
    level = "serializability" if valid else LADDER[int(bad)]
    out = txn_result(g, level, None, None, prov)
    out["valid"] = bool(valid)      # the journal is authoritative
    out["resumed"] = True
    return out


def _chunk_recorder(sch, journal, graphs):
    """on_chunk hook journaling ladder verdicts as chunks retire;
    ``bad`` holds LADDER.index(level). Quarantined rows journal only
    when the host oracle decides them."""
    def on_chunk(bucket, lo, hi, cyc, node):
        rows, vals, bads, provs = [], [], [], []
        for r in range(lo, hi):
            i = bucket.indices[r]
            if i in sch.quarantined:
                continue
            g = graphs[i]
            level, _, _ = ladder_verdict(
                bool(g.meta.get("g1a_reads")),
                bool(g.meta.get("g1b_reads")), cyc[r - lo])
            valid = level == "serializability"
            rows.append(i)
            vals.append(valid)
            bads.append(None if valid else LADDER.index(level))
            provs.append(sch.row_provenance.get(i, "device"))
        if rows:
            journal.record(rows, vals, bads, provs)
    return on_chunk


def certify_host(items: Sequence) -> List[dict]:
    """Host-oracle certification for a batch (the JT_TXN_DEVICE=0
    path)."""
    return [check_txn_host(g) for g in _as_graphs(items)]


def certify_batch(items: Sequence, *, faults=None, journal=None,
                  scheduler_opts: Optional[dict] = None,
                  stats_out: Optional[dict] = None,
                  timings: Optional[dict] = None,
                  device=None) -> List[dict]:
    """Certify a batch of transactional histories (or pre-extracted
    DepGraphs) at their highest satisfied isolation level on ``device``
    (the card unless the caller names another); one result dict per
    input (ops.txn_graph.txn_result shape), rows tagged ``device`` /
    ``device-retried`` / ``host-fallback``, or ``host`` under
    JT_TXN_DEVICE=0. ``faults``, ``journal``, ``stats_out`` and
    ``timings`` as in checkers.cycle.check_graphs_batch."""
    from .ops.schedule import GraphScheduler
    if not device_enabled():
        graphs = _as_graphs(items)
        results = certify_host(graphs)
        if journal is not None:
            for i, r in enumerate(results):
                bad = None if r["valid"] else LADDER.index(r["level"])
                journal.record([i], [r["valid"]], [bad], ["host"])
        return results
    t0 = time.perf_counter()
    graphs = _as_graphs(items)
    t1 = time.perf_counter()
    results: List[Optional[dict]] = [None] * len(graphs)
    if journal is not None:
        for i, (valid, bad, prov) in journal.decided().items():
            if 0 <= i < len(graphs):
                results[i] = _rehydrate(graphs[i], valid, bad, prov)
    todo = [i for i, r in enumerate(results) if r is None]
    sch = GraphScheduler(faults=faults, family="txn",
                         kernel=close_txn_planes, levels=N_CYC_PLANES,
                         op_model=txn_op_model, device=device,
                         **(scheduler_opts or {}))
    if journal is not None:
        sch.on_chunk = _chunk_recorder(sch, journal, graphs)
    buckets = encode_txn_graphs([graphs[i] for i in todo], indices=todo)
    t2 = time.perf_counter()
    refine_s = 0.0
    for bucket, (cyc, node) in sch.run(buckets):
        tr = time.perf_counter()
        for r, i in enumerate(bucket.indices):
            if i in sch.quarantined:
                continue           # placeholder; host-decided below
            results[i] = _decide(graphs[i], cyc[r],
                                 sch.row_provenance.get(i, "device"))
        refine_s += time.perf_counter() - tr
    for i, reason in sch.quarantined.items():
        r = check_txn_host(graphs[i], provenance="host-fallback")
        r["quarantine_reason"] = reason
        results[i] = r
        if journal is not None:
            bad = None if r["valid"] else LADDER.index(r["level"])
            journal.record([i], [r["valid"]], [bad], ["host-fallback"])
    if stats_out is not None:
        stats_out.update(sch.stats)
    if timings is not None:
        timings.update(extract_s=t1 - t0, encode_s=t2 - t1,
                       **sch.timings, refine_s=refine_s)
    assert all(r is not None for r in results), \
        "every history must receive a verdict"
    return results


class IsolationChecker(Checker):
    """Checker-protocol adapter: one history rides a batch of one (real
    scale comes from certify_batch). ``device`` is where the closure
    runs (the card unless the caller names another)."""

    def __init__(self, device=None):
        self.device = device

    def check(self, test, model, history, opts=None) -> dict:
        g = extract_txn_graph(list(history))
        if not device_enabled():
            return check_txn_host(g)
        return certify_batch([g], device=self.device)[0]


class HostIsolationChecker(IsolationChecker):
    """The pure-host oracle twin (DFS per plane + the A_SI relation; no
    device, no shared cycle machinery)."""

    def check(self, test, model, history, opts=None) -> dict:
        return check_txn_host(extract_txn_graph(list(history)))


# ----------------------------------------------------- live monitoring

class IncrementalIsolation:
    """Monotone live isolation verdict over a growing txn history.

    Each ``observe(new_ops)`` call appends to the buffered history,
    re-extracts the typed dependency graph (a linear host pass — the
    expensive O(V^3) closure is what stays incremental), diffs the
    edge set against what the closures already hold, and feeds ONLY
    the new edges: the 4 packed ladder planes ride one parameterized
    IncrementalClosure and the derived SI plane a second single-plane
    closure fed N edges plus composed RW·N edges (bookkeeping below).
    A retraction — an edge that disappeared because an append chain
    reordered or a txn changed status under info-visibility — resets
    and refeeds both closures (counted in ``stats["rebuilds"]``).

    ``level()`` is the strongest ladder level still holding. It is
    monotone non-increasing by construction: closures only gain
    edges between rebuilds, the G1 flags latch, and the reported
    level is floored at the worst level already reported (so even a
    rebuild can never raise it)."""

    def __init__(self):
        self._ops: List = []
        self._fed: Set[Tuple[str, int, int]] = set()
        self._planes = IncrementalClosure(level_types=TXN_LEVEL_TYPES,
                                          names=TXN_PLANES)
        self._si = IncrementalClosure(level_types=(("e",),),
                                      names=("G-SI",))
        self._rw_in: Dict[int, Set[int]] = {}
        self._n_out: Dict[int, Set[int]] = {}
        self._g1a = False
        self._g1b = False
        self._floor = len(LADDER) - 1          # best = serializability
        self._malformed = False
        self.stats = {"ops": 0, "ticks": 0, "edges": 0, "rebuilds": 0}

    # ------------------------------------------------------- plumbing
    def _feed(self, t: str, u: int, v: int) -> None:
        self.stats["edges"] += 1
        self._planes.add_edge(t, u, v)
        if t in ("rwi", "rwp"):
            self._rw_in.setdefault(v, set()).add(u)
            for w in sorted(self._n_out.get(v, ())):
                self._si.add_edge("e", u, w)
        else:
            self._n_out.setdefault(u, set()).add(v)
            self._si.add_edge("e", u, v)
            for p in sorted(self._rw_in.get(u, ())):
                self._si.add_edge("e", p, v)

    def _rebuild(self, edges: Set[Tuple[str, int, int]]) -> None:
        self.stats["rebuilds"] += 1
        self._planes = IncrementalClosure(level_types=TXN_LEVEL_TYPES,
                                          names=TXN_PLANES)
        self._si = IncrementalClosure(level_types=(("e",),),
                                      names=("G-SI",))
        self._rw_in, self._n_out = {}, {}
        for t, u, v in sorted(edges):
            self._feed(t, u, v)

    # -------------------------------------------------------- updates
    def observe(self, new_ops: Sequence) -> Optional[str]:
        """Fold newly-streamed ops in; returns level() (None when the
        buffered history is malformed → verdict unknown)."""
        self._ops.extend(new_ops)
        self.stats["ops"] += len(new_ops)
        self.stats["ticks"] += 1
        try:
            g = extract_txn_graph(self._ops)
        except ValueError:
            self._malformed = True
            return self.level()
        self._malformed = False
        edges = {(t, int(u), int(v)) for t in TXN_EDGE_TYPES
                 for u, v in g.edges.get(t, ())}
        if self._fed <= edges:
            for t, u, v in sorted(edges - self._fed):
                self._feed(t, u, v)
        else:
            self._rebuild(edges)
        self._fed = edges
        self._g1a = self._g1a or bool(g.meta.get("g1a_reads"))
        self._g1b = self._g1b or bool(g.meta.get("g1b_reads"))
        cyc = self._planes.cyclic_levels() + self._si.cyclic_levels()
        level, _, _ = ladder_verdict(self._g1a, self._g1b, cyc)
        self._floor = min(self._floor, LADDER.index(level))
        return self.level()

    # -------------------------------------------------------- verdict
    def level(self) -> Optional[str]:
        """The strongest ladder level still holding, or None while the
        buffered history is malformed (verdict unknown)."""
        if self._malformed:
            return None
        return LADDER[self._floor]

    def abbrev(self) -> str:
        return iso_abbrev(self.level())
