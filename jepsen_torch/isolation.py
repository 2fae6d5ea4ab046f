"""Isolation-ladder certification: the txn family's batch certifier and
its Checker adapters — the port of the reference's ``isolation.py``.

``certify_batch`` is the check_graphs_batch twin for transactional
histories: one call certifies a corpus at the highest isolation level
each history satisfies (ops.txn_graph), the ladder's 5 cycle planes
closed on the card by the closure kernel's txn entry through the
parameterized ops.schedule.GraphScheduler. ``JT_TXN_DEVICE=0`` is the
restore switch: every history certifies on the host oracle
``check_txn_host`` and nothing is launched. The reference's checker
nemesis and chunk journal come with the fault-ladder slice, and its live
monitor (IncrementalIsolation) with the online slice.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

from .checkers.core import Checker
from .checkers.cycle import _refuse_ladder
from .ops.graph import DepGraph
from .ops.txn_graph import (N_CYC_PLANES, check_txn_host, close_txn_planes,
                            encode_txn_graphs, extract_txn_graph,
                            iso_abbrev, ladder_verdict, refine_txn_witness,
                            txn_op_model, txn_result)

__all__ = ["certify_batch", "certify_host", "IsolationChecker",
           "HostIsolationChecker", "iso_abbrev"]


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
    input (ops.txn_graph.txn_result shape), rows tagged ``device``, or
    ``host`` under JT_TXN_DEVICE=0. ``stats_out`` and ``timings`` as in
    checkers.cycle.check_graphs_batch."""
    from .ops.schedule import GraphScheduler
    _refuse_ladder(faults, journal)
    if not device_enabled():
        return certify_host(items)
    t0 = time.perf_counter()
    graphs = _as_graphs(items)
    t1 = time.perf_counter()
    sch = GraphScheduler(family="txn", kernel=close_txn_planes,
                         levels=N_CYC_PLANES, op_model=txn_op_model,
                         device=device, **(scheduler_opts or {}))
    buckets = encode_txn_graphs(graphs)
    t2 = time.perf_counter()
    results: List[Optional[dict]] = [None] * len(graphs)
    refine_s = 0.0
    for bucket, (cyc, node) in sch.run(buckets):
        tr = time.perf_counter()
        for r, i in enumerate(bucket.indices):
            results[i] = _decide(graphs[i], cyc[r], "device")
        refine_s += time.perf_counter() - tr
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
