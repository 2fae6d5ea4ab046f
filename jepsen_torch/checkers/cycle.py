"""Happens-before cycle checker: Adya anomaly detection behind the
Checker protocol — the port of the reference's ``checkers/cycle.py``.

``CycleChecker`` decides register / list-append / Adya-G2 histories by
typed-dependency-graph cycle search on the card (the closure kernel of
ops.graph, scheduled by ops.schedule.GraphScheduler), with a pure-host
DFS oracle twin (``HostCycleChecker``) as the parity reference.

``check_graphs_batch`` is the batch seam: one call decides a whole
corpus of graphs, chunk by chunk, and refines each cyclic graph on the
host into a minimal witness cycle (ops.graph.refine_witness), under the
scheduler's degradation ladder (``faults=``, the checker nemesis) and
the chunk journal (``journal=``): rows the ladder quarantines are
re-decided by the host oracle, rows a journal holds are not dispatched
again.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..ops.graph import (DepGraph, LEVELS, check_graph_host, encode_graphs,
                         extract_graph, graph_result, refine_witness)
from .core import Checker


def _as_graphs(items, family: Optional[str]) -> List[DepGraph]:
    return [g if isinstance(g, DepGraph) else extract_graph(g, family)
            for g in items]


def _rehydrate(g: DepGraph, valid, bad, prov) -> dict:
    """A journal-resumed verdict: bare (the journal stores the anomaly
    class, not the refined cycle), as in the WGL resume."""
    anomaly = None if valid else LEVELS[int(bad)]
    out = graph_result(g, anomaly, None, prov)
    out["valid"] = bool(valid)      # the journal is authoritative
    out["resumed"] = True
    return out


def _chunk_recorder(sch, journal):
    """on_chunk hook journaling graph verdicts as chunks retire;
    ``bad`` holds the anomaly's level index. Quarantined rows carry
    inert placeholders: they journal when the host oracle decides
    them."""
    def on_chunk(bucket, lo, hi, cyc, node):
        rows, vals, bads, provs = [], [], [], []
        for r in range(lo, hi):
            i = bucket.indices[r]
            if i in sch.quarantined:
                continue
            c = cyc[r - lo]
            rows.append(i)
            vals.append(not c.any())
            bads.append(int(np.argmax(c)) if c.any() else None)
            provs.append(sch.row_provenance.get(i, "device"))
        if rows:
            journal.record(rows, vals, bads, provs)
    return on_chunk


def check_graphs_batch(items: Sequence, *, family: Optional[str] = None,
                       faults=None, journal=None,
                       scheduler_opts: Optional[dict] = None,
                       stats_out: Optional[dict] = None,
                       timings: Optional[dict] = None,
                       device=None) -> List[dict]:
    """Decide a batch of histories (or pre-extracted DepGraphs) by
    transitive closure on ``device`` (the card unless the caller names
    another); returns one result dict per input (ops.graph.graph_result
    shape), every row tagged ``device`` / ``device-retried`` /
    ``host-fallback``.

    ``faults`` — a FaultInjector (the checker nemesis) at the
    scheduler's stage boundaries; rows the ladder quarantines are
    decided by the host oracle (``check_graph_host``), tagged
    ``host-fallback`` with their ``quarantine_reason``. ``journal`` — a
    store.ChunkJournal: rows it already holds come back as bare
    ``resumed`` verdicts and are never encoded, and retired chunks
    journal as they decode.
    ``stats_out`` — filled with the scheduler's stats (graphs, chunks,
    closure_matmuls, mxu_macs, the ladder's counters).
    ``timings`` — filled with host-clock seconds: ``extract_s``,
    ``encode_s``, the scheduler's ``upload_s``, ``launch_s``,
    ``copy_back_s`` and ``validate_s``, and ``refine_s`` (the result
    dicts with their witness cycles).
    """
    from ..ops.schedule import GraphScheduler
    t0 = time.perf_counter()
    graphs = _as_graphs(items, family)
    t1 = time.perf_counter()
    results: List[Optional[dict]] = [None] * len(graphs)
    if journal is not None:
        for i, (valid, bad, prov) in journal.decided().items():
            if 0 <= i < len(graphs):
                results[i] = _rehydrate(graphs[i], valid, bad, prov)
    todo = [i for i, r in enumerate(results) if r is None]
    sch = GraphScheduler(faults=faults, device=device,
                         **(scheduler_opts or {}))
    if journal is not None:
        sch.on_chunk = _chunk_recorder(sch, journal)
    buckets = encode_graphs([graphs[i] for i in todo], indices=todo)
    t2 = time.perf_counter()
    refine_s = 0.0
    for bucket, (cyc, node) in sch.run(buckets):
        tr = time.perf_counter()
        for r, i in enumerate(bucket.indices):
            if i in sch.quarantined:
                continue           # placeholder; host-decided below
            g = graphs[i]
            c = cyc[r]
            prov = sch.row_provenance.get(i, "device")
            if c.any():
                li = int(np.argmax(c))
                results[i] = graph_result(g, LEVELS[li],
                                          refine_witness(g, li), prov)
            else:
                results[i] = graph_result(g, None, None, prov)
        refine_s += time.perf_counter() - tr
    # Quarantined graphs: the host oracle decides them, and they join
    # the journal only once truly decided.
    for i, reason in sch.quarantined.items():
        r = check_graph_host(graphs[i], provenance="host-fallback")
        r["quarantine_reason"] = reason
        results[i] = r
        if journal is not None:
            lvl = None if r["valid"] else LEVELS.index(r["anomaly"])
            journal.record([i], [r["valid"]], [lvl], ["host-fallback"])
    if stats_out is not None:
        stats_out.update(sch.stats)
    if timings is not None:
        timings.update(extract_s=t1 - t0, encode_s=t2 - t1,
                       **sch.timings, refine_s=refine_s)
    assert all(r is not None for r in results), \
        "every graph must receive a verdict"
    return results


class CycleChecker(Checker):
    """Checker-protocol adapter: one history rides a batch of one (real
    scale comes from check_graphs_batch). ``family`` pins the
    extraction rules; None auto-detects from the op vocabulary.
    ``device`` is where the closure runs (the card unless the caller
    names another)."""

    def __init__(self, family: Optional[str] = None, device=None):
        self.family = family
        self.device = device

    def check(self, test, model, history, opts=None) -> dict:
        g = extract_graph(list(history), self.family)
        return check_graphs_batch([g], device=self.device)[0]


class HostCycleChecker(CycleChecker):
    """The pure-host oracle twin (DFS, no device, no shared cycle
    machinery) — the parity reference tests compare against."""

    def check(self, test, model, history, opts=None) -> dict:
        return check_graph_host(extract_graph(list(history), self.family))


def cycle_checker(family: Optional[str] = None, device=None) -> Checker:
    return CycleChecker(family, device=device)


def host_cycle_checker(family: Optional[str] = None) -> Checker:
    return HostCycleChecker(family)
