"""Happens-before cycle checker: Adya anomaly detection behind the
Checker protocol — the port of the reference's ``checkers/cycle.py``.

``CycleChecker`` decides register / list-append / Adya-G2 histories by
typed-dependency-graph cycle search on the card (the closure kernel of
ops.graph, scheduled by ops.schedule.GraphScheduler), with a pure-host
DFS oracle twin (``HostCycleChecker``) as the parity reference.

``check_graphs_batch`` is the batch seam: one call decides a whole
corpus of graphs, chunk by chunk, and refines each cyclic graph on the
host into a minimal witness cycle (ops.graph.refine_witness). The
reference's checker nemesis (``faults=``) and chunk journal
(``journal=``) come with the fault-ladder slice and are refused here.
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


def _refuse_ladder(faults, journal) -> None:
    if faults is not None or journal is not None:
        raise NotImplementedError(
            "the checker nemesis (faults=) and the chunk journal "
            "(journal=) come with the fault-ladder slice (ROADMAP item "
            "4b), which is not part of jepsen_torch yet")


def check_graphs_batch(items: Sequence, *, family: Optional[str] = None,
                       faults=None, journal=None,
                       scheduler_opts: Optional[dict] = None,
                       stats_out: Optional[dict] = None,
                       timings: Optional[dict] = None,
                       device=None) -> List[dict]:
    """Decide a batch of histories (or pre-extracted DepGraphs) by
    transitive closure on ``device`` (the card unless the caller names
    another); returns one result dict per input (ops.graph.graph_result
    shape), every row tagged ``device``.

    ``stats_out`` — filled with the scheduler's stats (graphs, chunks,
    closure_matmuls, mxu_macs, the ladder's counters at 0).
    ``timings`` — filled with host-clock seconds: ``extract_s``,
    ``encode_s``, the scheduler's ``upload_s``, ``launch_s``,
    ``copy_back_s`` and ``validate_s``, and ``refine_s`` (the result
    dicts with their witness cycles).
    """
    from ..ops.schedule import GraphScheduler
    _refuse_ladder(faults, journal)
    t0 = time.perf_counter()
    graphs = _as_graphs(items, family)
    t1 = time.perf_counter()
    sch = GraphScheduler(device=device, **(scheduler_opts or {}))
    buckets = encode_graphs(graphs)
    t2 = time.perf_counter()
    results: List[Optional[dict]] = [None] * len(graphs)
    refine_s = 0.0
    for bucket, (cyc, node) in sch.run(buckets):
        tr = time.perf_counter()
        for r, i in enumerate(bucket.indices):
            g = graphs[i]
            c = cyc[r]
            if c.any():
                li = int(np.argmax(c))
                results[i] = graph_result(g, LEVELS[li],
                                          refine_witness(g, li), "device")
            else:
                results[i] = graph_result(g, None, None, "device")
        refine_s += time.perf_counter() - tr
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
