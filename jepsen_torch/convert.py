"""Carry state across from another encoder.

``batch_from_arrays`` builds this package's ``EncodedBatch`` from any
object that holds an encoded batch as numpy arrays under the reference
encoder's attribute names (duck-typed: nothing is imported from the
producer). It lets one encoding feed both packages, and lets a caller
hand a batch encoded elsewhere to the CUDA kernel. ``cols_from_arrays``
does the same for a columnar batch of histories (history.columnar), and
``graph_bucket_from_arrays`` for a bucket of packed dependency graphs
(ops.graph), ``dc_plan_from_arrays`` for a peel-loop plan
(ops.dc_monitor). Router rates cross over as the plain dict they are
(``fleet.set_measured_rates``).
Frontier carries cross over through
``ops.linearize.import_frontier``/``export_frontier``, which keep the
reference's journal format. A synthetic batch crosses by its spec: a
``SynthSpec`` with the same fields names the same batch in both
packages.
"""
from __future__ import annotations

import numpy as np

from .history.columnar import ColumnarOps
from .ops.dc_monitor import DCPlan
from .ops.encode import EncodedBatch
from .ops.graph import GraphBucket


def batch_from_arrays(src) -> EncodedBatch:
    """An ``EncodedBatch`` from ``src.ev_type, ev_slot, ev_slots,
    ev_opidx, target, V, W, shared_target, w_live`` (and ``indices`` when
    present). The arrays are copied; ``spaces`` stays empty, since state
    spaces are the producer's objects — decode such a batch's frontiers
    with the producer's spaces, or re-encode here."""
    B = int(np.asarray(src.ev_type).shape[0])
    indices = getattr(src, "indices", None)
    return EncodedBatch(
        ev_type=np.array(src.ev_type, np.int8),
        ev_slot=np.array(src.ev_slot, np.int8),
        ev_slots=np.array(src.ev_slots),
        ev_opidx=np.array(src.ev_opidx, np.int32),
        target=np.array(src.target, np.int32),
        V=int(src.V), W=int(src.W),
        indices=list(indices) if indices is not None else list(range(B)),
        failures=[], spaces=None,
        shared_target=bool(src.shared_target), w_live=int(src.w_live))


def cols_from_arrays(src) -> ColumnarOps:
    """A ``ColumnarOps`` from ``src.type, process, kind, kinds`` and, when
    present and not None, ``index`` and ``key``. The arrays are copied
    at the columnar contract's dtypes; generator metadata stays behind
    (it is advisory)."""
    def opt(name):
        a = getattr(src, name, None)
        return None if a is None else np.array(a, np.int32)

    return ColumnarOps(type=np.array(src.type, np.int8),
                       process=np.array(src.process, np.int16),
                       kind=np.array(src.kind, np.int32),
                       kinds=[tuple(k) for k in src.kinds],
                       index=opt("index"), key=opt("key"))


def graph_bucket_from_arrays(src) -> GraphBucket:
    """A ``GraphBucket`` from ``src.adj`` (packed [B, L, V, words(V)]
    words, uint32 or int32), ``src.V`` and ``src.indices``. The words are
    copied as int32 bit patterns, the port's form of the reference's
    uint32 packing."""
    adj = np.array(src.adj)
    return GraphBucket(adj=adj.view(np.int32) if adj.dtype == np.uint32
                       else adj.astype(np.int32),
                       V=int(src.V), indices=list(src.indices))


def dc_plan_from_arrays(src) -> DCPlan:
    """A ``DCPlan`` from ``src.inv``, ``cluster``, ``active`` and
    ``capable``, copied at the plan's dtypes (int32, int32, bool,
    bool)."""
    return DCPlan(inv=np.array(src.inv, np.int32),
                  cluster=np.array(src.cluster, np.int32),
                  active=np.array(src.active, bool),
                  capable=np.array(src.capable, bool))
