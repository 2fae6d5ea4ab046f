"""The port's three live monitors against the reference's, on every
prefix, on the CPU.

  * ``IncrementalClosure`` (jepsen_torch.ops.graph): seeded typed edge
    streams; at every edge the packed closure planes, the cyclic levels,
    the verdict and the stats equal the reference's, and the verdict
    equals the port's from-scratch host oracle ``check_graph_host``.
  * ``IncrementalIsolation`` (jepsen_torch.isolation): the seeded txn
    histories of each anomaly fed one op at a time (and in the daemon's
    chunks); the level, abbreviation and stats equal the reference's,
    and the level is the running minimum of the port's host
    certification ``check_txn_host``.
  * ``IncrementalDC`` (jepsen_torch.ops.dc_monitor): read/write register
    streams, clean and stale; every prefix answers as the reference's
    (certified, not served, latched), and a prefix it certifies is one
    the exact host engine finds linearizable: it never certifies a
    violation.

The same seeded JSON op lines go into both packages. Tolerance: none.
"""
import json
import random

import numpy as np
import pytest
import torch

from jepsen_tpu.history.codec import loads_op as r_loads
from jepsen_tpu.isolation import IncrementalIsolation as RIso
from jepsen_tpu.ops import dc_monitor as RDC
from jepsen_tpu.ops.graph import IncrementalClosure as RClosure
from jepsen_tpu.workloads.synth import synth_rw_history

from jepsen_torch.checkers.linearizable import wgl_check
from jepsen_torch.history.codec import dumps_op, loads_op as p_loads
from jepsen_torch.isolation import IncrementalIsolation
from jepsen_torch.models.core import cas_register
from jepsen_torch.online import checkable_prefix
from jepsen_torch.ops import dc_monitor as PDC
from jepsen_torch.ops.graph import (EDGE_TYPES, LEVELS, DepGraph,
                                    IncrementalClosure, check_graph_host)
from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_history
from jepsen_torch.ops.txn_graph import (LADDER, check_txn_host,
                                        extract_txn_graph, iso_abbrev)

torch.set_num_threads(1)

MODEL = cas_register()


def both(lines):
    return [r_loads(x) for x in lines], [p_loads(x) for x in lines]


# ------------------------------------------------------ the closure

@pytest.mark.parametrize("seed", range(4))
def test_closure_every_edge_matches_reference_and_host_oracle(seed):
    rng = random.Random(seed)
    for trial in range(3):
        n = rng.randint(2, 40)          # crosses the 8, 16 and 32 buckets
        p, r = IncrementalClosure(), RClosure()
        typed = {t: [] for t in EDGE_TYPES}
        prev = None
        for _ in range(rng.randint(10, 60)):
            t = rng.choice(EDGE_TYPES)
            u, v = rng.randrange(n), rng.randrange(n)
            p.add_edge(t, u, v)
            r.add_edge(t, u, v)
            typed[t].append((u, v))
            np.testing.assert_array_equal(p._C, r._C)
            assert p.cyclic_levels() == r.cyclic_levels()
            assert p.stats == r.stats and (p.n, p.cols) == (r.n, r.cols)
            edges = {ty: np.array(sorted(set(ps)), np.int64).reshape(-1, 2)
                     for ty, ps in typed.items()}
            want = check_graph_host(DepGraph(n=p.n, edges=edges,
                                             meta={}))["anomaly"]
            got = p.anomaly()
            assert got == want == r.anomaly(), (seed, trial)
            if prev is not None:        # monotone: only moves earlier
                assert got is not None
                assert LEVELS.index(got) <= LEVELS.index(prev)
            prev = got


def test_closure_reaches_and_bucket_growth_match_reference():
    p, r = IncrementalClosure(), RClosure()
    for t, u, v in (("wr", 0, 5), ("wr", 5, 7), ("wr", 7, 11),
                    ("ww", 0, 5), ("rw", 11, 0)):
        p.add_edge(t, u, v)
        r.add_edge(t, u, v)
    assert p.cols == r.cols == 16 and p.stats["recloses"] == 1
    assert p.stats == r.stats and p.anomaly() == r.anomaly() == "G2"
    for li in range(3):
        for u in range(12):
            for v in range(12):
                assert p.reaches(li, u, v) == r.reaches(li, u, v)


# ---------------------------------------------------- the isolation

ANOMALIES = [None, "write-skew", "phantom", "lost-update", "fractured-read",
             "aborted-read", "intermediate-read", "dirty-write"]


@pytest.mark.parametrize("anomaly", ANOMALIES)
def test_isolation_every_prefix_matches_reference(anomaly):
    ops, _ = synth_txn_history(TxnSpec(n_txns=5, seed=2, anomaly=anomaly), 0)
    r_ops, p_ops = both([dumps_op(o) for o in ops])
    p, r = IncrementalIsolation(), RIso()
    floor = len(LADDER) - 1
    for i in range(len(p_ops)):
        got = p.observe([p_ops[i]])
        assert got == r.observe([r_ops[i]]), (anomaly, i)
        assert p.abbrev() == r.abbrev() == iso_abbrev(got)
        host = check_txn_host(extract_txn_graph(p_ops[:i + 1]))["level"]
        floor = min(floor, LADDER.index(host))
        assert got == LADDER[floor], (anomaly, i)
    assert p.stats == r.stats


@pytest.mark.parametrize("chunk", [3, 7])
def test_isolation_chunked_feed_matches_reference(chunk):
    """The daemon's cadence: chunks of ops per tick, on a mix batch."""
    spec = TxnSpec(n=6, seed=5, n_txns=8, anomaly="mix")
    for i in range(spec.n):
        ops, _ = synth_txn_history(spec, i)
        r_ops, p_ops = both([dumps_op(o) for o in ops])
        p, r = IncrementalIsolation(), RIso()
        for lo in range(0, len(p_ops), chunk):
            assert p.observe(p_ops[lo:lo + chunk]) == \
                r.observe(r_ops[lo:lo + chunk]), (i, lo)
        assert p.stats == r.stats
        assert p.level() == check_txn_host(extract_txn_graph(p_ops))["level"]


# -------------------------------------------------------------- dc

def rw_lines(seed, stale):
    h = synth_rw_history(seed, n_procs=4 + seed % 4, n_ops=30, stale=stale)
    return [json.dumps(o.to_dict()) for o in h]


@pytest.mark.parametrize("seed,stale", [(0, 0.0), (1, 0.0), (2, 0.5),
                                        (3, 0.5), (4, 0.3)])
def test_dc_every_prefix_matches_reference_and_never_certifies_a_violation(
        seed, stale):
    r_ops, p_ops = both(rw_lines(seed, stale))
    p, r = PDC.IncrementalDC(), RDC.IncrementalDC()
    served = 0
    for k in range(1, len(p_ops) + 1):
        got = p.advance(p_ops[:k])
        assert got == r.advance(r_ops[:k]), (seed, k)
        assert (p.pos, p.dead, p.seals, p.sealed_values, p.ops,
                p.last_delta_ops) == (r.pos, r.dead, r.seals,
                                      r.sealed_values, r.ops,
                                      r.last_delta_ops), (seed, k)
        if got:
            served += 1
            assert wgl_check(MODEL, checkable_prefix(p_ops[:k]))[
                "valid"] is True, (seed, k)
    assert served, "the monitor served no prefix"


def test_dc_latches_where_the_reference_does():
    """A cas, a read of the initial state, a fail and a stale read of a
    sealed value each latch both monitors dead."""
    def pair(proc, f, v, typ="ok"):
        return [json.dumps({"process": proc, "type": "invoke", "f": f,
                            "value": None if f == "read" else v}),
                json.dumps({"process": proc, "type": typ, "f": f,
                            "value": v})]
    cases = [pair(0, "cas", [1, 2]),
             pair(0, "read", None),
             pair(0, "write", 1) + pair(1, "write", 2, typ="fail"),
             pair(0, "write", 1) + pair(1, "write", 2) + pair(2, "read", 1)]
    for lines in cases:
        r_ops, p_ops = both(lines)
        p, r = PDC.IncrementalDC(), RDC.IncrementalDC()
        for k in range(1, len(p_ops) + 1):
            assert p.advance(p_ops[:k]) == r.advance(r_ops[:k])
        assert p.dead and r.dead
        assert p.advance(p_ops) is None


def test_online_dc_switch(monkeypatch):
    monkeypatch.delenv("JT_ONLINE_DC", raising=False)
    assert PDC.online_dc_enabled() is RDC.online_dc_enabled() is False
    monkeypatch.setenv("JT_ONLINE_DC", "1")
    assert PDC.online_dc_enabled() is RDC.online_dc_enabled() is True
