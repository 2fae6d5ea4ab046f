"""The port's dependency-graph cycle checker (jepsen_torch.ops.graph,
ops.schedule.GraphScheduler, checkers.cycle) against the reference.

The same histories, built once per package from one seeded description,
go through both packages' extraction, packing and checker; the port runs
on the CPU, where the closure is the CUDA kernel's plain version
(``plain_graph_closure``), held here against the reference's
``graph_kernel(V)`` run by jax on the CPU (the kernel itself is held
against the plain version on the card by chip_smoke.py). Also mirrored
from the reference's tests/test_graphs.py: bucket and word edges, the
anomaly class order, the witness cycle, the extraction rules of the
three families and the checker protocol. Tolerance: none — edge arrays,
packed words, ``cyc``/``node`` and result dicts must be identical.
"""
import random

import numpy as np
import pytest
import torch

from jepsen_tpu.adya import G2Checker
from jepsen_tpu.checkers.cycle import check_graphs_batch as r_check
from jepsen_tpu.history import core as r_core
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.independent import KV as r_KV
from jepsen_tpu.ops import graph as R
from jepsen_tpu.workloads.synth import synth_la_history as r_la

from jepsen_torch.checkers.core import Checker
from jepsen_torch.checkers.cycle import (CycleChecker, HostCycleChecker,
                                         check_graphs_batch, cycle_checker,
                                         host_cycle_checker)
from jepsen_torch.convert import graph_bucket_from_arrays
from jepsen_torch.history import core as p_core
from jepsen_torch.history import ops as p_ops
from jepsen_torch.independent import KV as p_KV
from jepsen_torch.ops import graph as G
from jepsen_torch.ops.faults import INT32_MAX, CorruptOutput
from jepsen_torch.workloads.synth import synth_la_history

from _graph_planes import PLAN_KEYS, pack_dense, random_planes

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

# ------------------------------------------------------------- corpora

def build(events, pkg):
    """One history from (process, type, f, value) events, in either
    package's Op and KV types (``pkg`` is "ref" or "port")."""
    ops, core, kv = ((r_ops, r_core, r_KV) if pkg == "ref"
                     else (p_ops, p_core, p_KV))

    def val(v):
        return kv(*v[1]) if isinstance(v, tuple) and v[:1] == ("kv",) \
            else v
    return core.index([ops.Op(process=p, type=t, f=f, value=val(v))
                       for p, t, f, v in events])


def register_events(seed, n_ops=24, stale=False):
    """A unique-write register history (reads, writes and cas over a
    register whose every write value is fresh), ops overlapping; with
    ``stale`` one read observes an overwritten value."""
    rng = random.Random(seed)
    reg, nxt, ev, live, free = None, 1, [], {}, [0, 1, 2]
    started, written = 0, []
    while started < n_ops or live:
        if free and started < n_ops and (not live or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            f = rng.choice(("read", "write", "cas"))
            v = None
            if f == "write":
                v, nxt = nxt, nxt + 1
            elif f == "cas":
                v, nxt = [reg, nxt], nxt + 1
            ev.append((p, "invoke", f, v))
            live[p] = (f, v)
            started += 1
        else:
            p = rng.choice(sorted(live))
            f, v = live.pop(p)
            if f == "read":
                seen = reg
                if stale and len(written) >= 2 and rng.random() < 0.5:
                    seen = written[-2]
                ev.append((p, "ok", "read", seen))
            elif f == "write":
                reg = v
                written.append(v)
                ev.append((p, "ok", "write", v))
            elif v[0] == reg and reg is not None:
                reg = v[1]
                written.append(v[1])
                ev.append((p, "ok", "cas", v))
            else:
                ev.append((p, "fail", "cas", v))
            free.append(p)
    return ev


def g2_events(seed, n_keys=4):
    """Adya G2 predicate-insert histories: per key one or two committed
    inserts (two is the anomaly), some failed ones, a nemesis op."""
    rng = random.Random(seed)
    ev = [("nemesis", "info", "start", None)]
    for k in range(n_keys):
        for p in range(rng.randrange(1, 3)):
            v = ("kv", (k, [None, p]))
            ev.append((p, "invoke", "insert", v))
            ev.append((p, rng.choice(("ok", "ok", "fail")), "insert", v))
    return ev


def families():
    """(family, [(ref history, port history)]) corpora."""
    la = [(r_la(s, corrupt=1.0 if s % 7 == 0 else 0.0),
           synth_la_history(s, corrupt=1.0 if s % 7 == 0 else 0.0))
          for s in range(24)]
    la += [(r_la(s, n_ops=60, n_keys=3, corrupt=0.5),
            synth_la_history(s, n_ops=60, n_keys=3, corrupt=0.5))
           for s in range(100, 106)]
    reg = [register_events(s, stale=s % 3 == 0) for s in range(16)]
    g2 = [g2_events(s) for s in range(12)]
    return [("list-append", la),
            ("register", [(build(e, "ref"), build(e, "port")) for e in reg]),
            ("adya-g2", [(build(e, "ref"), build(e, "port")) for e in g2])]


FAMILIES = families()


def mk_graph(mod, n, **edges):
    z = np.zeros((0, 2), np.int32)
    e = {t: z for t in mod.EDGE_TYPES}
    for t, pairs in edges.items():
        e[t] = np.asarray(pairs, np.int32).reshape(-1, 2)
    return mod.DepGraph(n=n, edges=e)


def random_graph_spec(rng):
    """The reference tests' blind random typed graph: ww/wr/rw random in
    both directions, po/rt forward only."""
    n = rng.randrange(1, 41)
    edges = {}
    for t in R.EDGE_TYPES:
        density = rng.uniform(0.0, 0.9 / n)
        edges[t] = [(u, v) for u in range(n) for v in range(n)
                    if u != v and rng.random() < density
                    and (u < v or t in ("ww", "wr", "rw"))]
    return n, {t: e for t, e in edges.items() if e}


EDGE_CASES = [
    (1, {}), (1, {"ww": [(0, 0)]}), (8, {"ww": [(6, 7), (7, 6)]}),
    (9, {"ww": [(7, 8), (8, 7)]}), (9, {"ww": [(0, 8)]}),
    (33, {"wr": [(2, 32), (32, 2)]}), (33, {"rw": [(31, 32)]}),
    (5, {"ww": [(0, 1)], "rw": [(2, 3), (3, 4), (4, 2)]}),
    (4, {"wr": [(0, 1), (1, 0)]}),
    (4, {"ww": [(0, 1)], "wr": [(1, 2)], "rw": [(2, 0)]}),
    (64, {"rw": [(i, (i + 1) % 64) for i in range(64)]}),
]


def graph_pairs():
    specs = [random_graph_spec(random.Random(31_000 + s))
             for s in range(60)] + EDGE_CASES
    return [(mk_graph(R, n, **e), mk_graph(G, n, **e)) for n, e in specs]


def assert_graph_equal(p, r):
    assert p.n == r.n
    assert set(p.edges) == set(r.edges)
    for t in r.edges:
        np.testing.assert_array_equal(p.edges[t], r.edges[t])
        assert p.edges[t].dtype == r.edges[t].dtype
    assert p.meta == r.meta


def plan(stats):
    return {k: stats[k] for k in PLAN_KEYS}


# ---------------------------------------------------- history generator

@pytest.mark.parametrize("kw", [
    {}, {"corrupt": 1.0}, {"n_ops": 1000, "n_keys": 8, "corrupt": 1.0},
    {"n_ops": 30, "n_procs": 7, "n_keys": 1}], ids=str)
def test_synth_la_history_matches_reference(kw):
    for s in (0, 7, 13):
        want, got = r_la(s, **kw), synth_la_history(s, **kw)
        assert [(o.process, o.type, o.f, o.value, o.time, o.index)
                for o in got] == \
            [(o.process, o.type, o.f, o.value, o.time, o.index)
             for o in want]


# ----------------------------------------------------------- extraction

@pytest.mark.parametrize("family,corpus", FAMILIES, ids=lambda x: (
    x if isinstance(x, str) else None))
def test_extraction_matches_reference(family, corpus):
    for r_h, p_h in corpus:
        r_g = R.extract_graph(r_h, family)
        p_g = G.extract_graph(p_h, family)
        assert_graph_equal(p_g, r_g)
        # the sniffed family is the same one
        assert G.extract_graph(p_h).meta["family"] == family


def test_extraction_refusals_match_reference():
    dup = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
           (1, "invoke", "write", 1), (1, "ok", "write", 1)]
    phantom = [(0, "invoke", "read", None), (0, "ok", "read", 9)]
    la_dup = [(0, "invoke", "append", [0, 1]), (0, "ok", "append", [0, 1]),
              (1, "invoke", "read", [0, None]),
              (1, "ok", "read", [0, [1, 1]])]
    for ev, fam, msg in ((dup, "register", "unique write values"),
                         (phantom, "register", "never-written"),
                         (la_dup, "list-append", "duplicated element")):
        with pytest.raises(ValueError, match=msg):
            R.extract_graph(build(ev, "ref"), fam)
        with pytest.raises(ValueError, match=msg):
            G.extract_graph(build(ev, "port"), fam)


# --------------------------------------------------------------- packing

@pytest.mark.parametrize("family,corpus", FAMILIES, ids=lambda x: (
    x if isinstance(x, str) else None))
def test_encode_graphs_matches_reference(family, corpus):
    r_gs = [R.extract_graph(r, family) for r, _ in corpus]
    p_gs = [G.extract_graph(p, family) for _, p in corpus]
    want = [graph_bucket_from_arrays(b) for b in R.encode_graphs(r_gs)]
    got = G.encode_graphs(p_gs)
    assert [(b.V, b.indices) for b in got] == \
        [(b.V, b.indices) for b in want]
    for g, w in zip(got, want):
        assert g.adj.dtype == np.int32
        np.testing.assert_array_equal(g.adj, w.adj)
    for r_g, p_g in zip(r_gs, p_gs):
        V = R.bucket_v(r_g.n)
        np.testing.assert_array_equal(
            G.pack_graph(p_g, V), R.pack_graph(r_g, V).view(np.int32))


def test_pack_graph_bitset_layout():
    g = mk_graph(G, 33, ww=[(0, 32), (5, 31)])
    p = G.pack_graph(g, 64)
    assert p.shape == (3, 64, 2) and p.dtype == np.int32
    assert p[0, 0, 1] == 1            # column 32 -> word 1, bit 0
    assert p.view(np.uint32)[0, 5, 0] == np.uint32(1 << 31)
    assert int(np.unpackbits(p.view(np.uint8)).sum()) == 2 * 3


# ------------------------------------------------ the closure's plain form

def special_planes(V, L):
    """Empty, self-loop, single-vertex-edge and V-long-cycle planes."""
    dense = np.zeros((4, L, V, V), np.uint8)
    dense[1, :, V - 1, V - 1] = 1                   # self-loop, last vertex
    dense[2, :, 0, 1] = 1                           # one edge, acyclic
    for v in range(V):                              # the V-long cycle
        dense[3, :, v, (v + 1) % V] = 1
    return pack_dense(dense)


def ref_graph_kernel(adj, V):
    cyc, node = R.graph_kernel(V)(adj)
    return np.asarray(cyc), np.asarray(node)


@pytest.mark.parametrize("V", [8, 16, 32, 64])
def test_plain_graph_closure_matches_graph_kernel(V):
    rng = np.random.default_rng(V)
    adj = np.concatenate(
        [random_planes(rng, 6, 3, V, d) for d in (0.05, 0.2, 0.6)]
        + [special_planes(V, 3)])
    want_c, want_n = ref_graph_kernel(adj, V)
    got_c, got_n = G.plain_graph_closure(
        torch.from_numpy(adj.view(np.int32)), V)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    assert want_c.any() and not want_c.all()
    # the V-long cycle puts every vertex on it: node 0 on every plane
    assert (want_n[-1] == 0).all()
    assert (want_n[-4] == INT32_MAX).all()           # the empty graph
    assert (want_n[-3] == V - 1).all()               # the self-loop
    # the device entry on the CPU gives the same arrays
    c, n = G.graph_closure(adj.view(np.int32), V, device="cpu")
    np.testing.assert_array_equal(c, want_c)
    np.testing.assert_array_equal(n, want_n)


def test_closure_cost_model_and_validation():
    assert [G.closure_iters(v) for v in (1, 8, 9, 64)] == [1, 3, 4, 6]
    for V in (8, 64, 1024):
        assert G.mxu_op_model(V) == R.mxu_op_model(V)
    G.validate_graph_decoded(np.array([[True, False]]),
                             np.array([[3, INT32_MAX]], np.int32), 8)
    with pytest.raises(CorruptOutput):
        G.validate_graph_decoded(np.array([[False]]),
                                 np.array([[0]], np.int32), 8)
    with pytest.raises(CorruptOutput):
        G.validate_graph_decoded(np.array([[True]]),
                                 np.array([[8]], np.int32), 8)


# ---------------------------------------------------- the batch checker

@pytest.mark.parametrize("family,corpus", FAMILIES, ids=lambda x: (
    x if isinstance(x, str) else None))
def test_check_graphs_batch_matches_reference(family, corpus):
    want_stats, got_stats = {}, {}
    want = r_check([r for r, _ in corpus], family=family,
                   stats_out=want_stats)
    got = check_graphs_batch([p for _, p in corpus], family=family,
                             stats_out=got_stats, device="cpu")
    assert got == want
    assert plan(got_stats) == plan(want_stats)
    assert {r["valid"] for r in got} == {True, False}


def test_check_graphs_batch_random_graphs_match_reference():
    pairs = graph_pairs()
    want_stats, got_stats = {}, {}
    want = r_check([r for r, _ in pairs], stats_out=want_stats)
    got = check_graphs_batch([p for _, p in pairs], stats_out=got_stats,
                             device="cpu", timings=(t := {}))
    assert got == want
    assert plan(got_stats) == plan(want_stats)
    assert {r["anomaly"] for r in got} >= {None, "G0", "G1c", "G2"}
    host = [G.check_graph_host(p) for _, p in pairs]
    assert [{**r, "provenance": "host"} for r in got] == host
    assert set(t) == {"extract_s", "encode_s", "upload_s", "launch_s",
                      "copy_back_s", "validate_s", "refine_s"}


def test_chunking_matches_reference():
    """Chunks of a few rows: the same results and the same plan keys."""
    pairs = graph_pairs()[:30]
    opts = {"chunk_rows": 4}
    want_stats, got_stats, seen = {}, {}, []
    want = r_check([r for r, _ in pairs], stats_out=want_stats,
                   scheduler_opts=opts)
    got = check_graphs_batch(
        [p for _, p in pairs], stats_out=got_stats, device="cpu",
        scheduler_opts={**opts, "on_chunk": lambda b, lo, hi, c, n:
                        seen.append((b.V, lo, hi, c.shape, n.shape))})
    assert got == want
    assert plan(got_stats) == plan(want_stats)
    assert got_stats["chunks"] == len(seen) > len({s[0] for s in seen})
    assert all(c == n == (hi - lo, 3) for _, lo, hi, c, n in seen)


def test_check_graph_host_matches_reference():
    for r_g, p_g in graph_pairs():
        assert G.check_graph_host(p_g) == R.check_graph_host(r_g)
    for family, corpus in FAMILIES:
        for r_h, p_h in corpus:
            assert G.check_graph_host(G.extract_graph(p_h, family)) == \
                R.check_graph_host(R.extract_graph(r_h, family))


def test_witness_cycle_and_anomaly_class():
    cases = [mk_graph(G, n, **e) for n, e in EDGE_CASES]
    got = check_graphs_batch(cases, device="cpu")
    assert [r["valid"] for r in got] == [True, False, False, False, True,
                                         False, True, False, False, False,
                                         False]
    assert got[1]["anomaly"] == "G0" and \
        [c["vertex"] for c in got[1]["cycle"]] == [0]
    assert got[5]["anomaly"] == "G1c"
    assert [c["vertex"] for c in got[7]["cycle"]] == [2, 3, 4]
    assert [c["via"] for c in got[9]["cycle"]] == [["ww"], ["wr"], ["rw"]]
    assert len(got[10]["cycle"]) == 64
    assert G.shortest_cycle(5, [[1], [2], [0, 3], [4], [3]]) == [3, 4]
    assert G.shortest_cycle(2, [[], []]) is None


def test_adya_g2_keys_match_reference_host_checker():
    for e in (g2_events(s) for s in range(12)):
        host = G2Checker().check({}, None, build(e, "ref"))
        dev = CycleChecker("adya-g2", device="cpu").check(
            {}, None, build(e, "port"))
        assert dev["valid"] is host["valid"]
        assert dev["illegal-keys"] == host["illegal-keys"]
        if not dev["valid"]:
            assert dev["anomaly"] == "G2" and len(dev["cycle"]) == 2


# ------------------------------------------------------- checker protocol

def test_cycle_checker_protocol():
    la = synth_la_history(3, corrupt=1.0)
    for chk in (CycleChecker("list-append", device="cpu"),
                cycle_checker(device="cpu"), HostCycleChecker(),
                host_cycle_checker("list-append")):
        assert isinstance(chk, Checker)
        r = chk({}, None, la)
        assert r["valid"] is False and r["anomaly"] == "G2"
        assert r["provenance"] == ("host" if isinstance(
            chk, HostCycleChecker) else "device")


def test_empty_history_and_empty_batch():
    assert check_graphs_batch([], device="cpu") == []
    r = CycleChecker("list-append", device="cpu").check(
        {}, None, p_core.index([]))
    assert r["valid"] is True and r["vertices"] == 0


@pytest.mark.parametrize("what", ["faults", "journal"])
def test_refuses_the_fault_ladder(what, tmp_path):
    """The fault ladder is ported (it was refused before): the checker
    nemesis and the chunk journal are accepted, and the results are the
    fault-free run's."""
    from jepsen_torch.ops.faults import FaultInjector, FaultPlan
    from jepsen_torch.store import ChunkJournal
    hists = [synth_la_history(s, corrupt=1.0 if s % 2 else 0.0)
             for s in range(4)]
    want = check_graphs_batch(hists, device="cpu")
    kw = ({"faults": FaultInjector(FaultPlan.single("dispatch", "oom"))}
          if what == "faults" else
          {"journal": ChunkJournal(tmp_path / "j.jsonl", {"k": 1})})
    got = check_graphs_batch(hists, device="cpu", **kw)
    assert [{**g, "provenance": None} for g in got] == \
        [{**w, "provenance": None} for w in want]
    if what == "journal":
        assert len(kw["journal"].decided()) == len(hists)
    else:
        assert kw["faults"].log


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_graphs_batch([synth_la_history(1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.graph_closure(np.zeros((1, 3, 8, 1), np.int32), 8)
