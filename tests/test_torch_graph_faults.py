"""The graph family under the checker nemesis: the port's GraphScheduler
ladder, chunk journal and host-oracle quarantine behind
``checkers.cycle.check_graphs_batch`` and ``isolation.certify_batch``,
against the fault and journal tests of the reference's tests/test_graphs.py
and tests/test_isolation.py and against the reference itself.

The same list-append and transactional histories, built once per package
from one seed, go through both packages under each single-fault schedule
(each with its own FaultInjector): every result dict, provenance
included, equals the reference's, and every field but provenance equals
the fault-free run's and the host oracle's. The plain closures run on
the CPU. Tolerance: none.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import isolation as RI
from jepsen_tpu import store as RSTORE
from jepsen_tpu.checkers.cycle import check_graphs_batch as r_check
from jepsen_tpu.ops import faults as RF
from jepsen_tpu.ops import synth_txn as RS
from jepsen_tpu.workloads.synth import synth_la_history as r_la

from jepsen_torch import isolation as I
from jepsen_torch.checkers.cycle import check_graphs_batch
from jepsen_torch.ops import synth_txn as S
from jepsen_torch.ops.faults import (FaultInjector, FaultPlan, InjectedKill,
                                     single_fault_schedules)
from jepsen_torch.ops.graph import (check_graph_host, encode_graphs,
                                    extract_graph)
from jepsen_torch.ops.schedule import GraphScheduler
from jepsen_torch.ops.txn_graph import check_txn_host, extract_txn_graph
from jepsen_torch.store import ChunkJournal
from jepsen_torch.workloads.synth import synth_la_history

torch.set_num_threads(1)

CPU = "cpu"
PROVENANCE_TAGS = {"device", "device-retried", "host-fallback"}
SCHEDULES = [n for n, _ in single_fault_schedules()]
OPTS = {"chunk_rows": 8}
TXN_MIX = dict(n=24, seed=11, n_txns=8, anomaly="mix")


def la(build, n=32):
    return [build(s, n_ops=10 + s % 7, corrupt=1.0 if s % 3 == 0 else 0.0)
            for s in range(n)]


@pytest.fixture(scope="module")
def graphs():
    return ([extract_graph(h, "list-append") for h in la(synth_la_history)],
            la(r_la))


@pytest.fixture(scope="module")
def txns():
    return ([extract_txn_graph(h) for h, _ in
             S.synth_txn_batch(S.TxnSpec(**TXN_MIX))],
            [h for h, _ in RS.synth_txn_batch(RS.TxnSpec(**TXN_MIX))])


@pytest.fixture(scope="module")
def graph_base(graphs):
    got = check_graphs_batch(graphs[0], device=CPU, scheduler_opts=OPTS)
    assert {r["anomaly"] for r in got} >= {None, "G2"}
    return got


@pytest.fixture(scope="module")
def txn_base(txns):
    return I.certify_batch(txns[0], device=CPU, scheduler_opts=OPTS)


def without_provenance(r):
    return {k: v for k, v in r.items() if k != "provenance"}


def assert_parity_under(name, got, base, want, inj, r_inj):
    assert [without_provenance(g) for g in got] == \
        [without_provenance(b) for b in base], name
    assert got == want, name
    assert all(g["provenance"] in PROVENANCE_TAGS for g in got), name
    assert inj.log == r_inj.log and inj.log, name
    assert any(g["provenance"] != "device" for g in got), name


@pytest.mark.parametrize("name", SCHEDULES)
def test_graphs_under_every_single_fault_schedule(graphs, graph_base,
                                                  name):
    inj = FaultInjector(dict(single_fault_schedules())[name])
    r_inj = RF.FaultInjector(dict(RF.single_fault_schedules())[name])
    got = check_graphs_batch(graphs[0], faults=inj, device=CPU,
                             scheduler_opts=OPTS)
    want = r_check(graphs[1], faults=r_inj, scheduler_opts=OPTS)
    assert_parity_under(name, got, graph_base, want, inj, r_inj)


@pytest.mark.parametrize("name", SCHEDULES)
def test_isolation_under_every_single_fault_schedule(txns, txn_base, name):
    inj = FaultInjector(dict(single_fault_schedules())[name])
    r_inj = RF.FaultInjector(dict(RF.single_fault_schedules())[name])
    got = I.certify_batch(txns[0], faults=inj, device=CPU,
                          scheduler_opts=OPTS)
    want = RI.certify_batch(txns[1], faults=r_inj, scheduler_opts=OPTS)
    assert_parity_under(name, got, txn_base, want, inj, r_inj)


@pytest.mark.parametrize("family", ["graph", "txn"])
def test_sticky_corruption_quarantines_to_host_oracle(graphs, txns, family):
    """Corrupt output on every decode: the poison hunt quarantines every
    row, and the host oracle decides each one, tagged host-fallback."""
    items = graphs[0] if family == "graph" else txns[0]
    fn = check_graphs_batch if family == "graph" else I.certify_batch
    oracle = check_graph_host if family == "graph" else check_txn_host
    stats = {}
    got = fn(items, faults=FaultInjector(FaultPlan.sticky("decode",
                                                          "corrupt")),
             scheduler_opts={**OPTS, "max_retries": 1}, stats_out=stats,
             device=CPU)
    for g, item in zip(got, items, strict=True):
        assert g.pop("quarantine_reason").startswith("CorruptOutput")
        assert g == oracle(item, provenance="host-fallback")
    assert stats["quarantined_rows"] == len(items)
    assert stats["corrupt_chunks"] >= 1


def test_learned_safe_rows_cap_applies_to_later_chunks(graphs):
    """A size-dependent out-of-memory wall (dispatches above 4 rows fail)
    is found ONCE per vertex bucket: later chunks dispatch under the
    learned cap."""
    items = [g for g in graphs[0] if g.n <= 32][:24]
    want = {i: r["valid"] for i, r in enumerate(
        check_graphs_batch(items, device=CPU))}
    sch = GraphScheduler(chunk_rows=8, device=CPU)
    real_ship = sch._ship

    def walled_ship(b, lo, hi, Bp):
        if Bp > 4:
            raise torch.cuda.OutOfMemoryError("synthetic wall")
        return real_ship(b, lo, hi, Bp)

    sch._ship = walled_ship
    got = {}
    buckets = encode_graphs(items)
    for b, (cyc, node) in sch.run(buckets):
        for r, i in enumerate(b.indices):
            got[i] = not bool(cyc[r].any())
    assert got == want
    assert set(sch._safe_bp.values()) == {4}
    assert sch.stats["oom_events"] == sch.stats["bisections"] \
        == len(buckets)
    assert not sch.quarantined


def test_oom_bisects_and_learns_safe_rows(graphs, graph_base):
    inj = FaultInjector(FaultPlan.single("dispatch", "oom"))
    sch = GraphScheduler(chunk_rows=32, faults=inj, device=CPU)
    got = {}
    for b, (cyc, node) in sch.run(encode_graphs(graphs[0])):
        for r, i in enumerate(b.indices):
            got[i] = not bool(cyc[r].any())
    assert got == {i: r["valid"] for i, r in enumerate(graph_base)}
    assert sch.stats["oom_events"] >= 1 and sch.stats["bisections"] >= 1
    assert sch._safe_bp and not sch.quarantined


@pytest.mark.parametrize("family", ["graph", "txn"])
def test_kill_and_resume_redispatches_zero_decided_graphs(tmp_path, graphs,
                                                          txns, graph_base,
                                                          txn_base, family):
    items = graphs[0] if family == "graph" else txns[0]
    fn = check_graphs_batch if family == "graph" else I.certify_batch
    base = graph_base if family == "graph" else txn_base
    key = {"digest": f"{family}-kill"}
    j1 = ChunkJournal(tmp_path / "g.jsonl", key)
    with pytest.raises(InjectedKill):
        fn(items, faults=FaultInjector(FaultPlan.single(
            "dispatch", "kill", chunk=2, deadline_s=5.0)), journal=j1,
           scheduler_opts=OPTS, device=CPU)
    j1.close()
    j2 = ChunkJournal(tmp_path / "g.jsonl", key, resume=True)
    decided = j2.decided()
    assert 0 < len(decided) < len(items)
    stats = {}
    got = fn(items, journal=j2, scheduler_opts=OPTS, stats_out=stats,
             device=CPU)
    assert stats["graphs"] == len(items) - len(decided), \
        "decided rows must not be dispatched again"
    cls = "level" if family == "txn" else "anomaly"
    n_resumed = 0
    for i, (g, w) in enumerate(zip(got, base, strict=True)):
        assert g["valid"] == w["valid"] and g[cls] == w[cls], i
        if g.get("resumed"):
            n_resumed += 1
            assert g["provenance"] in PROVENANCE_TAGS
        else:
            assert g == w, i
    assert n_resumed == len(decided) == j2.resume_hits
    j2.finish()
    assert not (tmp_path / "g.jsonl").exists()


@pytest.mark.parametrize("killed_by", ["reference", "port"])
def test_a_graph_journal_resumes_across_the_packages(tmp_path, graphs,
                                                     graph_base, killed_by):
    key = {"digest": "graphs-across"}
    path = tmp_path / "x.jsonl"
    kill = dict(stage="dispatch", kind="kill", chunk=2, deadline_s=5.0)
    if killed_by == "reference":
        j1 = RSTORE.ChunkJournal(path, key)
        with pytest.raises(RF.InjectedKill):
            r_check(graphs[1], faults=RF.FaultInjector(
                RF.FaultPlan.single(**kill)), journal=j1,
                scheduler_opts=OPTS)
        j1.close()
        j2 = ChunkJournal(path, key, resume=True)
        decided = len(j2.decided())
        stats = {}
        got = check_graphs_batch(graphs[0], journal=j2, stats_out=stats,
                                 scheduler_opts=OPTS, device=CPU)
    else:
        j1 = ChunkJournal(path, key)
        with pytest.raises(InjectedKill):
            check_graphs_batch(graphs[0], faults=FaultInjector(
                FaultPlan.single(**kill)), journal=j1, scheduler_opts=OPTS,
                device=CPU)
        j1.close()
        j2 = RSTORE.ChunkJournal(path, key, resume=True)
        decided = len(j2.decided())
        stats = {}
        got = r_check(graphs[1], journal=j2, stats_out=stats,
                      scheduler_opts=OPTS)
    assert 0 < decided < len(graph_base)
    assert stats["graphs"] == len(graph_base) - decided
    assert [(g["valid"], g["anomaly"]) for g in got] == \
        [(w["valid"], w["anomaly"]) for w in graph_base]
    assert sum(bool(g.get("resumed")) for g in got) == decided
    j2.finish()


def test_txn_device_restore_switch_journals_host_rows(tmp_path, txns,
                                                      monkeypatch):
    """JT_TXN_DEVICE=0: every history certifies on the host oracle and
    is journaled as ``host``, as in the reference."""
    monkeypatch.setenv("JT_TXN_DEVICE", "0")
    j = ChunkJournal(tmp_path / "t.jsonl", {"k": 1})
    got = I.certify_batch(txns[0], journal=j, device=CPU)
    assert all(g["provenance"] == "host" for g in got)
    j.close()
    decided = ChunkJournal(tmp_path / "t.jsonl", {"k": 1},
                           resume=True).decided()
    assert sorted(decided) == list(range(len(got)))
    assert {p for _, _, p in decided.values()} == {"host"}
    assert all(v == g["valid"] for (v, _, _), g in
               zip((decided[i] for i in range(len(got))), got))


def test_ladder_stats_keys_are_the_references(graphs):
    from jepsen_tpu.ops.schedule import GraphScheduler as RGS
    assert set(GraphScheduler(device=CPU).stats) == \
        set(RGS(compilation_cache=False).stats)
    assert np.isclose(GraphScheduler(device=CPU).backoff_s, 0.25)
