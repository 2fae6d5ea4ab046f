"""The port's isolation-ladder certifier (jepsen_torch.isolation,
ops.txn_graph, ops.synth_txn) against the reference.

One ``TxnSpec`` names the same transactional histories in both packages;
they go through both packages' extraction and certifier. The port runs
on the CPU, where the ladder closure is the CUDA kernel's plain version
(``plain_txn_closure``), held here against the reference's
``txn_kernel(V)`` run by jax on the CPU (the kernel itself is held
against the plain version on the card by chip_smoke.py). Also mirrored
from the reference's tests/test_isolation.py: every injected anomaly
certifies at exactly its expected level on both engines, the
JT_TXN_DEVICE restore switch, and the checker adapters. Tolerance: none.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import isolation as RI
from jepsen_tpu.ops import synth_txn as RS
from jepsen_tpu.ops import txn_graph as RT

from jepsen_torch import isolation as I
from jepsen_torch.checkers.core import Checker
from jepsen_torch.convert import graph_bucket_from_arrays
from jepsen_torch.ops import synth_txn as S
from jepsen_torch.ops import txn_graph as T
from jepsen_torch.ops.faults import INT32_MAX

from _graph_planes import PLAN_KEYS, pack_dense, random_planes

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

#: The level and violated plane each injected anomaly must certify at.
EXPECTED = {
    None: ("serializability", None),
    "write-skew": ("snapshot-isolation", "G2"),
    "phantom": ("repeatable-read", "G-SI"),
    "lost-update": ("read-committed", "G2-item"),
    "fractured-read": ("read-committed", "G2-item"),
    "aborted-read": ("read-uncommitted", "G1a"),
    "intermediate-read": ("read-uncommitted", "G1b"),
    "dirty-write": ("none", "G0"),
}

MIX = dict(n=28, seed=11, n_txns=8, anomaly="mix")
WIDE = dict(n=6, seed=7, n_txns=40, n_keys=6, anomaly="mix")


def ops_key(ops):
    return [(o.process, o.type, o.f, o.value, o.time, o.index) for o in ops]


@pytest.fixture(scope="module")
def corpus():
    """(reference pairs, port pairs) of the mix and a wider mix."""
    specs = (MIX, WIDE)
    return ([p for kw in specs for p in RS.synth_txn_batch(RS.TxnSpec(**kw))],
            [p for kw in specs for p in S.synth_txn_batch(S.TxnSpec(**kw))])


# ----------------------------------------------------------- the workload

@pytest.mark.parametrize("kw", [MIX, WIDE, dict(n=4, seed=3),
                                dict(n=3, seed=5, anomaly="phantom",
                                     p_predicate=0.5)], ids=str)
def test_synth_txn_batch_matches_reference(kw):
    want = RS.synth_txn_batch(RS.TxnSpec(**kw))
    got = S.synth_txn_batch(S.TxnSpec(**kw))
    assert [(ops_key(o), a) for o, a in got] == \
        [(ops_key(o), a) for o, a in want]
    assert S.ANOMALIES == RS.ANOMALIES
    assert S.EXPECTED_CAP == RS.EXPECTED_CAP


def test_extract_txn_graph_matches_reference(corpus):
    for (r_ops, _), (p_ops, _) in zip(*corpus, strict=True):
        r_g, p_g = RT.extract_txn_graph(r_ops), T.extract_txn_graph(p_ops)
        assert p_g.n == r_g.n and p_g.meta == r_g.meta
        assert set(p_g.edges) == set(r_g.edges)
        for t in r_g.edges:
            np.testing.assert_array_equal(p_g.edges[t], r_g.edges[t])


def test_encode_txn_graphs_matches_reference(corpus):
    r_gs = [RT.extract_txn_graph(o) for o, _ in corpus[0]]
    p_gs = [T.extract_txn_graph(o) for o, _ in corpus[1]]
    want = [graph_bucket_from_arrays(b) for b in RT.encode_txn_graphs(r_gs)]
    got = T.encode_txn_graphs(p_gs)
    assert [(b.V, b.indices) for b in got] == \
        [(b.V, b.indices) for b in want]
    assert len(got) >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.adj, w.adj)


# ------------------------------------------------ the closure's plain form

@pytest.mark.parametrize("V", [8, 16, 32, 64])
def test_plain_txn_closure_matches_txn_kernel(V):
    """Seeded planes (G2 a superset of G1c, as extraction makes them,
    and arbitrary ones), plus an RW·N composition that only the SI plane
    closes: i -rw-> j -n-> i."""
    rng = np.random.default_rng(100 + V)
    adj = np.concatenate([random_planes(rng, 6, 4, V, d)
                          for d in (0.05, 0.2, 0.5)])
    nested = random_planes(rng, 6, 4, V, 0.1)
    nested[:, 3] |= nested[:, 1]
    dense = np.zeros((2, 4, V, V), np.uint8)
    dense[:, 1:, V - 1, 0] = 1          # n edge V-1 -> 0
    dense[0, 3, 0, V - 1] = 1           # rw edge 0 -> V-1: an SI cycle
    adj = np.concatenate([adj, nested, pack_dense(dense)])
    cyc, node = RT.txn_kernel(V)(adj)
    want_c, want_n = np.asarray(cyc), np.asarray(node)
    got_c, got_n = T.plain_txn_closure(
        torch.from_numpy(adj.view(np.int32)), V)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    assert want_c.any() and not want_c.all()
    assert want_c[-2].tolist() == [False, False, False, True, True]
    assert want_n[-1].tolist() == [INT32_MAX] * 5
    c, n = T.txn_closure(adj.view(np.int32), V, device="cpu")
    np.testing.assert_array_equal(c, want_c)
    np.testing.assert_array_equal(n, want_n)


def test_txn_op_model_matches_reference():
    for V in (8, 16, 64, 256):
        assert T.txn_op_model(V) == RT.txn_op_model(V)
    assert T.LADDER == RT.LADDER and T.CYC_NAMES == RT.CYC_NAMES
    assert [T.iso_abbrev(x) for x in T.LADDER] == \
        ["NONE", "RU", "RC", "RR", "SI", "SER"]
    assert T.iso_abbrev(None) == "?"


# ------------------------------------------------------- the certifier

def test_certify_batch_matches_reference(corpus):
    want_stats, got_stats = {}, {}
    want = RI.certify_batch([o for o, _ in corpus[0]], stats_out=want_stats)
    got = I.certify_batch([o for o, _ in corpus[1]], stats_out=got_stats,
                          device="cpu")
    assert got == want
    assert {k: got_stats[k] for k in PLAN_KEYS} == \
        {k: want_stats[k] for k in PLAN_KEYS}
    host = I.certify_host([o for o, _ in corpus[1]])
    assert [{**r, "provenance": "host"} for r in got] == host
    assert host == RI.certify_host([o for o, _ in corpus[0]])


def test_mix_labels_match_verdicts(corpus):
    seen = set()
    got = I.certify_batch([o for o, _ in corpus[1]], device="cpu")
    for (_, anom), r in zip(corpus[1], got, strict=True):
        assert r["level"] == S.EXPECTED_CAP[anom], anom
        seen.add(anom)
    assert seen == set(S.ANOMALIES) | {None}


@pytest.mark.parametrize("anomaly", list(EXPECTED))
def test_anomaly_certifies_at_exactly_its_cap_both_engines(anomaly):
    level, plane = EXPECTED[anomaly]
    spec = dict(n=3, seed=5, n_txns=6, anomaly=anomaly)
    r_pairs = RS.synth_txn_batch(RS.TxnSpec(**spec))
    for (ops, got_anom), (r_ops, _) in zip(
            S.synth_txn_batch(S.TxnSpec(**spec)), r_pairs, strict=True):
        assert got_anom == anomaly
        g = T.extract_txn_graph(ops)
        host = T.check_txn_host(g)
        dev = I.certify_batch([g], device="cpu")[0]
        ref = RI.certify_batch([RT.extract_txn_graph(r_ops)])[0]
        assert dev == ref
        for r in (host, dev):
            assert (r["level"], r["anomaly"]) == (level, plane)
            assert r["valid"] is (level == "serializability")
        if plane in ("G1a", "G1b"):
            assert host["cycle"] and all(
                "key" in w and "writer" in w for w in host["cycle"])
        elif plane is not None:
            assert len(host["cycle"]) >= 2


def test_txn_device_restore_switch(monkeypatch, corpus):
    hists = [o for o, _ in corpus[1]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("JT_TXN_DEVICE", "0")
    assert not I.device_enabled()
    got = I.certify_batch(hists)          # no card needed: nothing launches
    assert all(r["provenance"] == "host" for r in got)
    assert got == I.certify_host(hists)
    assert I.IsolationChecker()({}, None, hists[1])["provenance"] == "host"
    monkeypatch.delenv("JT_TXN_DEVICE")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        I.certify_batch(hists)


def test_checker_adapters():
    ops, _ = S.synth_txn_history(
        S.TxnSpec(n_txns=4, seed=9, anomaly="write-skew"), 0)
    r = I.IsolationChecker(device="cpu").check({}, None, ops)
    assert isinstance(I.IsolationChecker(), Checker)
    assert (r["level"], r["valid"]) == ("snapshot-isolation", False)
    assert r["provenance"] == "device"
    rh = I.HostIsolationChecker().check({}, None, ops)
    assert rh["level"] == r["level"] and rh["provenance"] == "host"


@pytest.mark.parametrize("what", ["faults", "journal"])
def test_refuses_the_fault_ladder(what, tmp_path):
    """The fault ladder is ported (it was refused before): the checker
    nemesis and the chunk journal are accepted, and the results are the
    fault-free run's."""
    from jepsen_torch.ops.faults import FaultInjector, FaultPlan
    from jepsen_torch.store import ChunkJournal
    hists = [S.synth_txn_history(S.TxnSpec(n_txns=4), i)[0]
             for i in range(3)]
    want = I.certify_batch(hists, device="cpu")
    kw = ({"faults": FaultInjector(FaultPlan.single("decode", "corrupt"))}
          if what == "faults" else
          {"journal": ChunkJournal(tmp_path / "j.jsonl", {"k": 1})})
    got = I.certify_batch(hists, device="cpu", **kw)
    assert [{**g, "provenance": None} for g in got] == \
        [{**w, "provenance": None} for w in want]
    if what == "journal":
        assert len(kw["journal"].decided()) == len(hists)
    else:
        assert kw["faults"].log
