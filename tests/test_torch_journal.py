"""The port's chunk journal (jepsen_torch.store.ChunkJournal) and the
kill-and-resume contract of its WGL entry points, against the
reference's journal tests (tests/test_faults.py) and across the two
packages.

A check killed mid-stream by the checker nemesis leaves every retired
chunk's verdicts on disk; resumed with the journal, it dispatches none
of the decided rows again (the journal refuses a row decided twice, the
scheduler's row counts and DISPATCH_LOG show it) and returns the
uninterrupted run's verdicts. The file format is the reference's, so a
journal killed under one package resumes under the other. Tolerance:
none.
"""
import json

import numpy as np
import pytest
import torch

from jepsen_tpu import store as RSTORE
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import faults as RF
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.workloads.synth import synth_cas_columnar

from jepsen_torch import store
from jepsen_torch.convert import cols_from_arrays
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.faults import FaultInjector, FaultPlan, InjectedKill
from jepsen_torch.store import ChunkJournal
from jepsen_torch.workloads.synth import synth_cas_history

torch.set_num_threads(1)

MODEL = cas_register()
CPU = "cpu"
PROVENANCE_TAGS = {"device", "device-retried", "host-fallback"}
OPTS = {"chunk_rows": 16}


def kill_plan(chunk, stage="dispatch"):
    return FaultPlan.single(stage, "kill", chunk=chunk, deadline_s=5.0)


# ------------------------------------------------------- the journal

def test_journal_refuses_double_decide(tmp_path):
    j = ChunkJournal(tmp_path / "j.jsonl", {"k": 1})
    j.record([0, 1], [True, False], [None, 7], ["device", "device"])
    with pytest.raises(ValueError, match="decided twice"):
        j.record([1], [True], [None], ["device"])
    j.record([], [], [], [])           # an empty chunk writes nothing
    j.close()
    assert len((tmp_path / "j.jsonl").read_text().splitlines()) == 2


def test_journal_key_mismatch_and_torn_tail(tmp_path):
    p = tmp_path / "j.jsonl"
    j = ChunkJournal(p, {"digest": "aa"})
    j.record([0], [True], [None], ["device"])
    j.close()
    j2 = ChunkJournal(p, {"digest": "bb"}, resume=True)
    assert j2.decided() == {}
    j2.record([0], [False], [3], ["device"])
    with open(p, "a") as f:
        f.write('{"rows": [9], "valid": [tr')
    j2.close()
    j3 = ChunkJournal(p, {"digest": "bb"}, resume=True)
    assert j3.decided() == {0: (False, 3, "device")}
    j3.record([7], [True], [None], ["device"])
    j3.close()
    j4 = ChunkJournal(p, {"digest": "bb"}, resume=True)
    assert j4.decided() == {0: (False, 3, "device"),
                            7: (True, None, "device")}
    assert j4.resume_hits == 2
    j4.finish()
    assert not p.exists()


def test_journal_file_format_is_the_references(tmp_path):
    """The same records written by both packages give the same bytes,
    and each loads the other's file, frontier-checkpoint rows included
    (latest wins)."""
    key = {"digest": "fmt", "rows": 3}
    for name, cls in (("port", ChunkJournal),
                      ("ref", RSTORE.ChunkJournal)):
        j = cls(tmp_path / name, key)
        j.record([2, 0], [False, True], [5, None], ["device", "wgl-dc"])
        j.record([1], [True], [None], ["host-fallback"])
        j.close()
    assert (tmp_path / "port").read_bytes() == \
        (tmp_path / "ref").read_bytes()
    with open(tmp_path / "ref", "a") as f:
        f.write(json.dumps({"frontier": {"tick": 1}}) + "\n")
        f.write(json.dumps({"frontier": {"tick": 2}}) + "\n")
    p = ChunkJournal(tmp_path / "ref", key, resume=True)
    assert p.frontier() == {"tick": 2}
    r = RSTORE.ChunkJournal(tmp_path / "port", key, resume=True)
    assert p.decided() == r.decided() == {
        2: (False, 5, "device"), 0: (True, None, "wgl-dc"),
        1: (True, None, "host-fallback")}


def test_digests_are_the_references():
    rc = synth_cas_columnar(12, seed=3, n_ops=10, n_keys=3)
    pc = cols_from_arrays(rc)
    assert store.columnar_digest(pc) == RSTORE.columnar_digest(rc)
    spec = {"family": "cas", "n": 8, "seed": 2}
    assert store.spec_digest(spec, model="cas") == \
        RSTORE.spec_digest(spec, model="cas")


def test_atomic_write_json(tmp_path):
    p = tmp_path / "summary.json"
    store.atomic_write_json(p, {"a": [1, 2]}, indent=1)
    assert json.loads(p.read_text()) == {"a": [1, 2]}
    assert [q.name for q in tmp_path.iterdir()] == ["summary.json"]


# --------------------------------------------- kill and resume

@pytest.fixture(scope="module")
def cols():
    rc = synth_cas_columnar(90, seed=3, n_ops=16, corrupt=0.3, p_info=0.1)
    return rc, cols_from_arrays(rc)


def kill_then_resume(tmp_path, call, key, chunk=3, stage="dispatch"):
    """Kill ``call(faults=, journal=)`` mid-stream, then resume it from
    the journal; returns (result, rows journaled, rows dispatched on
    resume, resume hits)."""
    j1 = ChunkJournal(tmp_path / "j.jsonl", key)
    with pytest.raises(InjectedKill):
        call(faults=FaultInjector(kill_plan(chunk, stage)), journal=j1)
    j1.close()
    j2 = ChunkJournal(tmp_path / "j.jsonl", key, resume=True)
    decided = len(j2.decided())
    L.DISPATCH_LOG.clear()
    got = call(journal=j2)
    redispatched = sum(n for _, _, _, n in L.DISPATCH_LOG)
    hits = j2.resume_hits
    j2.finish()
    assert not (tmp_path / "j.jsonl").exists()
    return got, decided, redispatched, hits


def test_kill_and_resume_check_columnar(tmp_path, cols):
    _, pc = cols
    base_v, base_b = L.check_columnar(MODEL, pc, device=CPU,
                                      scheduler_opts=OPTS)
    stats = {}

    def call(**kw):
        return L.check_columnar(MODEL, pc, device=CPU, scheduler_opts=OPTS,
                                stats_out=stats, **kw)
    (v, b), decided, redispatched, hits = kill_then_resume(
        tmp_path, call, {"digest": store.columnar_digest(pc)})
    np.testing.assert_array_equal(v, base_v)
    np.testing.assert_array_equal(b, base_b)
    assert 0 < decided < pc.batch and hits == decided
    assert redispatched <= pc.batch - decided
    assert stats["rows"] <= pc.batch - decided


def test_kill_and_resume_details_mode(tmp_path, cols):
    """details="invalid": journaled rows come back bare and ``resumed``,
    fresh rows keep their counterexamples, valid bits as uninterrupted."""
    _, pc = cols
    want = L.check_columnar(MODEL, pc, device=CPU, details="invalid",
                            scheduler_opts=OPTS)

    def call(**kw):
        return L.check_columnar(MODEL, pc, device=CPU, details="invalid",
                                scheduler_opts=OPTS, **kw)
    got, decided, redispatched, hits = kill_then_resume(
        tmp_path, call, {"digest": "details"}, chunk=2)
    n_resumed = 0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g["valid"] == w["valid"], i
        if g["valid"] is False:
            assert g["op"]["index"] == w["op"]["index"], i
        if g.get("resumed"):
            n_resumed += 1
            assert g["provenance"] in PROVENANCE_TAGS
        elif g["valid"] is False:
            assert g.get("configs") == w.get("configs"), i
    assert n_resumed == decided == hits > 0
    assert redispatched <= pc.batch - decided


def test_kill_and_resume_check_batch(tmp_path):
    """The Op-list path: the journal's rows are history indices; a
    decided row is sliced out of its bucket before dispatch."""
    hists = [synth_cas_history(300 + i, n_procs=2 + i % 5, n_ops=14,
                               corrupt=0.4 if i % 3 == 0 else 0.0,
                               p_info=0.2 if i % 4 == 0 else 0.0)
             for i in range(64)]
    want = L.check_batch(MODEL, hists, device=CPU, scheduler_opts=OPTS)

    def call(**kw):
        return L.check_batch(MODEL, hists, device=CPU, scheduler_opts=OPTS,
                             **kw)
    got, decided, redispatched, hits = kill_then_resume(
        tmp_path, call, {"digest": "oplist"}, chunk=3)
    assert 0 < decided < len(hists) and hits == decided
    assert redispatched <= len(hists) - decided
    n_resumed = 0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g["valid"] == w["valid"], i
        if g["valid"] is False:
            assert g["op"]["index"] == w["op"]["index"], i
        if g.get("resumed"):
            n_resumed += 1
        else:
            assert g == w, i
    assert n_resumed == decided


def test_kill_and_resume_keyed_check_synth(tmp_path):
    """A keyed synthesized batch: the journal rides the per-key sub-batch
    and keys on the spec's digest."""
    from jepsen_torch.ops.synth_device import SynthSpec
    spec = SynthSpec(family="cas", n=24, seed=4, n_procs=3, n_ops=24,
                     n_values=3, corrupt=0.3, n_keys=3)
    base_v, base_b = L.check_synth(MODEL, spec, device=CPU,
                                   scheduler_opts=OPTS)

    def call(**kw):
        return L.check_synth(MODEL, spec, device=CPU, scheduler_opts=OPTS,
                             **kw)
    (v, b), decided, redispatched, _ = kill_then_resume(
        tmp_path, call, {"spec": store.spec_digest(spec)}, chunk=2,
        stage="decode")
    np.testing.assert_array_equal(v, base_v)
    np.testing.assert_array_equal(b, base_b)
    assert decided > 0


@pytest.mark.parametrize("killed_by", ["reference", "port"])
def test_a_journal_resumes_across_the_packages(tmp_path, cols, killed_by):
    """Kill under one package, resume under the other: zero decided rows
    dispatched again, verdicts as the uninterrupted run's."""
    rc, pc = cols
    key = {"digest": RSTORE.columnar_digest(rc)}
    base_v, base_b = L.check_columnar(MODEL, pc, device=CPU,
                                      scheduler_opts=OPTS)
    # the reference compiles its chunk shapes before the kill plan's
    # deadline applies
    rv, rb = R.check_columnar(r_cas(), rc, scheduler_opts=OPTS)
    np.testing.assert_array_equal(rv, base_v)
    path = tmp_path / "x.jsonl"
    if killed_by == "reference":
        j1 = RSTORE.ChunkJournal(path, key)
        with pytest.raises(RF.InjectedKill):
            R.check_columnar(r_cas(), rc, journal=j1, scheduler_opts=OPTS,
                             faults=RF.FaultInjector(RF.FaultPlan.single(
                                 "dispatch", "kill", chunk=3,
                                 deadline_s=5.0)))
        j1.close()
        j2 = ChunkJournal(path, key, resume=True)
        decided = len(j2.decided())
        L.DISPATCH_LOG.clear()
        v, b = L.check_columnar(MODEL, pc, device=CPU, journal=j2,
                                scheduler_opts=OPTS)
        redispatched = sum(n for _, _, _, n in L.DISPATCH_LOG)
    else:
        j1 = ChunkJournal(path, key)
        with pytest.raises(InjectedKill):
            L.check_columnar(MODEL, pc, device=CPU, journal=j1,
                             scheduler_opts=OPTS,
                             faults=FaultInjector(kill_plan(3)))
        j1.close()
        j2 = RSTORE.ChunkJournal(path, key, resume=True)
        decided = len(j2.decided())
        R.DISPATCH_LOG.clear()
        v, b = R.check_columnar(r_cas(), rc, journal=j2,
                                scheduler_opts=OPTS)
        redispatched = sum(n for _, _, _, n in R.DISPATCH_LOG)
    np.testing.assert_array_equal(v, base_v)
    np.testing.assert_array_equal(b, base_b)
    assert 0 < decided < pc.batch and j2.resume_hits == decided
    assert redispatched <= pc.batch - decided
    j2.finish()
