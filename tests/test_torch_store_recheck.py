"""The port's run store and its recheck path (jepsen_torch.store) against
the reference's (jepsen_tpu.store), on the CPU.

One store is written and copied: the reference rechecks one copy, the
port (``device="cpu"``) the other, and the result dicts must agree field
for field, the ``telemetry`` stamp (``source``, ``salvaged_runs``)
included. Covered:

* ``Store.recheck`` whole-history from the sidecars (the text loader
  poisoned to prove it), from the text through the native jsonl walk,
  with a mixed store (some runs without a sidecar), and over a store the
  other package wrote (byte-identical files either way);
* ``independent=True`` (per-key units, a keyless run kept whole);
* the explosion route (a vocabulary past the packed table: the Op-list
  route, the journal dropped);
* every malformed sidecar (another model, torn, not even the magic, a
  corrupt kind index) sending the whole batch to the text route;
* resume after an injected kill: the journal on disk, ``resume_hits``
  equal to the reference's, no decided row dispatched again, the dicts
  equal to the uninterrupted run's;
* ``recheck_isolation`` over stored transactional runs;
* ``salvage`` of a torn WAL: identical ``salvage.json`` and history
  files, then the rechecked verdict;
* ``latest`` links never pointing at a run without a verdict, and
  results.json equal but for its ``telemetry`` block (each package's own
  counters);
* the online daemon's final verdict on a SIGKILLed writer's run equal to
  ``Store.recheck`` on the salvaged run.

A few dozen rows of 10-80 ops. Tolerance: none.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import store as RS
from jepsen_tpu.history import codec as RC
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import faults as RF
from jepsen_tpu.ops import linearize as RL

from jepsen_torch import online as PON
from jepsen_torch import store as PS
from jepsen_torch.history import columnar as PCOL
from jepsen_torch.history.codec import dumps_op
from jepsen_torch.history.core import index
from jepsen_torch.history.ops import invoke_op, ok_op
from jepsen_torch.history.wal import WAL_FILE, WAL_MAGIC
from jepsen_torch.independent import tuple_
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.faults import FaultInjector, FaultPlan, InjectedKill
from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_batch
from jepsen_torch.workloads.synth import synth_cas_batch, synth_cas_history

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def jsonable(x):
    return json.loads(json.dumps(x, default=repr))


def write_store(base, name, hists, model=None, test=None):
    s = PS.Store(base)
    for i, h in enumerate(hists):
        hd = s.create(name, ts=f"r{i:02d}")
        if test is not None:
            hd.save_test(test)
        hd.save_history(index(list(h)), model=model)
    return s


def pair(tmp_path, name, hists, **kw):
    """The store written by the port under ``port/``, copied to
    ``ref/``: (port Store, reference Store)."""
    p = write_store(tmp_path / "port", name, hists, **kw)
    shutil.copytree(tmp_path / "port", tmp_path / "ref", symlinks=True)
    return p, RS.Store(tmp_path / "ref")


def cas_hists(n=16, seed=4, **kw):
    kw = {"n_procs": 4, "n_ops": 30, "n_values": 4, "corrupt": 0.3,
          "p_info": 0.05, **kw}
    return synth_cas_batch(n, seed, **kw)


def keyed_hists(n=6, n_keys=3):
    out = []
    for r in range(n):
        ops = []
        for k in range(n_keys):
            h = synth_cas_history(100 * r + k, n_procs=2, n_ops=10,
                                  n_values=3, corrupt=0.4)
            ops += [op.with_(process=op.process + 2 * k,
                             value=tuple_(k, op.value)) for op in h]
        out.append(ops)
    out.append(cas_hists(1, 99)[0])        # a keyless run: kept whole
    return out


def both(tmp_path, name, hists, call, **kw):
    p, r = pair(tmp_path, name, hists, **kw)
    got = jsonable(call(p, cas_register(), dict(device=CPU)))
    assert got == jsonable(call(r, r_cas(), {}))
    return got


# ------------------------------------------------------------ recheck

@pytest.mark.parametrize("route", ["sidecar", "text", "mixed"])
def test_recheck_whole_histories(tmp_path, monkeypatch, route):
    hists = cas_hists()
    p, r = pair(tmp_path, "t", hists,
                model=None if route == "text" else cas_register())
    if route == "mixed":
        for base in (p.base, r.base):
            (base / "t" / "r03" / "history.cols.bin").unlink()
    if route == "sidecar":
        def poisoned(*a, **kw):
            raise AssertionError("the text route ran despite sidecars")
        monkeypatch.setattr(PCOL, "jsonl_to_columnar", poisoned)
    got = p.recheck("t", cas_register(), device=CPU)
    want = r.recheck("t", r_cas())
    assert jsonable(got) == jsonable(want)
    assert got["valid"] is False and len(got["runs"]) == len(hists)
    assert got["telemetry"] == {"source": "recheck"}
    assert not (p.base / "t" / "recheck.journal.jsonl").exists()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_reads_in_the_other_package(tmp_path, writer):
    """The files each package writes are byte for byte the other's, so a
    store written by either rechecks in both from its sidecars."""
    hists = cas_hists(6, 7)
    write_store(tmp_path / "port", "t", hists, model=cas_register())
    rs = RS.Store(tmp_path / "ref")
    for i, h in enumerate(hists):
        rh = [RC.loads_op(dumps_op(op)) for op in index(list(h))]
        rs.create("t", ts=f"r{i:02d}").save_history(rh, model=r_cas())
    for i in range(len(hists)):
        for f in ("history.jsonl", "history.txt", "history.cols.bin"):
            a = tmp_path / "port" / "t" / f"r{i:02d}" / f
            b = tmp_path / "ref" / "t" / f"r{i:02d}" / f
            assert a.read_bytes() == b.read_bytes(), f
    base = tmp_path / writer
    got = PS.Store(base)._load_machine_forms("t", [f"r{i:02d}" for i in
                                                   range(6)], cas_register())
    assert got is not None
    assert jsonable(PS.Store(base).recheck("t", cas_register(),
                                           device=CPU)) == \
        jsonable(RS.Store(base).recheck("t", r_cas()))


def test_recheck_independent(tmp_path):
    got = both(tmp_path, "k", keyed_hists(),
               lambda s, m, d: s.recheck("k", m, independent=True, **d))
    runs = got["runs"]
    assert set(runs["r00"]["results"]) == {"0", "1", "2"}
    assert set(runs["r06"]["results"]) == {"history"}
    assert got["valid"] is False


def test_recheck_explosion_route(tmp_path):
    wide = index(sum([[invoke_op(0, "write", v), ok_op(0, "write", v)]
                      for v in range(200)], []))
    bad = index([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                 invoke_op(1, "read", None), ok_op(1, "read", 2)])
    got = both(tmp_path, "boom", [wide, bad],
               lambda s, m, d: s.recheck("boom", m, **d), model=None)
    assert got["runs"]["r00"]["valid"] is True
    assert got["runs"]["r01"]["valid"] is False
    assert not (tmp_path / "port" / "boom" / "recheck.journal.jsonl").exists()


def corrupt_kind(f, bad):
    raw = f.read_bytes()
    hlen = int.from_bytes(raw[8:12], "little")
    n = int(json.loads(raw[12:12 + hlen])["n"])
    off = 12 + hlen + 3 * n
    patched = bytearray(raw)
    patched[off:off + 4] = int(bad).to_bytes(4, "little", signed=True)
    f.write_bytes(bytes(patched))


SIDECAR_FAULTS = {
    "model": None,
    "torn": lambda f: f.write_bytes(f.read_bytes()[:-7]),
    "magic": lambda f: f.write_bytes(b"garbage"),
    "kind_high": lambda f: corrupt_kind(f, 10_000),
    "kind_negative": lambda f: corrupt_kind(f, -5),
}


@pytest.mark.parametrize("fault", list(SIDECAR_FAULTS))
def test_malformed_sidecars_fall_back_to_text(tmp_path, monkeypatch, fault):
    bad = index([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                 invoke_op(1, "read", None), ok_op(1, "read", 2)])
    model = cas_register("absent") if fault == "model" else cas_register()
    p, r = pair(tmp_path, "s", [bad, cas_hists(1, 2)[0]], model=model)
    for base in (p.base, r.base):
        f = base / "s" / "r00" / "history.cols.bin"
        if SIDECAR_FAULTS[fault] is not None:
            SIDECAR_FAULTS[fault](f)
    assert p._load_machine_forms("s", ["r00", "r01"], cas_register()) \
        is None
    texts = []
    real = PCOL.jsonl_to_columnar
    monkeypatch.setattr(PCOL, "jsonl_to_columnar",
                        lambda m, t, **kw: texts.append(len(t))
                        or real(m, t, **kw))
    got = p.recheck("s", cas_register(), device=CPU)
    assert texts == [2]
    assert jsonable(got) == jsonable(r.recheck("s", r_cas()))
    assert got["runs"]["r00"]["valid"] is False


@pytest.mark.parametrize("independent", [False, True])
def test_resume_after_an_injected_kill(tmp_path, monkeypatch, independent):
    # Small chunks, and the reference's fuse width under the tests (the
    # port's default is 4), so both streams cut the same chunks and the
    # kill lands at the same one. The reference reads its chunk size
    # when its scheduler module is imported, the port when a scheduler
    # is made.
    from jepsen_tpu.ops import schedule as RSCH
    monkeypatch.setattr(RSCH, "DEFAULT_CHUNK_ROWS", 4)
    monkeypatch.setenv("JT_SCHED_CHUNK_ROWS", "4")
    monkeypatch.setenv("JT_SCHED_FUSE_WIDTH", "1")
    hists = keyed_hists(8) if independent else cas_hists(24, 5)
    p, r = pair(tmp_path, "j", hists, model=cas_register())
    whole = jsonable(p.recheck("j", cas_register(), device=CPU,
                               independent=independent))
    # The uninterrupted run also compiles the reference's chunk shapes
    # before the kill plan's deadline applies.
    assert jsonable(r.recheck("j", r_cas(), independent=independent)) \
        == whole
    out = {}
    for pkg, s, m, faults, kill, killed, log, kw in (
            ("port", p, cas_register(), FaultInjector, FaultPlan,
             InjectedKill, L.DISPATCH_LOG, {"device": CPU}),
            ("ref", r, r_cas(), RF.FaultInjector, RF.FaultPlan,
             RF.InjectedKill, RL.DISPATCH_LOG, {})):
        with pytest.raises(killed):
            s.recheck("j", m, independent=independent, **kw,
                      faults=faults(kill.single("dispatch", "kill", chunk=2,
                                                deadline_s=5.0)))
        journal = s.base / "j" / "recheck.journal.jsonl"
        assert journal.exists()
        decided = sum(len(json.loads(x).get("rows", [])) for x in
                      journal.read_text().splitlines()[1:])
        log.clear()
        res = s.recheck("j", m, independent=independent, resume=True, **kw)
        assert res["resume_hits"] == decided > 0
        assert sum(n for *_, n in log) <= len(hists) * 3 - decided
        assert not journal.exists()
        out[pkg] = jsonable(res)
    assert out["port"] == out["ref"]

    # A resumed row comes back from the journal as its verdict and bad
    # op index (``resumed``): the verdicts equal the uninterrupted run's.
    def verdicts(res):
        return {ts: {k: (r["valid"], (r.get("op") or {}).get("index"))
                     for k, r in run["results"].items()}
                for ts, run in res["runs"].items()}
    assert verdicts(out["port"]) == verdicts(whole)
    assert out["port"]["valid"] == whole["valid"]


def test_recheck_isolation(tmp_path):
    pairs = synth_txn_batch(TxnSpec(n=12, seed=7, anomaly="mix"))
    got = both(tmp_path, "txn", [h for h, _ in pairs],
               lambda s, m, d: s.recheck_isolation("txn", **d))
    assert got["valid"] is False
    assert len(got["runs"]) == 12


def test_no_stored_histories_is_unknown(tmp_path):
    s = PS.Store(tmp_path)
    for call in (lambda: s.recheck("none", cas_register(), device=CPU),
                 lambda: s.recheck("none", cas_register(), device=CPU,
                                   independent=True),
                 lambda: s.recheck_isolation("none", device=CPU)):
        assert call()["valid"] == "unknown"


# ------------------------------------------------------------ salvage

def wal_lines(n, corrupt=None):
    out = [json.dumps({"wal": WAL_MAGIC, "test": {"name": "w"}, "seed": 3,
                       "pid": 2 ** 22 + 12345, "phase": "setup"}),
           json.dumps({"phase": "run", "wal_ops": 0})]
    for k in range(n):
        v = 999 if k == corrupt else k
        for typ, f, val in (("invoke", "write", k), ("ok", "write", k),
                            ("invoke", "read", None), ("ok", "read", v)):
            out.append(json.dumps({"process": k % 2, "type": typ, "f": f,
                                   "value": val, "index": None}))
    return out


@pytest.mark.parametrize("corrupt,harness_error", [
    (None, None), (3, None),
    # The reference's runner leaves this marker when the harness raised.
    (None, '{"error": "RuntimeError(\'setup\')", "phase": "run"}'),
    (None, "{torn"),
])
def test_salvage_torn_wal(tmp_path, corrupt, harness_error):
    lines = wal_lines(8, corrupt)
    text = "\n".join(lines) + "\n"
    text += text.splitlines()[-1][:17]                  # torn mid-line
    stats, trees = {}, {}
    for pkg, st, m in (("port", PS, cas_register()), ("ref", RS, r_cas())):
        d = tmp_path / pkg / "w" / "r0"
        d.mkdir(parents=True)
        (d / WAL_FILE).write_text(text)
        if harness_error is not None:
            (d / "harness-error.json").write_text(harness_error)
        s = st.Store(tmp_path / pkg)
        assert s.incomplete() == [("w", "r0")]
        stats[pkg] = s.salvage("w", "r0", model=m)
        trees[pkg] = {f: (d / f).read_bytes() for f in (
            "salvage.json", "history.jsonl", "history.txt",
            "history.cols.bin", "test.json")}
        assert s.incomplete() == []
    assert stats["port"] == stats["ref"]
    assert stats["port"]["torn_tail"] and stats["port"]["ops"] > 0
    assert ("harness_error" in stats["port"]) is (harness_error is not None)
    assert trees["port"] == trees["ref"]
    got = PS.Store(tmp_path / "port").recheck("w", cas_register(),
                                              device=CPU)
    want = RS.Store(tmp_path / "ref").recheck("w", r_cas())
    assert jsonable(got) == jsonable(want)
    assert got["telemetry"] == {"source": "recheck",
                                "salvaged_runs": ["r0"]}
    assert got["valid"] is (corrupt is None)


def test_salvage_without_a_wal_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        PS.Store(tmp_path).salvage("w", "r0")


# ------------------------------------------------------- latest links

def test_latest_links_follow_verdicts(tmp_path):
    layouts, results = {}, {}
    for pkg, st in (("port", PS), ("ref", RS)):
        s = st.Store(tmp_path / pkg)
        a = s.create("t", ts="a")
        a.save_history(index(cas_hists(1, 1)[0]))
        assert not (s.base / "t" / "latest").exists()
        assert (s.base / "latest-incomplete").resolve() == a.dir.resolve()
        a.save_results({"valid": True})
        b = s.create("t", ts="b")             # crashes: never a verdict
        assert (s.base / "t" / "latest").resolve() == a.dir.resolve()
        assert (s.base / "latest").resolve() == a.dir.resolve()
        assert (s.base / "t" / "latest-incomplete").resolve() == \
            b.dir.resolve()
        assert s.tests() == {"t": ["a", "b"]}
        layouts[pkg] = sorted(
            (str(p.relative_to(s.base)), os.readlink(p))
            for p in s.base.rglob("*") if p.is_symlink())
        r = json.loads((a.dir / "results.json").read_text())
        r.pop("telemetry", None)              # each package's counters
        results[pkg] = r
        loaded = s.load("t", "a")
        assert loaded["results"]["valid"] is True
        assert len(s.load_histories("t")) == 1
        s.delete("t", "b")
        assert s.tests() == {"t": ["a"]}
    assert layouts["port"] == layouts["ref"]
    assert results["port"] == results["ref"]


def test_attach_and_save_test(tmp_path):
    trees = {}
    for pkg, st in (("port", PS), ("ref", RS)):
        s = st.Store(tmp_path / pkg)
        t = st.attach({"name": "x", "nodes": ["n1"], "model": object(),
                       "opts": {1, 2}}, s)
        t["store_handle"].stop_logging()
        trees[pkg] = json.loads(
            (t["store_handle"].dir / "test.json").read_text())
    assert trees["port"] == trees["ref"]
    assert "model" not in trees["port"]


# ------------------------------------------------ the online daemon

WRITER = r"""
import json, os, signal, sys
sys.path.insert(0, sys.argv[1])
from jepsen_torch.history.codec import loads_op
from jepsen_torch.history.wal import HistoryWAL
wal = HistoryWAL(sys.argv[2], {"test": {"name": "reg"}, "seed": 5},
                 flush_ms=1e9)
wal.stamp_phase("run")
lines = json.loads(sys.argv[3])
for i, line in enumerate(lines):
    wal.append_op(loads_op(line))
    if i == int(sys.argv[4]):
        wal.sync()
    if i == int(sys.argv[4]) + 4:     # four ops buffered, not committed
        os.kill(os.getpid(), signal.SIGKILL)
"""


@pytest.mark.parametrize("corrupt", [None, 5])
def test_daemon_final_verdict_equals_store_recheck(tmp_path, corrupt):
    lines = []
    for k in range(12):
        v = 999 if k == corrupt else k
        for typ, f, val in (("invoke", "write", k), ("ok", "write", k),
                            ("invoke", "read", None), ("ok", "read", v)):
            lines.append(json.dumps({"process": k % 3, "type": typ,
                                     "f": f, "value": val}))
    d = tmp_path / "store" / "reg" / "r1"
    d.mkdir(parents=True)
    r = subprocess.run([sys.executable, "-c", WRITER, str(ROOT),
                        str(d / WAL_FILE), json.dumps(lines), "37"],
                       capture_output=True, timeout=60)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    shutil.copytree(tmp_path / "store", tmp_path / "post")
    daemon = PON.OnlineDaemon(
        store=PS.Store(tmp_path / "store"),
        config=PON.OnlineConfig(model=cas_register(), poll_s=0,
                                crash_quiet_s=0, device=CPU))
    daemon.tick()
    t = daemon.tenants[("reg", "r1")]
    assert t.status == "done" and t.salvaged is True
    daemon.close()
    post = PS.Store(tmp_path / "post")
    post.salvage("reg", "r1", model=cas_register())
    want = post.recheck("reg", cas_register(), timestamps=["r1"],
                        device=CPU)["runs"]["r1"]["results"]["history"]
    assert jsonable(t.result) == jsonable(want)
    assert t.result["valid"] is (corrupt is None)
