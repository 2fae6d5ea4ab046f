"""The port's online daemon (jepsen_torch.online) against the
reference's, on copies of one store, on the CPU.

Each test builds one store, copies it, and drives the reference's
``OnlineDaemon`` on one copy and the port's (``device="cpu"``) on the
other through the same steps: ticks, WAL appends, the writer's
``analyzed`` stamp, daemon restarts. After every tick the tenants'
verdicts, bad ops, provenances (the decided-prefix journal rows), stats
and summaries, the daemon's stats, the durable first-violation, verdict
and isolation records, and the ``online.*`` telemetry counters agree
field for field. Covered: interim checks then finalize, the first
violation persisted, a writer SIGKILLed mid-run, every single-fault
daemon schedule, a restart from the frontier checkpoint (also across the
packages, both ways), the overload ladder, a txn tenant through the live
isolation monitor, and the ``JT_ONLINE_DC`` and
``JT_ONLINE_INCREMENTAL=0`` switches. Tolerance: none.
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

from jepsen_tpu import online as RO
from jepsen_tpu import store as RSTORE
from jepsen_tpu import telemetry as RT
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops.linearize import check_batch_columnar as r_check

from jepsen_torch import online as PO
from jepsen_torch import store as PSTORE
from jepsen_torch import telemetry as PT
from jepsen_torch.history.codec import dumps_op, loads_op
from jepsen_torch.history.core import index
from jepsen_torch.history.wal import WAL_FILE, WAL_MAGIC
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_history

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEAD_PID = 2 ** 22 + 12345
LIVE = os.getpid()
PACKAGES = {"ref": (RO, RSTORE, RT, r_cas),
            "port": (PO, PSTORE, PT, cas_register)}


def reg_lines(n_pairs, start=0, corrupt=None, procs=1, start_value=0):
    """write k / read k pairs as JSON op lines, ``procs`` processes
    overlapping their pairs; the read of pair ``corrupt`` observes 999."""
    out, i = [], start
    for k in range(n_pairs):
        p, v = k % procs, start_value + k + 1
        rv = 999 if corrupt == k else v
        seq = [("invoke", "write", v), ("ok", "write", v),
               ("invoke", "read", None), ("ok", "read", rv)]
        for typ, f, val in seq:
            out.append(json.dumps({"process": p, "type": typ, "f": f,
                                   "value": val, "index": i}))
            i += 1
    return out


def conc_lines(seed, n, procs=3, vals=3):
    """A seeded concurrent CAS-register stream with failed pairs and a
    few :info ops, as JSON lines."""
    import random
    rng = random.Random(seed)
    out, open_, reg = [], {}, None
    while len(out) < n:
        if open_ and (len(open_) >= procs or rng.random() < 0.5):
            p = rng.choice(sorted(open_))
            f, v = open_.pop(p)
            r = rng.random()
            if f == "cas" and reg != v[0]:
                typ = "fail"
            elif r < 0.05:
                typ = "info"
            else:
                typ = "ok"
                if f == "read":
                    v = reg if rng.random() > 0.1 else vals + 1
                elif f == "write":
                    reg = v
                else:
                    reg = v[1]
        else:
            p = rng.choice([q for q in range(procs) if q not in open_])
            f = rng.choice(("read", "write", "cas"))
            v = (None if f == "read" else rng.randrange(vals) if f == "write"
                 else [rng.randrange(vals), rng.randrange(vals)])
            open_[p] = (f, v)
            typ = "invoke"
        out.append(json.dumps({"process": p, "type": typ, "f": f,
                               "value": v, "index": len(out)}))
    return out


def header(name, pid, seed=0):
    return [json.dumps({"wal": WAL_MAGIC, "test": {"name": name},
                        "seed": seed, "pid": pid, "phase": "setup"}),
            json.dumps({"phase": "run", "wal_ops": 0})]


def analyzed(n):
    return [json.dumps({"phase": "analyzed", "wal_ops": n})]


def history_jsonl(d, lines):
    """The stored history a finished run leaves beside its WAL."""
    from jepsen_torch.history.codec import write_jsonl
    write_jsonl(Path(d) / "history.jsonl",
                index([loads_op(x) for x in lines]))


class Pair:
    """One store, copied: ``ref/`` for the reference's daemon, ``port/``
    for the port's. Appends go to both copies."""

    def __init__(self, tmp_path):
        self.bases = {k: tmp_path / k for k in PACKAGES}
        self.daemons = {}
        for _, _, tel, _ in PACKAGES.values():
            tel.REGISTRY.reset()

    def write(self, name, ts, lines, append=False):
        for base in self.bases.values():
            d = base / name / ts
            d.mkdir(parents=True, exist_ok=True)
            with open(d / WAL_FILE, "a" if append else "w") as f:
                f.write("\n".join(lines) + "\n")

    def each_dir(self, name, ts):
        return [base / name / ts for base in self.bases.values()]

    def start(self, faults=None, packages=None, **kw):
        """New daemons on both copies (``packages`` maps copy name to
        the package that serves it, for cross-package restarts)."""
        packages = packages or {k: k for k in PACKAGES}
        for k, base in self.bases.items():
            mod, st, _, cas = PACKAGES[packages[k]]
            kw2 = dict(kw, model=cas(), poll_s=0)
            kw2.setdefault("check_interval_ops", 4)
            kw2.setdefault("crash_quiet_s", 0)
            if packages[k] == "port":
                kw2["device"] = "cpu"
            inj = (mod.DaemonFaultInjector(mod.DaemonFaultPlan.parse(faults))
                   if faults else None)
            self.daemons[k] = mod.OnlineDaemon(
                store=st.Store(base), config=mod.OnlineConfig(**kw2),
                faults=inj)
        return self

    def tick(self, n=1):
        for _ in range(n):
            levels = {k: d.tick() for k, d in self.daemons.items()}
            assert levels["ref"] == levels["port"]
            self.compare()
        return self

    def tenant(self, k, name, ts="r1"):
        return self.daemons[k].tenants[(name, ts)]

    def compare(self):
        got, want = (snapshot(self.daemons[k]) for k in ("port", "ref"))
        assert got == want
        cp, cr = (counters(PACKAGES[k][2]) for k in ("port", "ref"))
        assert cp == cr

    def close(self):
        for d in self.daemons.values():
            d.close()
        self.daemons = {}


def jsonable(x):
    return json.loads(json.dumps(x, default=repr))


def snapshot(daemon) -> dict:
    out = {"stats": dict(daemon.stats), "tenants": {}}
    for key, t in daemon.tenants.items():
        fv = dict(t.first_violation or {})
        for k in ("detected_at", "ino"):
            fv.pop(k, None)
        iso = dict(t.iso_record or {})
        for k in ("detected_at", "ino"):
            iso.pop(k, None)
        out["tenants"]["/".join(key)] = {
            "summary": t.summary(), "stats": dict(t.stats),
            "decided": dict(t._decided), "result": jsonable(t.result),
            "salvaged": t.salvaged, "first_violation": fv, "iso": iso,
            "status": t.status, "ops": [dumps_op(o) for o in t.ops]}
    return out


def counters(tel) -> dict:
    snap = tel.snapshot()
    out = {k: v for k, v in (snap.get("counters") or {}).items()
           if k.startswith("online.")}
    out.update({k: v["count"] for k, v in
                (snap.get("histograms") or {}).items()
                if k.startswith("online.")})
    return out


def verdict_file(d):
    v = json.loads((d / PSTORE.ONLINE_VERDICT).read_text())
    for k in ("ino", "finalized_at", "ttfv_s"):
        v.pop(k)
    if v.get("first_violation"):
        for k in ("ino", "detected_at"):
            v["first_violation"].pop(k)
    return v


# ---------------------------------------------------------- lifecycle

def test_interim_checks_then_finalize(tmp_path):
    """A live WAL grows over three ticks (delta, delta, delta), then the
    writer stamps analyzed beside the stored history and both daemons
    finalize with the same verdict file and journal retired."""
    lines = conc_lines(7, 60)
    pair = Pair(tmp_path)
    pair.write("reg", "r1", header("reg", LIVE) + lines[:20])
    pair.start(crash_quiet_s=60).tick()
    pair.write("reg", "r1", lines[20:40], append=True)
    pair.tick()
    t = pair.tenant("port", "reg")
    assert t.stats["delta_checks"] == 2
    assert {p for _, _, p in t._decided.values()} <= {"online-delta",
                                                       "online-rebuild"}
    pair.write("reg", "r1", lines[40:] + analyzed(len(lines)), append=True)
    for d in pair.each_dir("reg", "r1"):
        history_jsonl(d, lines)
    pair.tick()
    assert t.status == "done" and t.salvaged is False
    vp, vr = (verdict_file(d) for d in pair.each_dir("reg", "r1")[::-1])
    assert vp == vr
    for d in pair.each_dir("reg", "r1"):
        assert not (d / PSTORE.ONLINE_JOURNAL).exists()
    assert counters(PT)["online.ttfv_s"] >= 1
    pair.close()


def test_first_violation_persisted(tmp_path):
    """The first violating op is flagged from an interim prefix, durably,
    and later growth never un-flags it."""
    lines = reg_lines(10, corrupt=3, procs=2)
    pair = Pair(tmp_path)
    pair.write("reg", "r1", header("reg", LIVE) + lines[:24])
    pair.start(crash_quiet_s=60).tick()
    t = pair.tenant("port", "reg")
    assert t.valid_so_far is False
    fvs = [json.loads((d / PSTORE.FIRST_VIOLATION).read_text())
           for d in pair.each_dir("reg", "r1")]
    assert [(f["op_index"], f["prefix_ops"], f["mode"]) for f in fvs] == \
        [(fvs[0]["op_index"], 24, "online-rebuild")] * 2
    pair.write("reg", "r1", lines[24:], append=True)
    pair.tick()
    assert t.first_violation["op_index"] == fvs[0]["op_index"]
    pair.close()


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
    if i == 29:
        wal.sync()
    if i == 33:          # four ops buffered, not yet group-committed
        os.kill(os.getpid(), signal.SIGKILL)
"""


def test_writer_sigkill_parity(tmp_path):
    """A writer SIGKILLed between group commits: both daemons salvage the
    durable prefix (dangling invocations completed as :info) and
    finalize to the post-mortem check of the same salvaged history,
    field for field."""
    lines = conc_lines(3, 60, procs=3)
    wal = tmp_path / "w" / WAL_FILE
    wal.parent.mkdir()
    r = subprocess.run([sys.executable, "-c", WRITER, str(ROOT), str(wal),
                        json.dumps(lines)], capture_output=True, timeout=60)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    pair = Pair(tmp_path)
    for d in pair.each_dir("reg", "r1"):
        d.mkdir(parents=True)
        shutil.copy(wal, d / WAL_FILE)
    pair.start().tick()
    t = pair.tenant("port", "reg")
    assert t.status == "done" and t.salvaged is True
    assert len(t.ops) == 30
    from jepsen_tpu.history.wal import read_wal, salvage_history
    history, dangling = salvage_history(read_wal(wal)["ops"])
    want = r_check(r_cas(), [history], details="invalid",
                   min_device_batch=64)[0]
    assert jsonable(t.result) == jsonable(want)
    assert pair.tenant("ref", "reg").result == want
    pair.close()


@pytest.mark.parametrize("plan", ["fail@tail", "fail@encode",
                                  "fail@dispatch", "stall@tail",
                                  "stall@dispatch"])
def test_daemon_fault_schedule_sweep(tmp_path, plan):
    """Every single-fault schedule of ``daemon_fault_schedules()``
    engages in both daemons, costs at most retried ticks, and the final
    verdict equals the fault-free one."""
    plans = dict(PO.daemon_fault_schedules())
    assert sorted(plans) == sorted(dict(RO.daemon_fault_schedules()))
    lines = reg_lines(6, corrupt=4, procs=2)
    pair = Pair(tmp_path)
    pair.write("reg", "r1", header("reg", DEAD_PID) + lines
               + analyzed(len(lines)))
    for d in pair.each_dir("reg", "r1"):
        history_jsonl(d, lines)
    stage, kind = plan.split("@")[::-1]
    pair.start(faults=f"{stage}:{kind}:0")
    for _ in range(4):
        pair.tick()
        if pair.daemons["port"].idle():
            break
    for k in ("ref", "port"):
        assert pair.daemons[k].faults.log, (k, plan)
    t = pair.tenant("port", "reg")
    assert t.status == "done" and t.result["valid"] is False
    clean = Pair(tmp_path / "clean")
    clean.write("reg", "r1", header("reg", DEAD_PID) + lines
                + analyzed(len(lines)))
    for d in clean.each_dir("reg", "r1"):
        history_jsonl(d, lines)
    clean.start().tick()
    assert jsonable(t.result) == jsonable(clean.tenant("port", "reg").result)
    pair.close()
    clean.close()


# -------------------------------------------------------------- restart

@pytest.mark.parametrize("second", ["same", "swapped"])
def test_restart_resumes_the_frontier_checkpoint(tmp_path, second):
    """A daemon dropped mid-run (no close) is replaced by a new one on the
    same store: it restores the frontier checkpoint once, dispatches
    only the suffix and double-decides no journal row. ``swapped``: the
    second daemon is the other package's, so each package resumes the
    journal and checkpoint the other wrote."""
    lines = reg_lines(14, procs=2)
    pair = Pair(tmp_path)
    pair.write("reg", "r1", header("reg", LIVE) + lines[:32])
    pair.start(crash_quiet_s=3600).tick()
    pair.write("reg", "r1", lines[32:40], append=True)
    pair.tick()
    assert pair.tenant("port", "reg").stats["delta_checks"] == 2
    pair.daemons = {}                          # dropped: nothing closed
    swap = {"ref": "port", "port": "ref"} if second == "swapped" else None
    pair.start(crash_quiet_s=3600, packages=swap)
    pair.tick()                                # same content: zero work
    t = pair.tenant("port", "reg")
    assert t.stats["resumed_prefixes"] == 2 and t.stats["checks"] == 0
    pair.write("reg", "r1", lines[40:48], append=True)
    pair.tick()
    for k in ("ref", "port"):
        t = pair.tenant(k, "reg")
        assert t.stats["checks"] == 1 and t.stats["frontier_restored"] == 1
        assert t.stats["delta_events_last"] < 12      # the suffix only
        assert t.valid_so_far is True
    pair.write("reg", "r1", lines[48:] + analyzed(len(lines)), append=True)
    for d in pair.each_dir("reg", "r1"):
        history_jsonl(d, lines)
    pair.tick()
    assert pair.tenant("port", "reg").result["valid"] is True
    pair.close()


def test_overload_ladder(tmp_path):
    """A burst walks the ladder (widen, shed to the host oracle, defer
    with a durable mark, resume) in both daemons alike, and every tenant
    converges to its verdict."""
    pair = Pair(tmp_path)
    for i, name in enumerate(("t0", "t1", "t2")):
        pair.write(name, "r1", header(name, LIVE, seed=i)
                   + reg_lines(3, corrupt=1 if i == 2 else None))
    pair.start(check_interval_ops=2, crash_quiet_s=3600,
               overload_pending_ops=6, shed_pending_ops=12,
               defer_pending_ops=24, widen_factor=4)
    pair.tick()
    assert pair.daemons["port"].stats["deferred"] >= 1
    for _ in range(12):
        pair.tick()
        if all(t.status == "tailing" and t.pending == 0 and len(t.ops) == 12
               for t in pair.daemons["port"].tenants.values()):
            break
    st = pair.daemons["port"].stats
    assert st["shed"] >= 1 and st["resumed"] >= 1
    for d in pair.daemons.values():
        d.cfg.crash_quiet_s = 0
        for t in d.tenants.values():
            t.state.header = dict(t.state.header, pid=DEAD_PID)
            t.last_growth = 0.0
    for _ in range(4):
        pair.tick()
        if pair.daemons["port"].idle():
            break
    vs = {k[0]: t.result["valid"]
          for k, t in pair.daemons["port"].tenants.items()}
    assert vs == {"t0": True, "t1": True, "t2": False}
    pair.close()


def test_txn_tenant_through_the_isolation_monitor(tmp_path):
    """A transactional tenant: the live monitor downgrades once, durably
    (online-iso.json), and the final certification matches."""
    clean, _ = synth_txn_history(TxnSpec(n_txns=6, seed=3), 0)
    ops, _ = synth_txn_history(TxnSpec(n_txns=6, seed=3,
                                       anomaly="write-skew"), 0)
    lines = [dumps_op(o) for o in index([o.with_() for o in ops])]
    pair = Pair(tmp_path)
    pair.write("txn", "r1", header("txn", LIVE) + lines[:len(clean)])
    pair.start(crash_quiet_s=60).tick()
    t = pair.tenant("port", "txn")
    assert t.is_txn and t._iso.level() == "serializability"
    pair.write("txn", "r1", lines[len(clean):] + analyzed(len(lines)),
               append=True)
    for d in pair.each_dir("txn", "r1"):
        history_jsonl(d, lines)
    pair.tick()
    assert t._iso.level() == "snapshot-isolation"
    assert t.summary()["iso"] == "SI"
    for d in pair.each_dir("txn", "r1"):
        rec = json.loads((d / PSTORE.ONLINE_ISO).read_text())
        assert rec["level"] == "snapshot-isolation"
    pair.tick(2)
    assert t.status == "done"
    assert t.result["level"] == "snapshot-isolation"
    pair.close()


# -------------------------------------------------------------- switches

@pytest.mark.parametrize("env,value", [("JT_ONLINE_DC", "1"),
                                       ("JT_ONLINE_INCREMENTAL", "0")])
def test_switches(tmp_path, monkeypatch, env, value):
    """``JT_ONLINE_DC=1`` serves register-class ticks from the peel
    monitor (a violation still falls through to the frontier);
    ``JT_ONLINE_INCREMENTAL=0`` re-walks every prefix with no frontier.
    Both daemons agree either way, on a clean and an invalid tenant."""
    monkeypatch.setenv(env, value)
    pair = Pair(tmp_path)
    pair.write("ok", "r1", header("ok", LIVE) + reg_lines(6, procs=2)[:12])
    pair.write("bad", "r1", header("bad", LIVE)
               + reg_lines(6, corrupt=2, procs=2)[:12])
    pair.start(crash_quiet_s=60).tick()
    pair.write("ok", "r1", reg_lines(6, procs=2)[12:], append=True)
    pair.write("bad", "r1", reg_lines(6, corrupt=2, procs=2)[12:],
               append=True)
    pair.tick()
    good, bad = pair.tenant("port", "ok"), pair.tenant("port", "bad")
    assert good.valid_so_far is True and bad.valid_so_far is False
    if env == "JT_ONLINE_DC":
        assert good.stats["dc_delta_checks"] == 2
        assert counters(PT)["online.dc_delta_ops{tenant=ok}"] == 24
    else:
        assert "delta_checks" not in good.stats
        assert not pair.daemons["port"].engine.resident.frontiers
        assert {p for _, _, p in good._decided.values()} == {"online"}
    pair.close()


def test_daemon_and_watch_store_need_a_card_unless_told(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PO.OnlineDaemon(store=PSTORE.Store(tmp_path),
                        config=PO.OnlineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PO.watch_store(PSTORE.Store(tmp_path), ticks=1)
    pair = Pair(tmp_path)
    pair.write("reg", "r1", header("reg", DEAD_PID) + reg_lines(3))
    out = PO.watch_store(PSTORE.Store(pair.bases["port"]), until_idle=True,
                         device="cpu", poll_s=0, crash_quiet_s=0)
    assert out["tenants"]["reg/r1"]["status"] == "done"
    assert out["valid"] is True


def test_launch_error_drops_the_carry_and_is_not_absorbed(tmp_path,
                                                          monkeypatch):
    """A kernel error inside a delta tick drops the carried frontier
    (counted as an invalidation), is counted as a check error, and the
    tick is retried next poll: nothing decides that prefix on another
    version in the meantime."""
    from jepsen_torch.ops import linearize as L
    lines = reg_lines(6)
    pair = Pair(tmp_path)
    pair.write("reg", "r1", header("reg", LIVE) + lines[:12])
    pair.start(crash_quiet_s=60).tick()
    d = pair.daemons["port"]
    real = L.run_carried_events

    def boom(*a, **kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(L, "run_carried_events", boom)
    pair.write("reg", "r1", lines[12:20], append=True)
    d.tick()
    t = pair.tenant("port", "reg")
    assert d.stats["check_errors"] == 1
    assert d.stats["frontier_invalidations"] == 1
    assert not d.engine.resident.frontiers and t.checked_ops == 12
    monkeypatch.setattr(L, "run_carried_events", real)
    d.tick()
    assert t.checked_ops == 20 and t.valid_so_far is True
    pair.close()


def test_telemetry_registry_and_spans_match_the_reference():
    """The trimmed registry snapshots exactly as the reference's for the
    same observations; spans land in the ring with their parent and the
    enclosing correlation id, and record nothing with the tracer off."""
    for tel in (PT, RT):
        tel.REGISTRY.reset()
        for v in (0.002, 0.3, 7.0):
            tel.REGISTRY.histogram("online.ttfv_s").observe(v)
            tel.REGISTRY.histogram("online.ttfv_s", tenant="a").observe(v)
        tel.REGISTRY.counter("online.checks").inc(3)
        tel.REGISTRY.counter("online.delta_ops", tenant="a").inc(64)
        tel.REGISTRY.gauge("online.tenants").set(2)
    assert PT.snapshot() == RT.snapshot()
    assert PT.metrics_prefixed("online.") == RT.metrics_prefixed("online.")
    assert PT.REGISTRY.get("online.delta_ops", tenant="a") == 64
    try:
        PT.configure(True)
        PT.reset()
        with PT.correlation_scope("reg/r1#7"):
            with PT.span("online.check", tenant="reg/r1", ops=64):
                with PT.span("dispatch", cat="device", W=5):
                    pass
        inner, outer = PT.spans()
        assert (inner["name"], inner["cat"], outer["name"]) == \
            ("dispatch", "device", "online.check")
        assert inner["parent"] == outer["id"]
        assert inner["corr"] == outer["corr"] == "reg/r1#7"
        assert outer["args"] == {"tenant": "reg/r1", "ops": 64}
        PT.configure(False)
        with PT.span("online.check"):
            pass
        assert PT.span("x") is PT.NOP and PT.spans() == []
    finally:
        PT.configure("env")
