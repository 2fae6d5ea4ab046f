"""The checker nemesis turned on the port (jepsen_torch.ops.faults and the
degradation ladder of jepsen_torch.ops.schedule.BucketScheduler), against
the reference's tests/test_faults.py and the reference itself.

Under every single-fault schedule — an out-of-memory at each pipeline
stage, a deadline-tripping timeout, a wedged dispatch, corrupt output —
every history gets a verdict field for field identical to the fault-free
run's and to the reference's under the same plan (each package with its
own FaultInjector), with provenance saying which engine decided it. Also
here: torch's rules in the failure classifier, the watchdog, the OOM
bisection's learned safe chunk size carried by ResidentState, and
poison-row quarantine under sticky corruption with host parity. The
plain versions run on the CPU; schedules use the plan's test-scale
timings (a 0.75 s deadline, 1.2 s / 2.5 s stalls). Tolerance: none.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import faults as RF
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops import schedule as RSCH
from jepsen_tpu.workloads.synth import synth_cas_history as r_hist

from jepsen_torch.checkers.linearizable import prepare_history
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import _build
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.encode import bucket_encode
from jepsen_torch.ops.faults import (INT32_MAX, CorruptOutput, FaultInjector,
                                     FaultPlan, InjectedFault, InjectedKill,
                                     WatchdogExpired, classify_failure,
                                     corrupt_arrays, single_fault_schedules,
                                     validate_decoded)
from jepsen_torch.ops.schedule import (BucketScheduler, ResidentState,
                                       knob)
from jepsen_torch.workloads.synth import synth_cas_history

torch.set_num_threads(1)

MODEL = cas_register()
CPU = "cpu"
PROVENANCE_TAGS = {"device", "device-retried", "host-fallback"}
# Both packages plan the same chunks and launch members alone (the
# reference's fuse width under the tests' settings is 1), and the
# reference never takes its batch-sharded route here.
OPTS = {"chunk_rows": 8, "fuse_width": 1}
R_OPTS = {**OPTS, "shard_min_rows": 1 << 30}


def mixed(hist, n=24, seed0=900):
    return [hist(seed0 + i, n_procs=2 + i % 6, n_ops=12,
                 corrupt=0.4 if i % 3 == 0 else 0.0,
                 p_info=0.25 if i % 4 == 0 else 0.0)
            for i in range(n)]


def scatter(stream):
    """{caller index: (valid, bad)} from a (batch, out) stream."""
    got = {}
    for b, out in stream:
        v, bad = np.asarray(out[0]), np.asarray(out[1])
        for r, i in enumerate(b.indices):
            got[i] = (bool(v[r]), int(bad[r]) if not v[r] else None)
    return got


def same_verdicts(got, want, ctx):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g["valid"] == w["valid"], (ctx, i)
        if g["valid"] is False:
            assert g["op"]["index"] == w["op"]["index"], (ctx, i)
        assert g.get("configs") == w.get("configs"), (ctx, i)


# ------------------------------------------------ unit: classification

def test_classify_failure_routes():
    """torch's rules for real failures, the reference's for the rest."""
    assert classify_failure(torch.cuda.OutOfMemoryError("CUDA out of "
                                                        "memory")) == "oom"
    oom = _build.CudaLaunchError("wgl_frontier",
                                 _build.CUDA_ERROR_MEMORY_ALLOCATION,
                                 "out of memory")
    assert classify_failure(oom) == "oom"
    # An illegal address (700) or a failed launch (719) poisons the
    # context: never retried, never hunted.
    for code in (1, 700, 719):
        assert classify_failure(_build.CudaLaunchError("x", code, "e")) \
            is None
    assert classify_failure(RuntimeError("RESOURCE_EXHAUSTED: x")) is None
    assert classify_failure(CorruptOutput("x")) == "transient"
    assert classify_failure(WatchdogExpired("x")) == "transient"
    assert classify_failure(InjectedKill("x")) is None
    assert classify_failure(TypeError("bug")) is None
    for kind, cls in (("oom", "oom"), ("timeout", "transient"),
                      ("corrupt", "transient")):
        assert classify_failure(InjectedFault(kind, "dispatch", 0)) == cls
        assert RF.classify_failure(RF.InjectedFault(kind, "dispatch", 0)) \
            == cls


def test_validate_decoded_catches_garbage():
    """The port's invariants raise exactly where the reference's do."""
    cases = [
        (np.array([True, False]), np.array([INT32_MAX, 3], np.int32)),
        corrupt_arrays(np.array([True, False]),
                       np.array([INT32_MAX, 3], np.int32)),
        (np.array([True]), np.array([5], np.int32)),
        (np.array([False]), np.array([10], np.int32)),
        (np.array([False]), np.array([-1], np.int32)),
        (np.array([1, 0]), np.array([INT32_MAX, 3], np.int32)),
    ]
    for v, b in cases:
        want = None
        try:
            RF.validate_decoded(v, b, 10)
        except RF.CorruptOutput as e:
            want = str(e)
        got = None
        try:
            validate_decoded(v, b, 10)
        except CorruptOutput as e:
            got = str(e)
        assert got == want
    rv, rb = RF.corrupt_arrays(np.array([True, False]),
                               np.array([INT32_MAX, 3], np.int32))
    pv, pb = corrupt_arrays(np.array([True, False]),
                            np.array([INT32_MAX, 3], np.int32))
    assert np.array_equal(rv, pv) and np.array_equal(rb, pb)


def test_fault_plan_parse_env_syntax(monkeypatch):
    text = "dispatch:oom:2, decode:corrupt:*; encode:kill:1"
    plan, ref = FaultPlan.parse(text), RF.FaultPlan.parse(text)
    for stage in ("encode", "dispatch", "decode"):
        for n in range(4):
            got, want = plan.match(stage, n), ref.match(stage, n)
            assert (got and (got.stage, got.kind, got.chunk)) == \
                (want and (want.stage, want.kind, want.chunk))
    assert plan.match("dispatch", 2).kind == "oom"
    assert plan.match("decode", 7).kind == "corrupt"   # sticky
    assert [n for n, _ in single_fault_schedules()] == \
        [n for n, _ in RF.single_fault_schedules()]
    monkeypatch.delenv("JT_FAULT_PLAN", raising=False)
    assert FaultInjector.from_env() is None
    monkeypatch.setenv("JT_FAULT_PLAN", "dispatch:oom:0")
    inj = FaultInjector.from_env()
    assert inj.plan.match("dispatch", 0).kind == "oom"
    # the ambient plan reaches a scheduler made without faults=
    assert BucketScheduler(device=CPU).faults is not None


def test_injector_fires_once_per_ordinal():
    inj = FaultInjector(FaultPlan.single("decode", "corrupt", chunk=1))
    assert [inj.fire("decode") for _ in range(3)] == \
        [None, "corrupt", None]
    assert inj.log == [("decode", 1, "corrupt")]
    with pytest.raises(InjectedKill):
        FaultInjector(FaultPlan.single("encode", "kill")).fire("encode")
    with pytest.raises(InjectedFault, match="RESOURCE_EXHAUSTED"):
        FaultInjector(FaultPlan.single("encode", "oom")).fire("encode")


# ------------------------- field parity under every single schedule

@pytest.fixture(scope="module")
def corpus():
    return mixed(synth_cas_history), mixed(r_hist)


@pytest.fixture(scope="module")
def baselines(corpus):
    """The fault-free runs of both packages (the reference's also
    compiles every kernel shape the fault runs dispatch first)."""
    hists, r_hists = corpus
    return (L.check_batch(MODEL, hists, device=CPU, scheduler_opts=OPTS),
            R.check_batch_tpu(r_cas(), r_hists, scheduler_opts=R_OPTS))


@pytest.mark.parametrize("name", [n for n, _ in single_fault_schedules()])
def test_field_parity_under_every_single_fault_schedule(corpus, baselines,
                                                        name):
    """Every verdict, bad op and config sample equals the fault-free
    run's and the reference's under the same plan, each package with its
    own injector; provenance equals the reference's row for row, and a
    recovery shows where the schedule engaged."""
    hists, r_hists = corpus
    base, r_base = baselines
    plan = dict(single_fault_schedules())[name]
    r_plan = dict(RF.single_fault_schedules())[name]
    inj, r_inj = FaultInjector(plan), RF.FaultInjector(r_plan)
    got = L.check_batch(MODEL, hists, device=CPU, faults=inj,
                        scheduler_opts=OPTS)
    want = R.check_batch_tpu(r_cas(), r_hists, faults=r_inj,
                             scheduler_opts=R_OPTS)
    same_verdicts(got, base, name)
    same_verdicts(got, want, name)
    same_verdicts(r_base, want, name)
    assert [g["provenance"] for g in got] == \
        [w["provenance"] for w in want], name
    assert all(g["provenance"] in PROVENANCE_TAGS for g in got)
    assert inj.log == r_inj.log and inj.log, name
    assert any(g["provenance"] != "device" for g in got), name


# ------------------------------------- ladder mechanics (scheduler)

@pytest.fixture(scope="module")
def mixed_buckets():
    prepared = [prepare_history(h) for h in mixed(synth_cas_history, 40)]
    buckets = bucket_encode(MODEL, prepared)
    assert len({(b.V, b.W) for b in buckets}) >= 3
    return buckets


@pytest.fixture(scope="module")
def exact_verdicts(mixed_buckets):
    return scatter(L.run_buckets(mixed_buckets, device=CPU))


def test_wedge_trips_watchdog_then_recovers(mixed_buckets, exact_verdicts):
    inj = FaultInjector(FaultPlan.single("dispatch", "wedge"))
    sch = BucketScheduler(chunk_rows=32, faults=inj, device=CPU)
    got = scatter(sch.run(mixed_buckets))
    assert got == exact_verdicts
    assert sch.stats["watchdog_fired"] >= 1
    assert sch.stats["retries"] >= 1
    assert sch.stats["faults_injected"] == len(inj.log) >= 1
    assert "device-retried" in sch.row_provenance.values()
    assert not sch.quarantined


def test_timeout_on_a_group_launch_recovers(mixed_buckets, exact_verdicts):
    """A stall on a group launch's member: the group's one deadline
    expires, and every member walks the ladder alone."""
    inj = FaultInjector(FaultPlan.single("dispatch", "timeout", chunk=3))
    sch = BucketScheduler(chunk_rows=8, fuse_width=4, faults=inj,
                          device=CPU)
    got = scatter(sch.run(mixed_buckets))
    assert got == exact_verdicts
    assert sch.stats["fused_groups"] >= 1
    assert sch.stats["watchdog_fired"] == 1
    assert not sch.quarantined


def test_oom_bisects_and_learns_safe_chunk(mixed_buckets, exact_verdicts):
    """Sticky out-of-memory on every dispatch: Bp halves to the floor,
    the learned size sticks per W class and feeds the plan (also of the
    next scheduler through ResidentState), and the event-chunked kernel
    finishes the job."""
    rs = ResidentState()
    inj = FaultInjector(FaultPlan.sticky("dispatch", "oom"))
    sch = BucketScheduler(chunk_rows=32, faults=inj, resident=rs,
                          device=CPU)
    got = scatter(sch.run(mixed_buckets))
    assert got == exact_verdicts
    assert sch.stats["oom_events"] >= 1
    assert sch.stats["bisections"] >= 1
    assert sch._safe_bp and sch._safe_bp is rs.safe_bp
    assert all(bp <= knob("bisect_floor_rows")
               for bp in sch._safe_bp.values())
    for (V, W), bp in sch._safe_bp.items():
        assert sch._class_chunk(V, W) <= bp
    assert not sch.quarantined, \
        "the event-chunked rung should decide OOM rows on the device"
    nxt = BucketScheduler(chunk_rows=32, resident=rs, device=CPU)
    assert rs.batches == 2 and nxt._awaited_shapes is rs.awaited
    for (V, W), bp in rs.safe_bp.items():
        assert nxt._class_chunk(V, W) <= bp
    assert scatter(nxt.run(mixed_buckets)) == exact_verdicts


def test_sticky_corruption_quarantines_poison_rows(mixed_buckets,
                                                   exact_verdicts):
    inj = FaultInjector(FaultPlan.sticky("decode", "corrupt"))
    sch = BucketScheduler(chunk_rows=32, max_retries=1, faults=inj,
                          device=CPU)
    got = scatter(sch.run(mixed_buckets))
    n_rows = len(exact_verdicts)
    assert len(sch.quarantined) == n_rows
    assert sch.stats["quarantined_rows"] == n_rows
    assert sch.stats["corrupt_chunks"] >= 1
    assert set(sch.row_provenance.values()) == {"host-fallback"}
    assert all(got[i] == (True, None) for i in sch.quarantined)


def test_sticky_corruption_end_to_end_host_parity():
    hists = mixed(synth_cas_history, n=12, seed0=1500)
    r_hists = mixed(r_hist, n=12, seed0=1500)
    want = R.check_batch_tpu(r_cas(), r_hists)
    base = L.check_batch(MODEL, hists, device=CPU)
    inj = FaultInjector(FaultPlan.sticky("decode", "corrupt"))
    got = L.check_batch(MODEL, hists, device=CPU, faults=inj,
                        scheduler_opts={"chunk_rows": 32, "max_retries": 1})
    for i, (g, w, b) in enumerate(zip(got, want, base, strict=True)):
        assert g["valid"] == w["valid"] == b["valid"], i
        if g["valid"] is False:
            assert g["op"]["index"] == w["op"]["index"], i
        assert g["provenance"] == "host-fallback", i
        assert g["fallback"].startswith("quarantined: CorruptOutput"), i


def test_a_kill_is_never_absorbed(mixed_buckets):
    inj = FaultInjector(FaultPlan.single("decode", "kill"))
    sch = BucketScheduler(chunk_rows=32, faults=inj, device=CPU)
    with pytest.raises(InjectedKill):
        list(sch.run(mixed_buckets))


def test_ladder_knob_defaults_are_the_references():
    assert (knob("retry_max"), knob("retry_backoff_s"),
            knob("watchdog_min_s"), knob("watchdog_lane_ops_per_s"),
            knob("watchdog_factor"), knob("watchdog_compile_grace_s"),
            knob("bisect_floor_rows"), knob("watchdog_mxu_macs_per_s")) \
        == (RSCH.RETRY_MAX, RSCH.RETRY_BACKOFF_S, RSCH.WATCHDOG_MIN_S,
            RSCH.WATCHDOG_LANE_OPS_PER_S, RSCH.WATCHDOG_FACTOR,
            RSCH.WATCHDOG_COMPILE_GRACE_S, RSCH.BISECT_FLOOR_ROWS,
            RSCH.WATCHDOG_MXU_MACS_PER_S) \
        == (3, 0.25, 120.0, 1e8, 32.0, 900.0, 16, 1e11)
    sch = BucketScheduler(device=CPU)
    assert (sch.max_retries, sch.backoff_s) == (3, 0.25)
    assert sch.stats["quarantined_rows"] == 0 and sch.faults is None


def test_check_batch_columnar_takes_the_nemesis():
    """The columnar entry for Op lists: the same dicts under a schedule
    as fault-free, the recovered rows tagged device-retried."""
    hists = mixed(synth_cas_history, n=16, seed0=700)
    want = L.check_batch_columnar(MODEL, hists, device=CPU,
                                  scheduler_opts=OPTS)
    inj = FaultInjector(FaultPlan.single("decode", "corrupt"))
    got = L.check_batch_columnar(MODEL, hists, device=CPU, faults=inj,
                                 scheduler_opts=OPTS)
    same_verdicts(got, want, "corrupt@decode")
    assert inj.log
    assert "device-retried" in {g.get("provenance") for g in got}
