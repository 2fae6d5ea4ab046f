"""The port's streaming bucket scheduler: consolidation semantics and
pipeline parity, against the exact-W oracle and the reference.

The exact-W flow (``scheduler=False`` / run_buckets) is the parity
oracle: the scheduler may widen, merge, chunk, group and reorder
dispatch however it likes, but every verdict, bad index and
counterexample config sample must come out identical, and the entry
points' result dicts — ``provenance`` included — must equal the
reference's ``scheduler=True`` results on the CPU. Also pinned: why
widening is safe, the W-class DP's budget and boundary contract (with
the dispatch-overhead term pinned to 0 by tests/conftest.py, as for the
reference), group launches (fuse_width 1 vs 4), the frontier-only
backend names, and the checker nemesis and chunk journal accepted by
both entry points.
Tolerance: none (exact equality).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops import synth_device as RS
from jepsen_tpu.ops.schedule import choose_w_classes as r_choose
from jepsen_tpu.workloads.synth import synth_cas_history as r_hist

from jepsen_torch.checkers.linearizable import prepare_history
from jepsen_torch.convert import cols_from_arrays
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.encode import bucket_encode, merge_batches, widen_batch
from jepsen_torch.ops.schedule import (BucketScheduler, choose_w_classes,
                                       measure_dispatch_overhead_us,
                                       run_buckets_streamed)
from jepsen_torch.workloads.synth import synth_cas_history

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

MODEL = cas_register()


def mixed_w_histories(hist=synth_cas_history, n=60, seed0=0):
    """Histories across a spread of concurrency levels, with invalid and
    info-heavy rows mixed in — several exact-W buckets per batch."""
    return [hist(seed0 + i, n_procs=2 + i % 7, n_ops=20,
                 corrupt=0.4 if i % 3 == 0 else 0.0,
                 p_info=0.25 if i % 4 == 0 else 0.0)
            for i in range(n)]


def mixed_w_buckets():
    prepared = [prepare_history(h) for h in mixed_w_histories()]
    buckets = bucket_encode(MODEL, prepared)
    assert len({(b.V, b.W) for b in buckets}) >= 3, \
        "workload must produce genuinely mixed W"
    return buckets


def verdicts(stream):
    got_v, got_bad = {}, {}
    for b, out in stream:
        v, bad = np.asarray(out[0]), np.asarray(out[1])
        for r, i in enumerate(b.indices):
            got_v[i] = bool(v[r])
            if not v[r]:
                got_bad[i] = int(bad[r])
    return got_v, got_bad


# ----------------------------------------------------- widening semantics

def test_w5_history_under_w8_class_identical():
    """A W=5 bucket checked under a W=8 class returns identical verdicts
    and bad indices, and the widened frontier is the original embedded
    in the low 2^5 masks — the padded slots never acquire a bit."""
    hists = [synth_cas_history(s, n_procs=5, n_ops=25,
                               corrupt=0.5 if s % 2 else 0.0)
             for s in range(24)]
    prepared = [prepare_history(h) for h in hists]
    b5s = [b for b in bucket_encode(MODEL, prepared, min_w=5) if b.W == 5]
    assert b5s, "expected at least one W=5 bucket"
    for b in b5s:
        v5, bad5, f5 = L.run_encoded_batch(b, True, device="cpu")
        w8 = widen_batch(b, 8)
        assert w8.W == 8 and w8.ev_slots.shape[2] == 8
        v8, bad8, f8 = L.run_encoded_batch(w8, True, device="cpu")
        np.testing.assert_array_equal(v5, v8)
        np.testing.assert_array_equal(bad5, bad8)
        np.testing.assert_array_equal(f5, f8[:, :, :f5.shape[2]])
        assert not f8[:, :, f5.shape[2]:].any()


def test_merge_batches_covers_and_preserves_rows():
    buckets = mixed_w_buckets()
    narrow = [b for b in buckets if b.W <= 8]
    assert len(narrow) >= 2
    merged = merge_batches(narrow)
    assert merged.batch == sum(b.batch for b in narrow)
    assert sorted(merged.indices) == sorted(i for b in narrow
                                            for i in b.indices)
    assert merged.W == max(b.W for b in narrow)
    want_v, want_bad = verdicts(
        (b, L.run_encoded_batch(b, device="cpu")) for b in narrow)
    got_v, got_bad = verdicts(
        [(merged, L.run_encoded_batch(merged, device="cpu"))])
    assert (got_v, got_bad) == (want_v, want_bad)


# ------------------------------------------------------- W-class cost DP

@pytest.mark.parametrize("stats,max_classes,boundary", [
    ({**{(8, w): float((17 - w) * 100) for w in range(4, 17)},
      (8, 18): 7.0}, 5, 16),
    ({**{(8, w): 1.0 for w in range(4, 17)}, (8, 12): 1e6}, 3, 16),
    ({(8, 4): 5.0, (8, 7): 3.0, (16, 6): 2.0}, 5, 16),
], ids=["budget_boundary", "dominant_window", "under_budget"])
def test_choose_w_classes_matches_reference(stats, max_classes, boundary):
    cls = choose_w_classes(stats, max_classes=max_classes,
                           boundary=boundary)
    assert cls == r_choose(stats, max_classes=max_classes,
                           boundary=boundary)
    narrow = {w: c for (v, w), c in cls.items() if w <= boundary}
    assert all(c >= w for w, c in narrow.items())     # only ever widen
    assert len(set(narrow.values())) <= max_classes   # the launch budget
    for (v, w), c in cls.items():
        if w > boundary:
            assert c == w                              # wide stays exact
    if (8, 12) in stats and stats[(8, 12)] == 1e6:
        assert cls[(8, 12)] == 12    # the dominant window keeps its own
    if len(stats) == 3:
        assert cls == {(8, 4): 4, (8, 7): 7, (16, 6): 6}


def test_dispatch_overhead_term(monkeypatch):
    """The DP charges each class a launch: a large overhead folds the
    windows into fewer classes. The measurement honours the pin."""
    stats = {(8, w): 10.0 for w in range(4, 10)}
    free = choose_w_classes(stats, max_classes=5, overhead=0.0)
    taxed = choose_w_classes(stats, max_classes=5, overhead=1e9)
    assert len(set(taxed.values())) < len(set(free.values()))
    assert taxed == r_choose(stats, max_classes=5, overhead=1e9)
    monkeypatch.setenv("JT_DISPATCH_OVERHEAD_US", "7.5")
    assert measure_dispatch_overhead_us("cpu") == 7.5
    monkeypatch.delenv("JT_DISPATCH_OVERHEAD_US")
    assert measure_dispatch_overhead_us("cpu") > 0


def test_late_wide_window_stays_exact():
    """A wide window surfacing in a later streaming group freezes a new
    EXACT class; narrow late windows ride the next-wider frozen narrow
    class, unless consolidation is off."""
    sch = BucketScheduler(device="cpu")
    frozen = {(8, 20): 20, (8, 6): 8, (8, 8): 8}
    assert sch._class_of(dict(frozen), 8, 17) == 17
    assert sch._class_of(dict(frozen), 8, 7) == 8
    exact = BucketScheduler(consolidate=False, device="cpu")
    assert exact._class_of(dict(frozen), 8, 7) == 7


def test_empty_first_group_defers_class_freeze():
    """An all-failures first encode group must not freeze an empty class
    plan: classes freeze on the first NON-empty group."""
    buckets = mixed_w_buckets()
    exact = {(b.V, b.W) for b in buckets}
    sch = BucketScheduler(max_classes=2, chunk_rows=32, device="cpu")
    pairs = list(sch.run(iter([[], list(buckets)])))
    assert sorted(i for b, _ in pairs for i in b.indices) == \
        sorted(i for b in buckets for i in b.indices)
    assert len({(b.V, b.W) for b, _ in pairs}) < len(exact)


# ------------------------------------------------------- streamed parity

def test_run_buckets_streamed_scatter_parity():
    """Verdict and bad-index parity with run_buckets on mixed-W
    buckets, scattered through indices."""
    buckets = mixed_w_buckets()
    want = verdicts(L.run_buckets(buckets, device="cpu"))
    classes = set()

    def seen(stream):
        for b, out in stream:
            classes.add((b.V, b.W))
            yield b, out

    got = verdicts(seen(run_buckets_streamed(list(buckets), max_classes=2,
                                             chunk_rows=16, device="cpu")))
    assert got == want
    assert len(classes) < len({(b.V, b.W) for b in buckets})


def test_scheduler_streams_chunks_and_reports_stats():
    buckets = mixed_w_buckets()
    seen = []
    sch = BucketScheduler(max_classes=2, chunk_rows=16, device="cpu",
                          on_chunk=lambda b, lo, hi, v, bad, fr:
                          seen.append((lo, hi, len(v))))
    pairs = list(sch.run(buckets))
    assert sorted(i for b, _ in pairs for i in b.indices) == \
        sorted(i for b in buckets for i in b.indices)
    assert len(seen) >= 2 and all(n == hi - lo for lo, hi, n in seen)
    assert sum(n for _, _, n in seen) == sum(b.batch for b in buckets)
    st = sch.stats
    for k in ("classes", "chunks", "dispatches", "fused_groups", "rows",
              "pad_rows", "events", "orig_events", "fusion_ratio",
              "encode_busy_s", "dispatch_busy_s", "device_wait_s",
              "overlap_ratio", "t_first_dispatch_s", "t_first_verdict_s",
              "wall_s"):
        assert k in st, k
    assert st["chunks"] == len(seen)
    assert st["rows"] == sum(b.batch for b in buckets)
    assert st["t_first_verdict_s"] <= st["wall_s"]
    assert st["classes"] and st["fusion_ratio"] >= 1.0


def test_check_batch_streamed_matches_reference_and_oracle():
    """check_batch(scheduler=True): the exact-W path's valid, bad op and
    configs, and the reference's scheduler=True dicts field for field,
    provenance included."""
    mine = mixed_w_histories()
    got = L.check_batch(MODEL, mine, device="cpu")
    oracle = L.check_batch(MODEL, mine, device="cpu", scheduler=False)
    for i, (x, y) in enumerate(zip(got, oracle)):
        assert x["provenance"] in ("device", "host-fallback"), i
        assert {k: v for k, v in x.items() if k != "provenance"} == y, i
    assert got == R.check_batch_tpu(r_cas(), mixed_w_histories(r_hist))
    assert any(r["valid"] is False for r in got)


@pytest.fixture(scope="module")
def shared_cols():
    spec = dict(family="cas", n=32, seed=7, n_procs=4, n_ops=30,
                n_values=4, corrupt=0.25, p_info=0.1)
    rc, _ = RS.synth_cas_device(RS.SynthSpec(**spec), backend="numpy",
                                key_meta=False)
    return rc, cols_from_arrays(rc)


@pytest.mark.parametrize("details", [False, True, "invalid"])
def test_check_columnar_streamed_parity(shared_cols, details):
    rc, pc = shared_cols
    got = L.check_columnar(MODEL, pc, device="cpu", details=details)
    oracle = L.check_columnar(MODEL, pc, device="cpu", details=details,
                              scheduler=False)
    want = R.check_columnar(r_cas(), rc, details=details)
    if details is False:
        for a, b, c in zip(got, oracle, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        return
    assert got == want
    for x, y in zip(got, oracle):
        assert {k: v for k, v in x.items() if k != "provenance"} == \
            {k: v for k, v in y.items() if k != "provenance"}


def test_fuse_width_one_vs_four(shared_cols):
    """Group launches change nothing but the launch count: fuse_width 4
    retires chunks in groups (plain_fused_wgl on the CPU) with the same
    dicts as fuse_width 1 and as the reference at fuse_width 4."""
    rc, pc = shared_cols
    opts = {"chunk_rows": 8}
    L.DISPATCH_LOG.clear()
    four = L.check_columnar(MODEL, pc, device="cpu", details=True,
                            scheduler_opts={**opts, "fuse_width": 4})
    grouped = sum(1 for e in L.DISPATCH_LOG if e[0] == "data1fused")
    L.DISPATCH_LOG.clear()
    one = L.check_columnar(MODEL, pc, device="cpu", details=True,
                           scheduler_opts={**opts, "fuse_width": 1})
    assert not any(e[0] == "data1fused" for e in L.DISPATCH_LOG)
    assert grouped > 0
    assert four == one
    assert four == R.check_columnar(
        r_cas(), rc, details=True,
        scheduler_opts={**opts, "fuse_width": 4, "shard_min_rows": 1 << 30})


@pytest.mark.parametrize("what", ["faults", "journal"])
def test_refuses_what_is_not_ported(shared_cols, what, tmp_path):
    """The checker nemesis and the chunk journal are ported (they were
    refused before): both entry points accept them and return the
    fault-free results."""
    from jepsen_torch.ops.faults import FaultInjector, FaultPlan
    from jepsen_torch.store import ChunkJournal
    _, pc = shared_cols
    hists = mixed_w_histories(n=6)

    def kw(tag):
        if what == "faults":
            return {"faults": FaultInjector(FaultPlan.single("decode",
                                                             "corrupt"))}
        return {"journal": ChunkJournal(tmp_path / f"{tag}.jsonl", {})}
    want_v, want_b = L.check_columnar(MODEL, pc, device="cpu")
    got_v, got_b = L.check_columnar(MODEL, pc, device="cpu", **kw("c"))
    assert np.array_equal(got_v, want_v) and np.array_equal(got_b, want_b)
    want = L.check_batch(MODEL, hists, device="cpu")
    got = L.check_batch(MODEL, hists, device="cpu", **kw("b"))
    assert [{**g, "provenance": None} for g in got] == \
        [{**w, "provenance": None} for w in want]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_refuses_a_backend_choice(shared_cols, backend):
    """The reference's two TPU forms of the frontier search are one CUDA
    kernel here: naming either runs that kernel alone, never the peel
    pre-filter, with the same results as "auto" on both entry points
    and the same dicts as the reference under that name."""
    rc, pc = shared_cols
    opts = {"wgl_backend": backend, "chunk_rows": 8}
    L.DISPATCH_LOG.clear()
    got = L.check_columnar(MODEL, pc, device="cpu", details=True,
                           scheduler_opts=opts)
    assert not any(e[0] == "dc" for e in L.DISPATCH_LOG)
    assert got == L.check_columnar(MODEL, pc, device="cpu", details=True,
                                   scheduler_opts={"chunk_rows": 8})
    if backend == "xla":
        assert got == R.check_columnar(r_cas(), rc, details=True,
                                       scheduler_opts=opts)
    hists = mixed_w_histories(n=8)
    L.DISPATCH_LOG.clear()
    got = L.check_batch(MODEL, hists, device="cpu", scheduler_opts=opts)
    assert not any(e[0] == "dc" for e in L.DISPATCH_LOG)
    assert got == L.check_batch(MODEL, hists, device="cpu")


@pytest.mark.parametrize("V", [8, 48])
@pytest.mark.parametrize("w_live", [None, 3])
def test_groupable_answers_as_before_the_warp_tier(V, w_live):
    """Which chunks may ride a group launch does not change with the
    kernel's tiers: every window whose frontier fits in shared memory
    beside its staged rows (W <= 15 at one state word, <= 14 at two),
    so the scheduler's dispatches and launch counts stay as they were."""
    for W in range(1, 19):
        wl = W if w_live is None else min(w_live, W)
        b = SimpleNamespace(V=V, W=W, eff_w_live=wl)
        NW = (V + 31) // 32
        fits = wl * NW * V * 4 + NW * 4 * (1 << W) <= 232448
        assert BucketScheduler._groupable(b) is fits
        assert fits is (W <= (15 if V <= 32 else 14))


def test_iter_synth_groups_matches_reference_and_scheduler():
    """Device synthesis as a scheduler source: a keyed spec generated,
    strained and encoded (fused, renumbered) in row groups gives the
    reference's buckets array for array, and the scheduler over it
    gives the exact per-sub verdicts."""
    from jepsen_tpu.ops.schedule import iter_synth_groups as r_groups
    from jepsen_tpu.ops.statespace import enumerate_statespace as r_space

    from jepsen_torch.ops import synth_device as PS
    from jepsen_torch.ops.partition import partition_columnar
    from jepsen_torch.ops.schedule import iter_synth_groups
    from jepsen_torch.ops.statespace import enumerate_statespace
    from jepsen_torch.workloads.synth import cas_kind_vocabulary
    spec = dict(family="cas", n=24, seed=3, n_procs=4, n_ops=20,
                n_values=3, corrupt=0.3, p_info=0.1, n_keys=3)
    kinds = cas_kind_vocabulary(3)
    space = enumerate_statespace(MODEL, kinds, 64)
    kw = dict(max_slots=16, rows_per_group=10, fuse=True, renumber=True)
    got = [list(g) for g in iter_synth_groups(
        space, PS.SynthSpec(**spec), device="cpu", **kw)]
    want = [list(g) for g in r_groups(
        r_space(r_cas(), kinds, 64), RS.SynthSpec(**spec), synth="numpy",
        **kw)]
    assert len(got) == len(want) == 3
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert (g.V, g.W, g.indices) == (w.V, w.W, w.indices)
            for f in ("ev_type", "ev_slot", "ev_slots", "ev_opidx"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            np.testing.assert_array_equal(np.asarray(g.target),
                                          np.asarray(w.target))
    v, _ = verdicts(BucketScheduler(device="cpu").run(iter(got)))
    cols, _ = PS.synthesize(PS.SynthSpec(**spec), device="cpu")
    pb = partition_columnar(cols)
    ev, _ = L.check_columnar(MODEL, pb.cols, device="cpu",
                             scheduler=False, partition=False)
    assert v == {i: bool(x) for i, x in enumerate(ev)}
    assert not ev.all()
