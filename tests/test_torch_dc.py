"""The port's decrease-and-conquer peel loop (jepsen_torch.ops.dc_monitor,
the scheduler's pre-filter and ``wgl_backend``) against the reference.

The same histories, built once per package from one seeded description,
go through both packages' encoders, plans and checkers; the port runs on
the CPU, where the peel loop is the CUDA kernel's plain version
(``plain_dc_peel``), held here bit for bit against the reference's
``get_dc_kernel`` run by jax on the CPU and against its numpy twin
``dc_host_decide`` (the kernel itself is held against the plain version
on the card by chip_smoke.py). Mirrored from the reference's
tests/test_dc_monitor.py: parity with the host twin on real buckets,
certified == capable and valid, the probe plan, capability, the skipped
scans and their provenance, residue parity and the JT_ROUTER_DC switch.
Tolerance: none: plans, decided/rounds, stats and result dicts must be
identical.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.linearizable import prepare_history as r_prepare
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import dc_monitor as R
from jepsen_tpu.ops import linearize as RL
from jepsen_tpu.ops.encode import bucket_encode as r_bucket_encode
from jepsen_tpu.ops.schedule import BucketScheduler as RScheduler
from jepsen_tpu.workloads import synth as RS

from jepsen_torch.checkers.linearizable import prepare_history, wgl_check
from jepsen_torch.convert import dc_plan_from_arrays
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import dc_monitor as D
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.encode import bucket_encode
from jepsen_torch.ops.schedule import BucketScheduler
from jepsen_torch.workloads import synth as S

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

MODEL = cas_register()
SCHED = {"wgl_backend": "dc", "chunk_rows": 8}
PLAN_FIELDS = ("inv", "cluster", "active", "capable")
DC_STATS = ("dc_dispatches", "dc_rows", "dc_decided_rows",
            "dc_skipped_scans", "wgl_backend", "dispatches", "chunks",
            "rows", "fused_groups")


def rw_corpus(M, n=16, seed0=4200):
    """Wide-window read/write histories, every other one stale."""
    return [M.synth_rw_history(seed0 + i, n_procs=6 + i % 4, n_ops=28,
                               stale=0.4 if i % 2 else 0.0)
            for i in range(n)]


def mixed_corpus(M):
    """Register-class rows beside cas rows (incapable vocabulary) and
    info-pinned rows (incapable close snapshot)."""
    return (rw_corpus(M, n=10, seed0=4700)
            + [M.synth_cas_history(40 + i, n_procs=3, n_ops=14,
                                   p_info=0.3 if i % 2 else 0.0)
               for i in range(6)])


def buckets(M, hists):
    """Each package's encoded buckets of its own histories."""
    if M is RS:
        prep, enc, model = r_prepare, r_bucket_encode, r_cas()
    else:
        prep, enc, model = prepare_history, bucket_encode, MODEL
    return enc(model, [prep(h) for h in hists], max_states=64,
               max_slots=32, fuse=True)


def both_buckets(corpus):
    rb, pb = buckets(RS, corpus(RS)), buckets(S, corpus(S))
    assert len(rb) == len(pb)
    return list(zip(rb, pb))


def peel_args(inv, cluster, active):
    return (torch.from_numpy(inv), torch.from_numpy(cluster),
            torch.from_numpy(active))


def random_plan(rng, B, E, structured):
    """A random plan: ``structured`` rows are W-overlapped write+read
    pairs like the workload's, the others arbitrary clusters and
    invocations; a fifth of the ops inactive."""
    if structured:
        w = int(rng.integers(1, 8))
        inv = np.maximum(0, np.arange(E) - w)[None].repeat(B, 0)
        cluster = (np.arange(E) // 2 * 2)[None].repeat(B, 0)
    else:
        inv = rng.integers(0, E, (B, E))
        cluster = rng.integers(0, E, (B, E))
    active = rng.random((B, E)) < 0.8
    return inv.astype(np.int32), cluster.astype(np.int32), active


# ------------------------------------------------------- the plan

@pytest.mark.parametrize("corpus", [rw_corpus, mixed_corpus],
                         ids=["rw", "mixed"])
def test_dc_plan_matches_reference(corpus):
    """The plan, field for field, from each package's own encode of the
    same histories; the capable rows are exactly the reference's."""
    seen = 0
    for rb, pb in both_buckets(corpus):
        rp, pp = R.dc_plan(rb), D.dc_plan(pb)
        assert (rp is None) == (pp is None)
        if rp is None:
            continue
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(pp, f), getattr(rp, f),
                                          err_msg=f)
            assert getattr(pp, f).dtype == getattr(rp, f).dtype, f
        assert pp.capable_frac == rp.capable_frac
        seen += int(pp.capable.sum())
    assert seen >= 8


def test_dc_plan_from_arrays_round_trips():
    """A reference plan crosses over field for field and feeds the
    port's peel loop to the reference's verdicts."""
    for rb, _ in both_buckets(mixed_corpus):
        rp = R.dc_plan(rb)
        if rp is None:
            continue
        pp = dc_plan_from_arrays(rp)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(pp, f), getattr(rp, f))
            assert getattr(pp, f).dtype == getattr(rp, f).dtype
        np.testing.assert_array_equal(
            D.dc_decide(pp.inv, pp.cluster, pp.active, device="cpu"),
            R.dc_decide(rp.inv, rp.cluster, rp.active))


# ------------------------------------------ the peel loop, bit for bit

@pytest.mark.parametrize("E", [1, 2, 8, 64, 256])
@pytest.mark.parametrize("max_rounds", [0, 1, 2])
def test_plain_peel_matches_get_dc_kernel(E, max_rounds):
    """``plain_dc_peel`` against the reference's ``get_dc_kernel(E,
    max_rounds)``: decided and rounds bit for bit, on structured and
    arbitrary plans (arbitrary ones stick early, structured ones peel
    for several rounds), and against ``dc_host_decide``."""
    rng = np.random.default_rng(1000 * E + max_rounds)
    kern = R.get_dc_kernel(E, max_rounds)
    for structured in (True, False):
        plan = random_plan(rng, 8, E, structured)
        want_d, want_r = (np.asarray(a) for a in kern(*plan))
        got_d, got_r = D.plain_dc_peel(*peel_args(*plan), max_rounds)
        assert got_d.dtype == torch.bool and got_r.dtype == torch.int32
        np.testing.assert_array_equal(got_d.numpy(), want_d)
        np.testing.assert_array_equal(got_r.numpy(), want_r)
        np.testing.assert_array_equal(
            got_d.numpy(), R.dc_host_decide(*plan, max_rounds=max_rounds))


def test_plain_peel_edge_rows():
    """All-inactive rows stop before a round (rounds 0, decided); a row
    whose every op sits in one cluster ties every other cluster at BIG,
    so the outside bound is BIG and the cluster peels in one round; an
    op invoked after its cluster's earliest response elsewhere sticks."""
    E = 8
    inv = np.zeros((3, E), np.int32)
    cluster = np.zeros((3, E), np.int32)
    active = np.zeros((3, E), bool)
    active[1] = True                         # one cluster, all ops
    inv[1] = np.arange(E)
    active[2, :4] = True                     # two clusters, stuck
    cluster[2, :4] = [0, 0, 2, 2]
    inv[2, :4] = [0, 3, 0, 3]
    want = [np.asarray(a) for a in R.get_dc_kernel(E)(inv, cluster, active)]
    got = D.plain_dc_peel(*peel_args(inv, cluster, active))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert want[0].tolist() == [True, True, False]
    assert want[1].tolist()[:2] == [0, 1]


def test_plain_peel_refuses_device_tensors():
    """The plain version takes CPU tensors only; ``peel`` sends a CUDA
    tensor to the kernel."""
    inv = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        D.plain_dc_peel(inv, inv, inv.bool())


def test_kernel_bit_parity_vs_host_twin():
    """dc_decide (padded as the reference pads) and the numpy twin agree
    row for row on real buckets, incapable and residue rows included,
    and both equal the reference's dc_decide."""
    checked = residue = 0
    for rb, pb in both_buckets(lambda M: rw_corpus(M, n=24, seed0=4300)):
        plan = D.dc_plan(pb)
        if plan is None:
            continue
        host = D.dc_host_decide(plan.inv, plan.cluster, plan.active)
        got = D.dc_decide(plan.inv, plan.cluster, plan.active, device="cpu")
        np.testing.assert_array_equal(host, got)
        rp = R.dc_plan(rb)
        np.testing.assert_array_equal(
            got, R.dc_decide(rp.inv, rp.cluster, rp.active))
        checked += pb.batch
        residue += int((~(got & plan.capable)).sum())
    assert checked >= 20
    assert residue >= 1, "corpus must exercise the residue path"


def test_max_rounds_env_matches_reference(monkeypatch):
    """JT_DC_MAX_ROUNDS caps the rounds in both packages alike: a cap of
    1 turns rows that need more rounds into residue."""
    monkeypatch.setenv("JT_DC_MAX_ROUNDS", "1")
    assert D.dc_max_rounds() == 1
    plan = R.make_probe_plan(rows=4, events=32, w=6)
    rounds: list = []
    got = D.dc_decide(*plan, device="cpu", rounds_out=rounds)
    np.testing.assert_array_equal(got, R.dc_decide(*plan))
    assert rounds == [1] * 4
    monkeypatch.setenv("JT_DC_MAX_ROUNDS", "x")
    assert D.dc_max_rounds() == 0 == R.dc_max_rounds()


def test_certified_is_exactly_capable_and_valid():
    """A row is certified iff its plan calls it capable and the host
    oracle calls it valid: sound and, on the capable class, complete."""
    hists = rw_corpus(S, n=24, seed0=4400)
    verdicts = {id(h): wgl_check(MODEL, h)["valid"] for h in hists}
    seen_cert = seen_residue = 0
    for b in buckets(S, hists):
        plan = D.dc_plan(b)
        assert plan is not None
        cert = D.dc_decide(plan.inv, plan.cluster, plan.active,
                           device="cpu") & plan.capable
        for r in range(b.batch):
            want = plan.capable[r] and verdicts[id(hists[b.indices[r]])]
            assert bool(cert[r]) == bool(want), r
            seen_cert += int(cert[r])
            seen_residue += int(not cert[r])
    assert seen_cert and seen_residue


def test_probe_plan_self_parity():
    """The probe plan is the reference's and fully peelable, and the CPU
    probe reports parity and a rate."""
    got = D.make_probe_plan(rows=8, events=32, w=6)
    for a, b in zip(got, R.make_probe_plan(rows=8, events=32, w=6)):
        np.testing.assert_array_equal(a, b)
    assert D.dc_host_decide(*got).all()
    out = D.probe_rates(rows=8, events=32, repeats=1, device="cpu")
    assert out["parity"] is True
    assert out["dc_events_per_s"] > 0


def test_entry_points_need_the_card_unless_told(monkeypatch):
    """No fallback: without a card, dc_decide and the probe raise unless
    the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = D.make_probe_plan(rows=2, events=8, w=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.dc_decide(*plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.probe_rates(rows=2, events=8)


# ------------------------------------------------------ capability

def test_cas_history_is_incapable():
    """Surviving cas ops put the vocabulary outside the read/write
    class: the sniff and the plan refuse, in both packages alike."""
    h = S.synth_cas_history(0, n_procs=3, n_ops=12)
    assert any(op.f == "cas" and op.type == "ok" for op in h)
    assert D.dc_capable_history(h) is False
    assert R.dc_capable_history(RS.synth_cas_history(
        0, n_procs=3, n_ops=12)) is False
    for b in buckets(S, [h]):
        plan = D.dc_plan(b)
        assert plan is None or not plan.capable.any()


@pytest.mark.parametrize("stale", [0.0, 0.5])
def test_rw_history_sniff_matches_reference(stale):
    """The Op-list sniff agrees with the reference's on the same seeded
    histories (a stale read still reads a written value)."""
    for s in range(6):
        kw = dict(n_procs=6, n_ops=24, stale=stale)
        h = S.synth_rw_history(s, **kw)
        assert D.dc_capable_history(h) is True
        assert R.dc_capable_history(RS.synth_rw_history(s, **kw)) is True
        assert [(o.process, o.type, o.f, o.value) for o in h] == \
            [(o.process, o.type, o.f, o.value)
             for o in RS.synth_rw_history(s, **kw)]


# ------------------------------------------- the scheduler's pre-filter

def test_dc_backend_skips_scan_and_tags_provenance():
    """An all-valid rw batch is decided by the peel loop alone: dc
    entries and no frontier launch in the dispatch log, every row
    ``wgl-dc``, and the result dicts equal to the reference's."""
    hists = [S.synth_rw_history(7000 + i, n_procs=6, n_ops=24)
             for i in range(8)]
    assert all(wgl_check(MODEL, h)["valid"] for h in hists)
    L.DISPATCH_LOG.clear()
    got = L.check_batch_columnar(MODEL, hists, details="invalid",
                                 device="cpu", scheduler_opts=dict(SCHED))
    assert [r["valid"] for r in got] == [True] * len(hists)
    assert any(t[0] == "dc" for t in L.DISPATCH_LOG)
    assert not any(t[0].startswith("data1") for t in L.DISPATCH_LOG)
    assert all(r.get("provenance") == "wgl-dc" for r in got)
    want = RL.check_batch_columnar(
        r_cas(), [RS.synth_rw_history(7000 + i, n_procs=6, n_ops=24)
                  for i in range(8)],
        details="invalid", scheduler_opts=dict(SCHED))
    assert got == want


@pytest.mark.parametrize("details", ["invalid", True])
def test_dc_backend_matches_reference(details):
    """Mixed corpus under the forced pre-filter: result dicts field for
    field equal to the reference's, provenance included; invalid rows
    ride the scan with the host oracle's bad op."""
    want = RL.check_batch_columnar(r_cas(), mixed_corpus(RS),
                                   details=details,
                                   scheduler_opts=dict(SCHED))
    hists = mixed_corpus(S)
    got = L.check_batch_columnar(MODEL, hists, details=details,
                                 device="cpu", scheduler_opts=dict(SCHED))
    assert got == want
    oracle = [wgl_check(MODEL, h) for h in hists]
    assert any(r["valid"] is False for r in oracle)
    for g, w in zip(got, oracle):
        assert g["valid"] == w["valid"]
        if g["valid"] is False:
            assert g["op"]["index"] == w["op"]["index"]


def test_dc_scheduler_stats_match_reference():
    """The two schedulers over each package's buckets of the same
    histories: the dc_* stats, dispatch counts and the skipped rows'
    provenance are the reference's."""
    corpus = lambda M: rw_corpus(M, n=24, seed0=4800)  # noqa: E731
    rs = RScheduler(return_frontier="invalid", wgl_backend="dc",
                    chunk_rows=8, fuse_width=1, shard_min_rows=1 << 30)
    ps = BucketScheduler(return_frontier="invalid", wgl_backend="dc",
                         chunk_rows=8, fuse_width=1, device="cpu")
    want = [(b.indices, np.asarray(v), np.asarray(bad))
            for b, (v, bad, _) in rs.run(buckets(RS, corpus(RS)))]
    got = [(b.indices, v, bad)
           for b, (v, bad, _) in ps.run(buckets(S, corpus(S)))]
    assert len(got) == len(want)
    for (gi, gv, gb), (wi, wv, wb) in zip(got, want):
        assert list(gi) == list(wi)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gb, wb)
    for k in DC_STATS:
        assert ps.stats[k] == rs.stats[k], k
    assert ps.stats["dc_skipped_scans"] > 0
    assert ps.row_provenance == rs.row_provenance


def test_check_batch_oplist_runs_the_prefilter():
    """The Op-list entry carries the backend too: with full frontiers
    the pre-filter runs but never skips a scan, and the dicts equal the
    reference's."""
    hists = rw_corpus(S, n=8, seed0=4900)
    L.DISPATCH_LOG.clear()
    got = L.check_batch(MODEL, hists, device="cpu",
                        scheduler_opts=dict(SCHED))
    assert any(t[0] == "dc" for t in L.DISPATCH_LOG)
    assert all(r["provenance"] == "device" for r in got)
    assert got == RL.check_batch_tpu(r_cas(), rw_corpus(RS, n=8,
                                                        seed0=4900),
                                     scheduler_opts=dict(SCHED))


def test_router_disable_restores_scan_path(monkeypatch):
    """JT_ROUTER_DC=0 makes the forced pre-filter vanish: same verdicts,
    no dc dispatch, no wgl-dc provenance."""
    hists = rw_corpus(S, n=8, seed0=4600)
    base = L.check_batch_columnar(MODEL, hists, details="invalid",
                                  device="cpu", scheduler_opts=dict(SCHED))
    monkeypatch.setenv("JT_ROUTER_DC", "0")
    L.DISPATCH_LOG.clear()
    off = L.check_batch_columnar(MODEL, hists, details="invalid",
                                 device="cpu", scheduler_opts=dict(SCHED))
    assert not any(t[0] == "dc" for t in L.DISPATCH_LOG)
    assert [r["valid"] for r in off] == [r["valid"] for r in base]
    assert all(r.get("provenance") != "wgl-dc" for r in off)


def test_auto_unprobed_dispatches_no_dc():
    """With no measured dc rate, "auto" never prices the pre-filter: no
    dc dispatch, and results bit-identical to the frontier-only run and
    to the reference's auto run."""
    hists = rw_corpus(S, n=12, seed0=5000)
    opts = {"chunk_rows": 8}
    L.DISPATCH_LOG.clear()
    auto = L.check_batch_columnar(MODEL, hists, details="invalid",
                                  device="cpu", scheduler_opts=opts)
    assert not any(t[0] == "dc" for t in L.DISPATCH_LOG)
    xla = L.check_batch_columnar(MODEL, hists, details="invalid",
                                 device="cpu",
                                 scheduler_opts={**opts,
                                                 "wgl_backend": "xla"})
    assert auto == xla
    assert auto == RL.check_batch_columnar(
        r_cas(), rw_corpus(RS, n=12, seed0=5000), details="invalid",
        scheduler_opts=opts)


def test_auto_engages_dc_under_favouring_rates(monkeypatch):
    """Pinned rates that price the peel loop under the scan engage it in
    "auto" per bucket shape, in both packages alike; the residue gate
    keeps it off a mostly-incapable batch."""
    monkeypatch.setenv("JT_DC_EVENTS_PER_S", "1e9")
    hists = rw_corpus(S, n=12, seed0=5100)
    L.DISPATCH_LOG.clear()
    got = L.check_batch_columnar(MODEL, hists, details="invalid",
                                 device="cpu",
                                 scheduler_opts={"chunk_rows": 8})
    assert any(t[0] == "dc" for t in L.DISPATCH_LOG)
    RL.DISPATCH_LOG.clear()
    assert got == RL.check_batch_columnar(
        r_cas(), rw_corpus(RS, n=12, seed0=5100), details="invalid",
        scheduler_opts={"chunk_rows": 8})
    assert any(t[0] == "dc" for t in RL.DISPATCH_LOG)
    assert D.router_prefers_dc(12, 64, 8, device="cpu") is \
        R.router_prefers_dc(12, 64, 8)
    monkeypatch.setenv("JT_DC_RESIDUE_MAX_FRAC", "0")
    cas = [S.synth_cas_history(60 + i, n_procs=3, n_ops=14)
           for i in range(4)] + hists[:4]
    sch = BucketScheduler(chunk_rows=64, device="cpu")
    for b in buckets(S, cas):
        plan = D.dc_plan(b)
        assert sch._dc_for(b) == (plan is not None
                                  and plan.capable_frac >= 1.0)


def test_unknown_backend_is_logged_and_ignored(caplog):
    """An unknown wgl_backend falls back to "auto" with the reference's
    warning."""
    sch = BucketScheduler(wgl_backend="tpu", device="cpu")
    assert sch.wgl_backend == "auto" == sch.stats["wgl_backend"]
    assert "ignoring unknown wgl_backend" in caplog.text
    assert RScheduler(wgl_backend="tpu").wgl_backend == "auto"


def test_dc_check_batch_matches_reference():
    """The route_check group engine: decided rows tagged wgl-dc, the
    rest as the scan tags them, equal to the reference's."""
    got = D.dc_check_batch(MODEL, mixed_corpus(S), device="cpu")
    want = R.dc_check_batch(r_cas(), mixed_corpus(RS))
    assert got == want
    assert all("provenance" in r for r in got)


def test_decode_takes_a_decided_chunk():
    """A chunk the peel loop decided alone arrives as host arrays with
    no frontier: all valid, no bad event, an empty invalid-row map. It
    goes through the decode-stage fault and validation like any chunk,
    so the decode takes the bucket (its event axis)."""
    from types import SimpleNamespace
    batch = SimpleNamespace(n_events=8)
    sch = BucketScheduler(return_frontier="invalid", device="cpu")
    out = (np.ones(3, bool), np.full(3, L.INT32_MAX, np.int32), None)
    v, b, fr = sch._decode_member(out, 3, batch)
    assert v.all() and (b == L.INT32_MAX).all() and fr == {}
    sch = BucketScheduler(return_frontier=False, device="cpu")
    assert sch._decode_member(out, 2, batch)[2] is None

