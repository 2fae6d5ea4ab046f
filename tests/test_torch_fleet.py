"""The port's cost router (jepsen_torch.fleet: rates, pricing, choices and
route_check) against the reference's jepsen_tpu.fleet.

Prices are held as equal floats under the same rates (tests/conftest.py
pins JT_DISPATCH_OVERHEAD_US=0, so neither package probes its dispatch
overhead), choices and summaries field for field, and route_check's
results and routing on mixed corpora against the reference's, the port
on the CPU. Mirrored from the reference's tests/test_fleet.py: the W and
graph crossovers, the post-partition W estimate, router-choice parity on
a mixed corpus, and the dc backend's rates, selection and group
dispatch. Both packages' host-oracle groups run their native engines
(whose dicts carry the verdict and bad op), so every row is held field
for field. Tolerance: none.
"""
import socket
from types import SimpleNamespace

import pytest
import torch

from jepsen_tpu import fleet as RF
from jepsen_tpu.history.ops import Op as r_Op
from jepsen_tpu.independent import KV as r_KV
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops.synth_txn import TxnSpec as r_TxnSpec
from jepsen_tpu.ops.synth_txn import synth_txn_batch as r_txn_batch
from jepsen_tpu.store import atomic_write_json
from jepsen_tpu.workloads import synth as RS

from jepsen_torch import fleet as F
from jepsen_torch.checkers.linearizable import wgl_check
from jepsen_torch.history.core import index
from jepsen_torch.history.ops import Op, invoke_op, ok_op
from jepsen_torch.independent import KV
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops.graph import check_graph_host, extract_graph
from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_batch
from jepsen_torch.workloads import synth as S

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

MODEL = cas_register()
RATES = {"lane_ops_per_s": 1e8, "host_s_per_event": 4e-4,
         "pallas_lane_ops_per_s": 0.0, "dc_events_per_s": 1e7}


@pytest.fixture(autouse=True)
def clean_overlay(monkeypatch):
    """No measured-rate overlay leaks into or out of a test: the overlay
    is process-wide, and other test files in this process route with
    the defaults."""
    for _, env in F._RATE_ENV:
        monkeypatch.delenv(env, raising=False)
    monkeypatch.delenv("JT_ROUTER_DC", raising=False)
    F.set_measured_rates(None)
    RF.set_measured_rates(None)
    yield
    F.set_measured_rates(None)
    RF.set_measured_rates(None)
    monkeypatch.setattr(F, "_PROBED_RATES", None)


def routers(rates=None, **kw):
    """The reference's router and the port's on the CPU, same rates."""
    return RF.CostRouter(rates=rates, **kw), F.CostRouter(rates=rates,
                                                          device="cpu", **kw)


# ------------------------------------------------------------ pricing

@pytest.mark.parametrize("w", [2, 8, 11, 15, 16, 24])
@pytest.mark.parametrize("dc", [False, True])
def test_price_wgl_equals_reference(w, dc):
    """Prices as equal floats, default and dc-favouring rates, every
    window including one past the frontier cap."""
    for rates in (None, RATES):
        r, p = routers(rates)
        for events, rows in ((96, 1), (1000, 64)):
            assert p.price_wgl(w, events, rows, dc=dc) == \
                r.price_wgl(w, events, rows, dc=dc)
            assert p.choose_wgl(w, events, rows, dc=dc) == \
                r.choose_wgl(w, events, rows, dc=dc)
        assert p.summary() == r.summary()


@pytest.mark.parametrize("n_vertices", [3, 40, 700])
def test_price_graph_and_txn_equal_reference(n_vertices):
    for rates in (None, {"macs_per_s": 1.0},
                  {"macs_per_s": 1e15, "graph_host_s_per_edge": 2e-6}):
        r, p = routers(rates)
        for rows in (1, 512):
            assert p.price_graph(n_vertices, 5 * n_vertices, rows) == \
                r.price_graph(n_vertices, 5 * n_vertices, rows)
            assert p.price_txn(n_vertices, 5 * n_vertices, rows) == \
                r.price_txn(n_vertices, 5 * n_vertices, rows)
            assert p.choose_graph(n_vertices, 9, rows) == \
                r.choose_graph(n_vertices, 9, rows)
            assert p.choose_txn(n_vertices, 9, rows) == \
                r.choose_txn(n_vertices, 9, rows)
        assert p.summary() == r.summary()


def test_cost_router_w_crossover():
    """Device cost doubles per W and the host is W-flat, so a crossover
    exists (with these rates between W 15 and 16); past the frontier cap
    only the host is capable; the table names the winner per W, equal to
    the reference's."""
    rates = {"lane_ops_per_s": 1e8, "host_s_per_event": 4e-4}
    r, p = routers(rates)
    assert p.choose_wgl(8, 1000)[0] == "wgl-device"
    b_hi, costs = p.choose_wgl(16, 1000)
    assert b_hi == "host-oracle"
    assert costs["wgl-device"] > costs["host-oracle"]
    big = F.CostRouter(rates={"lane_ops_per_s": 1e30,
                              "host_s_per_event": 4e-4}, device="cpu")
    assert big.choose_wgl(big.max_device_w + 1, 100)[0] == "host-oracle"
    tbl = p.table(ws=(4, 16))
    assert [t["backend"] for t in tbl] == ["wgl-device", "host-oracle"]
    assert p.table() == r.table()
    assert F.CostRouter(rates=RATES, device="cpu").table() == \
        RF.CostRouter(rates=RATES).table()


def test_cost_router_graph_crossover():
    dev = F.CostRouter(rates={"macs_per_s": 1e15,
                              "graph_host_s_per_edge": 2e-6}, device="cpu")
    host = F.CostRouter(rates={"macs_per_s": 1.0,
                               "graph_host_s_per_edge": 2e-6}, device="cpu")
    assert dev.choose_graph(64, 200)[0] == "graph-device"
    assert host.choose_graph(64, 200)[0] == "graph-host"
    assert dev.price_graph(64, 200, rows=1024)["graph-device"] <= \
        dev.price_graph(64, 200, rows=1)["graph-device"]


def test_max_device_w_from_env(monkeypatch):
    monkeypatch.setenv("JT_ROUTER_MAX_W", "12")
    r, p = routers(RATES)
    assert p.max_device_w == r.max_device_w == 12
    assert p.choose_wgl(13, 96) == r.choose_wgl(13, 96)
    monkeypatch.setenv("JT_ROUTER_MAX_W", "x")
    assert F.CostRouter(device="cpu").max_device_w == 22


def test_wgl_check_kwargs_equal_reference():
    for rates in (None, {"lane_ops_per_s": 1e12}, {"host_s_per_event": 1}):
        r, p = routers(rates)
        for n_procs in (3, 5, 18):
            spec = SimpleNamespace(n_ops=1000, n_keys=8, n_procs=n_procs)
            assert p.wgl_check_kwargs(spec) == r.wgl_check_kwargs(spec)


# ------------------------------------------------------ unit features

def test_estimate_w_post_partition():
    """Two independent keys, each a 2-wide window: the unit's W is the
    per-key window, not the merged 4-wide one, in both packages."""
    def hist(op, kv):
        return [op(process=p, type=t, f="write", value=kv(k, p), time=tm)
                for p, t, k, tm in ((0, "invoke", "a", 0),
                                    (1, "invoke", "a", 1),
                                    (2, "invoke", "b", 2),
                                    (3, "invoke", "b", 3),
                                    (0, "ok", "a", 10), (1, "ok", "a", 11),
                                    (2, "ok", "b", 12), (3, "ok", "b", 13))]
    h = hist(Op, KV)
    assert F.pending_window(h) == 4 == RF.pending_window(hist(r_Op, r_KV))
    assert F.estimate_w(h) == 2 == RF.estimate_w(hist(r_Op, r_KV))


def test_classify_history():
    txn = synth_txn_batch(TxnSpec(n=1, seed=3, anomaly="mix"))[0][0]
    assert F.classify_history(txn) == "txn"
    assert F.classify_history(S.synth_la_history(1)) == "graph"
    assert F.classify_history(S.synth_rw_history(1)) == "wgl"
    assert F.classify_history(S.synth_cas_history(1)) == "wgl"


# -------------------------------------------------------------- rates

def test_persisted_rates_pre_dc_file_loads_cleanly(tmp_path):
    """A rate file written before the dc backend existed (no
    dc_events_per_s) loads, and the router fills the dc rate from the
    default 0.0, which prices it out."""
    pre = {"host": "relic", "ts": 1700000000.0,
           "rates": {"lane_ops_per_s": 1e8, "host_s_per_event": 4e-4,
                     "macs_per_s": 1e12, "graph_host_s_per_edge": 2e-6,
                     "pallas_lane_ops_per_s": 3e7}}
    p = F.rates_path(tmp_path, "relic")
    assert p == RF.rates_path(tmp_path, "relic")
    p.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_json(p, pre)
    assert F.load_persisted_rates(tmp_path, "relic") == pre["rates"]
    atomic_write_json(F.rates_path(tmp_path),
                      dict(pre, host=socket.gethostname()))
    r = F.CostRouter(store_dir=tmp_path, device="cpu")
    assert r.rates["dc_events_per_s"] == 0.0
    assert r.rates["lane_ops_per_s"] == 1e8
    assert "wgl-dc" not in r.price_wgl(11, 96, dc=True)
    assert r.rates == RF.CostRouter(store_dir=tmp_path).rates


def test_persist_rates_round_trips_through_the_reference(tmp_path):
    """A file the port persists is the reference's format: each package
    loads the other's."""
    rates = {**RATES, "bogus": 3.0, "macs_per_s": 0.0}
    F.persist_rates(tmp_path / "port", rates, host="h1")
    RF.persist_rates(tmp_path / "ref", rates, host="h1")
    assert RF.load_persisted_rates(tmp_path / "port", "h1") == \
        F.load_persisted_rates(tmp_path / "ref", "h1") == \
        {k: v for k, v in RATES.items() if v}


def test_dc_rate_precedence_defaults_measured_env(monkeypatch):
    assert F.router_rates() == RF.router_rates()
    assert F.router_rates()["dc_events_per_s"] == 0.0
    F.set_measured_rates({"dc_events_per_s": 5e6, "bogus": 1.0,
                          "lane_ops_per_s": 0.0})
    assert F.router_rates()["dc_events_per_s"] == 5e6
    assert "bogus" not in F.router_rates()
    assert F.router_rates()["lane_ops_per_s"] == 1e8
    monkeypatch.setenv("JT_DC_EVENTS_PER_S", "7e6")
    assert F.router_rates()["dc_events_per_s"] == 7e6
    monkeypatch.setenv("JT_DC_EVENTS_PER_S", "fast")
    assert F.router_rates()["dc_events_per_s"] == 5e6


def test_probe_and_persist_on_the_cpu(tmp_path):
    """The startup probe measures both WGL backends and the host oracle
    on the CPU, installs them, persists them under this host's key, and
    a wide register unit then routes to the peel loop."""
    rates = F.probe_and_persist(tmp_path, device="cpu")
    assert rates["dc_events_per_s"] > 0
    assert rates["lane_ops_per_s"] > 0
    assert rates["pallas_lane_ops_per_s"] == 0.0
    assert rates["host_s_per_event"] > 0
    assert F.load_persisted_rates(tmp_path) == {
        k: v for k, v in rates.items() if v}
    assert F.router_rates()["dc_events_per_s"] == rates["dc_events_per_s"]
    assert F.probe_and_persist(device="cpu") == rates     # memoized
    r = F.CostRouter(store_dir=tmp_path, device="cpu")
    assert r.choose_wgl(11, 96, dc=True)[0] == "wgl-dc"


def test_cost_router_dc_selection(monkeypatch):
    """The dc backend is chosen only when measured rates favour it and
    the caller sniffed a capable unit, and vanishes when unprobed,
    incapable or switched off by JT_ROUTER_DC=0, as in the reference."""
    r, p = routers(RATES)
    b, costs = p.choose_wgl(11, 96, dc=True)
    assert (b, costs) == r.choose_wgl(11, 96, dc=True)
    assert b == "wgl-dc"
    assert costs["wgl-dc"] < min(costs["wgl-device"], costs["host-oracle"])
    b0, c0 = p.choose_wgl(11, 96)
    assert "wgl-dc" not in c0
    unprobed = F.CostRouter(rates=dict(RATES, dc_events_per_s=0.0),
                            device="cpu")
    assert unprobed.choose_wgl(11, 96, dc=True)[1].keys() == c0.keys()
    monkeypatch.setenv("JT_ROUTER_DC", "0")
    assert F.CostRouter(rates=RATES, device="cpu").choose_wgl(
        11, 96, dc=True) == (b0, c0)
    monkeypatch.delenv("JT_ROUTER_DC")
    wide = p.max_device_w + 4
    assert p.choose_wgl(wide, 2000, dc=True)[0] == "wgl-dc"
    assert unprobed.choose_wgl(wide, 2000, dc=True)[0] == "host-oracle"
    assert p.table(ws=(11,))[0]["backend"] == "wgl-dc"


def test_router_and_route_check_need_the_card_unless_told(monkeypatch):
    """No fallback: without a card the router and route_check raise
    unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.CostRouter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.route_check(MODEL, [S.synth_rw_history(1)])


# -------------------------------------------------------- route_check

def wide_window(width, invalid=False):
    """The port's copy of the reference's synth_wide_window_history
    (seed None): width - 1 crashed writes pin their slots, then one read
    completes while all of them are pending; ``invalid`` makes it
    observe a value no write produced."""
    h = [invoke_op(p, "write", p % 2) for p in range(width - 1)]
    h.append(invoke_op(width - 1, "read", None))
    h.append(ok_op(width - 1, "read", 7 if invalid else None))
    return index(h)


def mixed(M, txn_spec, txn_batch, wide):
    """cas register rows, two W 12 wide-window rows, list-append rows
    (every other one corrupted), wide read/write rows and a few
    transactional rows."""
    return (M.synth_cas_batch(8, seed0=3, n_procs=3, n_ops=18, n_values=3,
                              corrupt=0.4, p_info=0.1)
            + [wide(width=12), wide(width=12, invalid=True)]
            + [M.synth_la_history(i, n_procs=3, n_ops=18,
                                  corrupt=1.0 if i % 2 else 0.0)
               for i in range(4)]
            + [M.synth_rw_history(6200 + i, n_procs=11, n_ops=30,
                                  stale=0.3 if i % 3 == 0 else 0.0)
               for i in range(6)]
            + [h for h, _ in txn_batch(txn_spec(n=4, seed=7,
                                                anomaly="mix"))])


# The host oracle's per-event rate is pinned low enough that the W 12
# rows ride it, as the reference's own test sends W 17 rows there under
# the defaults (a W 17 row costs the port's Python host engine 13-20 s).
HOST = {"host_s_per_event": 2e-5}


@pytest.mark.parametrize("rates", [HOST, {**HOST, "macs_per_s": 1.0},
                                   {**RATES, **HOST}],
                         ids=["default", "graph-host", "dc"])
def test_route_check_matches_reference(rates):
    """route_check on a mixed corpus under three rate sets: the same
    backends, routing summary and result dicts as the reference's, and
    every verdict equal to its host oracle."""
    corpus = mixed(RS, r_TxnSpec, r_txn_batch,
                   RS.synth_wide_window_history)
    want, wr = RF.route_check(r_cas(), corpus,
                              router=RF.CostRouter(rates=rates))
    corpus = mixed(S, TxnSpec, synth_txn_batch, wide_window)
    got, gr = F.route_check(MODEL, corpus, device="cpu",
                            router=F.CostRouter(rates=rates, device="cpu"))
    assert gr == wr
    assert len(got) == len(want) == len(corpus)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["backend"] == w["backend"], i
        assert g == w, (i, g, w)
    for h, g in zip(corpus[:20], got):
        oracle = (check_graph_host(extract_graph(h))["valid"]
                  if F.classify_history(h) == "graph"
                  else g["valid"] if g["backend"] == "host-oracle"
                  else wgl_check(MODEL, h)["valid"])
        assert g["valid"] == oracle
    assert [g["backend"] for g in got[8:10]] == ["host-oracle"] * 2
    assert [g["valid"] for g in got[8:10]] == [True, False]
    assert gr["backends"]["graph-host" if "macs_per_s" in rates
                          else "graph-device"] == 4
    if "dc_events_per_s" in rates:
        assert gr["backends"]["wgl-dc"] == 6
    else:
        assert "wgl-dc" not in gr["backends"]


def test_route_check_dispatches_dc_group():
    """An unkeyed wide rw corpus under rates that favour the peel loop:
    one dc-forced columnar group, every row tagged wgl-dc, verdicts and
    bad ops those of the host oracle."""
    hists = [S.synth_rw_history(6200 + i, n_procs=11, n_ops=30,
                                stale=0.3 if i % 3 == 0 else 0.0)
             for i in range(9)]
    results, summary = F.route_check(
        MODEL, hists, device="cpu",
        router=F.CostRouter(rates=RATES, device="cpu"))
    assert all(res["backend"] == "wgl-dc" for res in results)
    for i, (res, h) in enumerate(zip(results, hists)):
        want = wgl_check(MODEL, h)
        assert res["valid"] == want["valid"], i
        if res["valid"] is False:
            assert res["op"]["index"] == want["op"]["index"], i
    assert summary["chosen"].get("wgl-dc") == len(hists)
    assert summary["backends"] == {"wgl-dc": len(hists)}
