"""The port's native host engines (jepsen_torch.native) against the
numpy and Python walks they replace and against the reference's own
native engines (jepsen_tpu.native).

* ``encode_walk`` (the columnar encode walk in C++) bit for bit against
  the numpy lockstep walk of ``encode_columnar(native=False)`` and the
  reference's ``encode_walk``: random cas and rw batches, info lines,
  rows past ``max_slots``, K >= 127 (int32 slot tables) and random line
  streams; the buckets of ``encode_columnar`` (fused and renumbered too)
  equal under both walks.
* ``ops_to_columnar(native=True)`` (the ingest walk as a CPython
  extension) field for field against ``native=False`` and the
  reference's: failed ops, nemesis, bool and float processes, orphan
  completions, crashed invocations and never-ok identity reads.
* ``wgl_check_native`` and ``check_batch_native`` against the port's
  ``wgl_check`` (verdict and bad op) and the reference's native engine
  (the whole dict), the routing to ``wgl_check`` on a state-space
  explosion and on a search that gives up included;
  ``LinearizableChecker(backend="native")``.
* ``check_columnar`` with ``min_device_batch`` (the C++ tail), the
  verdict-only re-derivation of fused-run failures through
  ``check_batch_native``, and ``check_batch``'s small buckets, each
  against the reference on the same batch (the port on the CPU; the
  reference never shards, ``shard_min_rows=1 << 30``, and both run the
  same ``fuse_width``).
* No fallback: a missing or failing compiler raises under
  ``native=True``; ``native=False`` runs the numpy walk.

Inputs come from numpy seeds, a few dozen short rows. Tolerance: none,
exact equality throughout.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from jepsen_tpu import native as RN
from jepsen_tpu.history import columnar as RC
from jepsen_tpu.history import ops as RO
from jepsen_tpu.history.core import index as r_index
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.models.core import mutex as r_mutex
from jepsen_tpu.ops import linearize as RL
from jepsen_tpu.workloads import synth as RS

from jepsen_torch import native as N
from jepsen_torch.checkers.linearizable import linearizable, wgl_check
from jepsen_torch.history import columnar as PC
from jepsen_torch.history import ops as PO
from jepsen_torch.history.core import index as p_index
from jepsen_torch.models.core import cas_register, mutex
from jepsen_torch.ops import _build
from jepsen_torch.ops import encode as E
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.statespace import enumerate_statespace
from jepsen_torch.workloads import synth as S

# One intra-op thread: test processes running side by side must not
# oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
MODEL = cas_register()
FIELDS = ("ev_type", "ev_slot", "ev_slots", "ev_opidx", "target")
P_OPTS = {"scheduler_opts": {"fuse_width": 4}}
R_OPTS = {"scheduler_opts": {"fuse_width": 4, "shard_min_rows": 1 << 30}}


def events(n: int) -> int:
    """The walk's event buffer for ``n`` lines (encode_columnar's E)."""
    return E._round_up(n // 2 + 1, 8)


def numpy_walk(cols, S_, K, monkeypatch):
    """The numpy lockstep walk's raw arrays: encode_columnar(native=
    False) with the bucketing step captured."""
    got = {}

    def capture(space, *walked, **kw):
        got["walked"] = walked[:6]
        return [], []
    with monkeypatch.context() as m:
        m.setattr(E, "_bucket_encoded", capture)
        space = type("Space", (), {"n_kinds": K})()
        E.encode_columnar(space, cols, max_slots=S_, native=False)
    return got["walked"]


def assert_walks_equal(a, b):
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def cas_cols(n, seed, **kw):
    c = S.synth_cas_columnar(n, seed=seed, **kw)
    return c


WALK_CASES = [
    ("calm", dict(n_procs=4, corrupt=0.1, p_info=0.01), 16),
    ("info_overflow", dict(n_procs=6, corrupt=0.3, p_info=0.3), 6),
    ("small_window", dict(n_procs=3, corrupt=0.2, p_info=0.0), 3),
    ("keyed", dict(n_procs=5, corrupt=0.2, p_info=0.05, n_keys=3), 8),
]


@pytest.mark.parametrize("kw,max_slots", [c[1:] for c in WALK_CASES],
                         ids=[c[0] for c in WALK_CASES])
def test_encode_walk_matches_numpy_and_reference(kw, max_slots,
                                                 monkeypatch):
    cols = cas_cols(48, 13, n_ops=40, n_values=4, **kw)
    K = enumerate_statespace(MODEL, cols.kinds, 64).n_kinds
    Ev = events(cols.n_lines)
    got = N.encode_walk(cols.type, cols.process, cols.kind, Ev, max_slots,
                        K, n_threads=2)
    assert_walks_equal(got, numpy_walk(cols, max_slots, K, monkeypatch))
    assert_walks_equal(got, RN.encode_walk(cols.type, cols.process,
                                           cols.kind, Ev, max_slots, K))
    if kw["p_info"] >= 0.3:
        assert got[5].any(), "no row overflowed max_slots"


def test_encode_walk_threads_agree():
    """The threaded walk (64 rows and more spread over threads) equals
    the one-thread walk."""
    cols = cas_cols(96, 5, n_procs=5, n_ops=24, n_values=3, p_info=0.1)
    K = enumerate_statespace(MODEL, cols.kinds, 64).n_kinds
    args = (cols.type, cols.process, cols.kind, events(cols.n_lines), 8, K)
    assert_walks_equal(N.encode_walk(*args, n_threads=1),
                       N.encode_walk(*args, n_threads=4))


def test_encode_walk_rw_batch(monkeypatch):
    """Read/write histories at W 11-13 through the native ingest walk,
    then both encode walks."""
    hists = [S.synth_rw_history(s, n_procs=11 + s % 3, n_ops=30,
                                stale=0.3 if s % 2 else 0.0)
             for s in range(12)]
    cols = PC.ops_to_columnar(MODEL, hists)
    K = enumerate_statespace(MODEL, cols.kinds, 64).n_kinds
    for max_slots in (16, 12):
        got = N.encode_walk(cols.type, cols.process, cols.kind,
                            events(cols.n_lines), max_slots, K, n_threads=2)
        assert_walks_equal(got, numpy_walk(cols, max_slots, K, monkeypatch))
        assert_walks_equal(got, RN.encode_walk(
            cols.type, cols.process, cols.kind, events(cols.n_lines),
            max_slots, K))


@pytest.mark.parametrize("K", [5, 126, 127, 200])
def test_encode_walk_random_streams(K, monkeypatch):
    """Random line streams (pads, invokes, oks and infos of random
    processes, oks with no open invoke, a process re-invoking over its
    open slot), at K on each side of the int8 slot table's edge."""
    rng = np.random.default_rng(K)
    B, Nl, P = 20, 60, 7
    typ = rng.integers(-1, 3, (B, Nl)).astype(np.int8)
    proc = rng.integers(0, P, (B, Nl)).astype(np.int16)
    kind = np.where(typ == 0, rng.integers(0, K, (B, Nl)), -1
                    ).astype(np.int32)
    cols = PC.ColumnarOps(type=typ, process=proc, kind=kind, kinds=[])
    for max_slots in (32, 5):
        got = N.encode_walk(typ, proc, kind, events(Nl), max_slots, K)
        assert got[1].dtype == (np.int32 if K >= 127 else np.int8)
        assert_walks_equal(got, numpy_walk(cols, max_slots, K, monkeypatch))
        assert_walks_equal(got, RN.encode_walk(typ, proc, kind, events(Nl),
                                               max_slots, K))


def test_encode_walk_wide_kind_table():
    """K >= 127 flips the slot table to int32: a hand-computed walk."""
    K, S_, Ev = 200, 4, 8
    typ = np.array([[PC.C_INVOKE, PC.C_INVOKE, PC.C_OK, PC.C_OK]], np.int8)
    proc = np.array([[0, 1, 0, 1]], np.int16)
    kind = np.array([[150, 199, -1, -1]], np.int32)
    es, esl, eo, ml, ne, ov = N.encode_walk(typ, proc, kind, Ev, S_, K)
    assert esl.dtype == np.int32
    assert not ov[0] and ml[0] == 2 and ne[0] == 3
    assert es[0, :2].tolist() == [0, 1]
    assert esl[0, 0, :2].tolist() == [150, 199]
    assert esl[0, 1, :2].tolist() == [K, 199]
    assert esl[0, 2, :].tolist() == [K] * S_
    assert eo[0, :3].tolist() == [2, 3, -1]


def test_encode_walk_checks_its_inputs():
    typ = np.zeros((1, 4), np.int8)
    kind = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError, match="process"):
        N.encode_walk(typ, np.zeros((1, 4), np.int32), kind, 8, 4, 5)
    with pytest.raises(ValueError, match="outside"):
        N.encode_walk(typ, np.zeros((1, 4), np.int16), kind, 8, 33, 5)
    with pytest.raises(ValueError, match="below"):
        N.encode_walk(typ, np.zeros((1, 4), np.int16), kind, 2, 4, 5)


@pytest.mark.parametrize("fuse", [False, True], ids=["exact", "fused"])
def test_encode_columnar_buckets_native_equal_numpy(fuse):
    cols = cas_cols(40, 3, n_procs=5, n_ops=30, n_values=5, corrupt=0.3,
                    p_info=0.1)
    space = enumerate_statespace(MODEL, cols.kinds, 64)
    kw = dict(max_slots=6, fuse=fuse, renumber=fuse)
    b1, f1 = E.encode_columnar(space, cols, native=False, **kw)
    b2, f2 = E.encode_columnar(space, cols, native=True, **kw)
    assert f1 == f2 and f1
    assert [(b.V, b.W, b.indices) for b in b1] == \
        [(b.V, b.W, b.indices) for b in b2]
    for x, y in zip(b1, b2):
        for f in FIELDS:
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


# ------------------------------------------------------------ ingest walk

def raw_histories(seed: int, n: int, n_ops: int = 24):
    """Recorded histories as (process, type, f, value) tuples: reads,
    writes and cas over 3 values with ok, fail and info completions,
    crashed invocations, orphan completions, nemesis ops and processes
    that are a bool (True, the same key as 1) or a float."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        procs = [0, 1, 2, True, 1.5]
        open_: dict = {}
        h = []
        for _ in range(n_ops):
            u = rng.random()
            if u < 0.07:
                h.append(("nemesis", "info", "start", None))
                continue
            if u < 0.1:
                h.append((int(rng.integers(0, 3)), "ok", "read", 1))
                continue
            p = procs[int(rng.integers(0, len(procs)))]
            if p not in open_:
                f = ("read", "write", "cas")[int(rng.integers(0, 3))]
                v = (None if f == "read" else int(rng.integers(0, 3))
                     if f == "write" else [int(rng.integers(0, 3)),
                                           int(rng.integers(0, 3))])
                open_[p] = (f, v)
                h.append((p, "invoke", f, v))
            else:
                f, v = open_.pop(p)
                t = ("ok", "ok", "fail", "info")[int(rng.integers(0, 4))]
                if f == "read" and t == "ok":
                    v = int(rng.integers(0, 3))
                h.append((p, t, f, v))
        out.append(h)
    return out


def materialize(raw, pkg_ops, index):
    return [index([pkg_ops.Op(process=p, type=t, f=f, value=v)
                   for p, t, f, v in h]) for h in raw]


def cols_fields(c):
    return (c.type, c.process, c.kind, c.index, c.key)


def assert_cols_equal(a, b):
    assert a.kinds == b.kinds
    for x, y in zip(cols_fields(a), cols_fields(b)):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ops_to_columnar_native_matches_python_and_reference(seed):
    raw = raw_histories(seed, 16)
    p_h = materialize(raw, PO, p_index)
    r_h = materialize(raw, RO, r_index)
    got = PC.ops_to_columnar(MODEL, p_h, native=True)
    assert_cols_equal(got, PC.ops_to_columnar(MODEL, p_h, native=False))
    for native in (True, False):
        assert_cols_equal(got, RC.ops_to_columnar(r_cas(), r_h,
                                                  native=native))
    # What the rows hold: nemesis and float-process ops skipped, failed
    # ops' lines gone, the never-ok identity reads dropped.
    assert got.process.max() <= 3


def test_ops_to_columnar_seeded_vocabulary_and_tuples():
    """A seeded vocabulary keeps its indices; tuple histories and empty
    histories walk too."""
    raw = raw_histories(7, 6, n_ops=16) + [[]]
    p_h = [tuple(h) for h in materialize(raw, PO, p_index)]
    r_h = [tuple(h) for h in materialize(raw, RO, r_index)]
    seed_kinds = S.cas_kind_vocabulary(3)
    got = PC.ops_to_columnar(MODEL, p_h, kinds=seed_kinds)
    assert got.kinds[:len(seed_kinds)] == seed_kinds
    assert_cols_equal(got, PC.ops_to_columnar(MODEL, p_h, kinds=seed_kinds,
                                              native=False))
    assert_cols_equal(got, RC.ops_to_columnar(r_cas(), r_h,
                                              kinds=seed_kinds))


# ------------------------------------------------------------ WGL search

def both_batches(n, seed0=21, **kw):
    kw = dict(dict(n_procs=4, n_ops=20, n_values=3, corrupt=0.3,
                   p_info=0.12), **kw)
    return (S.synth_cas_batch(n, seed0=seed0, **kw),
            RS.synth_cas_batch(n, seed0=seed0, **kw))


def verdict(r):
    return r["valid"], r.get("op", {}).get("index")


def test_wgl_check_native_matches_host_and_reference():
    p_h, r_h = both_batches(40)
    got = [N.wgl_check_native(MODEL, h) for h in p_h]
    batch = N.check_batch_native(MODEL, p_h, n_threads=3)
    want = RN.check_batch_native(r_cas(), r_h, n_threads=2)
    assert got == batch == want
    host = [wgl_check(MODEL, h) for h in p_h]
    assert [verdict(r) for r in got] == [verdict(r) for r in host]
    assert {r["valid"] for r in got} == {True, False}
    # An invalid row's op is the host engine's op, field for field.
    assert all(g.get("op") == h.get("op") for g, h in zip(got, host))


def test_wgl_check_native_hand_cases():
    h = [PO.invoke_op(0, "write", 1), PO.ok_op(0, "write", 1),
         PO.invoke_op(1, "write", 2), PO.info_op(1, "write", 2),
         PO.invoke_op(2, "read", None), PO.ok_op(2, "read", 1),
         PO.invoke_op(2, "read", None), PO.ok_op(2, "read", 2),
         PO.invoke_op(2, "read", None), PO.ok_op(2, "read", 1)]
    r = N.wgl_check_native(MODEL, p_index(h))
    assert r["valid"] is False and r["op"]["index"] == 9
    bad = p_index([PO.invoke_op(0, "acquire", None),
                   PO.ok_op(0, "acquire", None),
                   PO.invoke_op(1, "acquire", None),
                   PO.ok_op(1, "acquire", None)])
    assert N.wgl_check_native(mutex(), bad)["valid"] is False
    r_bad = r_index([RO.invoke_op(0, "acquire", None),
                     RO.ok_op(0, "acquire", None),
                     RO.invoke_op(1, "acquire", None),
                     RO.ok_op(1, "acquire", None)])
    assert N.wgl_check_native(mutex(), bad) == \
        RN.wgl_check_native(r_mutex(), r_bad)
    # Unindexed histories are indexed in place first.
    h = [PO.invoke_op(0, "write", 1), PO.ok_op(0, "write", 1),
         PO.invoke_op(0, "read", None), PO.ok_op(0, "read", 2)]
    assert N.wgl_check_native(MODEL, h)["op"]["index"] == 3


@pytest.mark.parametrize("kw", [{"max_states": 2}, {"max_configs": 3}],
                         ids=["state_space_explosion", "search_gave_up"])
def test_native_routes_to_wgl_check(kw):
    """A state space past max_states, and a search past max_configs
    (verdict -1), are decided by wgl_check, as in the reference."""
    p_h, r_h = both_batches(12, seed0=4, n_procs=5)
    got = N.check_batch_native(MODEL, p_h, n_threads=2, **kw)
    one = [N.wgl_check_native(MODEL, h, **kw) for h in p_h]
    want = RN.check_batch_native(r_cas(), r_h, n_threads=2, **kw)
    assert got == one == want
    host = [wgl_check(MODEL, h, max_configs=kw.get("max_configs",
                                                   2_000_000))
            for h in p_h]
    assert [verdict(r) for r in got] == [verdict(r) for r in host]
    # Routed rows carry wgl_check's whole dict (its config sample, or
    # "unknown" where the Python search gave up too).
    routed = [i for i, r in enumerate(got)
              if "configs" in r or r["valid"] == "unknown"]
    assert len(routed) >= (len(got) if "max_states" in kw else 1)
    assert all(got[i] == host[i] for i in routed)


def test_linearizable_checker_native_backend():
    p_h, r_h = both_batches(8, seed0=40)
    chk = linearizable("native")
    from jepsen_tpu.checkers.linearizable import linearizable as r_lin
    rchk = r_lin("native")
    for p, r in zip(p_h, r_h):
        assert chk.check({}, MODEL, p) == rchk.check({}, r_cas(), r)


# ------------------------------------------------- the engines, wired in

def wide_rows(pkg_synth, pkg_index, ops):
    """Wide-window rows for the tail: a valid W 17 row, and W 17 and W 16
    rows that fail at their first read (so that the host engine, which
    re-derives an invalid tail row's dict, stops there)."""
    def early_fail(width):
        h = [ops.invoke_op(width - 1, "read", None),
             ops.ok_op(width - 1, "read", 7)]
        return pkg_index(h + pkg_synth.synth_wide_window_history(
            width=width))
    return [pkg_synth.synth_wide_window_history(width=17), early_fail(17),
            early_fail(16)]


def tail_corpus():
    p_h, r_h = both_batches(24, seed0=60, n_procs=4, n_ops=18)
    return (p_h + wide_rows(S, p_index, PO),
            r_h + wide_rows(RS, r_index, RO))


@pytest.mark.parametrize("scheduler", [True, False],
                         ids=["scheduler", "exact"])
@pytest.mark.parametrize("details", [False, "invalid"])
def test_check_columnar_native_tail_matches_reference(scheduler, details,
                                                      monkeypatch):
    """Wide buckets smaller than min_device_batch are decided by the C++
    tail on its thread: no wide launch, and the reference's results."""
    p_h, r_h = tail_corpus()
    calls = []
    real = N.check_batch_native

    def counted(model, hs, **kw):
        calls.append(len(hs))
        return real(model, hs, **kw)
    monkeypatch.setattr(N, "check_batch_native", counted)
    pc = PC.ops_to_columnar(MODEL, p_h)
    rc = RC.ops_to_columnar(r_cas(), r_h)
    L.DISPATCH_LOG.clear()
    got = L.check_columnar(MODEL, pc, device=CPU, details=details,
                           min_device_batch=4, scheduler=scheduler,
                           **P_OPTS)
    want = RL.check_columnar(r_cas(), rc, details=details,
                             min_device_batch=4, scheduler=scheduler,
                             **R_OPTS)
    assert sum(calls) >= 3, "the wide rows did not reach the C++ tail"
    assert all(W < 16 for _, _, W, _ in L.DISPATCH_LOG)
    if details:
        assert got == want
        assert [r["valid"] for r in got[-3:]] == [True, False, False]
    else:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[0][-3:].tolist() == [True, False, False]


def test_fused_refine_rows_ride_the_native_engine(monkeypatch):
    """Verdict-only callers re-derive the rows that failed inside a
    fused run with check_batch_native, details callers with the host
    engine's dicts; both as the reference does."""
    spec = dict(n=32, seed=0, n_procs=2, n_ops=30, n_values=2,
                corrupt=0.9)
    pc = S.synth_cas_columnar(spec["n"], seed=spec["seed"],
                              **{k: v for k, v in spec.items()
                                 if k not in ("n", "seed")})
    rc = RS.synth_cas_columnar(spec["n"], seed=spec["seed"],
                               **{k: v for k, v in spec.items()
                                  if k not in ("n", "seed")})
    refined = []
    real = N.check_batch_native

    def counted(model, hs, **kw):
        refined.append(len(hs))
        return real(model, hs, **kw)
    monkeypatch.setattr(N, "check_batch_native", counted)
    got = L.check_columnar(MODEL, pc, device=CPU, **P_OPTS)
    want = RL.check_columnar(r_cas(), rc, **R_OPTS)
    assert refined and refined[0] > 0, "no row failed inside a fused run"
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    n_refined = refined[0]
    refined.clear()
    got_d = L.check_columnar(MODEL, pc, device=CPU, details=True, **P_OPTS)
    want_d = RL.check_columnar(r_cas(), rc, details=True, **R_OPTS)
    assert got_d == want_d
    assert not refined, "details callers take the host engine's dicts"
    assert sum(r.get("provenance") == "host-fallback" for r in got_d) \
        >= n_refined


@pytest.mark.parametrize("scheduler", [True, False],
                         ids=["scheduler", "exact"])
def test_check_batch_small_buckets_ride_the_native_engine(scheduler,
                                                          monkeypatch):
    p_h, r_h = tail_corpus()
    calls = []
    real = N.check_batch_native

    def counted(model, hs, **kw):
        calls.append(len(hs))
        return real(model, hs, **kw)
    monkeypatch.setattr(N, "check_batch_native", counted)
    got = L.check_batch(MODEL, p_h, device=CPU, min_device_batch=4,
                        scheduler=scheduler, partition=False, **P_OPTS)
    want = RL.check_batch_tpu(r_cas(), r_h, min_device_batch=4,
                              scheduler=scheduler, partition=False,
                              **R_OPTS)
    assert calls
    assert got == want



def test_engines_from_many_threads(monkeypatch, tmp_path):
    """More threads than cores racing to build, load and call the search
    and the encode walk: one library, every result the one-thread
    result."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(N, "_lib", None)
    cols = cas_cols(32, 2, n_procs=4, n_ops=20, n_values=3, p_info=0.1)
    K = enumerate_statespace(MODEL, cols.kinds, 64).n_kinds
    args = (cols.type, cols.process, cols.kind, events(cols.n_lines), 8, K)
    want_v = [verdict(wgl_check(MODEL, h))
              for h in both_batches(10, seed0=5)[0]]
    got_v, got_w = [], []

    def work():
        got_v.append([verdict(r) for r in N.check_batch_native(
            MODEL, both_batches(10, seed0=5)[0], n_threads=2)])
        got_w.append(N.encode_walk(*args, n_threads=2))
    threads = [threading.Thread(target=work) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got_v == [want_v] * 16 and len(got_w) == 16
    for w in got_w:
        assert_walks_equal(w, got_w[0])
    assert len(list((tmp_path / "build").glob("libwgl-*.so"))) == 1

# ------------------------------------------------------------ no fallback

@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """A fresh build directory and a compiler that does not exist."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(N, "CXX", "no-such-cxx-compiler")
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_ingest_mod", None)


def test_missing_compiler_raises_and_native_false_runs_numpy(no_compiler):
    cols = cas_cols(8, 1, n_procs=3, n_ops=10, n_values=3)
    space = enumerate_statespace(MODEL, cols.kinds, 64)
    with pytest.raises(OSError):
        E.encode_columnar(space, cols)
    with pytest.raises(OSError):
        N.check_batch_native(MODEL, S.synth_cas_batch(2, n_ops=6))
    with pytest.raises(OSError):
        PC.ops_to_columnar(MODEL, S.synth_cas_batch(2, n_ops=6))
    buckets, _ = E.encode_columnar(space, cols, native=False)
    assert sum(b.batch for b in buckets) == cols.batch
    PC.ops_to_columnar(MODEL, S.synth_cas_batch(2, n_ops=6), native=False)


def test_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                      tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build broken.cpp"):
        _build.build_library(src, {}, compiler="g++",
                             flags=_build.GXX_FLAGS)
    assert not list((tmp_path / "build").glob("*.so"))
