"""The port's invariant fold checkers (jepsen_torch.ops.folds,
checkers.simple) against the reference.

The same histories, built once per package from one seeded description,
go through both packages' batch folds and host checkers; the port runs
on the CPU, where each of its four kernels is its plain version, held
here bit for bit against the reference's jax programs (``_set_kernel``,
``_crdb_set_kernel``, ``_tq_kernel``, ``_ids_kernel``,
``_counter_kernel``, ``_queue_kernel``, ``_fifo_kernel``) run by jax on
the CPU on seeded random line tensors with PAD and sentinel edges (the
kernels themselves are held against the plain versions on the card by
chip_smoke.py). Mirrored from the reference's tests/test_folds.py: every
family's parity with the host checker, the counter's overflow guard, the
FIFO error texts, the protocol adapters and empty histories; from
tests/test_suite_cockroach.py, the cockroach sets truth table. Tolerance:
none — result dicts field for field (a FIFO queue compared by its
pending elements, since the two packages' model objects never compare
equal), kernel outputs bit for bit.
"""
import random

import numpy as np
import pytest
import torch

from jepsen_tpu.checkers import simple as r_simple
from jepsen_tpu.history import core as r_core
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.models.core import fifo_queue as r_fifo_queue
from jepsen_tpu.models.core import unordered_queue as r_unordered_queue
from jepsen_tpu.ops import folds as R

from jepsen_torch.checkers import simple as p_simple
from jepsen_torch.history import core as p_core
from jepsen_torch.history import ops as p_ops
from jepsen_torch.models.core import FIFOQueue
from jepsen_torch.models.core import fifo_queue as p_fifo_queue
from jepsen_torch.models.core import unordered_queue as p_unordered_queue
from jepsen_torch.ops import cuda_folds
from jepsen_torch.ops import folds as F

# One intra-op thread: the plain scans run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

N_HIST = 40

# ------------------------------------------------------------- corpora


def build(events, pkg):
    """One history from (process, type, f, value) events, in either
    package's Op type (``pkg`` is "ref" or "port")."""
    ops, core = (r_ops, r_core) if pkg == "ref" else (p_ops, p_core)
    return core.index([ops.Op(process=p, type=t, f=f, value=v)
                       for p, t, f, v in events])


def both(events_list):
    return ([build(e, "ref") for e in events_list],
            [build(e, "port") for e in events_list])


def set_events(seed):
    rng = random.Random(seed)
    h, added_ok = [], []
    for i in range(rng.randrange(5, 30)):
        p = rng.randrange(4)
        h.append((p, "invoke", "add", i))
        r = rng.random()
        if r < 0.7:
            h.append((p, "ok", "add", i))
            added_ok.append(i)
        elif r < 0.85:
            h.append((p, "fail", "add", i))
        else:
            h.append((p, "info", "add", i))
    final = set(added_ok)
    if rng.random() < 0.4 and added_ok:     # lose an acknowledged add
        final.discard(rng.choice(added_ok))
    if rng.random() < 0.3:                  # element from nowhere
        final.add(10_000 + seed)
    final = sorted(final)
    if rng.random() < 0.2 and final:        # read one twice (crdb)
        final.append(final[0])
    h.append((0, "invoke", "read", None))
    if rng.random() < 0.9:
        h.append((0, "ok", "read", final))
    if rng.random() < 0.2:                  # a nemesis op is skipped
        h.append(("nemesis", "info", "start", None))
    return h


def total_queue_events(seed):
    rng = random.Random(seed)
    h, enq_ok = [], []
    for i in range(rng.randrange(5, 25)):
        p = rng.randrange(3)
        h.append((p, "invoke", "enqueue", i))
        r = rng.random()
        if r < 0.75:
            h.append((p, "ok", "enqueue", i))
            enq_ok.append(i)
        elif r < 0.9:
            h.append((p, "fail", "enqueue", i))
        else:
            h.append((p, "info", "enqueue", i))
    deqs = list(enq_ok)
    rng.shuffle(deqs)
    if rng.random() < 0.4 and deqs:
        deqs.pop()                           # lost element
    if rng.random() < 0.3 and deqs:
        deqs.append(rng.choice(deqs))        # duplicate delivery
    if rng.random() < 0.2:
        deqs.append(7_000 + seed)            # unexpected element
    drain_at = len(deqs) // 2 if rng.random() < 0.5 else None
    for j, v in enumerate(deqs):
        p = rng.randrange(3)
        if drain_at is not None and j == drain_at:
            h.append((p, "invoke", "drain", None))
            h.append((p, "ok", "drain", deqs[drain_at:]))
            break
        h.append((p, "invoke", "dequeue", None))
        h.append((p, "ok", "dequeue", v))
    return h


def counter_events(seed):
    rng = random.Random(seed)
    h = []
    lower = upper = 0
    pending = {}
    for _ in range(rng.randrange(10, 40)):
        p = rng.randrange(4)
        if p in pending:
            h.append((p, "ok", "read", pending.pop(p)))
            continue
        if rng.random() < 0.5:
            v = rng.randrange(1, 5)
            h.append((p, "invoke", "add", v))
            upper += v
            if rng.random() < 0.8:
                h.append((p, "ok", "add", v))
                lower += v
            else:
                h.append((p, "info", "add", v))
        else:
            val = rng.randrange(lower, upper + 1) if upper >= lower else 0
            if rng.random() < 0.2:
                val = upper + rng.randrange(5, 50)
            h.append((p, "invoke", "read", None))
            if rng.random() < 0.8:
                pending[p] = val
            else:
                h.append((p, "info", "read", None))
    return h


def ids_events(seed):
    rng = random.Random(seed)
    h, issued = [], []
    next_id = seed * 1000
    for _ in range(rng.randrange(5, 30)):
        p = rng.randrange(4)
        h.append((p, "invoke", "generate", None))
        r = rng.random()
        if r < 0.75:
            if issued and rng.random() < 0.15:
                v = rng.choice(issued)       # duplicate id
            else:
                v = next_id
                next_id += 1
            issued.append(v)
            h.append((p, "ok", "generate", v))
        elif r < 0.9:
            h.append((p, "fail", "generate", None))
        else:
            h.append((p, "info", "generate", None))
    return h


def queue_events(seed, fifo=False):
    rng = random.Random(seed)
    h, in_queue = [], []
    for i in range(rng.randrange(5, 25)):
        p = rng.randrange(3)
        if in_queue and rng.random() < 0.4:
            k = 0 if fifo and rng.random() < 0.8 else \
                rng.randrange(len(in_queue))
            v = in_queue.pop(k)
            if rng.random() < 0.1:
                v = 9_000 + seed             # dequeue from nowhere
            h.append((p, "invoke", "dequeue", None))
            h.append((p, "ok", "dequeue", v))
        else:
            h.append((p, "invoke", "enqueue", i))
            h.append((p, "ok", "enqueue", i))
            in_queue.append(i)
    if fifo and rng.random() < 0.3:          # drain, then one past the end
        for v in in_queue:
            h.append((0, "invoke", "dequeue", None))
            h.append((0, "ok", "dequeue", v))
        h.append((0, "invoke", "dequeue", None))
        h.append((0, "ok", "dequeue", 8_000))
    return h


def corpus(fn, **kw):
    return both([fn(s, **kw) for s in range(N_HIST)])


def fifo_pending(results):
    """FIFO results with each final queue as its pending elements."""
    return [{**r, "final-queue": list(r["final-queue"].pending)}
            if "final-queue" in r else r for r in results]


def queue_multiset(results):
    """Host unordered-queue results with the final queue as a dict."""
    return [{**r, "final-queue": dict(r["final-queue"].pending)}
            if "final-queue" in r else r for r in results]


def both_verdicts(results):
    vs = [r["valid"] for r in results]
    assert True in vs and False in vs


# ------------------------------------------------------ batch parity

def test_set_fold_parity():
    ref, port = corpus(set_events)
    got = F.check_sets_batch(port, device="cpu")
    assert got == R.check_sets_batch(ref)
    assert got == [r_simple.SetChecker().check({}, None, h) for h in ref]
    assert got == [p_simple.SetChecker().check({}, None, h) for h in port]
    both_verdicts(got)


def test_crdb_set_fold_parity():
    ref, port = corpus(set_events)
    got = F.check_crdb_sets_batch(port, device="cpu")
    assert got == R.check_crdb_sets_batch(ref)
    both_verdicts(got)
    assert any(r.get("duplicates") for r in got)


def test_total_queue_fold_parity():
    ref, port = corpus(total_queue_events)
    got = F.check_total_queues_batch(port, device="cpu")
    assert got == R.check_total_queues_batch(ref)
    assert got == [r_simple.TotalQueueChecker().check({}, None, h)
                   for h in ref]
    assert got == [p_simple.TotalQueueChecker().check({}, None, h)
                   for h in port]
    both_verdicts(got)


def test_counter_fold_parity():
    ref, port = corpus(counter_events)
    stats = {}
    got = F.check_counters_batch(port, device="cpu", stats_out=stats)
    assert got == R.check_counters_batch(ref)
    assert got == [r_simple.CounterChecker().check({}, None, h) for h in ref]
    assert got == [p_simple.CounterChecker().check({}, None, h)
                   for h in port]
    assert stats == {"host_rows": 0, "device_rows": N_HIST}
    both_verdicts(got)


def test_counter_fold_overflow_guard():
    """Values or running sums beyond int32 detour to the host checker
    instead of silently wrapping in the int32 scan (and a value of
    exactly -2^31 can't collide with the none-sentinel); the detour is
    counted."""
    big = [(0, "invoke", "add", 2**40), (0, "ok", "add", 2**40),
           (1, "invoke", "read", None), (1, "ok", "read", 2**40)]
    wrap = [e for _ in range(3) for e in
            ((0, "invoke", "add", 2**30), (0, "ok", "add", 2**30))] + \
        [(1, "invoke", "read", None), (1, "ok", "read", 3 * 2**30)]
    sentinel = [(0, "invoke", "add", -2**31), (0, "ok", "add", -2**31),
                (1, "invoke", "read", None), (1, "ok", "read", -2**31)]
    small = [(0, "invoke", "add", 1), (0, "ok", "add", 1),
             (1, "invoke", "read", None), (1, "ok", "read", 1)]
    ref, port = both([big, wrap, sentinel, small])
    stats = {}
    got = F.check_counters_batch(port, device="cpu", stats_out=stats)
    assert got == R.check_counters_batch(ref)
    assert got == [p_simple.CounterChecker().check({}, None, h)
                   for h in port]
    assert all(r["valid"] is True for r in got)
    assert stats == {"host_rows": 3, "device_rows": 1}
    stats = {}
    assert F.check_counters_batch(port[:3], device="cpu",
                                  stats_out=stats) == got[:3]
    assert stats == {"host_rows": 3, "device_rows": 0}


def test_unique_ids_fold_parity():
    ref, port = corpus(ids_events)
    got = F.check_unique_ids_batch(port, device="cpu")
    assert got == R.check_unique_ids_batch(ref)
    assert got == [r_simple.UniqueIdsChecker().check({}, None, h)
                   for h in ref]
    assert got == [p_simple.UniqueIdsChecker().check({}, None, h)
                   for h in port]
    both_verdicts(got)


def test_queue_fold_parity():
    ref, port = corpus(queue_events)
    got = F.check_queues_batch(port, device="cpu")
    assert got == R.check_queues_batch(ref)
    host = [p_simple.QueueChecker().check({}, p_unordered_queue(), h)
            for h in port]
    assert got == queue_multiset(host)
    assert [r["valid"] for r in got] == [
        r_simple.QueueChecker().check({}, r_unordered_queue(), h)["valid"]
        for h in ref]
    both_verdicts(got)


def test_fifo_queue_fold_parity():
    ref, port = corpus(queue_events, fifo=True)
    got = F.check_fifo_queues_batch(port, device="cpu")
    assert all(isinstance(r["final-queue"], FIFOQueue)
               for r in got if r["valid"])
    got = fifo_pending(got)
    assert got == fifo_pending(R.check_fifo_queues_batch(ref))
    assert got == fifo_pending(
        [r_simple.QueueChecker().check({}, r_fifo_queue(), h) for h in ref])
    assert got == fifo_pending(
        [p_simple.QueueChecker().check({}, p_fifo_queue(), h)
         for h in port])
    both_verdicts(got)
    errors = {r["error"].endswith("from empty queue")
              for r in got if not r["valid"]}
    assert errors == {True, False}


def test_fifo_queue_fold_error_texts():
    """In-order dequeues are valid, out-of-order ones not; a mismatch
    followed by in-order dequeues stays a mismatch (the head AT THE
    FAILURE decides empty against wrong); list payloads keep parity
    through vocabulary interning."""
    def hist(order):
        e = [x for i in range(4) for x in ((0, "invoke", "enqueue", i),
                                           (0, "ok", "enqueue", i))]
        return e + [x for v in order for x in ((1, "invoke", "dequeue",
                                                None),
                                               (1, "ok", "dequeue", v))]

    tricky = [(0, "invoke", "enqueue", 0), (0, "ok", "enqueue", 0),
              (1, "invoke", "dequeue", None), (1, "ok", "dequeue", 1),
              (1, "invoke", "dequeue", None), (1, "ok", "dequeue", 0)]
    lv = [(0, "invoke", "enqueue", [1, 2]), (0, "ok", "enqueue", [1, 2])]
    ref, port = both([hist([0, 1, 2, 3]), hist([0, 2, 1, 3]), hist([0, 1]),
                      hist([1]), tricky, lv])
    got = fifo_pending(F.check_fifo_queues_batch(port, device="cpu"))
    assert got == fifo_pending(R.check_fifo_queues_batch(ref))
    assert got == fifo_pending(
        [p_simple.QueueChecker().check({}, p_fifo_queue(), h)
         for h in port])
    assert [g["valid"] for g in got] == [True, False, True, False, False,
                                         True]
    assert "empty" not in got[4]["error"]
    assert got[5]["final-queue"] == [[1, 2]]


def test_crdb_sets_fold_truth_table():
    """The cockroach sets semantics (sets.clj:21-101): lost / unexpected
    / duplicate / revived each invalidate; recovered (indeterminate adds
    that appear) does not."""
    def h(adds, final):
        e = [x for v, typ in adds for x in ((0, "invoke", "add", v),
                                            (0, typ, "add", v))]
        return e + [(1, "invoke", "read", None), (1, "ok", "read", final)]

    rows = [
        h([(1, "ok"), (2, "ok")], [1, 2]),           # clean
        h([(1, "ok"), (2, "ok")], [1]),              # lost 2
        h([(1, "ok")], [1, 9]),                      # unexpected 9
        h([(1, "ok"), (2, "fail")], [1, 2]),         # revived 2
        h([(1, "ok"), (2, "info")], [1, 2]),         # recovered 2: fine
        h([(1, "ok")], [1, 1]),                      # duplicate 1
        [(0, "invoke", "add", 1), (0, "ok", "add", 1)],  # no read
    ]
    ref, port = both(rows)
    out = F.check_crdb_sets_batch(port, device="cpu")
    assert out == R.check_crdb_sets_batch(ref)
    assert [r["valid"] for r in out] == [
        True, False, False, False, True, False, "unknown"]
    assert out[1]["lost"] == "#{2}"
    assert out[2]["unexpected"] == "#{9}"
    assert out[3]["revived"] == "#{2}"
    assert out[4]["recovered"] == "#{2}"
    assert out[5]["duplicates"] == [1]


def test_fold_checker_protocol_adapters():
    cases = [
        (F.set_checker_cuda, set_events, p_simple.SetChecker(), None),
        (F.counter_checker_cuda, counter_events, p_simple.CounterChecker(),
         None),
        (F.total_queue_checker_cuda, total_queue_events,
         p_simple.TotalQueueChecker(), None),
        (F.unique_ids_checker_cuda, ids_events,
         p_simple.UniqueIdsChecker(), None),
    ]
    for factory, events, host, model in cases:
        h = build(events(3), "port")
        assert factory(device="cpu").check({}, None, h) == \
            host.check({}, model, h)
    h = build(queue_events(3), "port")
    assert F.queue_checker_cuda(device="cpu").check({}, None, h) == \
        queue_multiset([p_simple.QueueChecker().check(
            {}, p_unordered_queue(), h)])[0]
    h = build(queue_events(3, fifo=True), "port")
    assert F.fifo_queue_checker_cuda(device="cpu").check({}, None, h) == \
        p_simple.QueueChecker().check({}, p_fifo_queue(), h)
    h = build(set_events(3), "port")
    assert F.crdb_set_checker_cuda(device="cpu").check({}, None, h) == \
        F.check_crdb_sets_batch([h], device="cpu")[0]


def test_checkers_package_exports_the_fold_checkers():
    from jepsen_torch import checkers
    assert checkers.check_sets_batch is F.check_sets_batch
    assert checkers.fifo_queue_checker_cuda is F.fifo_queue_checker_cuda
    assert checkers.SetChecker is p_simple.SetChecker
    assert checkers.check_graphs_batch.__module__ == \
        "jepsen_torch.checkers.cycle"


def test_empty_histories():
    cpu = {"device": "cpu"}
    assert F.check_sets_batch([[]], **cpu)[0]["valid"] == "unknown"
    assert F.check_crdb_sets_batch([[]], **cpu)[0]["valid"] == "unknown"
    assert F.check_total_queues_batch([[]], **cpu)[0]["valid"] is True
    assert F.check_counters_batch([[]], **cpu)[0]["valid"] is True
    assert F.check_unique_ids_batch([[]], **cpu)[0]["valid"] is True
    assert F.check_queues_batch([[]], **cpu)[0]["valid"] is True
    assert F.check_fifo_queues_batch([[]], **cpu)[0] == {
        "valid": True, "final-queue": FIFOQueue()}
    for name in ("check_sets_batch", "check_crdb_sets_batch",
                 "check_total_queues_batch", "check_counters_batch",
                 "check_unique_ids_batch", "check_queues_batch",
                 "check_fifo_queues_batch"):
        assert getattr(F, name)([], **cpu) == getattr(R, name)([]) == []


@pytest.mark.parametrize("family", ["set", "crdb", "tq", "ids", "counter",
                                    "queue", "fifo"])
def test_fold_timings_split(family):
    """``timings`` gets the host clock's split of a batch."""
    events = {"set": set_events, "crdb": set_events,
              "tq": total_queue_events, "ids": ids_events,
              "counter": counter_events, "queue": queue_events,
              "fifo": queue_events}[family]
    port = [build(events(s), "port") for s in range(4)]
    fn = {"set": F.check_sets_batch, "crdb": F.check_crdb_sets_batch,
          "tq": F.check_total_queues_batch,
          "ids": F.check_unique_ids_batch,
          "counter": F.check_counters_batch, "queue": F.check_queues_batch,
          "fifo": F.check_fifo_queues_batch}[family]
    timings = {}
    fn(port, device="cpu", timings=timings)
    keys = {"encode_s", "upload_s", "launch_s", "copy_back_s", "decode_s"}
    if family == "counter":
        keys.add("host_detour_s")
    assert set(timings) == keys
    assert all(v >= 0 for v in timings.values())


# ---------------------------------------------- encoders and lowering

def test_encode_matches_the_reference():
    """The line tensors, the vocabulary (first-seen order, lists as
    tuples, None interned) and the final-read bitmap equal the
    reference's."""
    ref, port = corpus(set_events)
    a = R._encode(ref, {"add": R.F_ADD})
    b = F._encode(port, {"add": F.F_ADD})
    for name in ("typ", "f", "val", "proc"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert a.vocab == b.vocab
    Va, fa, ha, _ = R._final_read_bitmap(ref, a)
    Vb, fb, hb, _ = F._final_read_bitmap(port, b)
    assert Va == Vb and a.vocab == b.vocab
    assert np.array_equal(fa, fb.astype(bool)) and np.array_equal(ha, hb)
    ref, port = corpus(counter_events)
    a = R._encode(ref, {"add": 0, "read": 1}, raw_values=True)
    b = F._encode(port, {"add": 0, "read": 1}, raw_values=True)
    for name in ("typ", "f", "val", "proc"):
        assert np.array_equal(getattr(a, name), getattr(b, name))


def test_complete_matches_the_reference_on_fail_and_info_adds():
    """The cockroach sets and the counter complete histories first."""
    for s in range(N_HIST):
        for events in (set_events(s), counter_events(s)):
            ref, port = build(events, "ref"), build(events, "port")
            a, b = r_core.complete(ref), p_core.complete(port)
            assert [(o.process, o.type, o.f, o.value) for o in a] == \
                [(o.process, o.type, o.f, o.value) for o in b]


@pytest.mark.parametrize("family,entry", [
    ("set", "fold_counts"), ("crdb", "fold_counts"), ("tq", "fold_counts"),
    ("ids", "fold_counts"), ("counter", "counter_scan"),
    ("queue", "queue_scan"), ("fifo", "fifo_scan")])
def test_lower_names_the_kernel_and_its_width(family, entry):
    events = {"set": set_events, "crdb": set_events,
              "tq": total_queue_events, "ids": ids_events,
              "counter": counter_events, "queue": queue_events,
              "fifo": queue_events}[family]
    port = [build(events(s), "port") for s in range(6)]
    lw = F.lower(family, port)
    assert lw.entry == entry
    assert lw.family == (family if entry == "fold_counts" else None)
    B, N = lw.arrays[0].shape
    assert B == 6 and all(a.shape[0] == B for a in lw.arrays
                          if a is not None)
    width = lw.width
    assert width >= 1 and width & (width - 1) == 0
    if entry == "fifo_scan":
        assert width >= N


# ------------------------------------- plain kernels vs the reference

def random_lines(seed, B, N, V, raw=False, P=None, span=None):
    """Seeded int32 [B, N] line tensors with PAD tails (some with
    garbage f and val), every (type, f) code, values past V - 1 (below
    ``span`` where given, so that values repeat), negatives and
    NONE_SENTINEL; processes in [0, P), half of them in [0, 4) so that
    reads pair up."""
    rng = np.random.default_rng(seed)
    none = int(R.NONE_SENTINEL)
    typ = rng.integers(0, 4, (B, N)).astype(np.int32)
    f = rng.integers(0, 3, (B, N)).astype(np.int32)
    if raw:
        val = rng.integers(-3, 40, (B, N)).astype(np.int32)
    else:
        val = rng.integers(0, min(V + 3, span or V + 3), (B, N)
                           ).astype(np.int32)
    odd = rng.random((B, N))
    val[odd < 0.05] = none
    val[(odd >= 0.05) & (odd < 0.1)] = -7
    live = rng.integers(0, N + 1, B)
    live[0] = N
    pad = np.arange(N)[None, :] >= live[:, None]
    typ[pad] = -1
    clean = pad & (rng.random((B, N)) < 0.5)
    f[clean] = 0
    val[clean] = none
    out = [typ, f, val]
    if P is not None:
        few = rng.integers(0, min(P, 4), (B, N))
        out.append(np.where(rng.random((B, N)) < 0.5, few,
                            rng.integers(0, P, (B, N))).astype(np.int32))
    return out


def queue_lines(seed, B, N, V):
    """Lines whose dequeues mostly follow their enqueues, so both
    verdicts (and both FIFO errors) occur."""
    typ, f, val = random_lines(seed, B, N, V)
    rng = np.random.default_rng(seed + 1)
    f = np.where(typ >= 0, rng.integers(0, 2, (B, N)), f).astype(np.int32)
    enq = (typ == 0) & (f == 0)
    deq = (typ == 1) & (f == 1)
    run = np.where(enq, np.cumsum(enq, 1) - 1, np.cumsum(deq, 1) - 1) % V
    keep = (rng.random((B, N)) < 0.9) & (typ >= 0)
    val = np.where(keep, run, val).astype(np.int32)
    return [typ, f, val]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(got, want):
    assert got.dtype == (torch.uint8 if want.dtype == bool
                         else torch.int32)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(
        got.numpy().dtype))


COUNT_VS = (1, 2, 31, 32, 33, 64)


@pytest.mark.parametrize("V", COUNT_VS)
@pytest.mark.parametrize("family", ["set", "crdb"])
def test_plain_set_counts_match_reference_kernels(family, V):
    typ, f, val = random_lines(V, 12, 57, V)
    final = np.random.default_rng(V).random((12, V)) < 0.5
    ref = (R._set_kernel if family == "set" else R._crdb_set_kernel)(V)(
        typ, f, val, final)
    planes, attempted = F.plain_fold_counts(
        family, t(typ), t(f), t(val), t(final.astype(np.uint8)), V)
    assert attempted is None and planes.shape == (12, len(ref), V)
    for k, want in enumerate(ref):
        same(planes[:, k], want)
    assert 0 < int(planes.sum()) < planes.numel()


@pytest.mark.parametrize("V", COUNT_VS)
def test_plain_tq_counts_match_reference_kernel(V):
    typ, f, val = random_lines(100 + V, 16, 120, V, span=4)
    ref = R._tq_kernel(V)(typ, f, val)
    planes, attempted = F.plain_fold_counts("tq", t(typ), t(f), t(val),
                                            None, V)
    assert attempted is None
    for k, want in enumerate(ref):
        same(planes[:, k], want)
    assert int(planes[:, 3].sum()) > 0     # some duplicated counts


@pytest.mark.parametrize("V", COUNT_VS)
def test_plain_ids_counts_match_reference_kernel(V):
    typ, f, val = random_lines(200 + V, 12, 57, V)
    acks, attempted = R._ids_kernel(V)(typ, f, val)
    planes, att = F.plain_fold_counts("ids", t(typ), t(f), t(val), None, V)
    same(planes[:, 0], acks)
    same(att, attempted)


@pytest.mark.parametrize("P", [1, 2, 4, 16, 64, 128])
def test_plain_counter_scan_matches_reference_kernel(P):
    typ, f, val, proc = random_lines(300 + P, 9, 80, None, raw=True, P=P)
    ref = R._counter_kernel()(typ, f, val, proc, P)
    got = F.plain_counter_scan(t(typ), t(f), t(val), t(proc), P)
    for g, w in zip(got, ref):
        same(g, w)
    assert int(got[3].sum()) > 0           # some reads emitted


def test_plain_counter_scan_wraps_like_int32():
    typ = np.array([[0, 0, 1, 0, 1]], np.int32)
    f = np.array([[0, 0, 0, 1, 1]], np.int32)
    val = np.array([[2**31 - 1, 5, 2**31 - 1, 0, 3]], np.int32)
    proc = np.zeros_like(typ)
    ref = R._counter_kernel()(typ, f, val, proc, 1)
    got = F.plain_counter_scan(t(typ), t(f), t(val), t(proc), 1)
    for g, w in zip(got, ref):
        same(g, w)


@pytest.mark.parametrize("V", [1, 2, 31, 33, 64])
def test_plain_queue_scan_matches_reference_kernel(V):
    typ, f, val = queue_lines(400 + V, 16, 70, V)
    ref = R._queue_kernel(V)(typ, f, val)
    got = F.plain_queue_scan(t(typ), t(f), t(val), V)
    for g, w in zip(got, ref):
        same(g, w)
    assert set(got[0].tolist()) == {0, 1}


@pytest.mark.parametrize("N,Nmax", [(1, 1), (5, 8), (40, 64), (70, 128),
                                    (70, 8)])
def test_plain_fifo_scan_matches_reference_kernel(N, Nmax):
    typ, f, val = queue_lines(500 + N + Nmax, 16, N, max(N, 2))
    ref = R._fifo_kernel(Nmax)(typ, f, val)
    got = F.plain_fifo_scan(t(typ), t(f), t(val), Nmax)
    for g, w in zip(got, ref):
        same(g, w)


# ------------------------------------------- wrappers and dispatch

def test_plain_versions_refuse_device_tensors():
    m = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        F.plain_fold_counts("tq", m, m, m, None, 4)
    with pytest.raises(ValueError, match="CPU tensors only"):
        F.plain_counter_scan(m, m, m, m, 2)
    with pytest.raises(ValueError, match="CPU tensors only"):
        F.plain_queue_scan(m, m, m, 4)
    with pytest.raises(ValueError, match="CPU tensors only"):
        F.plain_fifo_scan(m, m, m, 4)


def test_kernel_wrappers_refuse_cpu_tensors_before_building():
    x = torch.zeros((2, 3), dtype=torch.int32)
    u = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_folds.fold_counts("set", x, x, x, u, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_folds.counter_scan(x, x, x, x, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_folds.queue_scan(x, x, x, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_folds.fifo_scan(x, x, x, 4)
    assert cuda_folds._LIB is None
    assert cuda_folds.LAUNCHES == dict.fromkeys(cuda_folds.ENTRIES, 0)


@pytest.mark.parametrize("entry,family,width,rows,tier", [
    ("fold_counts", "set", 6144, 264, "smem"),
    ("fold_counts", "set", 6145, 264, "sliced"),
    ("fold_counts", "crdb", 3072, 264, "smem"),
    ("fold_counts", "crdb", 16384, 32, "sliced"),
    ("fold_counts", "tq", 16384, 32, "sliced"),
    ("fold_counts", "ids", 12288, 264, "smem"),
    ("fold_counts", "ids", 65536, 6, "sliced"),
    ("fold_counts", "tq", 1024, 24, "smem"),
    ("fold_counts", "tq", 1025, 24, "sliced"),
    ("fold_counts", "tq", 128, 2000, "smem"),
    ("counter_scan", None, 64, 1, "smem"),
    ("counter_scan", None, 65, 1, "global"),
    ("queue_scan", None, 1024, 1, "smem"),
    ("queue_scan", None, 1025, 1, "sliced"),
    ("fifo_scan", None, 16384, 1, "smem"),
    ("fifo_scan", None, 65536, 1, "global"),
])
def test_tier_edges(entry, family, width, rows, tier):
    """Each entry's tier at both sides of its edges: fold_counts counts a
    row in one block (``smem``) until its histograms pass a slice's
    shared memory or the batch has too few rows to fill the card, then
    in several (``sliced``); queue_scan takes a row in one block until a
    slice's pairs pass its shared memory; the other scans keep their
    state in shared memory to the widths that fit."""
    assert cuda_folds.tier(entry, width, family, rows=rows) == tier


@pytest.mark.parametrize("family", sorted(cuda_folds.FAMILIES))
def test_count_plan_slices_cover_the_vocabulary(family):
    """Every slice plan: S slices of Vs values (a multiple of 32) cover
    V exactly once (S·Vs >= V > (S-1)·Vs), each slice's C histograms
    within COUNT_SLICE_BYTES, no more slices than the histograms' fit or
    V / COUNT_MIN_SLICE asks for, and the width that gives the batch
    COUNT_TARGET_BLOCKS blocks where V allows that many (rounded up to
    32 values, which may cost the last slice)."""
    C = cuda_folds.FAMILIES[family][1]
    widest = cuda_folds.COUNT_SLICE_BYTES // (4 * C) // 32 * 32
    for V in (1, 2, 31, 32, 33, 1023, 1024, 1025, 4096, 4097, widest,
              widest + 1, 16384, 65536, 1 << 20):
        for rows in (1, 6, 24, 32, 64, 264, 2000):
            p = cuda_folds.count_plan(family, V, rows)
            S, Vs = p["slices"], p["slice_width"]
            assert Vs % 32 == 0 and S * Vs >= V > (S - 1) * Vs
            assert p["smem_bytes"] == 4 * C * Vs
            assert p["smem_bytes"] <= cuda_folds.COUNT_SLICE_BYTES
            assert p["blocks"] == rows * S
            assert p["tier"] == ("smem" if S == 1 else "sliced")
            assert p["threads"] == cuda_folds.COUNT_THREADS
            fit = -(-V // widest)
            assert S <= max(fit, -(-V // cuda_folds.COUNT_MIN_SLICE), 1)
            fill = -(-cuda_folds.COUNT_TARGET_BLOCKS // rows)
            want = max(fit, min(fill, -(-V // cuda_folds.COUNT_MIN_SLICE)))
            assert Vs == -(-(-(-V // want)) // 32) * 32
    # The bench batch takes one block a row, the full-width one 9.
    assert cuda_folds.count_plan("tq", 128, 2000)["slices"] == 1
    assert (cuda_folds.count_plan("tq", 16384, 32)["slices"],
            cuda_folds.count_plan("tq", 16384, 32)["slice_width"]) == (9,
                                                                       1824)


def test_dispatch_takes_the_plain_version_for_cpu_tensors():
    typ, f, val = random_lines(9, 3, 10, 8)
    planes, _ = F.fold_counts("tq", t(typ), t(f), t(val), None, 8)
    want, _ = F.plain_fold_counts("tq", t(typ), t(f), t(val), None, 8)
    assert torch.equal(planes, want)
    assert cuda_folds.LAUNCHES == dict.fromkeys(cuda_folds.ENTRIES, 0)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown fold family"):
        F.lower("register", [])
    x = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown family"):
        F.plain_fold_counts("register", x, x, x, None, 1)
