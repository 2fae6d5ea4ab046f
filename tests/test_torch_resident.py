"""The port's carried WGL frontier (jepsen_torch.ops.schedule.
ResidentFrontier) against the reference's, on the CPU.

The same seeded JSON op lines go into both packages. On every prefix the
port's ``advance`` gives the reference's (valid, first bad op) and the
full engine's; both raise FrontierInvalid at the same prefixes. A
checkpoint either package exports restores in the other and continues
exactly; a mismatched checkpoint is refused. Later ticks dispatch fewer
events than the first, a window burst rebuilds wider, a vocabulary
crossing 32 states widens the carry to two words, and the journal's
frontier rows compact and read across the packages. The launches run on
the plain version (``device="cpu"``); without a card and without that
argument the frontier refuses to be built. Tolerance: none.
"""
import json
import random

import numpy as np
import pytest
import torch

from jepsen_tpu import store as RSTORE
from jepsen_tpu.history.codec import loads_op as r_loads
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.online import checkable_prefix as r_prefix
from jepsen_tpu.ops import schedule as RS
from jepsen_tpu.ops.linearize import check_batch_columnar as r_full

from jepsen_torch import store as PSTORE
from jepsen_torch.history.codec import loads_op as p_loads
from jepsen_torch.models.core import cas_register
from jepsen_torch.online import checkable_prefix
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.linearize import check_batch_columnar
from jepsen_torch.ops.schedule import FrontierInvalid, ResidentFrontier

torch.set_num_threads(1)

MODEL = cas_register()
CPU = "cpu"


def stream(seed, n=90, procs=4, vals=4, p_fail=0.1, p_info=0.05):
    """Concurrent register ops as JSON lines: failed pairs, :info ops
    and dangling invocations, the frontier walk's whole case analysis."""
    rng = random.Random(seed)
    out, open_ = [], {}
    while len(out) < n:
        if open_ and (len(open_) >= procs or rng.random() < 0.5):
            pr = rng.choice(sorted(open_))
            f, v = open_.pop(pr)
            r = rng.random()
            if r < p_fail:
                t, val = "fail", v
            elif r < p_fail + p_info:
                t, val = "info", v
            else:
                t = "ok"
                val = v if f == "write" else rng.randint(1, vals)
        else:
            pr = rng.choice([p for p in range(procs) if p not in open_])
            f, val = (("write", rng.randint(1, vals))
                      if rng.random() < 0.5 else ("read", None))
            open_[pr] = (f, val)
            t = "invoke"
        out.append({"process": pr, "type": t, "f": f, "value": val,
                    "time": len(out), "index": len(out)})
    return [json.dumps(d) for d in out]


def both(lines):
    return [r_loads(x) for x in lines], [p_loads(x) for x in lines]


def full_port(ops):
    r = check_batch_columnar(MODEL, [checkable_prefix(ops)], device=CPU,
                             details="invalid")[0]
    return (True, None) if r["valid"] else (False, r["op"]["index"])


def full_ref(ops):
    r = r_full(r_cas(), [r_prefix(ops)], details="invalid")[0]
    return (True, None) if r["valid"] else (False, r["op"]["index"])


def advance_or_raise(fr, ops):
    try:
        return fr.advance(ops)
    except (FrontierInvalid, RS.FrontierInvalid) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_prefix_matches_reference_and_full_engine(seed):
    """On every prefix: the port's verdict, the reference's and the full
    engine's agree; an invalidation happens at the same prefix in both
    packages, and both rebuild to the same verdict."""
    r_ops, p_ops = both(stream(seed))
    pf, rf = ResidentFrontier(MODEL, device=CPU), RS.ResidentFrontier(r_cas())
    bad = 0
    for k in range(1, len(p_ops) + 1):
        got = advance_or_raise(pf, p_ops[:k])
        want = advance_or_raise(rf, r_ops[:k])
        assert got == want, (seed, k)
        if got == "FrontierInvalid":
            pf = ResidentFrontier(MODEL, device=CPU)
            rf = RS.ResidentFrontier(r_cas())
            got, want = pf.advance(p_ops[:k]), rf.advance(r_ops[:k])
            assert got == want, (seed, k)
        assert got == full_port(p_ops[:k]), (seed, k)
        assert (pf.pos, pf.n_events, pf.W, pf.last_events) == \
            (rf.pos, rf.n_events, rf.W, rf.last_events), (seed, k)
        bad += got[0] is False
    assert got == full_ref(r_ops)
    assert seed != 1 or bad, "the corpus has an invalid prefix"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(writer):
    """A checkpoint exported by one package restores in the other, and
    both continue to the same verdict and the same export."""
    r_ops, p_ops = both(stream(11, n=80))
    pf = ResidentFrontier(MODEL, device=CPU)
    rf = RS.ResidentFrontier(r_cas())
    assert pf.advance(p_ops[:40]) == rf.advance(r_ops[:40])
    assert json.dumps(pf.export()) == json.dumps(rf.export())
    src = pf if writer == "port" else rf
    payload = json.loads(json.dumps(src.export()))   # disk round trip
    p2 = ResidentFrontier.restore(MODEL, payload, device=CPU)
    r2 = RS.ResidentFrontier.restore(r_cas(), payload)
    assert p2 is not None and r2 is not None
    assert (p2.pos, p2.n_events, p2.W) == (pf.pos, pf.n_events, pf.W)
    for k in (60, 80):
        got, want = p2.advance(p_ops[:k]), r2.advance(r_ops[:k])
        assert got == want == pf.advance(p_ops[:k]), k
        assert got == full_port(p_ops[:k]), k
    assert json.dumps(p2.export()) == json.dumps(r2.export())


def test_restore_refuses_mismatched_checkpoints():
    _, p_ops = both(stream(3, n=40))
    fr = ResidentFrontier(MODEL, device=CPU)
    fr.advance(p_ops)
    good = fr.export()
    assert ResidentFrontier.restore(MODEL, good, device=CPU) is not None
    wide = dict(good, table=good["table"] + [0])      # window mismatch
    stale = dict(good, W=good["W"] + 1,
                 table=good["table"] + [-1])          # carry shape
    kinds = dict(good, kinds=good["kinds"] + [["write", v] for v in
                                              range(100, 140)])  # 2 words
    for bad in (wide, stale, kinds, {"v": 99}, {"v": 1, "W": None}):
        assert ResidentFrontier.restore(MODEL, bad, device=CPU) is None
        assert RS.ResidentFrontier.restore(r_cas(), bad) is None


def test_later_ticks_dispatch_fewer_events():
    """The O(new ops) property at unit scale: after the first tick pays
    the whole prefix, each tick of a growing prefix dispatches fewer
    events, as many as the reference's."""
    r_ops, p_ops = both(stream(5, n=120, p_fail=0.0, p_info=0.0))
    pf, rf = ResidentFrontier(MODEL, device=CPU), RS.ResidentFrontier(r_cas())
    events = []
    for k in (80, 96, 112):
        assert pf.advance(p_ops[:k]) == rf.advance(r_ops[:k])
        assert pf.last_events == rf.last_events
        events.append(pf.last_events)
    assert events[1] < events[0] and events[2] < events[0], events
    assert pf.stats == rf.stats


def test_window_growth_rebuilds_wider():
    """A burst of writers past the carried mask axis raises
    FrontierInvalid in both packages; the rebuild is wider and exact."""
    lines, t = [], 0
    for k in range(4):
        for typ, f, v in (("invoke", "write", k + 1), ("ok", "write", k + 1),
                          ("invoke", "read", None), ("ok", "read", k + 1)):
            lines.append(json.dumps({"process": 0, "type": typ, "f": f,
                                     "value": v, "index": t}))
            t += 1
    for typ in ("invoke", "ok"):
        for p in range(1, 5):
            lines.append(json.dumps({"process": p, "type": typ,
                                     "f": "write", "value": 1, "index": t}))
            t += 1
    r_ops, p_ops = both(lines)
    pf, rf = ResidentFrontier(MODEL, device=CPU), RS.ResidentFrontier(r_cas())
    assert pf.advance(p_ops[:16]) == rf.advance(r_ops[:16]) == (True, None)
    with pytest.raises(FrontierInvalid, match="outgrew"):
        pf.advance(p_ops)
    with pytest.raises(RS.FrontierInvalid, match="outgrew"):
        rf.advance(r_ops)
    p2 = ResidentFrontier(MODEL, device=CPU)
    assert p2.advance(p_ops) == RS.ResidentFrontier(r_cas()).advance(r_ops)
    assert p2.advance(p_ops) == full_port(p_ops)
    assert p2.W > pf.W


def test_vocabulary_growth_crosses_32_states():
    """Writes of 40 fresh values, read back, one process: the state
    space grows append-stable past 32 states while the carry is live, so
    the carry widens from one state word to two (no rebuild), and every
    tick matches the reference and the full engine; the last read is
    corrupt."""
    lines, t = [], 0
    for v in range(1, 41):
        rv = 999 if v == 40 else v
        for typ, f, val in (("invoke", "write", v), ("ok", "write", v),
                            ("invoke", "read", None), ("ok", "read", rv)):
            lines.append(json.dumps({"process": 0, "type": typ, "f": f,
                                     "value": val, "index": t}))
            t += 1
    r_ops, p_ops = both(lines)
    pf, rf = ResidentFrontier(MODEL, device=CPU), RS.ResidentFrontier(r_cas())
    widths = set()
    for k in range(16, len(p_ops) + 1, 16):
        got = pf.advance(p_ops[:k])
        assert got == rf.advance(r_ops[:k]) == full_port(p_ops[:k]), k
        widths.add(pf.carry["F"].shape[1])
        np.testing.assert_array_equal(pf.carry["F"], rf.carry["F"])
    assert widths == {1, 2}
    assert pf.v_pad == 64 and pf.space.n_states == 41
    assert got == (False, len(p_ops) - 1)
    assert got == full_ref(r_ops)


def test_journal_frontier_rows_compact_and_read_across_packages(tmp_path):
    """FRONTIER_COMPACT_EVERY superseded rows rewrite the journal down to
    its header, the decided rows and the latest checkpoint; a journal
    either package wrote resumes in the other with the same rows."""
    assert PSTORE.ChunkJournal.FRONTIER_COMPACT_EVERY == \
        RSTORE.ChunkJournal.FRONTIER_COMPACT_EVERY == 64
    key = {"online": 1, "run": "reg/r1"}
    for cls, other in ((PSTORE.ChunkJournal, RSTORE.ChunkJournal),
                       (RSTORE.ChunkJournal, PSTORE.ChunkJournal)):
        p = tmp_path / f"{cls.__module__}.jsonl"
        j = cls(p, key)
        j.record([8], [True], [None], ["online-rebuild"])
        for i in range(70):
            j.record_frontier({"v": 1, "pos": i})
        j.record([16], [False], [5], ["online-delta"])
        j.close()
        lines = p.read_text().splitlines()
        assert len(lines) == 3 + 6 + 1, len(lines)   # compacted at 64
        for reader in (cls, other):
            r = reader(p, key, resume=True)
            assert r.frontier() == {"v": 1, "pos": 69}
            assert r.decided() == {8: (True, None, "online-rebuild"),
                                   16: (False, 5, "online-delta")}
            r.close()
    # Both packages write the same bytes for the same rows.
    names = sorted(tmp_path.iterdir())
    assert names[0].read_text() == names[1].read_text()


def test_frontier_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentFrontier(MODEL)
    _, p_ops = both(stream(4, n=20))
    fr = ResidentFrontier(MODEL, device=CPU)
    fr.advance(p_ops)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentFrontier.restore(MODEL, fr.export())


def test_kernel_error_propagates(monkeypatch):
    """A launch error of the resume entry reaches the caller: nothing
    catches it and goes on on another version."""
    _, p_ops = both(stream(6, n=30))

    def boom(*a, **kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(L, "run_carried_events", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        ResidentFrontier(MODEL, device=CPU).advance(p_ops)


def test_cached_target_follows_the_space_after_the_memo_is_cleared():
    """The frontier caches its padded transition table per state space.
    When enumerate_statespace's memo is cleared, an outgrown space is
    freed and a newer one may take its address: the cache must still
    follow the space, or a new kind's row reads as the all-invalid
    sentinel and a valid prefix is flagged invalid. Every tick's table
    equals the space's, and every verdict the full engine's."""
    from jepsen_torch.ops import statespace

    lines, t = [], 0
    for v in range(1, 31):
        for typ, f, val in (("invoke", "write", v), ("ok", "write", v),
                            ("invoke", "read", None), ("ok", "read", v)):
            lines.append(json.dumps({"process": 0, "type": typ, "f": f,
                                     "value": val, "index": t}))
            t += 1
    _, p_ops = both(lines)
    fr = ResidentFrontier(MODEL, device=CPU)
    for k in range(4, len(p_ops) + 1, 4):
        statespace._SPACE_MEMO.clear()
        got = fr.advance(p_ops[:k])
        np.testing.assert_array_equal(
            fr.target, fr.space.padded_target(fr.v_pad, fr._k_rows - 1))
        assert got == (True, None), k
    assert got == full_port(p_ops)
