"""The port's live history WAL (jepsen_torch.history.wal and .codec)
against the reference's, on the CPU.

A WAL that either package's ``HistoryWAL`` writes is tailed, read,
probed and salvaged by the other with the same ops, cursor state and
results; the tailer's edge cases (a torn record completed by a later
poll, rotation under an active cursor, a missing file, a bad magic)
answer as the reference's; ``wal_progress`` resets on rotation;
``salvage_history`` completes dangling invocations as the reference
does; the codec's round trips (KV values, sets, bytes) are the
reference's line for line. Tolerance: none.
"""
import dataclasses
import json
import os

import pytest
import torch

from jepsen_tpu.history import codec as RC
from jepsen_tpu.history import wal as RW

from jepsen_torch.history import codec as PC
from jepsen_torch.history import wal as PW
from jepsen_torch.independent import KV

torch.set_num_threads(1)

PACKAGES = {"port": (PW, PC), "reference": (RW, RC)}


def lines(n_pairs, start=0, corrupt=None, procs=1):
    """Register ops as JSON lines: write k / read k pairs (the read of
    pair ``corrupt`` observes 999), ``procs`` processes interleaved."""
    out, i = [], start
    for k in range(n_pairs):
        p = k % procs
        rv = 999 if corrupt == k else k + 1
        for typ, f, v in (("invoke", "write", k + 1), ("ok", "write", k + 1),
                          ("invoke", "read", None), ("ok", "read", rv)):
            out.append(json.dumps({"process": p, "type": typ, "f": f,
                                   "value": v, "time": i, "index": i}))
            i += 1
    return out


def write_raw(path, body, *, seed=0, pid=2 ** 22 + 12345, torn=b"",
              append=False):
    head = [json.dumps({"wal": RW.WAL_MAGIC, "test": {"name": "reg"},
                        "seed": seed, "pid": pid, "phase": "setup"}),
            json.dumps({"phase": "run", "wal_ops": 0})]
    text = "\n".join(([] if append else head) + body)
    with open(path, "ab" if append else "wb") as f:
        if text:
            f.write((text + "\n").encode())
        f.write(torn)


def dicts(ops):
    return [o.to_dict() for o in ops]


def state(st):
    return dataclasses.asdict(st)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_written_by_one_package_tails_in_the_other(tmp_path, writer):
    wal_mod, codec = PACKAGES[writer]
    p = tmp_path / "history.wal.jsonl"
    w = wal_mod.HistoryWAL(p, {"test": {"name": "reg"}, "seed": 3},
                           flush_ms=0)
    ops = [codec.loads_op(x) for x in lines(5, procs=2)]
    w.stamp_phase("run")
    for o in ops[:12]:
        w.append_op(o)
    st_p, out_p = PW.tail_wal(p)
    st_r, out_r = RW.tail_wal(p)
    for o in ops[12:]:
        w.append_op(o)
    w.stamp_phase("analyzed")
    w.close()
    st_p, out_p2 = PW.tail_wal(p, st_p)
    st_r, out_r2 = RW.tail_wal(p, st_r)
    assert dicts(out_p["ops"]) == dicts(out_r["ops"]) == dicts(ops[:12])
    assert dicts(out_p2["ops"]) == dicts(out_r2["ops"]) == dicts(ops[12:])
    assert state(st_p) == state(st_r)
    assert st_p.phase == "analyzed" and st_p.n_ops == len(ops)
    assert out_p2["phases"] == out_r2["phases"] == [("analyzed", 20)]
    rp, rr = PW.read_wal(p), RW.read_wal(p)
    assert rp["header"] == rr["header"] and rp["phases"] == rr["phases"]
    assert dicts(rp["ops"]) == dicts(rr["ops"]) and rp["torn"] is False
    assert PW.wal_header(p) == RW.wal_header(p) == rp["header"]
    assert PW.estimate_peak_w(p) == RW.estimate_peak_w(p) == (1, 20)
    # The writer is this process: a live run to nobody's sweep.
    assert PW.writer_alive(rp["header"]) is RW.writer_alive(
        rr["header"]) is False


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_writer_resume_appends_after_the_durable_end(tmp_path, writer):
    wal_mod, codec = PACKAGES[writer]
    p = tmp_path / "w.jsonl"
    body = lines(2)
    write_raw(p, body, torn=body[-1][:7].encode())
    w = wal_mod.HistoryWAL(p, resume=True, flush_ms=0)
    assert w.ops_appended == 8 and w.phase == "run"
    w.append_op(codec.loads_op(lines(1, start=8)[0]))
    w.close()
    for mod in (PW, RW):
        r = mod.read_wal(p)
        assert [o.index for o in r["ops"]] == list(range(9))
        assert r["torn"] is False


def test_tail_torn_mid_record_then_completed(tmp_path):
    """A torn record is left for a later poll to complete: nothing
    lost, nothing duplicated, in both packages."""
    p = tmp_path / "w.jsonl"
    body = lines(3)
    write_raw(p, body[:-1], torn=body[-1][:9].encode())
    st_p, out_p = PW.tail_wal(p)
    st_r, out_r = RW.tail_wal(p)
    assert out_p["torn"] is out_r["torn"] is True
    assert [o.index for o in out_p["ops"]] == list(range(11))
    extra = lines(1, start=12)[0]
    with open(p, "ab") as f:
        f.write(body[-1][9:].encode() + b"\n" + extra.encode() + b"\n")
    st_p, out_p = PW.tail_wal(p, st_p)
    st_r, out_r = RW.tail_wal(p, st_r)
    assert out_p["torn"] is out_r["torn"] is False
    assert [o.index for o in out_p["ops"]] == [11, 12]
    assert dicts(out_p["ops"]) == dicts(out_r["ops"])
    assert state(st_p) == state(st_r)


def test_tail_rotation_missing_and_bad_magic(tmp_path):
    p = tmp_path / "w.jsonl"
    write_raw(p, lines(4), seed=1)
    st, out = PW.tail_wal(p)
    assert st.n_ops == 16 and not out["rotated"]
    fresh = tmp_path / "w.new"
    write_raw(fresh, lines(2), seed=2)
    os.replace(fresh, p)
    st2, out2 = PW.tail_wal(p, st)
    assert out2["rotated"] is True and st2.header["seed"] == 2
    assert len(out2["ops"]) == 8 and st2.n_ops == 8
    st, out = PW.tail_wal(tmp_path / "absent.jsonl")
    assert out["missing"] is True and st.header is None
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"not": "a wal"}\n')
    assert PW.tail_wal(bad)[1]["bad_magic"] is True
    with pytest.raises(ValueError, match="bad magic"):
        PW.read_wal(bad)
    # A non-WAL swapped in under the cursor: rotated and bad magic.
    os.replace(bad, p)
    out3 = PW.tail_wal(p, st2)[1]
    assert out3["rotated"] is True and out3["bad_magic"] is True


def test_wal_progress_resets_on_rotation(tmp_path):
    p = tmp_path / "history.wal.jsonl"
    write_raw(p, lines(2), seed=7)
    assert PW.wal_progress(p)["ops"] == RW.wal_progress(p)["ops"] == 8
    fresh = tmp_path / "w.new"
    write_raw(fresh, lines(5), seed=8)        # larger than the original
    os.replace(fresh, p)
    got, want = PW.wal_progress(p), RW.wal_progress(p)
    assert got == want
    assert got["ops"] == 20 and got["header"]["seed"] == 8
    headerless = tmp_path / "h.jsonl"
    headerless.write_bytes(b'{"wal": "JTW')
    assert PW.wal_progress(headerless) is None
    assert PW.wal_header(headerless) is None


def test_salvage_history_matches_reference(tmp_path):
    """A killed run's prefix: dangling invocations of two processes
    complete as :info in invocation order, the sequence reindexes."""
    body = lines(4, procs=2)
    body.append(json.dumps({"process": 1, "type": "invoke", "f": "write",
                            "value": 7, "time": 99, "index": 16}))
    body.append(json.dumps({"process": 0, "type": "invoke", "f": "read",
                            "value": None, "time": 100, "index": 17}))
    p = tmp_path / "w.jsonl"
    write_raw(p, body, torn=b'{"process": 0, "ty')
    hp, np_ = PW.salvage_history(PW.read_wal(p)["ops"])
    hr, nr = RW.salvage_history(RW.read_wal(p)["ops"])
    assert np_ == nr == 2
    assert dicts(hp) == dicts(hr)
    assert [o.type for o in hp[-2:]] == ["info", "info"]
    assert [o.process for o in hp[-2:]] == [1, 0]
    assert [o.index for o in hp] == list(range(len(hp)))


@pytest.mark.parametrize("value", [KV("k1", [1, 2]), {1, 2, 3}, b"\x00\xff",
                                   [KV(1, None), {"a": KV(2, 3)}], None])
def test_codec_round_trips_as_the_reference(tmp_path, value):
    from jepsen_tpu.independent import KV as RKV
    from jepsen_torch.history.ops import Op

    op = Op(process=3, type="ok", f="txn", value=value, time=5, index=9,
            error="e", extra={"node": "n1"})
    line = PC.dumps_op(op)
    back = RC.loads_op(line)
    assert RC.dumps_op(back) == line
    again = PC.loads_op(RC.dumps_op(back))
    assert again == op
    if isinstance(value, KV):
        assert isinstance(back.value, RKV) and isinstance(again.value, KV)
    path = tmp_path / "h.jsonl"
    PC.write_jsonl(path, [op, op.with_(index=10)])
    assert [RC.dumps_op(o) for o in RC.read_jsonl(path)] == \
        [line, PC.dumps_op(op.with_(index=10))]
    with open(path, "a") as f:
        f.write('{"process": 1, "typ')
    with pytest.raises(PC.CorruptHistoryLine, match=":3:"):
        PC.read_jsonl(path)
    assert len(PC.read_jsonl(path, tolerant=True)) == 2
    with pytest.raises(TypeError):
        PC.dumps_op(op.with_(value=object()))
