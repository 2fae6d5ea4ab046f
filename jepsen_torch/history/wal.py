"""Live history write-ahead log: what the online daemon tails.

A copy of the reference's ``history/wal.py``, the same segment format,
so a WAL that either package writes is tailed by the other. A run's
worker loop appends every op to a per-run, fsynced, group-committed
JSONL segment as it lands in the in-memory history, so any prefix of
the run survives process death.

Segment format (``history.wal.jsonl`` in the run dir):

    line 1:  {"wal": "JTWAL1", "test": {...}, "seed": ..., "phase": "setup"}
    then:    op records (codec.dumps_op, the history.jsonl line format)
             interleaved with phase stamps {"phase": NAME, "wal_ops": N}
             at each lifecycle transition (setup/run/teardown/analyzed).

Phase stamps and the header are flushed and fsynced at once; op records
group-commit: buffered writes are fsynced once ``JT_WAL_FLUSH_MS``
(default 50) has passed since the last sync. A torn final line (a kill
mid-write) is tolerated and dropped on read. ``salvage_history`` turns
any recovered prefix into a checkable history: dangling invocations
complete as ``:info`` and the sequence reindexes. Op records differ from
phase stamps by the ``type`` key, which every op carries and no stamp
does.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

from .codec import dumps_op, loads_op
from .core import index
from .ops import Op, INFO, INVOKE

log = logging.getLogger("jepsen.wal")

WAL_MAGIC = "JTWAL1"

# Lifecycle phases, in stamp order (mirrored by ops.faults.RUN_PHASES).
PHASES = ("setup", "run", "teardown", "analyzed")

WAL_FILE = "history.wal.jsonl"


def flush_window_ms() -> float:
    return float(os.environ.get("JT_WAL_FLUSH_MS", "50"))


class HistoryWAL:
    """One run's live op log. ``append_op`` is called from the History
    append hook (inside the history lock, so records land in history
    order); ``stamp_phase`` marks lifecycle transitions. Thread safety
    comes from the caller's serialization (History's lock for ops; the
    run's single control thread for stamps) plus file appends being
    whole-line writes.

    ``run_fault`` (an object with ``on_op(wal, n)`` and
    ``on_phase(wal, phase)``, the run-level crash nemesis) is called
    where run-level faults fire: after an op is durable, and at a phase
    boundary.

    ``resume=True`` re-attaches to an EXISTING segment instead of
    truncating it: a restarted writer appends after the last durable
    whole line, so already-landed ops are never re-written and a torn
    tail from the dead incarnation is dropped before the first new
    append would weld onto it. The original header line is preserved
    verbatim; ``ops_appended``/``phase`` recover from the segment, and
    the recovered op count is the resume point exactly-once sequencing
    acks from. Falls back to a fresh segment when the path is missing
    or is not a history WAL."""

    def __init__(self, path, header: Optional[dict] = None,
                 flush_ms: Optional[float] = None, run_fault=None,
                 resume: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.flush_ms = flush_window_ms() if flush_ms is None \
            else float(flush_ms)
        self.run_fault = run_fault
        self.ops_appended = 0
        self.phase = "setup"
        # Group-commit fsync latencies. Only op-path syncs are recorded
        # (header, stamp and close fsyncs are mandatory, not group
        # commits), and the deque bounds a long run's memory.
        from collections import deque
        self.sync_ns = deque(maxlen=65536)
        self._record_sync = False
        self._dirty = False
        self._closed = False
        recovered = self._recover() if resume else None
        if recovered is not None:
            # Drop the torn tail BEFORE reopening for append: the
            # cursor stops after the last whole parsed line, so the
            # truncate is exact — durable ops are untouched, and the
            # dead writer's in-flight partial line can never corrupt
            # the first resumed append.
            os.truncate(self.path, recovered.pos)
            self._f = open(self.path, "a")
            self._last_sync = time.monotonic()
            self.header = recovered.header
            self.ops_appended = recovered.n_ops
            self.phase = recovered.phase or "setup"
            self.sync()
            return
        self._f = open(self.path, "w")
        self._last_sync = time.monotonic()
        # The writer pid lets a blind salvage sweep tell a LIVE run
        # (writer still alive on this host) from a crashed one.
        head = {"wal": WAL_MAGIC, **(header or {}),
                "pid": os.getpid(), "phase": "setup"}
        self.header = head
        self._f.write(json.dumps(head, default=repr) + "\n")
        self.sync()
        # The durable header IS the ``setup`` stamp — give the crash
        # nemesis its boundary (``phase:setup`` kills fire here).
        if self.run_fault is not None:
            self.run_fault.on_phase(self, "setup")

    def _recover(self) -> Optional["TailState"]:
        """Parse an existing segment to its durable end through the ONE
        tolerant parser (tail_wal: whole lines only, torn tail left
        behind the cursor). None when there is nothing to resume — the
        file is absent, headerless, or not a history WAL."""
        st = TailState()
        while True:
            prev = st.pos
            st, out = tail_wal(self.path, st, materialize=False)
            if out["missing"] or out["bad_magic"]:
                return None
            if st.pos == prev:
                break
        return st if st.header is not None else None

    # ------------------------------------------------------- writing
    def sync(self) -> None:
        """Flush + fsync everything buffered — the group commit."""
        if self._closed:
            return
        t0 = time.monotonic_ns()
        self._f.flush()
        os.fsync(self._f.fileno())
        if self._record_sync:
            dt = time.monotonic_ns() - t0
            self.sync_ns.append(dt)
            # Group-commit latency also lands on the registry.
            from .. import telemetry
            telemetry.REGISTRY.histogram("wal.flush_ms").observe(
                dt / 1e6)
            telemetry.REGISTRY.counter("wal.group_commits").inc()
        self._dirty = False
        self._last_sync = time.monotonic()

    def _maybe_sync(self) -> None:
        if self.flush_ms <= 0 or \
                (time.monotonic() - self._last_sync) * 1000.0 >= \
                self.flush_ms:
            self._record_sync = True
            try:
                self.sync()
            finally:
                self._record_sync = False

    def append_op(self, op: Op) -> None:
        """Record one history op (invoke or completion). Buffered;
        durable at the next group commit."""
        if self._closed:
            return
        n = self.ops_appended
        self._f.write(dumps_op(op) + "\n")
        self.ops_appended = n + 1
        self._dirty = True
        self._maybe_sync()
        if self.run_fault is not None:
            self.run_fault.on_op(self, n)

    def stamp_phase(self, phase: str) -> None:
        """Mark a lifecycle transition. Stamps are synchronous — the
        boundary itself must be durable (salvage reports how far the
        run got, and the campaign resume trusts it)."""
        assert phase in PHASES, phase
        if self._closed:
            return
        self.phase = phase
        self._f.write(json.dumps(
            {"phase": phase, "wal_ops": self.ops_appended}) + "\n")
        self.sync()
        if self.run_fault is not None:
            self.run_fault.on_phase(self, phase)

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.sync()
        finally:
            self._closed = True
            try:
                self._f.close()
            except Exception:
                pass


# ------------------------------------------------------------ reading

@dataclass
class TailState:
    """Persistent cursor for ``tail_wal``: which segment identity
    (inode) and byte offset the tailer has consumed through, plus the
    running parse state (header / op count / latest phase). The online
    checker keeps one per tenant; it is cheap, picklable state — a
    daemon restart rebuilds it by re-tailing from 0 (decided-prefix
    journals, not the cursor, are what make restarts cheap)."""

    ino: int = -1          # inode the cursor is on; -1 = nothing seen
    pos: int = 0           # byte offset past the last whole parsed line
    header: Optional[dict] = None
    n_ops: int = 0
    phase: Optional[str] = None
    phases: List[Tuple[str, int]] = field(default_factory=list)


def tail_wal(path, st: Optional[TailState] = None, *,
             max_bytes: int = 8 << 20,
             materialize: bool = True) -> Tuple[TailState, dict]:
    """Incremental segment tail — the online checker's read primitive.

    Reads only the bytes appended since ``st`` (a fresh TailState
    starts at 0) and parses WHOLE lines: a torn final line (the
    writer's in-flight group commit, or a kill mid-write) is left for
    a later call to complete — the "torn mid-record tail then
    completion" case loses nothing and duplicates nothing. Rotation
    and truncation are detected by inode change / size shrink: the
    cursor resets and the NEW segment is consumed from offset 0 in the
    same call, with ``rotated`` set so the caller can invalidate
    anything derived from the old content. ``max_bytes`` bounds one
    call's read (a first tail of a huge segment catches up over
    successive calls instead of stalling the poll loop).

    Returns ``(state, out)`` where out is ``{"ops": [Op...], "phases":
    [(name, wal_ops)...], "rotated", "torn", "missing", "bad_magic",
    "grew"}``. ``bad_magic`` marks a file that is not a history WAL
    (the tailer's answer, not an exception — a daemon sweeping a
    store must skip, not die). Ops carry their writer-assigned indexes
    untouched. ``materialize=False`` counts ops (``st.n_ops``) without
    building a single Op — the wal_progress mode, one parser for both
    consumers."""
    st = st or TailState()
    out = {"ops": [], "phases": [], "rotated": False, "torn": False,
           "missing": False, "bad_magic": False, "grew": False}
    p = Path(path)
    try:
        s = os.stat(p)
    except OSError:
        out["missing"] = True
        return st, out
    if st.ino >= 0 and (s.st_ino != st.ino or s.st_size < st.pos):
        # The path names different content now (logrotate-style swap,
        # truncate-and-rewrite): everything parsed so far described
        # the OLD segment.
        st = TailState()
        out["rotated"] = True
    st.ino = s.st_ino
    out["size"] = s.st_size
    if s.st_size <= st.pos:
        return st, out
    try:
        with open(p, "rb") as f:
            f.seek(st.pos)
            data = f.read(min(s.st_size - st.pos, max_bytes))
    except OSError:
        out["missing"] = True
        return st, out
    pos = consumed = 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:
            out["torn"] = True      # next call completes the line
            break
        line = data[pos:nl].strip()
        try:
            if st.header is None:
                if line:
                    d = json.loads(line)
                    if d.get("wal") != WAL_MAGIC:
                        out["bad_magic"] = True
                        return st, out
                    st.header = d
                    st.phase = d.get("phase", st.phase)
            elif b'"type"' in line:
                if materialize:
                    out["ops"].append(loads_op(line.decode()))
                st.n_ops += 1
            elif line:
                d = json.loads(line)
                st.phase = d.get("phase", st.phase)
                stamp = (st.phase, int(d.get("wal_ops", -1)))
                st.phases.append(stamp)
                out["phases"].append(stamp)
        except Exception:
            # A corrupt whole line can only be the in-flight group
            # commit at the moment of writer death — stop here; the
            # good prefix stands and writer-death finalization (which
            # re-reads through read_wal's identical tolerance) owns
            # the rest.
            out["torn"] = True
            break
        pos = nl + 1
        consumed = pos              # only whole parsed lines advance
    st.pos += consumed
    out["grew"] = bool(out["ops"] or out["phases"]
                       or (consumed and st.header is not None))
    return st, out


# Bounded per-path cursor cache for wal_progress: an always-on live-run
# poller must not grow one entry per run forever (finished runs stop
# being polled but their entries would otherwise persist). LRU via
# dict insertion order — re-inserting on touch keeps hot paths warm.
_PROGRESS_CACHE: dict = {}
_PROGRESS_CACHE_MAX = 256
_PROGRESS_READ_BUDGET = 32 << 20          # bytes scanned per call
_PROGRESS_LOCK = threading.Lock()


def wal_progress(path) -> Optional[dict]:
    """Cheap live-run probe: header + latest phase + op count, WITHOUT
    materializing a single Op, for a view that polls every in-flight
    run (read_wal builds the full Op list; on a
    million-op campaign that is the difference between a page load and
    a stall). ONE parser with the online tailer: this is
    ``tail_wal(materialize=False)`` behind a bounded per-path cursor
    cache, so the two consumers cannot drift — incremental scans, a
    torn final line left for the next poll to complete,
    rotation/truncation reset by inode change or shrink, and a bounded
    per-call read (the first poll of a multi-GB segment catches up
    over successive ticks instead of stalling a page load). None when
    there is no durable header yet."""
    key = str(Path(path))
    with _PROGRESS_LOCK:
        st = _PROGRESS_CACHE.pop(key, None)       # re-insert = LRU touch
        st, out = tail_wal(path, st, materialize=False,
                           max_bytes=_PROGRESS_READ_BUDGET)
        if out["missing"] or out["bad_magic"]:
            return None                   # evicted: nothing to resume
        _PROGRESS_CACHE[key] = st
        while len(_PROGRESS_CACHE) > _PROGRESS_CACHE_MAX:
            _PROGRESS_CACHE.pop(next(iter(_PROGRESS_CACHE)))
        header = st.header
        if header is None:
            return None
        return {"header": header, "ops": st.n_ops,
                "phase": st.phase or header.get("phase", "setup"),
                "seed": header.get("seed"),
                "bytes": out.get("size", st.pos)}


# estimate_peak_w memo: {path: ((inode, offset watermark), result)}.
# Placement re-prices every candidate tenant on every discover() sweep
# (and every peer does the same), so the same unchanged WAL was being
# re-scanned once per worker per tick; the probe only reads the first
# ``max_bytes``, so (inode, min(size, max_bytes)) IS the input's
# identity — same watermark, same answer, for free. Bounded LRU.
_PEAK_W_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PEAK_W_CACHE_MAX = 512
_PEAK_W_LOCK = threading.Lock()


def estimate_peak_w(path, *, max_bytes: int = 1 << 20
                    ) -> Optional[Tuple[int, int]]:
    """Cheap tenant-shape probe for a checking service's placement and
    W-class admission: the peak pending
    window and op count of the WAL's first ``max_bytes`` — one bounded
    scan, no cursor kept, no tenant state touched. The window rule
    matches the encoder's (and OnlineTenant._track_w's): invokes open
    a slot, ok/fail completions close it, ``:info`` pends forever.
    Returns (peak_w, n_ops) or None when the file has no durable
    header (or isn't a WAL).

    Memoized per (inode, offset watermark): repeated placement pricing
    of an unchanged segment — every worker, every tick — costs one
    stat, not one scan; growth or rotation changes the watermark and
    re-probes."""
    try:
        fst = os.stat(path)
        # mtime in the stamp closes the truncate-and-rewrite-in-place
        # window: same inode, same size watermark, different content.
        stamp = (fst.st_ino, min(fst.st_size, max_bytes), max_bytes,
                 fst.st_mtime_ns)
    except OSError:
        return None
    key = str(Path(path))
    with _PEAK_W_LOCK:
        hit = _PEAK_W_CACHE.pop(key, None)   # re-insert = LRU touch
        if hit is not None and hit[0] == stamp:
            _PEAK_W_CACHE[key] = hit
            return hit[1]
    st, out = tail_wal(path, None, max_bytes=max_bytes)
    if st.header is None or out["bad_magic"] or out["missing"]:
        return None
    open_: set = set()
    peak = 0
    for op in out["ops"]:
        if op.type == INVOKE:
            open_.add(op.process)
            if len(open_) > peak:
                peak = len(open_)
        elif op.is_completion and op.type != INFO:
            open_.discard(op.process)
    result = (peak, st.n_ops)
    with _PEAK_W_LOCK:
        _PEAK_W_CACHE[key] = (stamp, result)
        while len(_PEAK_W_CACHE) > _PEAK_W_CACHE_MAX:
            _PEAK_W_CACHE.pop(next(iter(_PEAK_W_CACHE)))
    return result


def wal_header(path) -> Optional[dict]:
    """Just the (fsynced-first) header line — the cheap probe for
    sweeps that must not read a potentially huge segment. None when the
    file has no durable header (killed before the first fsync)."""
    try:
        with open(path, "rb") as f:
            line = f.readline()
        if not line.endswith(b"\n"):
            return None
        d = json.loads(line)
        return d if d.get("wal") == WAL_MAGIC else None
    except Exception:
        return None


def writer_alive(header: Optional[dict]) -> bool:
    """Is the WAL's writer process still alive on THIS host? Best
    effort (pid reuse can false-positive) — the blind salvage sweep's
    liveness guard, overridable by naming the run explicitly."""
    pid = (header or {}).get("pid")
    if not isinstance(pid, int) or pid <= 0 or pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
        return True
    except PermissionError:
        return True       # exists, just unsignalable from this user
    except OSError:
        return False


def read_wal(path) -> dict:
    """Recover a WAL segment, tolerating the torn tail a kill leaves.

    Returns ``{"header": dict, "phases": [(name, wal_ops)...],
    "ops": [Op...], "torn": bool}`` — ``torn`` is True when a trailing
    partial/corrupt line (or missing final newline) was dropped. A file
    that isn't a WAL (wrong magic) raises ValueError naming the path.
    """
    data = Path(path).read_bytes()
    header: Optional[dict] = None
    phases: List[Tuple[str, int]] = []
    ops: List[Op] = []
    torn = False
    pos = 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:
            torn = True             # killed mid-write: drop the tail
            break
        line = data[pos:nl].strip()
        pos = nl + 1
        if not line:
            continue
        try:
            if header is None:
                d = json.loads(line)
                if d.get("wal") != WAL_MAGIC:
                    raise ValueError(
                        f"{path}: not a history WAL (bad magic)")
                header = d
            elif b'"type"' in line:
                ops.append(loads_op(line.decode()))
            else:
                d = json.loads(line)
                phases.append((d["phase"], int(d.get("wal_ops", -1))))
        except Exception:
            if header is None:
                raise
            # Corruption can only be the in-flight group commit at the
            # moment of death — everything after it was never written.
            torn = True
            break
    if header is None:
        raise ValueError(f"{path}: empty WAL (no durable header)")
    return {"header": header, "phases": phases, "ops": ops, "torn": torn}


def salvage_history(ops: List[Op]) -> Tuple[List[Op], int]:
    """A recovered prefix → a standard checkable history.

    Dangling client invocations (no completion in the prefix) complete
    as ``:info`` — the Jepsen convention for an op that may or may not
    have taken effect by the end of the (truncated) test — appended in
    invocation order, and the whole sequence reindexes. Returns
    (history, number of dangling invocations completed). Every checker
    family accepts the result: WGL treats ``:info`` as pending forever,
    the graph families consider only ok-completed pairs.
    """
    out = [op.with_() for op in ops]
    open_: dict = {}
    for i, op in enumerate(out):
        if op.type == INVOKE:
            open_[op.process] = i
        elif op.is_completion and op.process in open_:
            open_.pop(op.process)
    dangling = sorted(open_.values())
    t = max((op.time for op in out if op.time is not None), default=None)
    for i in dangling:
        inv = out[i]
        out.append(inv.with_(type=INFO, time=t,
                             error="salvaged: run crashed before "
                                   "completion"))
    return index(out), len(dangling)
