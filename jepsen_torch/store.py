"""The checker's write-ahead logs: copies of the reference's
``store.ChunkJournal`` and ``store.CampaignCheckpoint``, the digests that
key them, and the part of the run store the online daemon reads.

The file format is the reference's, so a journal written by either
package resumes in the other: a header line ``{"journal": "JTJRNL1",
"key": {...}}`` binding the journal to one exact batch, then one
fsynced JSON line per retired chunk, ``{"rows": [...], "valid": [...],
"bad": [...], "prov": [...]}``. The online daemon's frontier-checkpoint
rows (``{"frontier": {...}}``, ``record_frontier``) load latest-wins and
compact the file every ``FRONTIER_COMPACT_EVERY`` rows. A campaign
checkpoint has the reference's format too (``{"campaign": "JTCAMP1",
"key": {...}}``, then ``started`` and ``done`` lines per seed), so a
campaign killed under one package resumes under the other.

Of the run store (``Store``) the port keeps the root and what the online
daemon (jepsen_torch.online) calls: the run listing (``tests``,
``incomplete``, ``run_dir``), the persisted tenant registry and the
per-run online artifacts beside each WAL (the names below). Creating,
salvaging and re-checking runs stay with the reference.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

JOURNAL_MAGIC = "JTJRNL1"
# Campaign-checkpoint header magic (CampaignCheckpoint).
CAMPAIGN_MAGIC = "JTCAMP1"
BASE = Path("store")

# The online daemon's per-run artifacts beside the WAL: the decided-
# prefix journal, the durable final verdict, the overload-deferred
# mark, the first-violation record and the live isolation monitor's
# downgrade record; and the store-level tenant registry it persists
# each tick.
ONLINE_JOURNAL = "online.journal.jsonl"
ONLINE_VERDICT = "online-verdict.json"
ONLINE_DEFERRED = "online-deferred.json"
FIRST_VIOLATION = "first-violation.json"
ONLINE_ISO = "online-iso.json"
ONLINE_REGISTRY = "online-registry.json"

# Directories under the store that hold coordination or diagnostics
# state, never runs: Store.tests() skips them.
FLEET_DIR = "fleet"
SERVICE_DIR = "service"
TELEMETRY_DIR = "telemetry"

log = logging.getLogger("jepsen.store")


class CampaignMismatch(ValueError):
    """An explicit campaign resume named a checkpoint belonging to a
    different campaign (key mismatch): refused rather than clobbered,
    because the checkpoint is the only resume point."""


class Store:
    """The store root (``base/<test-name>/<timestamp>/`` a run): what
    campaigns and the online daemon read and write under it."""

    def __init__(self, base=BASE):
        self.base = Path(base)

    def tests(self) -> Dict[str, List[str]]:
        """{test-name: [timestamps]} of stored runs. Symlinks (latest,
        latest-incomplete) and the coordination directories are never
        runs."""
        out: Dict[str, List[str]] = {}
        if not self.base.exists():
            return out
        for name_dir in sorted(self.base.iterdir()):
            if (not name_dir.is_dir() or name_dir.is_symlink()
                    or name_dir.name in ("latest", SERVICE_DIR,
                                         TELEMETRY_DIR)):
                continue
            runs = [d.name for d in sorted(name_dir.iterdir())
                    if d.is_dir() and not d.is_symlink()
                    and d.name not in ("latest", FLEET_DIR)]
            if runs:
                out[name_dir.name] = runs
        return out

    def incomplete(self, include_salvaged: bool = False) -> List[tuple]:
        """(test_name, ts) of runs with a live-WAL segment and no
        results.json: still running, or crashed. Runs already salvaged
        (salvage.json at least as new as the WAL) are skipped unless
        ``include_salvaged``."""
        from .history.wal import WAL_FILE
        out = []
        for name, runs in self.tests().items():
            for ts in runs:
                d = self.base / name / ts
                if not (d / WAL_FILE).exists() or \
                        (d / "results.json").exists():
                    continue
                if not include_salvaged:
                    try:
                        sj = d / "salvage.json"
                        if sj.exists() and sj.stat().st_mtime >= \
                                (d / WAL_FILE).stat().st_mtime:
                            continue
                    except OSError:
                        pass
                out.append((name, ts))
        return out

    def run_dir(self, test_name: str, ts: str = "latest") -> Path:
        return self.base / test_name / ts

    def save_online_registry(self, reg: dict) -> None:
        """Persist the online daemon's tenant registry (display and
        resume state, never a correctness gate)."""
        self.base.mkdir(parents=True, exist_ok=True)
        atomic_write_json(self.base / ONLINE_REGISTRY, reg)

    def _run_json(self, test_name: str, ts: str, name: str
                  ) -> Optional[dict]:
        try:
            f = self.run_dir(test_name, ts) / name
            return json.loads(f.read_text()) if f.exists() else None
        except Exception:
            return None

    def online_verdict(self, test_name: str, ts: str) -> Optional[dict]:
        """The daemon's durable final verdict for a run, or None while
        the run is still being tailed or was never watched."""
        return self._run_json(test_name, ts, ONLINE_VERDICT)

    def first_violation(self, test_name: str, ts: str) -> Optional[dict]:
        """Which op first made the run invalid, and at what prefix the
        daemon caught it."""
        return self._run_json(test_name, ts, FIRST_VIOLATION)

    def online_iso(self, test_name: str, ts: str) -> Optional[dict]:
        """The live isolation monitor's durable downgrade record, or
        None while the run holds serializability (or is not
        transactional)."""
        return self._run_json(test_name, ts, ONLINE_ISO)


DEFAULT = Store()


class ChunkJournal:
    """Durable chunk-verdict journal.

    The streaming checkers append one line per retired chunk as verdicts
    land: ``rows`` are caller-level history indices, ``bad`` the final
    bad-op index (null for valid rows), ``prov`` the provenance tag per
    row. The header's key carries a fingerprint of the batch (model, row
    count, a content digest), so a stale journal is discarded rather
    than trusted.

    Every record is flushed and fsynced: an interrupted process leaves
    every retired chunk on disk, and a torn final line is dropped on
    load (and cut off before the next append). ``resume=True`` reloads
    the decided rows so the next run dispatches only the remainder;
    ``record`` refuses a row decided twice, which makes the journal the
    enforcement point of the no-row-redispatched rule. ``finish()``
    deletes the file: a journal only outlives an interrupted run."""

    def __init__(self, path, key: dict, resume: bool = False):
        self.path = Path(path)
        self.key = dict(key)
        self.resume_hits = 0
        self._decided: Dict[int, tuple] = {}
        self._frontier: Optional[dict] = None
        self._stale_frontier_rows = 0
        self._good_end = 0     # byte offset past the last clean line
        if resume and self.path.exists():
            self._load()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self._decided or self._frontier is not None:
            # Drop the torn tail BEFORE appending: a record written after
            # a partial line would weld onto it.
            with open(self.path, "r+b") as f:
                f.truncate(self._good_end)
            self._f = open(self.path, "a")
        else:
            self._f = open(self.path, "w")
            self._f.write(json.dumps(
                {"journal": JOURNAL_MAGIC, "key": self.key}) + "\n")
            self._flush()

    def _load(self) -> None:
        try:
            data = self.path.read_bytes()
            pos = 0
            header_seen = False
            while pos < len(data):
                nl = data.find(b"\n", pos)
                if nl < 0:
                    break          # torn tail from the interruption
                try:
                    e = json.loads(data[pos:nl])
                    if not header_seen:
                        if e.get("journal") != JOURNAL_MAGIC or \
                                e.get("key") != self.key:
                            log.warning("chunk journal %s belongs to a "
                                        "different batch (key mismatch); "
                                        "starting fresh", self.path)
                            return
                        header_seen = True
                    elif "frontier" in e:
                        self._frontier = e["frontier"]
                    else:
                        for r, v, b, p in zip(e["rows"], e["valid"],
                                              e["bad"], e["prov"]):
                            self._decided[int(r)] = (
                                bool(v), None if b is None else int(b), p)
                except Exception:
                    break          # malformed line: keep the prefix
                pos = nl + 1
                self._good_end = pos
        except Exception:
            self._decided = {}
            self._good_end = 0

    def _flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def decided(self) -> Dict[int, tuple]:
        """{row: (valid, bad-op-index-or-None, provenance)} recovered
        from a previous interrupted run."""
        self.resume_hits = len(self._decided)
        return dict(self._decided)

    def record(self, rows, valid, bad, prov) -> None:
        rows = [int(r) for r in rows]
        if not rows:
            return
        dup = [r for r in rows if r in self._decided]
        if dup:
            raise ValueError(
                f"chunk journal: rows decided twice (double dispatch): "
                f"{dup[:5]}")
        valid = [bool(v) for v in valid]
        bad = [None if b is None else int(b) for b in bad]
        prov = [str(p) for p in prov]
        for r, v, b, p in zip(rows, valid, bad, prov):
            self._decided[r] = (v, b, p)
        self._f.write(json.dumps({"rows": rows, "valid": valid, "bad": bad,
                                  "prov": prov}) + "\n")
        self._flush()

    def frontier(self) -> Optional[dict]:
        """The latest frontier-checkpoint payload recovered on resume,
        or None."""
        return self._frontier

    #: Superseded frontier rows tolerated before the journal compacts in
    #: place: only the latest checkpoint is ever used.
    FRONTIER_COMPACT_EVERY = 64

    def record_frontier(self, payload: dict) -> None:
        """Append one frontier-checkpoint row, fsynced like every chunk
        verdict. Every FRONTIER_COMPACT_EVERY rows the journal rewrites
        itself (atomic tmp and rename) down to the header, the decided
        rows and this one checkpoint."""
        self._frontier = payload
        self._stale_frontier_rows += 1
        if self._stale_frontier_rows >= self.FRONTIER_COMPACT_EVERY:
            self._compact()
        else:
            self._f.write(json.dumps({"frontier": payload}) + "\n")
            self._flush()

    def _compact(self) -> None:
        """Rewrite the journal as header, one consolidated decided-rows
        record and the latest frontier row, atomically: a kill
        mid-compact leaves the old file or the new one."""
        tmp = self.path.parent / (self.path.name + f".tmp{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(json.dumps(
                {"journal": JOURNAL_MAGIC, "key": self.key}) + "\n")
            if self._decided:
                rows = sorted(self._decided)
                f.write(json.dumps({
                    "rows": rows,
                    "valid": [self._decided[r][0] for r in rows],
                    "bad": [self._decided[r][1] for r in rows],
                    "prov": [self._decided[r][2] for r in rows],
                }) + "\n")
            if self._frontier is not None:
                f.write(json.dumps({"frontier": self._frontier}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "a")
        self._flush()
        self._stale_frontier_rows = 0

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass

    def finish(self) -> None:
        """The run completed: the journal has served its purpose."""
        self.close()
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass


class CampaignCheckpoint:
    """Durable seed-campaign progress: the campaign's write-ahead log.

    One fsynced JSON line per transition: line 1 a header binding the
    checkpoint to one campaign (``{"campaign": "JTCAMP1", "key":
    {...}}``; resuming against a mismatched checkpoint raises
    CampaignMismatch rather than clobbering the only resume point), then
    ``{"seed": s, "dir": ..., "status": "started"}`` when a seed starts
    and ``{"seed": s, "status": "done"}`` when it completes. A killed
    campaign resumes only the remaining seeds. Torn final lines are
    dropped and cut off before appending (the ChunkJournal discipline).
    ``finish()`` deletes the file: a checkpoint only outlives an
    interrupted campaign."""

    def __init__(self, path, key: dict, resume: bool = False):
        self.path = Path(path)
        self.key = dict(key)
        self._runs: Dict[int, dict] = {}   # seed -> {"dir", "done"}
        self._good_end = 0
        if resume and self.path.exists():
            self._load()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self._runs:
            with open(self.path, "r+b") as f:
                f.truncate(self._good_end)
            self._f = open(self.path, "a")
        else:
            self._f = open(self.path, "w")
            self._f.write(json.dumps(
                {"campaign": CAMPAIGN_MAGIC, "key": self.key}) + "\n")
            self._flush()

    def _load(self) -> None:
        try:
            data = self.path.read_bytes()
            pos = 0
            header_seen = False
            while pos < len(data):
                nl = data.find(b"\n", pos)
                if nl < 0:
                    break
                try:
                    e = json.loads(data[pos:nl])
                    if not header_seen:
                        if e.get("campaign") != CAMPAIGN_MAGIC or \
                                e.get("key") != self.key:
                            raise CampaignMismatch(
                                f"campaign checkpoint {self.path} "
                                f"belongs to a different campaign: "
                                f"stored key {e.get('key')!r} != "
                                f"{self.key!r}; start a fresh campaign "
                                f"(without resume) to replace it")
                        header_seen = True
                    elif e.get("status") == "started":
                        self._runs[int(e["seed"])] = {
                            "dir": e["dir"], "done": False}
                    elif e.get("status") == "done":
                        r = self._runs.get(int(e["seed"]))
                        if r is not None:
                            r["done"] = True
                except CampaignMismatch:
                    raise
                except Exception:
                    break
                pos = nl + 1
                self._good_end = pos
        except CampaignMismatch:
            raise
        except Exception:
            self._runs = {}
            self._good_end = 0

    def _flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def seed_state(self, seed: int) -> Optional[dict]:
        """{"dir": ..., "done": bool} for a seed a prior campaign
        already touched, else None."""
        r = self._runs.get(int(seed))
        return dict(r) if r is not None else None

    def started(self, seed: int, dir) -> None:
        self._runs[int(seed)] = {"dir": str(dir), "done": False}
        self._f.write(json.dumps(
            {"seed": int(seed), "dir": str(dir), "status": "started"})
            + "\n")
        self._flush()

    def done(self, seed: int) -> None:
        r = self._runs.get(int(seed))
        if r is not None:
            r["done"] = True
        self._f.write(json.dumps(
            {"seed": int(seed), "status": "done"}) + "\n")
        self._flush()

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass

    def finish(self) -> None:
        """The campaign completed: every seed ran."""
        self.close()
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass


def columnar_digest(cols) -> str:
    """Content fingerprint of a ColumnarOps batch: the journal key
    component that pins a journal to one exact row set and order (the
    reference's digest, byte for byte)."""
    h = hashlib.sha256()
    for arr in (cols.type, cols.process, cols.kind):
        h.update(np.ascontiguousarray(arr).tobytes())
    if cols.index is not None:
        h.update(np.ascontiguousarray(cols.index).tobytes())
    key = getattr(cols, "key", None)
    if key is not None:
        h.update(b"key")
        h.update(np.ascontiguousarray(key).tobytes())
    h.update(json.dumps(list(map(list, cols.kinds)), default=str)
             .encode())
    return h.hexdigest()[:16]


def spec_digest(spec, **extra) -> str:
    """Fingerprint of a deterministic generator spec (a dataclass such
    as ops.synth_device.SynthSpec) plus labelling kwargs: the journal
    key of a synthesized batch, which the spec names completely."""
    import dataclasses

    d = dataclasses.asdict(spec) if dataclasses.is_dataclass(spec) \
        else dict(spec)
    d.update(extra)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def atomic_write_json(path, obj, **dump_kwargs) -> None:
    """Durable small-JSON write: an fsynced temp file (named by the pid,
    so two writers never share one) and an atomic rename, so a crash
    never leaves a torn file. ``dump_kwargs`` go to json.dump."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f, **dump_kwargs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
