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

The run store (``Store``, ``StoreHandle``) mirrors jepsen/src/jepsen/
store.clj. Layout:

    store/<test-name>/<timestamp>/
        test.json          the serializable slice of the test map
        history.txt        human-readable op log
        history.jsonl      machine-readable history (codec.write_jsonl)
        history.cols.bin   the columnar walk cached at save time
        results.json       checker output
    store/<test-name>/latest    -> most recent completed run
    store/latest                -> most recent completed run of any test

Persistence is two-phase like the reference's save-1!/save-2!
(store.clj:279-302): the history lands before analysis, so a crashed
checker leaves a re-checkable run. ``Store.salvage`` rebuilds a run from
a torn live WAL; ``Store.recheck`` re-checks every stored run of a test
in one batched dispatch on the card (store.clj:165-171, the replay
seam), from the sidecars, or through the native jsonl walk, or from the
parsed Op lists; ``recheck_isolation`` certifies stored transactional
runs. The per-run online artifacts beside each WAL and the tenant
registry are the online daemon's (jepsen_torch.online). The reference's
service, fleet and telemetry namespaces under the store are not ported;
their directory names are kept so that ``tests`` never lists them as
runs.

A store written by either package reads in the other: the files are
the same bytes, and a sidecar's model fingerprint is ``repr(model)``,
which is the same string for the models of both packages. A sidecar
whose fingerprint differs from the requested model's sends the whole
batch to the text route.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import telemetry
from .history.codec import read_jsonl, write_jsonl, write_txt
from .history.ops import Op

JOURNAL_MAGIC = "JTJRNL1"
# Machine-form sidecar magic (history.cols.bin,
# StoreHandle._save_machine_form).
MACHINE_MAGIC = b"JTCOLS1\n"

# Test-map keys that are live objects, never serialized
# (store.clj:155-163 default-nonserializable-keys).
NONSERIALIZABLE_KEYS = {
    "db", "os", "net", "client", "nemesis", "checker", "model", "generator",
    "barrier", "clock", "rng", "sessions", "active_histories", "history",
    "results", "store_handle", "ssh", "wal",
}
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


def _scrub(x):
    try:
        json.dumps(x)
        return x
    except TypeError:
        return repr(x)


class StoreHandle:
    """One run's directory and its file helpers.

    ``store`` and ``test_name`` (set by Store.create) let
    ``save_results`` promote the run's ``latest`` symlinks, which move
    only once results exist, so ``latest`` never points at a run
    directory a crash left without a verdict (the ``latest-incomplete``
    link tracks those instead)."""

    def __init__(self, dir: Path, store: Optional["Store"] = None,
                 test_name: Optional[str] = None):
        self.dir = Path(dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.store = store
        self.test_name = test_name
        self._log_handler: Optional[logging.Handler] = None
        # Telemetry baseline: the registry is process-cumulative, so
        # save_results reports this run's counter deltas.
        self._tel_base = telemetry.snapshot()

    def path(self, *parts: str) -> str:
        """A path inside the run dir, parents created (store.clj path!)."""
        p = self.dir.joinpath(*[str(x) for x in parts])
        p.parent.mkdir(parents=True, exist_ok=True)
        return str(p)

    def write_json(self, parts, obj) -> None:
        """An fsynced temp file and an atomic rename: results.json,
        test.json and salvage.json are resume-path inputs and are never
        left torn."""
        parts = [parts] if isinstance(parts, str) else list(parts)
        atomic_write_json(self.path(*parts), obj, indent=2,
                          default=_scrub)

    def read_json(self, *parts):
        with open(self.path(*parts)) as f:
            return json.load(f)

    def write_history(self, parts, history: Sequence[Op]) -> None:
        parts = [parts] if isinstance(parts, str) else list(parts)
        write_txt(self.path(*parts[:-1], parts[-1] + ".txt"), history)
        write_jsonl(self.path(*parts[:-1], parts[-1] + ".jsonl"), history)

    def save_test(self, test: dict) -> None:
        clean = {k: _scrub(v) for k, v in test.items()
                 if k not in NONSERIALIZABLE_KEYS}
        self.write_json("test.json", clean)

    def save_history(self, history: Sequence[Op], model=None,
                     txt: bool = True) -> None:
        """Phase 1: the history lands before analysis (save-1!,
        store.clj:279-290). With ``model``, the machine form is cached
        too: the exact columnar walk the replay seam would recompute
        from the jsonl text. The sidecar is best effort: any failure
        (state-space explosion, kinds that do not survive the JSON round
        trip) leaves only the text forms, and recheck parses them."""
        if txt:
            write_txt(self.path("history.txt"), history)
        write_jsonl(self.path("history.jsonl"), history)
        if model is not None:
            try:
                self._save_machine_form(history, model)
            except Exception:
                logging.getLogger("jepsen.store").debug(
                    "machine-form sidecar skipped", exc_info=True)

    def _save_machine_form(self, history: Sequence[Op], model) -> None:
        """history.cols.bin: the magic, a 4-byte little-endian header
        length, the header JSON (line count, kinds, model fingerprint),
        then the type (int8), process (int16), kind (int32) and index
        (int32) columns of the one row, raw little-endian: the
        reference's format, byte for byte."""
        from .history.columnar import ops_to_columnar
        cols = ops_to_columnar(model, [list(history)])
        kinds_json = json.dumps(cols.kinds)
        # Only kinds that survive the JSON round trip bit for bit are
        # cached; anything else stays on the parse-from-text route.
        if _kinds_from_json(kinds_json) != list(cols.kinds):
            return
        index = (cols.index if cols.index is not None
                 else np.full_like(cols.kind, -1))
        meta = json.dumps({
            "n": int(cols.type.shape[1]),
            "kinds": kinds_json,
            "model": repr(model),
        }).encode()
        target = self.path("history.cols.bin")
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MACHINE_MAGIC)
            f.write(len(meta).to_bytes(4, "little"))
            f.write(meta)
            f.write(np.ascontiguousarray(cols.type[0], np.int8).tobytes())
            f.write(np.ascontiguousarray(cols.process[0],
                                         np.int16).tobytes())
            f.write(np.ascontiguousarray(cols.kind[0], np.int32).tobytes())
            f.write(np.ascontiguousarray(index[0], np.int32).tobytes())
        os.replace(tmp, target)

    def save_results(self, results: dict) -> None:
        """Phase 2: analysis output (save-2!, store.clj:292-302), which
        promotes this run to ``latest``. The telemetry registry's
        counter deltas since this handle was made merge in as one
        ``telemetry`` block when non-empty, tagged with its ``source``:
        ``salvaged`` for runs rebuilt from a crashed WAL (salvage.json
        present), else ``live``. A caller-provided block wins."""
        snap = telemetry.counters_delta(self._tel_base, telemetry.snapshot())
        if snap and "telemetry" not in results:
            src = "salvaged" if (self.dir / "salvage.json").exists() \
                else "live"
            results["telemetry"] = {"source": src, **snap}
        self.write_json("results.json", results)
        if self.store is not None and self.test_name is not None:
            self.store.update_symlinks(self.test_name, self.dir)
            self.store.retire_incomplete_links(self.dir)

    def start_logging(self) -> None:
        """Attach a per-run jepsen.log file handler (store.clj:304-318)."""
        h = logging.FileHandler(self.path("jepsen.log"))
        h.setFormatter(logging.Formatter(
            "%(asctime)s{%(threadName)s} %(levelname)s %(name)s - "
            "%(message)s"))
        logging.getLogger().addHandler(h)
        self._log_handler = h

    def stop_logging(self) -> None:
        if self._log_handler is not None:
            logging.getLogger().removeHandler(self._log_handler)
            self._log_handler.close()
            self._log_handler = None


class Store:
    """The store root (``base/<test-name>/<timestamp>/`` a run): creates
    run dirs and symlinks, salvages and loads past runs, and re-checks
    them."""

    def __init__(self, base=BASE):
        self.base = Path(base)

    def create(self, test_name: str, ts: Optional[str] = None) -> StoreHandle:
        if ts is None:
            base = time.strftime("%Y%m%dT%H%M%S")
            ts, n = base, 0
            while (self.base / test_name / ts).exists():
                n += 1
                ts = f"{base}.{n}"
        h = StoreHandle(self.base / test_name / ts, store=self,
                        test_name=test_name)
        # A fresh run has no results yet: it is the newest incomplete
        # run. ``latest`` moves only when save_results lands.
        self.update_symlinks(test_name, h.dir, kind="latest-incomplete")
        return h

    def update_symlinks(self, test_name: str, target: Path,
                        kind: str = "latest") -> None:
        """Maintain store/<name>/<kind> and store/<kind>
        (store.clj:235-247). ``kind`` is ``latest`` (completed runs,
        moved by save_results) or ``latest-incomplete`` (the newest
        crashed or salvageable run, moved at create time)."""
        for link in (self.base / test_name / kind, self.base / kind):
            link.parent.mkdir(parents=True, exist_ok=True)
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(os.path.relpath(target, link.parent))

    def retire_incomplete_links(self, target: Path) -> None:
        """Drop any ``latest-incomplete`` link pointing at a run that
        just completed."""
        target = Path(target).resolve()
        for link in (target.parent / "latest-incomplete",
                     self.base / "latest-incomplete"):
            try:
                if link.is_symlink() and link.resolve() == target:
                    link.unlink()
            except OSError:
                pass

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

    def salvage(self, test_name: str, ts: str, model=None) -> dict:
        """Rebuild a checkable run from a (possibly torn) live WAL: drop
        the torn tail, complete dangling invocations as ``:info``, and
        write the standard ``history.jsonl`` and ``history.txt`` (and
        the sidecar when ``model`` is given), after which ``recheck``
        and every checker family work on the crashed run unchanged.
        ``test.json`` is restored from the WAL header if the crash
        predated it. Returns the salvage stats, also written as
        ``salvage.json``."""
        from .history.wal import WAL_FILE, read_wal, salvage_history

        d = self.run_dir(test_name, ts)
        wal_path = d / WAL_FILE
        if not wal_path.exists():
            raise FileNotFoundError(f"{wal_path}: no WAL to salvage")
        w = read_wal(wal_path)
        history, dangling = salvage_history(w["ops"])
        h = StoreHandle(d, store=self, test_name=test_name)
        h.save_history(history, model=model)
        if not (d / "test.json").exists():
            h.write_json("test.json", w["header"].get("test") or {})
        phases = [p for p, _ in w["phases"]]
        stats = {
            "salvaged": True,
            "ops": len(history),
            "wal_ops": len(w["ops"]),
            "dangling_completed": dangling,
            "torn_tail": w["torn"],
            "phase": phases[-1] if phases else
            w["header"].get("phase", "setup"),
            "seed": w["header"].get("seed"),
        }
        # A run that failed (harness exception) rather than being killed
        # left a marker: an empty salvaged prefix is never mistaken for
        # a clean recovery. The reference's runner writes it; the port's
        # runner is not ported, but a store is shared between the two.
        he = d / "harness-error.json"
        if he.exists():
            try:
                stats["harness_error"] = json.loads(
                    he.read_text()).get("error")
            except Exception:
                stats["harness_error"] = "unreadable harness-error.json"
        h.write_json("salvage.json", stats)
        return stats

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

    def load(self, test_name: str, ts: str = "latest") -> dict:
        """Rehydrate a stored run: test map slice, history and results
        (store.clj:165-171)."""
        d = self.run_dir(test_name, ts)
        out: dict = {}
        tj = d / "test.json"
        if tj.exists():
            out.update(json.loads(tj.read_text()))
        hist = d / "history.jsonl"
        if hist.exists():
            out["history"] = read_jsonl(hist)
        res = d / "results.json"
        if res.exists():
            out["results"] = json.loads(res.read_text())
        return out

    def load_histories(self, test_name: str,
                       timestamps: Optional[Sequence[str]] = None
                       ) -> List[List[Op]]:
        """Every stored history for a test. Runs that crashed before
        writing a history are skipped."""
        ts = timestamps if timestamps is not None else \
            self.tests().get(test_name, [])
        out = []
        for t in ts:
            loaded = self.load(test_name, t)
            if "history" in loaded:
                out.append(loaded["history"])
        return out

    def recheck(self, test_name: str, model,
                timestamps: Optional[Sequence[str]] = None, *,
                independent: bool = False, resume: bool = False,
                faults=None, device=None) -> dict:
        """Re-check every stored history of a test in one batched
        dispatch on ``device`` (the card unless the caller names another;
        without one this raises): the replay seam (store.clj:165-171).

        Whole histories (``independent=False``) load from the runs'
        sidecars when every run has one under this model, else through
        ``jsonl_to_columnar`` (the native jsonl walk), and go to
        ``ops.linearize.check_columnar``; a vocabulary too rich for the
        packed table (StateSpaceExplosion) degrades to the Op-list
        route, ``check_batch_columnar`` over the parsed histories.
        ``independent=True`` strains each stored history into per-key
        subhistories first (KV-valued workloads) and pools every (run,
        key) unit into the one batch. Returns {"valid", "runs": {ts:
        {"valid", "results"}}}.

        Both device routes journal retired chunk verdicts to
        ``store/<test>/recheck.journal.jsonl``; ``resume=True`` reloads
        an interrupted run's journal and dispatches only the remaining
        rows (``resume_hits`` counts the rows it found decided). The
        journal is deleted on success. ``faults`` threads a checker-
        nemesis injector (ops.faults) into the pipeline."""
        from .ops.device import resolve_device
        from .ops.linearize import check_batch_columnar, check_columnar
        from .ops.statespace import StateSpaceExplosion

        dev = resolve_device(device)
        ts = (list(timestamps) if timestamps is not None
              else self.tests().get(test_name, []))
        if not independent:
            from .history.columnar import jsonl_to_columnar

            machine = self._load_machine_forms(test_name, ts, model)
            texts, labels = [], []
            if machine is None:
                for t in ts:
                    f = self.run_dir(test_name, t) / "history.jsonl"
                    if f.exists():
                        texts.append(f.read_bytes())
                        labels.append((t, None))
                if not texts:
                    return {"valid": "unknown", "runs": {},
                            "error":
                            f"no stored histories for {test_name!r}"}
            try:
                if machine is not None:
                    cols, labels = machine
                else:
                    cols = jsonl_to_columnar(model, texts)
                # Lazy details: only invalid rows pay the replay decode
                # (checker.clj:98-103's render-only-failures rule); tiny
                # wide buckets ride the native engine.
                return self._journaled_recheck(
                    test_name,
                    {"model": repr(model), "rows": cols.batch,
                     "digest": columnar_digest(cols)},
                    resume, labels,
                    lambda journal: check_columnar(
                        model, cols, device=dev, details="invalid",
                        min_device_batch=64, journal=journal,
                        faults=faults))
            except StateSpaceExplosion:
                units = [loaded["history"] for t in ts
                         if "history" in
                         (loaded := self.load(test_name, t))]
                rs = check_batch_columnar(model, units, device=dev,
                                          details="invalid")
        else:
            units, labels = self.strain_units(test_name, ts,
                                              independent=True)
            if not units:
                return {"valid": "unknown", "runs": {},
                        "error": f"no stored histories for {test_name!r}"}
            # The strained (run, key) units are the batch rows: an
            # interrupted independent recheck resumes with no decided
            # sub-history dispatched again.
            return self._journaled_recheck(
                test_name,
                {"model": repr(model), "rows": len(units),
                 "independent": True,
                 "digest": _units_digest(units, labels)},
                resume, labels,
                lambda journal: check_batch_columnar(
                    model, units, device=dev, details="invalid",
                    journal=journal, faults=faults))
        out = group_unit_results(labels, rs)
        self._tag_recheck(out, test_name, ts)
        return out

    def recheck_isolation(self, test_name: str,
                          timestamps: Optional[Sequence[str]] = None, *,
                          faults=None, device=None) -> dict:
        """Certify the isolation level of every stored transactional
        history of a test in one batched dispatch on ``device`` (the
        card unless the caller names another): the txn family's
        ``recheck`` and the online daemon's parity reference (its final
        txn check is the same ``isolation.certify_batch`` call). Returns
        {"valid", "runs": {ts: result}}."""
        from .isolation import certify_batch
        from .ops.device import resolve_device

        dev = resolve_device(device)
        ts = (list(timestamps) if timestamps is not None
              else self.tests().get(test_name, []))
        units, labels = [], []
        for t in ts:
            loaded = self.load(test_name, t)
            if "history" in loaded:
                units.append(loaded["history"])
                labels.append(t)
        if not units:
            return {"valid": "unknown", "runs": {},
                    "error": f"no stored histories for {test_name!r}"}
        rs = certify_batch(units, faults=faults, device=dev)
        out = {"valid": all(r["valid"] for r in rs),
               "runs": dict(zip(labels, rs))}
        self._tag_recheck(out, test_name, labels)
        return out

    def _tag_recheck(self, out: dict, test_name: str, ts) -> None:
        """Stamp a recheck result with its source: these verdicts came
        from replay, not a live run, and runs rebuilt from a crashed WAL
        (salvage.json present) are named."""
        salvaged = [t for t in ts
                    if (self.run_dir(test_name, t)
                        / "salvage.json").exists()]
        out["telemetry"] = {"source": "recheck",
                            **({"salvaged_runs": salvaged}
                               if salvaged else {})}

    def _journaled_recheck(self, test_name: str, header: dict,
                           resume: bool, labels, call):
        """One batched recheck under a durable chunk journal keyed to
        the exact batch (``header``). ``call(journal)`` runs the check;
        an interrupted run keeps the journal on disk (its purpose), while
        a StateSpaceExplosion drops it (it is keyed to the exploded form,
        useless to any later resume) before propagating to the caller's
        degradation route."""
        from .ops.statespace import StateSpaceExplosion

        journal = ChunkJournal(
            self.base / test_name / "recheck.journal.jsonl",
            header, resume=resume)
        try:
            rs = call(journal)
            resume_hits = journal.resume_hits
            journal.finish()
        except StateSpaceExplosion:
            journal.finish()
            raise
        except BaseException:
            journal.close()
            raise
        out = group_unit_results(labels, rs)
        if resume:
            out["resume_hits"] = resume_hits
        self._tag_recheck(out, test_name,
                          sorted({t for t, _ in labels}))
        return out

    def _load_machine_forms(self, test_name: str, ts, model):
        """(ColumnarOps, labels) assembled from every run's sidecar, or
        None when any run lacks one, was cached under another model, or
        holds a malformed one (torn, foreign, a corrupt kinds vocabulary
        or kind index): all or nothing, so a mixed store degrades to the
        text route rather than dropping runs or reading wrong kinds."""
        from .history.columnar import PAD, ColumnarOps

        fingerprint = repr(model)
        rows = []          # (ts, n_lines, kinds_json, body_bytes, off)
        for t in ts:
            f = self.run_dir(test_name, t) / "history.cols.bin"
            if not f.exists():
                return None
            try:
                raw = f.read_bytes()
                if not raw.startswith(MACHINE_MAGIC):
                    return None
                hlen = int.from_bytes(raw[8:12], "little")
                meta = json.loads(raw[12:12 + hlen])
                n_lines = int(meta["n"])
                if len(raw) < 12 + hlen + n_lines * 11:
                    return None            # short body: torn file
                if meta["model"] != fingerprint:
                    return None
            except Exception:
                return None
            rows.append((t, n_lines, meta["kinds"], raw, 12 + hlen))
        if not rows:
            return None
        vocab: Dict[tuple, int] = {}
        kinds: List[tuple] = []
        # Kinds vocabularies repeat across runs of one test: memoize the
        # per-run lookup table by the kinds JSON text.
        lut_cache: Dict[str, np.ndarray] = {}
        n = max(m for _, m, _, _, _ in rows)
        B = len(rows)
        type_ = np.full((B, n), PAD, np.int8)
        process = np.zeros((B, n), np.int16)
        kind = np.full((B, n), -1, np.int32)
        index = np.full((B, n), -1, np.int32)
        for r, (_, m, kjson, raw, off) in enumerate(rows):
            try:
                lut = lut_cache.get(kjson)
                if lut is None:
                    ks = _kinds_from_json(kjson)
                    # Slot -1 keeps non-invoke lines' -1.
                    lut = np.empty(len(ks) + 1, np.int32)
                    for i, k in enumerate(ks):
                        j = vocab.get(k)
                        if j is None:
                            j = vocab[k] = len(kinds)
                            kinds.append(k)
                        lut[i] = j
                    lut[-1] = -1
                    lut_cache[kjson] = lut
                type_[r, :m] = np.frombuffer(raw, np.int8, m, off)
                off += m
                process[r, :m] = np.frombuffer(raw, np.int16, m, off)
                off += 2 * m
                kraw = np.frombuffer(raw, np.int32, m, off)
                # Valid kind indices are exactly [-1, len(ks)).
                if kraw.size and (int(kraw.min()) < -1
                                  or int(kraw.max()) >= lut.size - 1):
                    return None
                kind[r, :m] = lut[kraw]
                off += 4 * m
                index[r, :m] = np.frombuffer(raw, np.int32, m, off)
            except Exception:
                return None
        cols = ColumnarOps(type=type_, process=process, kind=kind,
                           kinds=kinds, index=index)
        return cols, [(t, None) for t, _, _, _, _ in rows]

    def strain_units(self, test_name: str, ts, *,
                     independent: bool) -> tuple:
        """(units, labels) over a test's stored runs: per-key
        subhistories when ``independent`` (the whole history for a run
        with no KV-keyed ops, so keyless runs are never excluded), else
        whole histories. Labels are (timestamp, key-or-None)."""
        from .independent import history_keys, subhistory

        units, labels = [], []
        for t in ts:
            loaded = self.load(test_name, t)
            h = loaded.get("history")
            if h is None:
                continue
            keys = history_keys(h) if independent else []
            if keys:
                for k in keys:
                    units.append(subhistory(k, h))
                    labels.append((t, k))
            else:
                units.append(h)
                labels.append((t, None))
        return units, labels

    def delete(self, test_name: str, ts: Optional[str] = None) -> None:
        """Remove a run, or all of a test's runs (store.clj:328-345)."""
        target = (self.base / test_name / ts) if ts else \
            (self.base / test_name)
        if target.exists():
            shutil.rmtree(target)


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


def _units_digest(units, labels) -> str:
    """Content fingerprint of strained (run, key) history units: the
    independent recheck's journal key component. Every op line feeds the
    hash: a re-salvage can flip a dangling middle invocation between ok
    and :info without touching counts or endpoints."""
    h = hashlib.sha256()
    for (ts, k), u in zip(labels, units):
        h.update(f"{ts}|{k!r}|{len(u)}".encode())
        for op in u:
            h.update(str(op).encode())
    return h.hexdigest()[:16]


def _kinds_from_json(text: str) -> list:
    """Decode a kinds vocabulary from JSON, restoring the tuple
    structure JSON flattens to lists (kinds are (f, value) tuples whose
    values may themselves be tuples, e.g. cas pairs)."""
    def detuple(x):
        if isinstance(x, list):
            return tuple(detuple(v) for v in x)
        return x

    return [detuple(k) for k in json.loads(text)]


def group_unit_results(labels, rs) -> dict:
    """Fold per-unit results back into the recheck shape {"valid",
    "runs": {ts: {"valid", "results"}}}: the grouping every replay path
    shares (Store.recheck and recheck.py's fold and bank families)."""
    from .checkers.core import merge_valid

    runs: Dict[str, dict] = {}
    for (t, k), r in zip(labels, rs):
        run = runs.setdefault(t, {"results": {}})
        run["results"][k if k is not None else "history"] = r
    for run in runs.values():
        run["valid"] = merge_valid(
            r["valid"] for r in run["results"].values())
    return {
        "valid": merge_valid(run["valid"] for run in runs.values())
        if runs else True,
        "runs": runs,
    }


def attach(test: dict, store: Optional[Store] = None) -> dict:
    """Give a test map a store handle and logging for its run; returns
    the test."""
    store = store or DEFAULT
    h = store.create(test.get("name", "noname"))
    test["store_handle"] = h
    h.save_test(test)
    h.start_logging()
    return test
