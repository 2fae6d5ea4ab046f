"""Always-on online checker: tail live WALs, check prefixes as they run.

A copy of the reference's ``online.py``, the daemon Jepsen users run
beside a campaign: it tails every live run's WAL
and reports the first violating op while the test is still writing its
history.

Model
-----
One ``OnlineDaemon`` watches a store. Every incomplete run (live WAL, no
results.json) becomes a *tenant*: an incremental tail cursor
(``history.wal.TailState``; whole lines only, so a torn in-flight group
commit is completed by a later poll, and rotation is an inode change
that resets the cursor), a buffered op prefix, and a per-tenant
``store.ChunkJournal`` whose rows are decided prefix lengths.

Interim checks take the delta path by default: the tenant's
``ops.schedule.ResidentFrontier`` resumes its carried WGL frontier over
the ops since the last tick, one resume launch of the WGL kernel for the
newly frozen events and one for the volatile tail, on the card
(``OnlineConfig.device``; None means the CUDA card, which must exist).
Where the delta path cannot serve a tick (a state-space explosion, a
window past the mask axis, a tenant still re-buffering) the full prefix
goes through ``check_columnar`` with a persistent
``schedule.ResidentState``. Dangling invocations are held open in the
checked prefix, never decided as ``:info``, so interim verdicts are
monotone, and the first invalid one persists ``first-violation.json``.

Finalization is parity-exact by construction: when the writer stamps
``analyzed`` the daemon re-checks the stored history; when the writer
dies (pid liveness and quiescence) it applies ``salvage_history``; either
way through the post-mortem recheck's own call,
``check_batch_columnar(..., details="invalid", min_device_batch=64)``.
A single history is one row, under 64, so that call decides it on the
host engine in both packages.

Robustness: admission bounds (tenant count, W class, check rate, a
bounded ingest buffer with counted backpressure), a degradation ladder
by total undecided backlog (widen the check interval, shed interim
checks to the host oracle, durably defer the stalest tenant), a
deterministic daemon fault plan at the tail, encode and dispatch stages
($JT_WATCH_FAULT_PLAN), and restart from the per-tenant journals and
durable verdict files. Only ``DaemonFault`` is absorbed as a stage
fault; any other error of a check is counted in ``check_errors``, the
carried frontier is dropped first, and the tick is retried next poll:
nothing goes on checking on a plain version after a kernel error.

SLOs land on the telemetry registry: ``online.ttfv_s`` histograms,
``online.pending_ops`` and ``online.tenants`` gauges, and counters for
every ladder transition, under the reference's names.
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import telemetry
from .history.core import index
from .history.ops import FAIL, INVOKE, OK, Op
from .history.wal import (TailState, WAL_FILE, salvage_history, tail_wal,
                          writer_alive)
from .ops.device import resolve_device
from .store import (FIRST_VIOLATION, ONLINE_DEFERRED, ONLINE_ISO,
                    ONLINE_JOURNAL, ONLINE_VERDICT, ChunkJournal,
                    DEFAULT, Store, atomic_write_json)

log = logging.getLogger("jepsen.online")

# Daemon-level fault stages: the three loop boundaries a tick crosses
# per tenant. (The checker pipeline's own encode/dispatch/decode
# nemesis — ops.faults — still applies INSIDE a dispatched check; these
# are the stages above it.)
DAEMON_STAGES = ("tail", "encode", "dispatch")
DAEMON_KINDS = ("fail", "stall")


class DaemonFault(RuntimeError):
    """An injected daemon-stage failure. The service loop absorbs it —
    the tenant's tick is skipped and retried on the next poll — which
    is exactly the property the parity tests pin: no single daemon
    fault changes any final verdict."""

    def __init__(self, stage: str, ordinal: int):
        self.stage, self.ordinal = stage, ordinal
        super().__init__(f"injected daemon fault at {stage} "
                         f"ordinal {ordinal}")


@dataclass(frozen=True)
class DaemonFaultSpec:
    """``kind`` at ``stage``, firing on that stage's Nth crossing
    (``tick`` None = sticky)."""

    stage: str
    kind: str
    tick: Optional[int] = 0

    def __post_init__(self):
        assert self.stage in DAEMON_STAGES, self.stage
        assert self.kind in DAEMON_KINDS, self.kind

    def matches(self, stage: str, ordinal: int) -> bool:
        return self.stage == stage and (self.tick is None
                                        or self.tick == ordinal)


class DaemonFaultPlan:
    """Deterministic daemon fault schedule — the ops.faults.FaultPlan
    idiom lifted to the service loop's stages. ``stall_s`` is what a
    ``stall`` fault sleeps (test-scale by default)."""

    def __init__(self, specs: List[DaemonFaultSpec], *,
                 stall_s: float = 0.05):
        self.specs = list(specs)
        self.stall_s = stall_s

    @classmethod
    def single(cls, stage: str, kind: str, tick: int = 0,
               **kw) -> "DaemonFaultPlan":
        return cls([DaemonFaultSpec(stage, kind, tick)], **kw)

    @classmethod
    def parse(cls, text: str, **kw) -> "DaemonFaultPlan":
        """``"stage:kind[:tick]"`` comma/semicolon-separated; tick
        ``*`` = sticky (the $JT_WATCH_FAULT_PLAN syntax)."""
        specs = []
        for part in text.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            tick: Optional[int] = 0
            if len(bits) > 2:
                tick = None if bits[2] == "*" else int(bits[2])
            specs.append(DaemonFaultSpec(bits[0], bits[1], tick))
        return cls(specs, **kw)

    def match(self, stage: str, ordinal: int) -> Optional[DaemonFaultSpec]:
        for s in self.specs:
            if s.matches(stage, ordinal):
                return s
        return None


def daemon_fault_schedules() -> List[Tuple[str, DaemonFaultPlan]]:
    """The canonical single-fault matrix the online parity tests sweep:
    one transient failure at each stage boundary plus a tail stall and
    a dispatch stall — each fired exactly once, on the first crossing
    of its stage."""
    out = [(f"fail@{s}", DaemonFaultPlan.single(s, "fail"))
           for s in DAEMON_STAGES]
    out.append(("stall@tail", DaemonFaultPlan.single("tail", "stall")))
    out.append(("stall@dispatch",
                DaemonFaultPlan.single("dispatch", "stall")))
    return out


class DaemonFaultInjector:
    """Executes a DaemonFaultPlan at the daemon's stage crossings.
    ``fire(stage)`` raises DaemonFault for ``fail`` and sleeps through
    ``stall``; ``log`` records every firing so tests can assert the
    schedule actually engaged."""

    def __init__(self, plan: DaemonFaultPlan):
        self.plan = plan
        self.log: List[Tuple[str, int, str]] = []
        self._ordinal: Dict[str, int] = {s: 0 for s in DAEMON_STAGES}

    def fire(self, stage: str) -> None:
        n = self._ordinal[stage]
        self._ordinal[stage] = n + 1
        spec = self.plan.match(stage, n)
        if spec is None:
            return
        self.log.append((stage, n, spec.kind))
        if spec.kind == "fail":
            raise DaemonFault(stage, n)
        time.sleep(self.plan.stall_s)

    @classmethod
    def from_env(cls) -> Optional["DaemonFaultInjector"]:
        text = os.environ.get("JT_WATCH_FAULT_PLAN")
        if not text:
            return None
        return cls(DaemonFaultPlan.parse(text))


# --------------------------------------------------------------- prefix

def checkable_prefix(ops: List[Op]) -> List[Op]:
    """An indexed copy of the raw tailed prefix, dangling invocations
    left OPEN. The WGL treats a never-completed invocation exactly like
    salvage's ``:info`` completion — pending forever, possibly taking
    effect at any point — so the prefix verdict is sound without
    durably deciding the dangling ops, which the live tail may yet
    confirm. (Excluding them would be UNSOUND: a completed read in the
    prefix may observe a dangling write's effect.)"""
    return index([op.with_() for op in ops])


def _is_txn(history: List[Op]) -> bool:
    """Transactional vocabulary sniff (fleet.classify_history's rule):
    any ``txn`` client op routes the history to the isolation plane —
    the register/WGL engines have no semantics for multi-key micro-op
    vectors."""
    return any(getattr(op, "f", None) == "txn" for op in history)


def _bad_index(r: dict) -> Optional[int]:
    """The first-impossible-op index out of a result dict, from either
    engine's shape (device details decode an op dict; the host engine
    an Op)."""
    if r.get("valid") is True:
        return None
    op = r.get("op")
    if op is None:
        return None
    if isinstance(op, dict):
        return op.get("index")
    return getattr(op, "index", None)


# --------------------------------------------------------------- config

@dataclass
class OnlineConfig:
    """The daemon's admission/overload policy. Thresholds are in
    buffered-undecided ops (the unit backpressure actually acts on);
    the defaults suit a real store, tests shrink them to force the
    ladder. ``device`` is where checks launch: None means the CUDA card
    (and raises without one), "cpu" the plain versions."""

    model: object = None
    device: object = None
    poll_s: float = 0.5             # tail poll interval (jittered)
    jitter: float = 0.25            # fraction of poll_s
    check_interval_ops: int = 64    # interim check every N new ops
    min_check_ops: int = 1
    # -- admission
    max_tenants: int = 64
    max_w: int = 14                 # W-class admission bound (device)
    rate_checks_per_s: float = 0.0  # per-tenant; 0 = unlimited
    max_buffered_ops: int = 262144  # ingest bound per tenant
    # -- degradation ladder (total undecided backlog across tenants)
    overload_pending_ops: int = 8192     # L1: widen check interval
    widen_factor: int = 4
    shed_pending_ops: int = 32768        # L2: shed to the host oracle
    defer_pending_ops: int = 131072      # L3: pause stalest tenant
    # Hard re-admission deadline for deferred tenants ($JT_DEFER_MAX_S,
    # default 300 s; 0 = disabled, the convention every sibling knob
    # uses): past it the stalest deferred tenant is force-admitted
    # ahead of fresh ones even while the fleet stays busy — no live
    # stream waits unboundedly behind a persistently overloaded
    # daemon (``deferred_starvation_rescues``).
    defer_max_s: Optional[float] = None
    # -- incremental prefix checking ($JT_ONLINE_INCREMENTAL, default
    # on; 0 = the restore switch, every interim check re-walks the
    # full prefix — the pre-frontier behavior, bit-for-bit). When on,
    # non-shed interim checks resume a per-tenant resident device
    # frontier (ops.schedule.ResidentFrontier) so per-tick cost is
    # O(new ops); any fault, rotation, or non-monotone vocabulary
    # growth invalidates the carried frontier and that tick falls back
    # to the full-prefix check. Finalization ALWAYS runs the exact
    # full Store.recheck engine call — the parity contract is
    # structurally untouched by this switch.
    incremental: Optional[bool] = None
    # -- live isolation monitoring ($JT_ONLINE_ISO, default on;
    # 0 = the restore switch). Transactional tenants (txn vocabulary)
    # feed an isolation.IncrementalIsolation monitor per tail tick:
    # the per-tick "strongest level still holding" verdict is monotone
    # non-increasing, and every downgrade persists durably as
    # ``online-iso.json`` (the first-violation pattern). Interim and
    # final CHECKS are unaffected — they ride the isolation certifier
    # either way; this switch only governs the per-tick monitor.
    iso: Optional[bool] = None
    # -- finalization
    crash_quiet_s: float = 1.0      # writer dead AND quiet this long
    min_device_batch: int = 64      # Store.recheck's value (parity)
    host_engine: object = None      # default: the exact host engine

    def __post_init__(self):
        if self.model is None:
            from .models.core import cas_register
            self.model = cas_register()
        if self.incremental is None:
            self.incremental = os.environ.get(
                "JT_ONLINE_INCREMENTAL", "1") != "0"
        if self.iso is None:
            self.iso = os.environ.get("JT_ONLINE_ISO", "1") != "0"
        if self.defer_max_s is None:
            try:
                self.defer_max_s = max(
                    0.0, float(os.environ.get("JT_DEFER_MAX_S", "300")))
            except ValueError:
                self.defer_max_s = 300.0


# --------------------------------------------------------------- engine

class OnlineCheckEngine:
    """The daemon's resident check engine. Rolling (interim) checks
    ride the device pipeline with persistent state: a grow-only kind
    vocabulary seeds every conversion (stable bucketing across
    checks), and one ``schedule.ResidentState`` carries learned
    OOM-safe chunk sizes and awaited kernel shapes across the
    per-check scheduler instances — together with the process-wide
    kernel registry/AOT cache these are the "persistent resident
    buffers" that make check k+1 cheaper than check k. Final checks
    deliberately run the UNSEEDED vanilla ``check_batch_columnar``
    call with ``Store.recheck``'s exact arguments: parity with the
    post-mortem path outranks warm-start economics exactly once per
    run. Shed checks (overload L2, W-class overflow, state-space
    explosion) run the same exact host engine quarantine falls back
    to."""

    def __init__(self, cfg: OnlineConfig):
        from .checkers.linearizable import wgl_check
        from .ops.schedule import ResidentState
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.kinds: Optional[list] = None
        self.resident = ResidentState()
        self.host = cfg.host_engine or wgl_check
        # $JT_ONLINE_DC: per-tenant decrease-and-conquer carries
        # (ops.dc_monitor.IncrementalDC), keyed like the resident
        # frontiers. Certify-only fast path — a tick it cannot serve
        # falls through to the frontier with verdicts unchanged.
        self._dc_inc: Dict[Tuple, object] = {}

    def check(self, history: List[Op], *, shed: bool = False,
              final: bool = False) -> Tuple[dict, str]:
        """(result dict, provenance). ``final`` = the parity-exact
        post-mortem call; ``shed`` = the host oracle."""
        from .ops.linearize import check_batch_columnar, check_columnar
        from .ops.statespace import StateSpaceExplosion

        cfg = self.cfg
        if _is_txn(history):
            # Transactional tenant: certification rides the isolation
            # plane (jepsen_tpu.isolation), not the register engines.
            # ``shed`` maps to the host oracle twin exactly like the
            # WGL route; final/interim ride certify_batch, which is
            # also what Store.recheck_isolation dispatches — the
            # parity contract carries over unchanged.
            from .isolation import certify_batch, certify_host
            if shed:
                return certify_host([history])[0], "online-iso-host"
            r = certify_batch([history], device=self.device)[0]
            return r, ("online-iso-final" if final else "online-iso")
        if final:
            r = check_batch_columnar(
                cfg.model, [history], device=self.device,
                details="invalid",
                min_device_batch=cfg.min_device_batch)[0]
            return r, "online-final"
        if shed:
            return self.host(cfg.model, history), "online-host"
        try:
            from .history.columnar import ops_to_columnar
            cols = ops_to_columnar(cfg.model, [history],
                                   kinds=self.kinds)
            self.kinds = list(cols.kinds)
            r = check_columnar(
                cfg.model, cols, device=self.device, details="invalid",
                min_device_batch=cfg.min_device_batch,
                scheduler_opts={"resident": self.resident})[0]
            return r, "online"
        except StateSpaceExplosion:
            # Vocabulary too rich for the packed table: this tenant's
            # interim checks ride the host engine (recheck's own
            # degradation route).
            return self.host(cfg.model, history), "online-host"

    def check_delta(self, tenant) -> Optional[Tuple[dict, str]]:
        """Incremental interim check: resume the tenant's resident
        device frontier over the ops that arrived since the last tick
        — O(new ops) — rebuilding from op 0 on any invalidation
        (vocabulary renumbering, window overflow, a poisoned carry).
        Returns None when the incremental path cannot serve this
        tenant (state space exploded, window beyond the single-device
        mask axis, a deferred tenant still re-buffering): the caller
        falls back to the full-prefix engine, verdicts unchanged.

        Soundness guard: ANY exception mid-advance drops the carried
        frontier before propagating — a half-updated carry never
        survives into the next tick."""
        from .ops.linearize import DATA_MAX_SLOTS
        from .ops.schedule import FrontierInvalid, ResidentFrontier
        from .ops.statespace import StateSpaceExplosion

        if tenant.is_txn:
            # The WGL frontier has no transactional semantics; txn
            # tenants' interim checks ride the isolation certifier
            # (their O(new ops) path is the per-tick monitor).
            return None
        d = tenant.daemon
        # $JT_ONLINE_DC: the decrease-and-conquer incremental monitor
        # sits BEFORE the frontier's width guard — its carry is flat
        # in W, so it serves the wide tenants (peak_w beyond the
        # device mask axis) the frontier must decline. Certify-only:
        # a tick it cannot serve (residue, non-register ops, a read of
        # a pending write) falls through with verdicts unchanged, and
        # the same soundness guard applies — any mid-advance fault
        # drops the carried peel state before propagating.
        from .ops.dc_monitor import online_dc_enabled
        if online_dc_enabled():
            from .ops.dc_monitor import IncrementalDC
            dkey = (tenant.key, tenant.state.ino)
            inc = self._dc_inc.get(dkey)
            if inc is None:
                inc = self._dc_inc.setdefault(dkey, IncrementalDC())
            try:
                served = inc.advance(tenant.ops)
            except Exception:
                self._dc_inc.pop(dkey, None)
                raise
            if served:
                if inc.last_delta_ops:
                    d._count("delta_ops", inc.last_delta_ops)
                    telemetry.REGISTRY.counter(
                        "online.dc_delta_ops", tenant=tenant.name).inc(
                        inc.last_delta_ops)
                tenant.stats["dc_delta_checks"] = \
                    tenant.stats.get("dc_delta_checks", 0) + 1
                return {"valid": True}, "online-dc"
        if getattr(tenant, "_no_frontier", False) \
                or tenant.peak_w > DATA_MAX_SLOTS:
            return None
        key = (tenant.key, tenant.state.ino)
        frontiers = self.resident.frontiers
        fr = frontiers.get(key)
        if fr is None and tenant.frontier_ckpt is not None:
            # Restore ONCE and adopt immediately — even when the
            # re-tailing buffer hasn't caught up to the carry yet (the
            # guard below just skips those ticks); re-restoring every
            # lagging tick would re-pay the enumeration + bitset
            # decompression for nothing.
            fr = ResidentFrontier.restore(self.cfg.model,
                                          tenant.frontier_ckpt,
                                          device=self.device)
            tenant.frontier_ckpt = None
            if fr is not None:
                frontiers[key] = fr
                tenant.stats["frontier_restored"] = \
                    tenant.stats.get("frontier_restored", 0) + 1
        resumed = fr is not None
        if resumed and fr.pos > len(tenant.ops):
            # A deferred/rebuffering tenant hasn't re-tailed past the
            # carry's consumed prefix yet: not an invalidation, just
            # not servable incrementally this tick (a multi-GB WAL
            # re-tails over several polls; the adopted frontier waits).
            return None
        prov = "online-delta" if resumed else "online-rebuild"
        try:
            try:
                if fr is None:
                    fr = ResidentFrontier(self.cfg.model,
                                          device=self.device)
                valid, bad = fr.advance(tenant.ops)
            except FrontierInvalid:
                frontiers.pop(key, None)
                if not resumed:
                    # A FRESH build already failed (window beyond the
                    # device axis): rebuilding identically would fail
                    # identically — the full-prefix engine owns this
                    # tick, no second full-cost walk.
                    return None
                tenant._count_frontier(d, "frontier_invalidations")
                prov = "online-rebuild"
                try:
                    fr = ResidentFrontier(self.cfg.model,
                                          device=self.device)
                    valid, bad = fr.advance(tenant.ops)
                except FrontierInvalid:
                    return None
        except StateSpaceExplosion:
            tenant._no_frontier = True
            frontiers.pop(key, None)
            return None
        except Exception:
            frontiers.pop(key, None)
            if resumed:
                tenant._count_frontier(d, "frontier_invalidations")
            raise
        frontiers[key] = fr
        if resumed:
            tenant._count_frontier(d, "frontier_resumes")
        if fr.last_delta_ops:
            d._count("delta_ops", fr.last_delta_ops)
            telemetry.REGISTRY.counter(
                "online.delta_ops", tenant=tenant.name).inc(
                fr.last_delta_ops)
        tenant.stats["delta_checks"] = \
            tenant.stats.get("delta_checks", 0) + 1
        tenant.stats["delta_events_last"] = fr.last_events
        # Stalled-frontier visibility: a single never-completing
        # invocation pins the stable point, so the volatile tail — and
        # with it per-tick cost — grows with the prefix again (sound,
        # same cost class as the full path, but no longer O(new ops)).
        # Soundness forbids freezing past an open invocation; what we
        # CAN do is make the degradation loud instead of letting the
        # `inc` badge claim flat cost that isn't. A LATCHED-invalid
        # tenant is exempt: its ticks are O(1) served from the latch —
        # the un-advancing pos is the short-circuit, not a stall.
        tail = len(tenant.ops) - fr.pos
        tenant.stats["delta_tail_last"] = tail
        if fr.latched_bad is None and \
                tail > max(1024, 8 * self.cfg.check_interval_ops):
            if not tenant.stats.get("frontier_stalled"):
                log.warning(
                    "%s: open invocation at op %d pins the frontier's "
                    "stable point; the %d-op volatile tail re-checks "
                    "every tick (O(prefix) again) until it completes "
                    "or the run finalizes", tenant.key, fr.pos, tail)
            tenant.stats["frontier_stalled"] = \
                tenant.stats.get("frontier_stalled", 0) + 1
            telemetry.REGISTRY.counter(
                "online.frontier_stalls", tenant=tenant.name).inc()
        else:
            tenant.stats["frontier_stalled"] = 0
        # Checkpoint the carry whenever it advanced (or latched): a
        # restart replays only the undecided suffix, with zero
        # re-dispatched decided events.
        if tenant.journal is not None and \
                (fr.pos != tenant._frontier_ckpt_pos
                 or (not valid and not tenant._frontier_ckpt_bad)):
            try:
                tenant.journal.record_frontier(fr.export())
                tenant._frontier_ckpt_pos = fr.pos
                tenant._frontier_ckpt_bad = not valid
            except Exception:
                log.debug("frontier checkpoint failed", exc_info=True)
        if valid:
            return {"valid": True}, prov
        return {"valid": False, "op": {"index": bad}}, prov


# --------------------------------------------------------------- tenant

class OnlineTenant:
    """One tailed run: cursor + buffered prefix + decided-prefix
    journal + verdict-so-far."""

    def __init__(self, daemon: "OnlineDaemon", name: str, ts: str,
                 run_dir):
        self.daemon = daemon
        self.name, self.ts = name, ts
        self.key = f"{name}/{ts}"
        self.run_dir = Path(run_dir)
        self.wal_path = self.run_dir / WAL_FILE
        self.state = TailState()
        self.ops: List[Op] = []
        self.status = "tailing"         # tailing | deferred | done
        self.deferred_at: Optional[float] = None  # wall time (durable)
        self.result: Optional[dict] = None
        self.salvaged: Optional[bool] = None
        self.valid_so_far: Optional[bool] = None
        self.first_violation: Optional[dict] = None
        self.checked_ops = 0            # newest decided prefix length
        self.last_growth = time.monotonic()
        self.last_check_t = 0.0
        self.t_admitted = time.monotonic()
        self.t_first_verdict: Optional[float] = None
        self.rotations = 0
        self._widen_counted = False
        self.stats = {"checks": 0, "device_checks": 0, "host_checks": 0,
                      "resumed_prefixes": 0}
        self._open: set = set()
        self.peak_w = 0
        self.journal: Optional[ChunkJournal] = None
        self._decided: Dict[int, tuple] = {}
        # Incremental prefix checking: the journal's latest frontier-checkpoint row,
        # consumed once by the engine's first delta check; the
        # explosion latch (a vocabulary past the packed table never
        # shrinks); and the checkpoint watermark.
        self.frontier_ckpt: Optional[dict] = None
        self._no_frontier = False
        self._frontier_ckpt_pos = -1
        self._frontier_ckpt_bad = False
        # Live isolation monitoring: the txn-vocabulary latch, the lazy IncrementalIsolation monitor, its
        # fed-ops watermark, and the durable downgrade record.
        self.is_txn = False
        self._iso = None
        self._iso_cursor = 0
        self.iso_record: Optional[dict] = None
        # Restart rehydration, cheapest gate first: a durable final
        # verdict means ZERO work; a decided-prefix journal means zero
        # re-dispatch of decided prefixes; a deferred mark means the
        # overload pause survives the daemon. The verdict is bound to
        # its segment incarnation (inode): a WAL rotated/rewritten
        # AFTER finalization must be re-checked, not served a stale
        # verdict about content that no longer exists.
        v = daemon.store.online_verdict(name, ts)
        if v is not None and not self._verdict_stale(v):
            self.result = v.get("result")
            val = v.get("valid")
            # Tri-state, preserved: a finalized "unknown" must not
            # latch False across restarts (same data, same exit code).
            self.valid_so_far = (True if val is True
                                 else False if val is False else None)
            self.salvaged = v.get("salvaged")
            self.status = "done"
        elif (self.run_dir / ONLINE_DEFERRED).exists():
            self.status = "deferred"
            # The overload pause survives the daemon — and so must its
            # starvation deadline: the mark's own stamp, not this
            # incarnation's admit time, ages the deferral.
            try:
                self.deferred_at = float(json.loads(
                    (self.run_dir / ONLINE_DEFERRED).read_text()
                ).get("deferred_at") or time.time())
            except Exception:
                self.deferred_at = time.time()
        fv = daemon.store.first_violation(name, ts)
        if fv is not None:
            self.first_violation = fv
        iso = daemon.store.online_iso(name, ts)
        if iso is not None:
            self.iso_record = iso

    def corr_id(self) -> str:
        """This tenant's correlation id: run key + writer INCARNATION
        (the WAL segment's inode, the same identity the decided-prefix
        journal and verdict staleness checks key on), so every daemon
        that ever serves this tenant derives the same id."""
        if self.state.ino >= 0:
            return f"{self.key}#{self.state.ino}"
        return self.key

    def _verdict_stale(self, v: dict) -> bool:
        """A stored final verdict is stale when the WAL at this path
        is a different segment (inode) than the one it was computed
        over. Verdicts from before inode stamping (no ``ino`` key) and
        verdicts whose WAL has since vanished stay trusted — there is
        nothing newer to check."""
        ino = v.get("ino")
        if ino is None:
            return False
        try:
            return os.stat(self.wal_path).st_ino != ino
        except OSError:
            return False

    # ------------------------------------------------------------ state
    @property
    def pending(self) -> int:
        """Buffered ops not yet covered by a decided prefix — the unit
        every ladder threshold is expressed in."""
        return max(0, len(self.ops) - self.checked_ops)

    def _alive(self) -> bool:
        """Writer liveness for finalization. A WAL written by THIS
        process (in-process campaign + daemon) is live by definition —
        writer_alive() excludes our own pid for the salvage sweep's
        sake, the opposite of what a tailer wants."""
        h = self.state.header
        if (h or {}).get("pid") == os.getpid():
            return True
        return writer_alive(h)

    def _open_journal(self) -> None:
        """Create the decided-prefix journal once the header is known:
        the key binds it to this SEGMENT incarnation — writer pid +
        seed from the header plus the segment's inode — so a WAL
        rotated while the daemon was down (or truncated-and-rewritten
        by the same writer) auto-invalidates the old journal
        (ChunkJournal discards on key mismatch) instead of poisoning
        the new content with stale prefix verdicts, while a plain
        daemon restart over the unrotated segment keys identically and
        resumes every decided prefix."""
        h = self.state.header or {}
        self.journal = ChunkJournal(
            self.run_dir / ONLINE_JOURNAL,
            {"online": 1, "model": repr(self.daemon.cfg.model),
             "run": self.key, "wal": {"pid": h.get("pid"),
                                      "seed": h.get("seed")},
             "ino": self.state.ino},
            resume=True)
        self._decided = self.journal.decided()
        self.frontier_ckpt = self.journal.frontier()
        if self._decided:
            self.stats["resumed_prefixes"] = len(self._decided)
            self.daemon._count("resumed_prefixes",
                               len(self._decided))
            k = max(self._decided)
            valid, bad, _prov = self._decided[k]
            self.checked_ops = k
            self.valid_so_far = bool(valid)

    def _track_w(self, op: Op) -> None:
        # :info completions do NOT close the slot — the op pends
        # forever, which is exactly what the encoder's window must
        # hold; the admission estimate has to agree with it.
        if op.f == "txn":
            self.is_txn = True
        if op.type == INVOKE:
            self._open.add(op.process)
            if len(self._open) > self.peak_w:
                self.peak_w = len(self._open)
        elif op.type in (OK, FAIL):
            self._open.discard(op.process)

    def _count_frontier(self, d, key: str) -> None:
        """One frontier lifecycle event: daemon stats + the per-tenant
        labeled registry counter."""
        d._count(key)
        telemetry.REGISTRY.counter(f"online.{key}",
                                   tenant=self.name).inc()

    def _drop_frontier(self, *, invalidated: bool) -> None:
        """Void every carried frontier for this tenant (any
        incarnation) — rotation and finalization both end the carry's
        life; rotation counts as an invalidation."""
        frontiers = self.daemon.engine.resident.frontiers
        mine = [k for k in frontiers if k[0] == self.key]
        for k in mine:
            del frontiers[k]
        if invalidated and mine:
            self._count_frontier(self.daemon, "frontier_invalidations")
        self.frontier_ckpt = None
        self._frontier_ckpt_pos = -1
        self._frontier_ckpt_bad = False

    def _reset_segment(self) -> None:
        """The path names different content now (rotation): everything
        derived from the old segment is void — including the durable
        first-violation record, which described ops that no longer
        exist (and would otherwise both badge the clean new segment
        invalid and block the NEW segment's first violation from ever
        persisting)."""
        self.ops = []
        self.checked_ops = 0
        self.valid_so_far = None
        self._open = set()
        self.peak_w = 0
        self._decided = {}
        self._drop_frontier(invalidated=True)
        if self.journal is not None:
            self.journal.finish()       # old-content rows: delete
            self.journal = None
        if self.first_violation is not None:
            self.first_violation = None
            fv = self.run_dir / FIRST_VIOLATION
            if fv.exists():
                fv.unlink()
        self._iso = None
        self._iso_cursor = 0
        if self.iso_record is not None:
            self.iso_record = None
            rec = self.run_dir / ONLINE_ISO
            if rec.exists():
                rec.unlink()

    # ------------------------------------------------------------- tail
    def tail(self) -> bool:
        """One poll: consume whatever whole lines the writer has made
        durable. Returns True when the prefix grew. The ingest buffer
        is bounded: past ``max_buffered_ops`` undecided ops the tail
        stops reading ahead of the checker (counted backpressure) —
        the WAL itself is the overflow queue."""
        d = self.daemon
        if self.pending >= d.cfg.max_buffered_ops:
            d._count("backpressure")
            return False
        self.state, out = tail_wal(self.wal_path, self.state)
        if out["rotated"]:
            # Reset BEFORE the bad-magic drop: a WAL replaced by a
            # non-WAL file reports both in one call, and the old
            # segment's artifacts (decided prefixes, the durable
            # first-violation record) describe content that no longer
            # exists either way.
            self.rotations += 1
            d._count("rotations")
            log.warning("%s rotated under the cursor; restarting the "
                        "tail from offset 0", self.wal_path)
            self._reset_segment()
        if out["bad_magic"]:
            log.warning("%s: not a history WAL; dropping tenant",
                        self.wal_path)
            self.status = "done"
            return False
        if out["missing"]:
            return False
        if self.journal is None and self.state.header is not None \
                and self.status == "tailing":
            self._open_journal()
        if out["grew"]:
            for op in out["ops"]:
                self._track_w(op)
            self.ops.extend(out["ops"])
            self.last_growth = time.monotonic()
            if out["ops"]:
                # The daemon's ingest meter.
                d._count("ingested_ops", len(out["ops"]))
            self._iso_tick()
        return bool(out["grew"])

    def _iso_tick(self) -> None:
        """Feed newly tailed ops to the live isolation monitor
        (isolation.IncrementalIsolation) and durably persist level
        DOWNGRADES as ``online-iso.json`` — the first-violation
        pattern, keyed to the segment incarnation. Only txn-vocabulary
        tenants ever allocate a monitor; $JT_ONLINE_ISO=0 disables the
        whole tick. The monitor is advisory observability — a failure
        here must never cost the tenant its verdict."""
        d = self.daemon
        if not d.cfg.iso or not self.is_txn \
                or self._iso_cursor >= len(self.ops):
            return
        try:
            from .isolation import IncrementalIsolation
            from .ops.txn_graph import LADDER, iso_abbrev
            if self._iso is None:
                self._iso = IncrementalIsolation()
            new = self.ops[self._iso_cursor:]
            self._iso_cursor = len(self.ops)
            level = self._iso.observe(new)
        except Exception:
            log.warning("isolation monitor tick of %s failed",
                        self.key, exc_info=True)
            return
        if level is None or level == "serializability":
            return
        prev = (self.iso_record or {}).get("level")
        if prev in LADDER and LADDER.index(level) >= LADDER.index(prev):
            return
        rec = {"run": self.key, "level": level,
               "abbrev": iso_abbrev(level),
               "prefix_ops": len(self.ops), "ino": self.state.ino,
               "detected_at": time.time()}
        atomic_write_json(self.run_dir / ONLINE_ISO, rec)
        self.iso_record = rec
        d._count("iso_downgrades")
        log.warning("ISOLATION DOWNGRADE in %s: %s (caught at a "
                    "%d-op prefix)", self.key, level, len(self.ops))

    # ----------------------------------------------------------- checks
    def _note_verdict(self, verdict, bad: Optional[int],
                      prefix_ops: int, prov: str) -> None:
        """Fold one check's verdict into the tenant's running state.
        Only an EXPLICIT True/False is a verdict: a host-engine
        ``"unknown"`` (config budget exhausted) carries no information
        — it must neither latch ``valid_so_far`` false, nor persist a
        first-violation record, nor count as the first verdict (a
        post-mortem recheck of the same run would say unknown, not
        invalid)."""
        d = self.daemon
        if verdict not in (True, False):
            d._count("unknown_verdicts")
            return
        if verdict is False:
            self.valid_so_far = False
        elif self.valid_so_far is None:
            self.valid_so_far = True
        if self.t_first_verdict is None:
            self.t_first_verdict = time.monotonic()
            ttfv = self.t_first_verdict - self.t_admitted
            telemetry.REGISTRY.histogram("online.ttfv_s").observe(ttfv)
            telemetry.REGISTRY.histogram(
                "online.ttfv_s", tenant=self.name).observe(ttfv)
        if verdict is False and self.first_violation is None:
            fv = {"run": self.key, "op_index": bad,
                  "prefix_ops": prefix_ops, "mode": prov,
                  "ino": self.state.ino, "detected_at": time.time()}
            atomic_write_json(self.run_dir / FIRST_VIOLATION, fv)
            self.first_violation = fv
            d._count("first_violations")
            log.warning("FIRST VIOLATION in %s: op %s (caught at a "
                        "%d-op prefix, %s)", self.key, bad, prefix_ops,
                        prov)

    def interim_check(self, shed: bool) -> None:
        """Dispatch one rolling prefix check. Journal-gated: a prefix
        length decided by an earlier daemon incarnation is never
        re-dispatched (ChunkJournal.record enforces it structurally)."""
        d = self.daemon
        k = len(self.ops)
        if k < d.cfg.min_check_ops or k == self.checked_ops \
                or k in self._decided:
            return
        with telemetry.correlation_scope(self.corr_id()), \
                telemetry.span("online.check", tenant=self.key,
                               ops=k, shed=bool(shed)):
            d._fire("encode")
            r = prov = None
            if d.cfg.incremental and not shed:
                # The O(new ops) path: resume the resident device
                # frontier over the delta. The dispatch-stage fault
                # fires BEFORE the carry is touched, so an injected
                # fault costs a retried tick, never a poisoned carry.
                d._fire("dispatch")
                out = d.engine.check_delta(self)
                if out is not None:
                    r, prov = out
            if r is None:
                history = checkable_prefix(self.ops)
                if not (d.cfg.incremental and not shed):
                    d._fire("dispatch")
                r, prov = d.engine.check(history, shed=shed)
            verdict = r.get("valid")
            bad = _bad_index(r)
            if verdict in (True, False):
                # Only explicit verdicts are DECIDED: an "unknown" is
                # neither journaled (a restart should re-try it) nor
                # latched — but checked_ops still advances, so this
                # incarnation doesn't hot-loop the same undecidable
                # prefix every poll.
                if self.journal is not None:
                    self.journal.record([k], [verdict], [bad], [prov])
                self._decided[k] = (bool(verdict), bad, prov)
            self.checked_ops = k
            self._widen_counted = False
            self.stats["checks"] += 1
            self.stats["host_checks" if prov == "online-host"
                       else "device_checks"] += 1
            self.last_check_t = time.monotonic()
            d._count("checks")
            d._count("host_checks" if prov == "online-host"
                     else "device_checks")
            self._note_verdict(verdict, bad, k, prov)

    # --------------------------------------------------------- finalize
    def should_finalize(self) -> bool:
        if self.status != "tailing":
            return False
        if self.state.header is None:
            # No durable header: the writer fsyncs it at WAL creation,
            # so a headerless file past the quiescence window was
            # killed inside that first fsync (or isn't growing a
            # header ever). There is nothing salvageable — the
            # post-mortem sweep refuses the same WAL — but the tenant
            # must still RETIRE (durable unknown verdict), or
            # ``run(until_idle=True)`` polls a dead run forever.
            return (time.monotonic() - self.last_growth) \
                >= self.daemon.cfg.crash_quiet_s
        if self.state.phase == "analyzed":
            return True
        return (not self._alive()
                and (time.monotonic() - self.last_growth)
                >= self.daemon.cfg.crash_quiet_s)

    def _drain_tail(self) -> None:
        """Consume the WAL to its durable end before finalizing. The
        ingest bound (``max_buffered_ops``) can legitimately leave
        unread bytes behind a backlogged checker; the FINAL verdict
        must cover the whole segment regardless — a post-mortem
        recheck would — so the drain bypasses the buffer bound (memory
        here is bounded by the WAL itself, exactly like salvage's full
        read). Bounded iterations: each call consumes up to the tail
        read budget, and a segment that keeps growing mid-drain is a
        live writer, which should_finalize already excluded."""
        for _ in range(4096):
            self.state, out = tail_wal(self.wal_path, self.state)
            if out["rotated"]:
                self.rotations += 1
                self.daemon._count("rotations")
                self._reset_segment()
            if not out["grew"]:
                return
            for op in out["ops"]:
                self._track_w(op)
            self.ops.extend(out["ops"])

    def _final_history(self) -> Tuple[List[Op], bool]:
        """The exact history a post-mortem recheck would see. Complete
        runs prefer the stored history.jsonl (byte-equal to the WAL —
        test_durability pins it — and what Store.recheck reads);
        crashed runs apply salvage_history, the same transform
        Store.salvage materializes."""
        if self.state.phase == "analyzed":
            hist = self.run_dir / "history.jsonl"
            if hist.exists():
                from .history.codec import read_jsonl
                try:
                    return read_jsonl(hist), False
                except Exception:
                    pass
            return index([op.with_() for op in self.ops]), False
        history, _dangling = salvage_history(self.ops)
        return history, True

    def finalize(self) -> None:
        """The run is over (analyzed, or the writer died): produce the
        durable final verdict through the parity-exact engine call,
        then retire the prefix journal — online-verdict.json gates any
        later restart."""
        d = self.daemon
        d._fire("encode")
        self._drain_tail()
        # The monitor's last word covers the whole drained segment, so
        # its final verdict and the post-mortem certification describe
        # the same ops.
        self._iso_tick()
        with telemetry.correlation_scope(self.corr_id()), \
                telemetry.span("online.finalize", tenant=self.key,
                               ops=len(self.ops)):
            self._finalize_inner(d)

    def _finalize_inner(self, d) -> None:
        if self.state.header is None:
            # Killed before the header fsync: nothing salvageable
            # (Store.salvage raises "empty WAL" on the same file).
            # Retire with a durable UNKNOWN — never a claimed pass.
            self.result = {"valid": "unknown",
                           "error": "no durable WAL header"}
            self.salvaged = True
            atomic_write_json(self.run_dir / ONLINE_VERDICT, {
                "run": self.key, "valid": "unknown", "bad_index": None,
                "ops": 0, "ino": self.state.ino, "salvaged": True,
                "unrecoverable": "no durable WAL header",
                "model": repr(d.cfg.model),
                "checks": self.stats["checks"], "first_violation": None,
                "ttfv_s": None, "finalized_at": time.time(),
                "result": self.result})
            self.status = "done"
            d._count("finalized")
            log.warning("finalized %s as UNKNOWN: no durable WAL "
                        "header (killed inside the first fsync?)",
                        self.key)
            return
        history, salvaged = self._final_history()
        d._fire("dispatch")
        r, prov = d.engine.check(history, final=True)
        bad = _bad_index(r)
        self.result = r
        self.salvaged = salvaged
        self.stats["checks"] += 1
        self.stats["device_checks"] += 1
        d._count("checks")
        d._count("device_checks")
        self._note_verdict(r.get("valid"), bad, len(history), prov)
        verdict = {
            "run": self.key, "valid": r.get("valid"),
            "bad_index": bad, "ops": len(history),
            "ino": self.state.ino,
            "salvaged": salvaged, "model": repr(d.cfg.model),
            "checks": self.stats["checks"],
            "first_violation": self.first_violation,
            "ttfv_s": (round(self.t_first_verdict - self.t_admitted, 4)
                       if self.t_first_verdict is not None else None),
            "finalized_at": time.time(),
            "result": r,
        }
        # Exotic values (Op objects from the host engine) degrade to
        # repr for the FILE; the in-memory result keeps full fidelity.
        verdict = json.loads(json.dumps(verdict, default=repr))
        atomic_write_json(self.run_dir / ONLINE_VERDICT, verdict)
        if self.journal is not None:
            self.journal.finish()
            self.journal = None
        self._drop_frontier(invalidated=False)
        mark = self.run_dir / ONLINE_DEFERRED
        if mark.exists():
            mark.unlink()
        self.status = "done"
        d._count("finalized")
        log.info("finalized %s: valid=%s bad=%s (%s, %d ops, %d checks)",
                 self.key, r.get("valid"), bad,
                 "salvaged" if salvaged else "complete", len(history),
                 self.stats["checks"])

    # ------------------------------------------------------------ defer
    def defer(self) -> None:
        """Overload L3: pause this tenant durably, release its buffer
        (the WAL itself is the queue; the journal keeps its decided
        prefixes, so resuming re-dispatches none of them)."""
        self.deferred_at = time.time()
        atomic_write_json(self.run_dir / ONLINE_DEFERRED,
                          {"run": self.key,
                           "deferred_at": self.deferred_at,
                           "pending": self.pending})
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        self.ops = []
        self.state = TailState()
        self._open = set()
        self.peak_w = 0
        # The monitor re-feeds from op 0 when the tail re-buffers; the
        # durable downgrade record (online-iso.json) carries the floor
        # across the pause.
        self._iso = None
        self._iso_cursor = 0
        self.status = "deferred"

    def resume(self) -> None:
        mark = self.run_dir / ONLINE_DEFERRED
        if mark.exists():
            mark.unlink()
        self.status = "tailing"
        self.deferred_at = None
        self.last_growth = time.monotonic()

    def close(self) -> None:
        # The carried frontier goes with the tenant: the journal
        # checkpoint is the durable copy the next owner resumes from.
        self._drop_frontier(invalidated=False)
        if self.journal is not None:
            self.journal.close()
            self.journal = None

    def summary(self) -> dict:
        return {"status": self.status, "phase": self.state.phase,
                "ops": len(self.ops), "checked_ops": self.checked_ops,
                "pending": self.pending, "peak_w": self.peak_w,
                "valid_so_far": self.valid_so_far,
                "first_violation": (self.first_violation or {}).get(
                    "op_index"),
                "salvaged": self.salvaged,
                "checks": self.stats["checks"],
                "host_checks": self.stats["host_checks"],
                "resumed_prefixes": self.stats["resumed_prefixes"],
                "incremental": bool(
                    (self.key, self.state.ino)
                    in self.daemon.engine.resident.frontiers),
                "delta_checks": self.stats.get("delta_checks", 0),
                "rotations": self.rotations,
                # Live isolation verdict (txn tenants): the monitor's
                # current abbreviated level, else the durable downgrade
                # record's — None for non-transactional tenants.
                "iso": (self._iso.abbrev() if self._iso is not None
                        else (self.iso_record or {}).get("abbrev")),
                # Wire-fed tenant (its header says a network ingest
                # wrote it): display-only, every checking path treats
                # both alike.
                "wire": (self.state.header or {}).get("ingest")
                == "wire"}


# --------------------------------------------------------------- daemon

class OnlineDaemon:
    """The multi-tenant online checking service. ``tick()`` is one
    poll pass (tests drive it directly); ``run()`` is the jittered
    serving loop.

    The reference's daemon also appends periodic registry frames to a
    durable metrics series and evaluates SLO alerts each tick
    (``series.SeriesWriter``, ``alerts.AlertEvaluator``); this one
    builds neither: the registry and the persisted tenant registry are
    its only reports."""

    def __init__(self, store: Optional[Store] = None,
                 config: Optional[OnlineConfig] = None,
                 faults: Optional[DaemonFaultInjector] = None):
        self.store = store if store is not None else DEFAULT
        self.cfg = config if config is not None else OnlineConfig()
        self.engine = OnlineCheckEngine(self.cfg)
        self.faults = faults if faults is not None \
            else DaemonFaultInjector.from_env()
        self.tenants: Dict[Tuple[str, str], OnlineTenant] = {}
        self._refused: set = set()
        self.stats = {"ticks": 0, "admitted": 0, "refused": 0,
                      "checks": 0, "device_checks": 0, "host_checks": 0,
                      "shed": 0, "shed_wclass": 0, "widened": 0,
                      "deferred": 0, "resumed": 0, "rate_deferred": 0,
                      "backpressure": 0, "rotations": 0,
                      "stage_faults": 0, "check_errors": 0,
                      "unknown_verdicts": 0, "first_violations": 0,
                      "finalized": 0, "resumed_prefixes": 0,
                      "ingested_ops": 0, "iso_downgrades": 0,
                      "delta_ops": 0, "frontier_resumes": 0,
                      "frontier_invalidations": 0,
                      "deferred_starvation_rescues": 0}
        self._t0 = time.monotonic()

    # ---------------------------------------------------------- helpers
    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n
        telemetry.REGISTRY.counter(f"online.{key}").inc(n)

    def _fire(self, stage: str) -> None:
        if self.faults is not None:
            self.faults.fire(stage)

    def _active(self) -> List[OnlineTenant]:
        return [t for t in self.tenants.values()
                if t.status == "tailing"]

    # -------------------------------------------------------- admission
    def discover(self) -> None:
        """Admit every incomplete run in the store (live WAL, no
        results.json) up to the tenant bound. Finalized-by-us runs
        rehydrate as ``done`` from their verdict file — free."""
        for name, ts in self.store.incomplete(include_salvaged=True):
            key = (name, ts)
            if key in self.tenants:
                continue
            active = sum(1 for t in self.tenants.values()
                         if t.status != "done")
            if active >= self.cfg.max_tenants:
                # One refusal EVENT per run, not one per poll — the
                # counter is an SLO transition signal, and a steady
                # over-capacity store must not grow it at tick rate.
                if key not in self._refused:
                    self._refused.add(key)
                    self._count("refused")
                continue
            self._refused.discard(key)
            t = OnlineTenant(self, name, ts,
                             self.store.run_dir(name, ts))
            self.tenants[key] = t
            if t.status != "done":
                self._count("admitted")

    def overload_level(self) -> int:
        """0..3 by total undecided backlog — the ladder's input."""
        cfg = self.cfg
        pending = sum(t.pending for t in self._active())
        telemetry.REGISTRY.gauge("online.pending_ops").set(pending)
        telemetry.REGISTRY.gauge("online.tenants").set(
            len(self._active()))
        if pending >= cfg.defer_pending_ops:
            return 3
        if pending >= cfg.shed_pending_ops:
            return 2
        if pending >= cfg.overload_pending_ops:
            return 1
        return 0

    # ------------------------------------------------------------- tick
    def _service_check(self, t: OnlineTenant, level: int) -> None:
        cfg = self.cfg
        if t.status != "tailing":
            return
        if t.should_finalize():
            try:
                t.finalize()
            except DaemonFault:
                # Retried next tick; finalize is idempotent (the
                # verdict file lands atomically at the very end).
                self._count("stage_faults")
            except Exception:
                # A real engine failure must not kill the SERVICE —
                # the other tenants keep their verdicts; this one
                # retries at poll cadence, loudly.
                self._count("check_errors")
                log.warning("finalize of %s failed; retrying next "
                            "tick", t.key, exc_info=True)
            return
        interval = max(cfg.min_check_ops, cfg.check_interval_ops)
        widened = interval * cfg.widen_factor
        if t.pending < interval:
            t._widen_counted = False
        if level >= 1 and interval <= t.pending < widened:
            # This check would have run at the base cadence; widening
            # deferred it — the L1 ladder rung, counted once per
            # deferred check (not once per idle poll re-visiting the
            # same backlog).
            if not t._widen_counted:
                t._widen_counted = True
                self._count("widened")
            return
        if t.pending < (widened if level >= 1 else interval):
            return
        if cfg.rate_checks_per_s > 0 and \
                (time.monotonic() - t.last_check_t) \
                < 1.0 / cfg.rate_checks_per_s:
            self._count("rate_deferred")
            return
        shed = level >= 2
        if t.peak_w > cfg.max_w:
            # W-class admission: an over-wide prefix is exponential
            # device cost — it rides the host oracle instead.
            shed = True
            self._count("shed_wclass")
        if shed:
            self._count("shed")
        try:
            t.interim_check(shed)
        except DaemonFault:
            self._count("stage_faults")
        except Exception:
            self._count("check_errors")
            log.warning("interim check of %s failed; retrying next "
                        "tick", t.key, exc_info=True)

    def tick(self) -> int:
        """One poll pass: ingest (tail) every active tenant FIRST, so
        the overload level sees the true backlog, then walk the ladder
        and service checks/finalizations fresh-prefix-first. Returns
        the overload level the check phase ran at."""
        self.stats["ticks"] += 1
        telemetry.REGISTRY.counter("online.ticks").inc()
        self.discover()
        for t in self._active():
            try:
                self._fire("tail")
                t.tail()
            except DaemonFault:
                self._count("stage_faults")
        level = self.overload_level()
        active = self._active()
        if level >= 3 and len(active) > 1:
            # L3: pause the STALEST tenant (durably) — the freshest
            # prefixes keep their time-to-first-verdict.
            stalest = min(active, key=lambda t: t.last_growth)
            log.warning("overload: deferring tenant %s (%d ops "
                        "pending)", stalest.key, stalest.pending)
            stalest.defer()
            self._count("deferred")
        elif level <= 1:
            deferred = [t for t in self.tenants.values()
                        if t.status == "deferred"]
            if deferred:
                t = min(deferred, key=lambda t: t.t_admitted)
                t.resume()
                self._count("resumed")
        if level >= 2 and self.cfg.defer_max_s > 0:
            # Deferred-starvation deadline: "resumes as load drops" is
            # not a liveness guarantee under a PERSISTENTLY busy
            # daemon. Past defer_max_s the stalest deferred tenant is
            # force-admitted ahead of fresh prefixes, load or no load.
            now = time.time()
            overdue = [t for t in self.tenants.values()
                       if t.status == "deferred"
                       and t.deferred_at is not None
                       and now - t.deferred_at
                       >= self.cfg.defer_max_s]
            if overdue:
                t = min(overdue, key=lambda t: t.deferred_at)
                log.warning(
                    "deferred tenant %s blew its %.0fs re-admission "
                    "deadline under sustained load; force-admitting "
                    "it ahead of fresh prefixes", t.key,
                    self.cfg.defer_max_s)
                t.resume()
                self._count("resumed")
                self._count("deferred_starvation_rescues")
        # Fresh-prefix-first: the most recently grown tenants are
        # serviced first, so a hot run's verdict lag stays at one
        # interval even when a cold backlog exists.
        for t in sorted(self._active(), key=lambda t: -t.last_growth):
            self._service_check(t, level)
        self._persist_registry()
        return level

    def _persist_registry(self) -> None:
        try:
            self.store.save_online_registry({
                "updated_at": time.time(), "pid": os.getpid(),
                "stats": dict(self.stats),
                "tenants": {t.key: t.summary()
                            for t in self.tenants.values()}})
        except Exception:
            log.debug("online registry persist failed", exc_info=True)

    # ------------------------------------------------------------- loop
    def idle(self) -> bool:
        return all(t.status == "done" for t in self.tenants.values())

    def run(self, *, stop=None, ticks: Optional[int] = None,
            until_idle: bool = False) -> dict:
        """The serving loop: tick, then sleep a jittered poll interval
        (early-woken by ``stop``). Bounded by ``ticks`` when given;
        ``until_idle`` exits once every tenant is finalized."""
        n = 0
        while True:
            self.tick()
            n += 1
            if ticks is not None and n >= ticks:
                break
            if until_idle and self.idle():
                break
            if stop is not None and stop.is_set():
                break
            delay = self.cfg.poll_s * (
                1.0 + self.cfg.jitter * random.random())
            if stop is not None:
                if stop.wait(delay):
                    break
            else:
                time.sleep(delay)
        return self.status()

    def status(self) -> dict:
        return {"wall_s": round(time.monotonic() - self._t0, 3),
                "stats": dict(self.stats),
                "tenants": {t.key: t.summary()
                            for t in self.tenants.values()},
                "slo": telemetry.metrics_prefixed("online."),
                "valid": all(t.valid_so_far is not False
                             for t in self.tenants.values())}

    def close(self) -> None:
        """Daemon shutdown: close (never delete) every open journal —
        decided prefixes are the next incarnation's resume point — and
        leave the registry current."""
        for t in self.tenants.values():
            t.close()
        self._persist_registry()


def watch_store(store: Optional[Store] = None, *, model=None,
                stop=None, ticks: Optional[int] = None,
                until_idle: bool = False, **cfg_kw) -> dict:
    """One-call service entry: build a daemon over ``store`` and serve.
    Returns the final status dict."""
    cfg = OnlineConfig(model=model, **cfg_kw)
    daemon = OnlineDaemon(store=store, config=cfg)
    try:
        return daemon.run(stop=stop, ticks=ticks, until_idle=until_idle)
    finally:
        daemon.close()
