"""Streaming bucket scheduler: encode → dispatch → decode as a pipeline.

The exact-W bucket flow (ops.encode.bucket_encode → ops.linearize.
run_buckets) launches one kernel per distinct pending-window width,
encodes the whole batch before the first byte moves to the card, and has
no verdict until the last bucket lands. This module is the layer the
entry points stream through by default (``scheduler=True``), a copy of
the reference's ``ops/schedule.py`` trimmed to its happy path:

  * **W-class consolidation** — exact windows fold into a small set of W
    *classes* chosen by a dynamic program over the cost basis ``rows x
    events x 2^W`` plus a measured per-launch overhead
    (choose_w_classes): the partition of the observed W range into <=
    max_classes contiguous groups that minimizes total padded frontier
    work. Checking a history under a wider class is semantics-preserving
    (ops.encode.widen_batch). Windows past DATA_MAX_SLOTS keep exact
    classes and ride the wide route.

  * **chunked pipeline** — each class bucket splits into row chunks; at
    most ``depth`` dispatch groups are in flight, so the host encodes and
    pads chunk k+1 and decodes chunk k-1 while the card runs chunk k
    (launches are asynchronous; the copy back is the only block point).

  * **fused multi-bucket dispatch** — while the pipeline is full, chunks
    of different classes accumulate and ship as ONE launch of up to
    ``fuse_width`` members (linearize.get_fused_kernel, the CUDA group
    entry ``wgl_frontier_group``), so many small buckets stop paying one
    launch each.

  * **the peel pre-filter** (``wgl_backend``) — before a chunk's
    frontier launch, the decrease-and-conquer peel loop (ops.dc_monitor,
    kernel K4) may certify its register-class rows valid; a chunk whose
    every row it certifies skips its frontier launch, and the residue
    rides the unchanged search in the same ``_ship``. ``"dc"`` pins the
    pre-filter on, ``"auto"`` engages it per bucket shape when the cost
    router prices it under the frontier search, and ``"xla"`` or
    ``"pallas"`` (the reference's two TPU forms of the search, one CUDA
    kernel here) run the search alone.

  * **the mesh routes** — a bucket past DATA_MAX_SLOTS, or one of at
    least ``shard_min_rows`` rows (default: the production mesh's data
    devices x $JT_SHARD_MIN_ROWS, parallel.mesh.should_shard) when the
    production devices form a mesh, drains the pipeline and runs
    blocking through ``run_encoded_batch``: the frontier-sharded,
    batch-sharded or one-card wide route (ops.linearize._route). With
    nothing provisioned (jepsen_torch.provision) a one-card host has no
    mesh, and every narrow bucket stays on the pipeline.

Contract for callers: ``run(source)`` yields ``(batch, out)`` pairs
where ``batch`` is a *consolidated* EncodedBatch (NOT an element of the
input list) and ``out`` is (valid, bad, frontier), a WindowOverflow, or
the DIVERTED sentinel for a small wide bucket the caller asked to keep
off the card (``min_device_rows``: the caller's C++ tail engine).
Callers scatter through ``batch.indices`` / ``batch.ev_opidx``. The
source is a Sequence[EncodedBatch] or an iterator of bucket *groups*
(iter_columnar_groups, iter_synth_groups): classes freeze on the first
non-empty group. ``on_chunk(batch, lo, hi, valid, bad, front)`` fires
per decoded chunk.

What the reference's scheduler has and this one does not, by decision:
the persistent XLA compilation cache, AOT executable shipping and
kernel pre-warm (the port has no compile step: each CUDA library builds
once, at first use, into ``build/jepsen_torch/``); the Pallas-versus-
scan backend choice (one CUDA kernel serves both TPU forms); and donated
buffers, which have no
meaning for torch tensors.

The degradation ladder is the reference's. Every chunk is copied back
on a daemon retire thread (on the stream it was launched on) under a
watchdog deadline priced by the op model; the checker nemesis
(ops.faults) fires at the encode, dispatch and decode boundaries of the
one dispatch sequence (``_ship``) that the pipeline and every retry
run. A chunk that fails walks retry with backoff → row bisection on an
out-of-memory (the learned size sticks, ``ResidentState`` carries it
across batches) → the event-chunked kernel → the poison-row hunt, whose
rows are quarantined for the caller's host engine. What a real wedge
does on CUDA: the kernel cannot be cancelled, the abandoned thread's
copy waits for it, and the retry queues behind it on the same stream;
that is the reference's threat model too (its DaemonFuture).

``GraphScheduler``, at the end, is the reference's dependency-graph
scheduler (vertex-bucket chunks for the closure kernel) with the same
ladder. Both schedulers read the reference's environment knobs
(``KNOBS``) when they are made.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from .cuda_wgl import MAX_GROUP_MEMBERS, n_state_words, smem_plan
from .device import resolve_device
from .encode import EMPTY, EV_CLOSE, EV_OK, EncodedBatch, merge_batches
from .faults import (INT32_MAX, CorruptOutput, FaultInjector,
                     WatchdogExpired, classify_failure, corrupt_arrays,
                     validate_decoded)
from .graph import (N_LEVELS, close_planes, mxu_op_model,
                    validate_graph_decoded)
from .linearize import (DATA_MAX_SLOTS, DISPATCH_LOG, MAX_FRONTIER_ELEMENTS,
                        MIN_ROWS_PER_DEVICE, WindowOverflow, _on,
                        get_fused_kernel, get_kernel, production_mesh,
                        run_encoded_batch, run_event_chunked, vpu_op_model)

log = logging.getLogger("jepsen.schedule")

# The schedulers' environment knobs, with the reference's names and
# defaults: {knob: (variable, default, least value)}.
#   chunk_rows          rows per device dispatch (before the per-class
#                       memory cap shrinks it);
#   max_classes         consolidation budget for the W <= DATA_MAX_SLOTS
#                       side;
#   fuse_width          class chunks one group launch takes (1 = one
#                       launch per chunk), capped at MAX_GROUP_MEMBERS;
#   max_queue           encoded chunks buffered at the encode-to-launch
#                       hand-off while the pipeline is full before a
#                       forced flush, counted in ``backpressure_events``
#                       (0 = no bound);
#   event_route_events  event-axis length at which a narrow bucket takes
#                       the long-history route (the carried-frontier
#                       resume kernel, run_event_chunked) instead of one
#                       long launch (0 = never);
#   event_chunk         event-axis chunk of that route;
#   graph_chunk_rows    rows per graph-closure dispatch (GraphScheduler);
# and the degradation ladder's (ops.faults documents the fault model):
#   retry_max           retries of a failing dispatch past the first try;
#   retry_backoff_s     backoff base between retries (doubles each time);
#   watchdog_min_s      the floor of a chunk's decode deadline;
#   watchdog_lane_ops_per_s, watchdog_mxu_macs_per_s
#                       the pessimistic sustained rates that price a WGL
#                       or graph chunk's deadline from its op model;
#   watchdog_factor     the safety factor over that estimate;
#   watchdog_compile_grace_s
#                       the extra allowance of a shape's first wait (its
#                       first launch builds the CUDA library);
#   bisect_floor_rows   below this many rows per dispatch an OOM stops
#                       halving and takes the event-chunked kernel;
#   shard_min_rows      rows per data device below which a bucket stays
#                       off the batch-sharded route (dataN), read by
#                       parallel.mesh.shard_min_rows.
# The reference also reads JT_COMPILE_CACHE=0 as fuse width 1, since a
# fused XLA program is a compile it would otherwise pay per process; the
# port compiles nothing per shape, so that variable means nothing here.
KNOBS = {
    "chunk_rows": ("JT_SCHED_CHUNK_ROWS", 1024, 1),
    "max_classes": ("JT_SCHED_CLASSES", 5, 1),
    "fuse_width": ("JT_SCHED_FUSE_WIDTH", 4, 1),
    "max_queue": ("JT_SCHED_MAX_QUEUE", 0, 0),
    "event_route_events": ("JT_EVENT_ROUTE_EVENTS", 8192, 0),
    "event_chunk": ("JT_EVENT_CHUNK", 2048, 1),
    "graph_chunk_rows": ("JT_GRAPH_CHUNK_ROWS", 2048, 1),
    "retry_max": ("JT_RETRY_MAX", 3, 0),
    "retry_backoff_s": ("JT_RETRY_BACKOFF_S", 0.25, 0.0),
    "watchdog_min_s": ("JT_WATCHDOG_MIN_S", 120.0, 0.0),
    "watchdog_lane_ops_per_s": ("JT_WATCHDOG_LANE_OPS_PER_S", 1e8, 1.0),
    "watchdog_mxu_macs_per_s": ("JT_WATCHDOG_MXU_MACS_PER_S", 1e11, 1.0),
    "watchdog_factor": ("JT_WATCHDOG_FACTOR", 32.0, 0.0),
    "watchdog_compile_grace_s": ("JT_WATCHDOG_COMPILE_GRACE_S", 900.0, 0.0),
    "bisect_floor_rows": ("JT_BISECT_FLOOR_ROWS", 16, 1),
    "shard_min_rows": ("JT_SHARD_MIN_ROWS", MIN_ROWS_PER_DEVICE, 1),
}


def knob(name: str):
    """The knob's value from its environment variable, read now (so a
    setting applies to the next scheduler made), else its default; an
    integer or a float as the default is. A malformed value is logged
    and ignored."""
    var, default, least = KNOBS[name]
    env = os.environ.get(var)
    if env is None:
        return default
    kind = type(default)
    try:
        return max(least, kind(env))
    except ValueError:
        log.warning("ignoring malformed %s=%r (want %s >= %s)", var, env,
                    "an integer" if kind is int else "a number", least)
        return default


# In-flight dispatch-group budget: 2 = double buffering (host pads k+1,
# card runs k, host decodes k-1).
PIPELINE_DEPTH = 2

# Small wide buckets the caller asked to divert (min_device_rows) are
# yielded with this sentinel instead of a device result.
DIVERTED = object()

# Shape quanta: event axes round up to EVENT_QUANTUM and sub-chunk row
# counts to the power-of-two ladder (>= ROW_QUANTUM), as in the
# reference, so both packages plan the same chunks.
EVENT_QUANTUM = 64
ROW_QUANTUM = 64

# Rows per streamed encode group (iter_columnar_groups,
# iter_synth_groups).
ENCODE_ROWS = 4096

# Assumed sustained lane-op rate that converts the measured dispatch
# overhead (wall microseconds) into the class DP's cost-base units (base
# x 2^W ~ lane-ops). Only the RATIO of overhead to work matters.
DISPATCH_COST_LANE_OPS_PER_S = 1e8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_ceil(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


# ------------------------------------------------------ W-class cost model

_DISPATCH_OVERHEAD_US: Dict[str, float] = {}


def measure_dispatch_overhead_us(device=None, samples: int = 12) -> float:
    """The fixed cost of one device dispatch, in wall microseconds: a
    trivial launch plus a synchronise on ``device`` (the card unless the
    caller names another), timed after a warm-up, median over
    ``samples``. Measured once per process and device type.
    $JT_DISPATCH_OVERHEAD_US overrides the measurement entirely — how
    tests pin the class plan and how deployments with a known launch
    latency skip the probe; 0 disables the term."""
    env = os.environ.get("JT_DISPATCH_OVERHEAD_US")
    if env is not None:
        try:
            return max(0.0, float(env))
        except ValueError:
            return 0.0
    device = resolve_device(device)
    hit = _DISPATCH_OVERHEAD_US.get(device.type)
    if hit is not None:
        return hit
    x = torch.zeros(8, dtype=torch.int32, device=device)

    def once():
        y = x + 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return y

    once()
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        once()
        ts.append(time.perf_counter() - t0)
    _DISPATCH_OVERHEAD_US[device.type] = sorted(ts)[len(ts) // 2] * 1e6
    return _DISPATCH_OVERHEAD_US[device.type]


def dispatch_overhead_units(device=None) -> float:
    """The per-dispatch fixed-overhead term in cost-base units — what
    choose_w_classes charges each group beyond its frontier work."""
    return (measure_dispatch_overhead_us(device) * 1e-6
            * DISPATCH_COST_LANE_OPS_PER_S)


def choose_w_classes(stats: Dict[Tuple[int, int], float], *,
                     max_classes: Optional[int] = None,
                     boundary: int = DATA_MAX_SLOTS,
                     overhead: Optional[float] = None
                     ) -> Dict[Tuple[int, int], int]:
    """Pick the W classes: {(V, exact_W): class_W}.

    ``stats`` maps (V, exact_W) -> cost base (rows x events; anything
    proportional works). Per V, the exact windows <= ``boundary``
    partition into at most ``max_classes`` contiguous groups, each
    checked at its widest member; the dynamic program minimizes
    sum(base_group x 2^class_W + overhead) — total padded frontier work
    plus a per-group dispatch tax — over all such partitions. Windows
    past the boundary keep exact classes (the wide route, where the mask
    axis is shape-critical). ``max_classes`` defaults to the
    ``max_classes`` knob, ``overhead`` to dispatch_overhead_units()."""
    if max_classes is None:
        max_classes = knob("max_classes")
    if overhead is None:
        overhead = dispatch_overhead_units()
    overhead = max(0.0, float(overhead))
    out: Dict[Tuple[int, int], int] = {}
    by_v: Dict[int, List[int]] = {}
    for (v, w) in stats:
        if w <= boundary:
            by_v.setdefault(v, []).append(w)
        else:
            out[(v, w)] = w
    for v, ws in by_v.items():
        ws = sorted(set(ws))
        if len(ws) <= max_classes and not overhead:
            out.update({(v, w): w for w in ws})
            continue
        base = [float(stats[(v, w)]) for w in ws]
        pre = [0.0]
        for b in base:
            pre.append(pre[-1] + b)

        def cost(i, j):        # group ws[i..j] checked at ws[j]
            return (pre[j + 1] - pre[i]) * float(1 << ws[j]) + overhead

        n = len(ws)
        INF = float("inf")
        # dp[c][j] = min cost covering ws[:j] with exactly c groups
        dp = [[INF] * (n + 1) for _ in range(max_classes + 1)]
        cut = [[0] * (n + 1) for _ in range(max_classes + 1)]
        dp[0][0] = 0.0
        for c in range(1, max_classes + 1):
            for j in range(1, n + 1):
                for i in range(c - 1, j):
                    d = dp[c - 1][i] + cost(i, j - 1)
                    if d < dp[c][j]:
                        dp[c][j] = d
                        cut[c][j] = i
        c = min(range(1, max_classes + 1), key=lambda c: dp[c][n])
        j = n
        while c > 0:
            i = cut[c][j]
            cls = ws[j - 1]
            for k in range(i, j):
                out[(v, ws[k])] = cls
            j, c = i, c - 1
    return out


# --------------------------------------------------------------- scheduler

class ChunkAbandoned(WindowOverflow):
    """A wide bucket the ladder could not decide on the card: as a
    WindowOverflow, the callers' route to the host engine re-decides its
    rows."""


class _ChunkFailed(Exception):
    """A dispatch range exhausted its retry budget."""


class ResidentState:
    """Scheduler memory across batches, for long-lived callers (the
    online checker runs one scheduler per rolling check), passed as
    ``scheduler_opts={"resident": rs}`` and shared by reference:

      * ``safe_bp`` — the rows-per-dispatch caps an OOM bisection
        learned, so the next batch plans under them;
      * ``awaited`` — the kernel shapes already awaited once, so the
        watchdog's first-wait grace is paid once per process;
      * ``frontiers`` — per-tenant ResidentFrontier objects (the online
        daemon's carried WGL search state), keyed by (tenant key,
        writer incarnation): a delta tick resumes the frontier the
        previous tick left instead of re-walking from op 0;
      * ``batches`` — schedulers adopted."""

    def __init__(self):
        self.safe_bp: Dict = {}
        self.awaited: set = set()
        self.frontiers: Dict = {}
        self.batches = 0

    def adopt(self, sch) -> None:
        """Wire a freshly built scheduler to this resident state."""
        sch._safe_bp = self.safe_bp
        sch._awaited_shapes = self.awaited
        self.batches += 1


# ------------------------------------------------- resident device frontier

class FrontierInvalid(Exception):
    """The carried frontier cannot soundly extend to the new prefix: the
    vocabulary outgrew the enumerated space non-monotonically, the
    pending window outgrew the mask axis, or the buffer no longer holds
    the frontier's consumed prefix. Callers rebuild from op 0 (one
    full-cost tick, still exact); the online engine counts each as a
    frontier invalidation."""


class ResidentFrontier:
    """Per-tenant resident WGL search state: the online daemon's
    O(new ops) seam, a copy of the reference's.

    Holds, across rolling prefix checks of ONE live history:

      * the packed frontier carry (F / Fb / valid / bad, the resume
        kernel's contract, linearize.run_carried_events), advanced
        permanently over the *stable* prefix;
      * the pending-invocation window at the stable point (slot table,
        free mask, live invocations awaiting completion), so the next
        tick's events continue the same slot numbering;
      * the kind-vocabulary watermark (grow-only; growth re-enumerates
        the state space and keeps the carry only when the existing
        states survive as a prefix, else the frontier invalidates; a
        state count crossing a 32-state word widens the carry,
        linearize.grow_frontier_states).

    The stable point is the earliest still-open invocation: every op
    before it has its completion in the buffer, so its encoding can
    never change. Events at or past it (the volatile tail, dangling
    invocations held open) are re-encoded each tick from a snapshot of
    the walk state and checked from a copy of the carry, so the interim
    verdict is exactly the full-prefix verdict while a tick's device
    work is O(new ops + open window): one resume launch for the frozen
    events and one for the tail, a single row at V padded to 32 x
    words and W = peak window + 1.

    The launches run on ``device`` (None: the CUDA card, which must
    exist; "cpu" runs the plain version). ``export``/``restore`` carry
    the state through the tenant's ChunkJournal frontier-checkpoint row
    in the reference's JSON, so a checkpoint either package wrote
    restores in the other."""

    #: Mask-axis headroom over the observed peak window at build time:
    #: absorbs the next invocation burst without a rebuild.
    W_HEADROOM = 1

    def __init__(self, model, *, max_states: Optional[int] = None,
                 w: Optional[int] = None, device=None):
        from .linearize import MAX_PACKED_STATES
        self.model = model
        self.device = resolve_device(device)
        self.max_states = max_states or MAX_PACKED_STATES
        self.kinds: List[tuple] = []
        self.kind_index: Dict[tuple, int] = {}
        self.space = None
        self.W = w
        self.pos = 0          # raw ops consumed into the frozen walk
        self.seen = 0         # raw ops ingested into bookkeeping
        self.n_events = 0     # frozen (permanently dispatched) events
        self.table: List[int] = []
        self.free = 0
        self.live = 0
        self.slot_of: Dict = {}       # process -> slot awaiting its OK
        self.peak_live = 0
        self.carry: Optional[dict] = None
        self.latched_bad: Optional[int] = None
        self.open_inv: Dict = {}      # process -> invoke position
        self.completion: Dict[int, tuple] = {}  # invoke pos -> (t, val)
        self._target_space = self._target_key = None
        self.target = None
        self.stats = {"advances": 0, "events": 0, "delta_ops": 0}
        self.last_events = 0
        self.last_delta_ops = 0

    # ------------------------------------------------------- vocabulary
    @property
    def v_pad(self) -> int:
        return 32 * max(1, -(-self.space.n_states // 32))

    @property
    def _k_rows(self) -> int:
        return max(16, _pow2_ceil(len(self.kinds) + 1))

    def _need_kind(self, kind: tuple) -> None:
        from .linearize import grow_frontier_states
        from .statespace import enumerate_statespace
        if kind in self.kind_index:
            return
        kinds2 = self.kinds + [kind]
        space2 = enumerate_statespace(self.model, kinds2,
                                      self.max_states)
        carried = self.carry is not None or self.n_events or self.pos
        if self.space is not None and carried:
            # The packed carry's state bits must stay aligned: growth is
            # admissible only when the existing states survive as a
            # PREFIX of the re-enumerated space. Before anything is
            # carried, renumbering is harmless.
            old_v = self.space.n_states
            if (list(space2.kinds[:len(self.kinds)]) != self.kinds
                    or space2.states[:old_v] != self.space.states):
                raise FrontierInvalid(
                    f"vocabulary growth renumbered the state space "
                    f"({old_v} -> {space2.n_states} states)")
            old_words = n_state_words(self.v_pad)
            self.space = space2
            new_words = n_state_words(self.v_pad)
            if self.carry is not None and new_words != old_words:
                self.carry = grow_frontier_states(self.carry, old_words,
                                                  new_words)
        else:
            self.space = space2
        self.kind_index[kind] = len(self.kinds)
        self.kinds.append(kind)

    def _refresh_target(self) -> None:
        # The space the table was padded from is held and compared by
        # identity: an id() key goes stale when enumerate_statespace's
        # memo is cleared, the old space is freed and a newer one takes
        # its address.
        key = (self.v_pad, self._k_rows)
        if self._target_space is not self.space or key != self._target_key:
            self.target = self.space.padded_target(self.v_pad,
                                                   self._k_rows - 1)
            self._target_space, self._target_key = self.space, key

    # ---------------------------------------------------------- ingest
    def _ingest(self, ops) -> int:
        """Fold newly arrived ops into the bookkeeping maps (open
        invocations, completion knowledge, vocabulary). Returns the
        count of new ops consumed."""
        from ..history.ops import INVOKE, OK
        from .statespace import canonical_value
        n = len(ops)
        new = n - self.seen
        for p in range(self.seen, n):
            o = ops[p]
            if not o.is_client:
                continue
            if o.type == INVOKE:
                self._need_kind((o.f, canonical_value(o.value)))
                self.open_inv[o.process] = p
            elif o.is_completion:
                ip = self.open_inv.pop(o.process, None)
                if ip is None:
                    continue
                self.completion[ip] = (o.type, o.value)
                if o.type == OK:
                    inv = ops[ip]
                    v = inv.value if inv.value is not None else o.value
                    self._need_kind((inv.f, canonical_value(v)))
        self.seen = n
        return max(0, new)

    def _kind_of(self, inv, comp) -> int:
        from ..history.ops import OK
        from .statespace import canonical_value
        v = inv.value
        if v is None and comp is not None and comp[0] == OK:
            v = comp[1]
        return self.kind_index[(inv.f, canonical_value(v))]

    # ------------------------------------------------------------ walks
    def _walk(self, ops, lo: int, hi: int, state: dict,
              events: List[tuple], *, volatile: bool) -> None:
        """The encode walk over positions [lo, hi), with the per-history
        semantics of ops.encode.encode_history: value-propagated
        invocations allocate lowest-free-first, failed pairs drop,
        never-ok identity invocations drop, :info (and, in the volatile
        tail, dangling) invocations pin their slot forever, ok
        completions emit one event snapshotting the pending table.
        Mutates ``state`` and appends (slot, table-copy, op-position) to
        ``events``."""
        from ..history.ops import FAIL, INFO, INVOKE, OK
        identity = self.space.identity_kinds if self.space else ()
        table, slot_of = state["table"], state["slot_of"]
        for p in range(lo, hi):
            o = ops[p]
            if not o.is_client:
                continue
            if o.type == INVOKE:
                comp = self.completion.get(p)
                if comp is not None and comp[0] == FAIL:
                    continue                  # failed pair: both drop
                kidx = self._kind_of(o, comp)
                dangles = comp is None or comp[0] == INFO
                if dangles and kidx in identity:
                    continue                  # the identity-drop rule
                if not volatile and comp is None:
                    raise FrontierInvalid(
                        "open invocation inside the frozen walk")
                if not state["free"]:
                    raise FrontierInvalid(
                        f"pending window outgrew the W={self.W} "
                        f"mask axis")
                slot = (state["free"] & -state["free"]).bit_length() - 1
                state["free"] &= state["free"] - 1
                table[slot] = kidx
                state["live"] += 1
                self.peak_live = max(self.peak_live, state["live"])
                if dangles:
                    continue                  # pinned: never freed
                slot_of[o.process] = slot
            elif o.type == OK:
                slot = slot_of.pop(o.process, None)
                if slot is None:
                    continue
                events.append((slot, table.copy(), p))
                table[slot] = EMPTY
                state["free"] |= 1 << slot
                state["live"] -= 1

    def _state(self) -> dict:
        return {"table": self.table, "free": self.free,
                "live": self.live, "slot_of": self.slot_of}

    def _dispatch(self, events: List[tuple], idx0: int, carry: dict,
                  close_table: Optional[List[int]] = None) -> dict:
        """Encode one event list (optionally + EV_CLOSE) and advance
        ``carry`` through the resume kernel in one launch."""
        from .linearize import run_carried_events
        n = len(events) + (1 if close_table is not None else 0)
        sent = self._k_rows - 1
        ev_type = np.zeros(n, np.int8)
        ev_slot = np.zeros(n, np.int8)
        ev_slots = np.full((n, self.W), sent, np.int32)
        for i, (slot, tab, _p) in enumerate(events):
            ev_type[i] = EV_OK
            ev_slot[i] = slot
            for s, k in enumerate(tab):
                if k != EMPTY:
                    ev_slots[i, s] = k
        if close_table is not None:
            ev_type[n - 1] = EV_CLOSE
            for s, k in enumerate(close_table):
                if k != EMPTY:
                    ev_slots[n - 1, s] = k
        self._refresh_target()
        with telemetry.span("dispatch", cat="device", family="frontier",
                            V=self.v_pad, W=self.W, events=n,
                            idx0=idx0):
            out = run_carried_events(self.v_pad, self.W, self.target,
                                     ev_type, ev_slot, ev_slots, idx0,
                                     carry, device=self.device)
        self.stats["events"] += n
        self.last_events += n
        return out

    # ---------------------------------------------------------- advance
    def advance(self, ops) -> Tuple[bool, Optional[int]]:
        """Fold the buffer's new ops into the carried frontier and
        decide the current full prefix: (valid, first-bad-op-position).
        Raises FrontierInvalid when the carry cannot soundly extend
        (callers rebuild); any other exception leaves the frontier
        poisoned, and callers must drop it."""
        from .linearize import frontier_carry_init
        self.last_events = 0
        self.last_delta_ops = 0
        if self.latched_bad is not None:
            # Linearizability is prefix-closed: once invalid, every
            # longer prefix is invalid with the same first bad op.
            return False, self.latched_bad
        if self.pos > len(ops):
            raise FrontierInvalid(
                f"buffer ({len(ops)} ops) no longer contains the "
                f"frontier's consumed prefix ({self.pos} ops)")
        seen0 = self.seen
        if self.W is None:
            self._bootstrap(ops)
        self._ingest(ops)
        new = max(0, len(ops) - seen0)
        self.stats["delta_ops"] += new
        self.last_delta_ops = new
        self.stats["advances"] += 1
        if self.space is None:
            return True, None             # no client ops yet
        if self.carry is None:
            self.carry = frontier_carry_init(self.v_pad, self.W)
        stable = max(self.pos,
                     min(self.open_inv.values(), default=len(ops)))
        if stable > self.pos:
            frozen: List[tuple] = []
            st = self._state()
            self._walk(ops, self.pos, stable, st, frozen,
                       volatile=False)
            self.free, self.live = st["free"], st["live"]
            if frozen:
                self.carry = self._dispatch(frozen, self.n_events,
                                            self.carry)
                if not bool(self.carry["valid"][0]):
                    off = int(self.carry["bad"][0]) - self.n_events
                    self.latched_bad = frozen[off][2]
                    self.n_events += len(frozen)
                    self.pos = stable
                    return False, self.latched_bad
                self.n_events += len(frozen)
            self.pos = stable
            for p in [p for p in self.completion if p < self.pos]:
                del self.completion[p]
        # Volatile tail: re-encoded each tick from a snapshot, checked
        # from the carry (the resume kernel never mutates its inputs),
        # dangling invocations held open, then the EV_CLOSE flush.
        vstate = {"table": self.table.copy(), "free": self.free,
                  "live": self.live, "slot_of": dict(self.slot_of)}
        tail: List[tuple] = []
        self._walk(ops, self.pos, len(ops), vstate, tail, volatile=True)
        out = self._dispatch(tail, self.n_events, self.carry,
                             close_table=vstate["table"])
        if bool(out["valid"][0]):
            return True, None
        off = int(out["bad"][0]) - self.n_events
        if not 0 <= off < len(tail):
            raise FrontierInvalid(
                f"bad-event ordinal {int(out['bad'][0])} outside the "
                f"volatile tail")
        return False, tail[off][2]

    def _bootstrap(self, ops) -> None:
        """First advance: size the mask axis from the buffer's true
        peak window (one host scan) with headroom for the next burst."""
        from .linearize import DATA_MAX_SLOTS
        self._ingest(ops)
        state = {"table": [EMPTY] * DATA_MAX_SLOTS,
                 "free": (1 << DATA_MAX_SLOTS) - 1, "live": 0,
                 "slot_of": {}}
        self.W = DATA_MAX_SLOTS          # probe walk at the full width
        if self.space is None:
            # No client ops at all yet: enumerate the empty vocabulary.
            self._need_kind(("__frontier_probe__", None))
            self.kinds.pop()
            del self.kind_index[("__frontier_probe__", None)]
        probe: List[tuple] = []
        self.peak_live = 0
        self._walk(ops, 0, len(ops), state, probe, volatile=True)
        w = max(2, self.peak_live + self.W_HEADROOM)
        if w > DATA_MAX_SLOTS:
            if self.peak_live <= DATA_MAX_SLOTS:
                w = DATA_MAX_SLOTS
            else:
                raise FrontierInvalid(
                    f"peak window {self.peak_live} beyond the "
                    f"single-device mask axis")
        self.W = w
        self.table = [EMPTY] * w
        self.free = (1 << w) - 1
        self.live = 0
        self.slot_of = {}
        self.peak_live = 0

    # ---------------------------------------------- checkpoint contract
    def export(self) -> dict:
        """The journal frontier-checkpoint row's payload: vocabulary
        watermark, pending window and carried bitsets."""
        from .linearize import export_frontier
        return {"v": 1, "W": self.W, "pos": self.pos,
                "n_events": self.n_events,
                "kinds": [[f, _json_value(v)] for f, v in self.kinds],
                "table": list(self.table), "free": self.free,
                "live": self.live,
                "slot_of": [[p, s] for p, s in self.slot_of.items()],
                "peak_live": self.peak_live,
                "latched_bad": self.latched_bad,
                "carry": (export_frontier(self.carry)
                          if self.carry is not None else None)}

    @classmethod
    def restore(cls, model, payload: dict, *,
                max_states: Optional[int] = None, device=None
                ) -> Optional["ResidentFrontier"]:
        """Rehydrate a checkpointed frontier; None on any mismatch (the
        caller rebuilds from op 0, the cache-miss path)."""
        from .linearize import import_frontier
        from .statespace import (StateSpaceExplosion, canonical_value,
                                 enumerate_statespace)
        device = resolve_device(device)
        try:
            if payload.get("v") != 1 or payload.get("W") is None:
                return None
            fr = cls(model, max_states=max_states, w=int(payload["W"]),
                     device=device)
            kinds = [(f, canonical_value(v))
                     for f, v in payload["kinds"]]
            if kinds:
                fr.space = enumerate_statespace(model, kinds,
                                                fr.max_states)
                if list(fr.space.kinds) != kinds:
                    return None
            fr.kinds = kinds
            fr.kind_index = {k: i for i, k in enumerate(kinds)}
            fr.pos = fr.seen = int(payload["pos"])
            fr.n_events = int(payload["n_events"])
            fr.table = [int(x) for x in payload["table"]]
            fr.free = int(payload["free"])
            fr.live = int(payload["live"])
            fr.slot_of = {p: int(s) for p, s in payload["slot_of"]}
            fr.peak_live = int(payload["peak_live"])
            lb = payload.get("latched_bad")
            fr.latched_bad = None if lb is None else int(lb)
            if len(fr.table) != fr.W:
                return None
            if payload.get("carry") is not None:
                if fr.space is None:
                    return None
                fr.carry = import_frontier(payload["carry"], fr.v_pad,
                                           fr.W)
                if fr.carry is None:
                    return None
            return fr
        except StateSpaceExplosion:
            return None
        except Exception:
            return None


def _json_value(v):
    """Kind values round-trip through JSON: canonical tuples become
    lists on disk and canonical_value() re-tuples them on restore."""
    if isinstance(v, tuple):
        return [_json_value(x) for x in v]
    if isinstance(v, frozenset):
        return sorted(_json_value(x) for x in v)
    return v


def _watched(sch, fn, deadline: float, what: str):
    """Run ``fn()`` on a daemon retire thread, inside the stream the
    calling thread launches on (so its copies wait for the launch,
    whatever stream the caller chose), and wait at most ``deadline``
    seconds; past it count ``watchdog_fired`` in the scheduler's stats,
    raise WatchdogExpired and abandon the thread. A wedged copy cannot
    be cancelled on CUDA, and a daemon never blocks the interpreter's
    exit (the reference's DaemonFuture threat model). A failure inside
    ``fn`` is re-raised here."""
    stream = (torch.cuda.current_stream(sch.device)
              if sch.device.type == "cuda" else None)
    q: "queue.Queue" = queue.Queue(1)

    def work():
        try:
            if stream is not None:
                with torch.cuda.stream(stream):
                    q.put((fn(), None))
            else:
                q.put((fn(), None))
        except BaseException as e:   # noqa: BLE001 — relayed below
            q.put((None, e))

    threading.Thread(target=work, name="jepsen-retire", daemon=True).start()
    try:
        r, err = q.get(timeout=deadline)
    except queue.Empty:
        sch._inc("watchdog_fired")
        raise WatchdogExpired(f"{what} exceeded its {deadline:.2f}s decode "
                              f"deadline") from None
    if err is not None:
        raise err
    return r


class _Run:
    """One consolidated bucket's in-flight accounting."""

    def __init__(self, batch: EncodedBatch, n_chunks: int):
        self.batch = batch
        self.remaining = n_chunks
        self.pieces: List[Tuple] = []

    def collect(self, v, b, fr):
        self.pieces.append(((v, b, fr), len(v)))
        self.remaining -= 1

    @property
    def done(self) -> bool:
        return self.remaining == 0

    def result(self, return_frontier):
        return self.batch, _concat_pieces(self.pieces, return_frontier)


class BucketScheduler:
    """The streaming scheduler. One instance per logical batch; not
    thread-safe; ``stats`` is a JSON-friendly dict filled as the run
    streams (wall_s and overlap_ratio land when the generator ends).
    ``device`` is where the kernels run (the card unless the caller
    names another); ``return_frontier`` is False, True or "invalid"
    (frontiers of the invalid rows only, as {row: frontier}).
    ``wgl_backend`` is "auto", "dc", "xla" or "pallas" (the module
    docstring), $JT_WGL_BACKEND when None. ``shard_min_rows`` is the
    rows from which a narrow bucket takes the batch-sharded route when
    there is a production mesh (None: parallel.mesh.should_shard).
    ``min_device_rows``: a consolidated wide bucket (W >= DATA_MAX_SLOTS)
    with fewer rows than this is yielded with DIVERTED instead of
    launched, for the caller's C++ tail engine. The check comes after
    consolidation, so a merged class stays on the card where the exact
    flow would send its fragments to the host one by one.

    The degradation ladder: ``faults`` is a FaultInjector (else the
    ambient $JT_FAULT_PLAN, else none); ``max_retries`` and
    ``backoff_s`` default to the knobs; ``resident`` a ResidentState.
    ``quarantined`` maps the caller-level index of each row the ladder
    gave up on to the reason (its in-band verdict is an inert
    placeholder the caller must re-decide on the host), and
    ``row_provenance`` tags every row off the happy path:
    ``"device-retried"``, ``"host-fallback"``, or ``"wgl-dc"`` for a row
    the peel loop decided alone."""

    def __init__(self, *, return_frontier=False,
                 max_classes: Optional[int] = None,
                 chunk_rows: Optional[int] = None,
                 depth: int = PIPELINE_DEPTH,
                 consolidate: bool = True,
                 on_chunk=None,
                 fuse_width: Optional[int] = None,
                 wgl_backend: Optional[str] = None,
                 faults: Optional[FaultInjector] = None,
                 max_retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 resident: Optional[ResidentState] = None,
                 shard_min_rows: Optional[int] = None,
                 min_device_rows: int = 0,
                 device=None):
        self.return_frontier = return_frontier
        self.min_device_rows = min_device_rows
        self.device = resolve_device(device)
        if wgl_backend is None:
            wgl_backend = os.environ.get("JT_WGL_BACKEND", "auto")
        if wgl_backend not in ("auto", "xla", "pallas", "dc"):
            log.warning("ignoring unknown wgl_backend=%r (want "
                        "auto|xla|pallas|dc)", wgl_backend)
            wgl_backend = "auto"
        self.wgl_backend = wgl_backend
        self._backend_choice: Dict[Tuple, bool] = {}
        self.max_classes = (knob("max_classes") if max_classes is None
                            else max_classes)
        self.chunk_rows = (knob("chunk_rows") if chunk_rows is None
                           else chunk_rows)
        self.depth = max(1, depth)
        # One group launch takes at most MAX_GROUP_MEMBERS chunks.
        self.fuse_width = min(MAX_GROUP_MEMBERS, max(
            1, knob("fuse_width") if fuse_width is None
            else int(fuse_width)))
        self.max_queue = knob("max_queue")
        self.event_route_events = knob("event_route_events")
        self.event_chunk = knob("event_chunk")
        self.bisect_floor_rows = knob("bisect_floor_rows")
        # Routing floor of the batch-sharded (dataN) route: merged
        # buckets below it stay on the chunked pipeline (its fault
        # hooks, chunk journal and group launches) instead of draining
        # it for a blocking sharded call. None keeps the mesh's default
        # (data devices x $JT_SHARD_MIN_ROWS, parallel.mesh.should_shard).
        self.shard_min_rows = shard_min_rows
        self._fuse_buf: List[Tuple] = []
        self.consolidate = consolidate
        self.on_chunk = on_chunk
        self.faults = faults if faults is not None \
            else FaultInjector.from_env()
        self.max_retries = (knob("retry_max") if max_retries is None
                            else max(0, int(max_retries)))
        if backoff_s is None and self.faults is not None:
            backoff_s = self.faults.backoff_s
        self.backoff_s = (knob("retry_backoff_s") if backoff_s is None
                          else float(backoff_s))
        self.quarantined: Dict[int, str] = {}
        self.row_provenance: Dict[int, str] = {}
        self._safe_bp: Dict[Tuple[int, int], int] = {}
        self._awaited_shapes: set = set()
        if resident is not None:
            resident.adopt(self)
        self._stats_lock = threading.Lock()
        self.stats: dict = {
            "input_buckets": 0, "classes": [], "chunks": 0,
            "dispatches": 0, "fused_groups": 0,
            "rows": 0, "pad_rows": 0,
            "t_first_verdict_s": None, "t_first_dispatch_s": None,
            "wall_s": None,
            "encode_busy_s": 0.0, "dispatch_busy_s": 0.0,
            "device_wait_s": 0.0, "overlap_ratio": None,
            "events": 0, "orig_events": 0, "fusion_ratio": None,
            "retries": 0, "bisections": 0, "watchdog_fired": 0,
            "oom_events": 0, "corrupt_chunks": 0, "quarantined_rows": 0,
            "abandoned_buckets": 0, "faults_injected": 0,
            "event_routed_rows": 0, "event_routed_dispatches": 0,
            "backpressure_events": 0,
            "dc_dispatches": 0, "dc_rows": 0, "dc_decided_rows": 0,
            "dc_skipped_scans": 0,
            "wgl_backend": self.wgl_backend,
        }
        self._t0 = None
        self._first_dispatch_t = None
        self._last_retire_t = None

    def _inc(self, key: str, n=1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    # ------------------------------------------------------------ plumbing
    def _class_chunk(self, V: int, W: int) -> int:
        per_hist = n_state_words(V) << W
        chunk = max(1, min(self.chunk_rows,
                           MAX_FRONTIER_ELEMENTS // per_hist))
        # An OOM bisection learned this class's memory wall: plan every
        # later chunk under it instead of re-entering the ladder.
        cap = self._safe_bp.get((V, W))
        return min(chunk, cap) if cap else chunk

    def _chunk_plan(self, batch: EncodedBatch) -> Tuple[int, List[Tuple]]:
        """(padded_rows_per_dispatch, [(lo, hi), ...])."""
        chunk = self._class_chunk(batch.V, batch.W)
        if batch.batch <= chunk:
            bp = min(chunk, max(ROW_QUANTUM, _pow2_ceil(batch.batch)))
            return bp, [(0, batch.batch)]
        return chunk, [(lo, min(lo + chunk, batch.batch))
                       for lo in range(0, batch.batch, chunk)]

    def _pad_chunk(self, batch: EncodedBatch, lo: int, hi: int,
                   Bp: int, Np: int):
        """Rows [lo, hi) padded to [Bp, Np] with no-op rows and events
        (EV_PAD, empty slots), on the device; the target is the shared
        [K1, V] table or the rows' own [Bp, K1, V] tables."""
        nb = hi - lo
        N = batch.n_events
        K1 = batch.target.shape[1]
        W = batch.ev_slots.shape[2]
        ev_type = np.zeros((Bp, Np), batch.ev_type.dtype)
        ev_slot = np.zeros((Bp, Np), batch.ev_slot.dtype)
        ev_slots = np.full((Bp, Np, W), K1 - 1, batch.ev_slots.dtype)
        ev_type[:nb, :N] = batch.ev_type[lo:hi]
        ev_slot[:nb, :N] = batch.ev_slot[lo:hi]
        ev_slots[:nb, :N] = batch.ev_slots[lo:hi]
        if batch.shared_target:
            target = batch.target[0]
        else:
            target = np.full((Bp, K1, batch.V), -1, np.int32)
            target[:nb] = batch.target[lo:hi]
        return tuple(_on(a, self.device)
                     for a in (ev_type, ev_slot, ev_slots, target))

    def _dc_for(self, batch: EncodedBatch) -> bool:
        """Does this bucket's dispatch run the peel pre-filter first?
        Forced "dc" runs it wherever the plan has a capable row; "auto"
        only when the cost router prices the peel loop under the frontier
        search (a measured dc_events_per_s, never a constant) and the
        bucket's capable fraction clears the residue gate. Memoized per
        bucket shape."""
        if self.wgl_backend in ("xla", "pallas"):
            return False
        from .dc_monitor import (dc_available, dc_plan_for,
                                 dc_residue_max_frac, router_prefers_dc)
        if not dc_available():
            return False
        if self.wgl_backend == "dc":
            return dc_plan_for(batch) is not None
        key = ("dc", batch.V, batch.W,
               _round_up(batch.n_events, EVENT_QUANTUM))
        hit = self._backend_choice.get(key)
        if hit is None:
            hit = router_prefers_dc(batch.W, batch.n_events,
                                    max(batch.batch, 1), device=self.device)
            self._backend_choice[key] = hit
        if not hit:
            return False
        plan = dc_plan_for(batch)
        return (plan is not None
                and plan.capable_frac >= 1.0 - dc_residue_max_frac())

    def _fire(self, stage: str) -> Optional[str]:
        return self.faults.fire(stage) if self.faults is not None else None

    def _ship(self, batch: EncodedBatch, lo: int, hi: int, Bp: int,
              Np: int, tag: str = "data1"):
        """The ONE dispatch sequence of the pipelined path and of every
        ladder re-dispatch, so a retry cannot drift from what it retries:
        the encode-stage fault, the pad, the dispatch-stage fault, the
        peel pre-filter where ``_dc_for`` says so, and (unless the peel
        loop decided every row) the launch of the padded chunk through
        the single-bucket kernel, asynchronously. Returns ``(out,
        delay)``: ``out`` is the device (valid, bad, frontier), or host
        arrays (all valid, no bad event, no frontier) for a chunk the
        peel loop decided alone; ``delay`` is a timeout or wedge fault's
        stall, applied where the watchdog sees it."""
        self._fire("encode")
        ev_type, ev_slot, ev_slots, target = self._pad_chunk(
            batch, lo, hi, Bp, Np)
        delay = 0.0
        if self.faults is not None:
            delay = self.faults.sleep_for(self._fire("dispatch"))
        if self._dc_for(batch):
            from .dc_monitor import dc_prefilter_chunk
            decided = dc_prefilter_chunk(batch, lo, hi, device=self.device)
            if decided is not None:
                DISPATCH_LOG.append(("dc", batch.V, batch.W, hi - lo))
                self._inc("dc_dispatches")
                self._inc("dc_rows", hi - lo)
                nd = int(decided.sum())
                if nd:
                    self._inc("dc_decided_rows", nd)
                if nd == hi - lo and self.return_frontier is not True:
                    self._inc("dc_skipped_scans")
                    self._inc("dispatches")
                    for r in range(lo, hi):
                        self.row_provenance[batch.indices[r]] = "wgl-dc"
                    return (np.ones(hi - lo, bool),
                            np.full(hi - lo, INT32_MAX, np.int32),
                            None), delay
        kern = get_kernel(batch.V, batch.W, w_live=batch.eff_w_live)
        DISPATCH_LOG.append((tag, batch.V, batch.W, hi - lo))
        self._inc("dispatches")
        # Padding rows are not launched: the decode reads the first
        # hi - lo rows only.
        nb = hi - lo
        return kern(ev_type[:nb], ev_slot[:nb], ev_slots[:nb],
                    target if batch.shared_target else target[:nb]), delay

    @staticmethod
    def _member_spec(batch: EncodedBatch) -> Tuple:
        return (batch.V, batch.W, batch.eff_w_live, batch.shared_target)

    @staticmethod
    def _groupable(batch: EncodedBatch) -> bool:
        """May this chunk ride a group launch? The group kernel keeps
        every member's frontier in one block's shared memory; a window
        whose frontier does not fit there (W >= 16 at one state word, >=
        15 at two: the cluster and device-memory tiers) launches
        alone."""
        return smem_plan(batch.V, batch.W,
                         batch.eff_w_live)["tier"] in ("warp", "block")

    def _dispatch_group(self, members: List[Tuple]):
        """Asynchronous dispatch of one group: ``members`` is [(run, lo,
        hi, Bp)]. A single member rides the single-bucket kernel
        (_ship); two or more groupable members retire in ONE launch of
        the group kernel, with any member that cannot join shipped alone
        in member order. A member routed to the peel pre-filter never
        joins: the pre-filter lives in _ship, and a chunk it decides
        skips the frontier launch a group would make. The fault hooks
        fire once per MEMBER, in member order, so fault ordinals count
        chunks whatever the fusion. A failure the classifier knows is
        carried to retire time as ``outs`` instead of raised, so the
        pipeline keeps streaming and the ladder runs per member when the
        group's turn comes. Returns (members, outs, delay)."""
        t0 = time.monotonic()
        delay = 0.0
        try:
            if len(members) == 1:
                run, lo, hi, Bp = members[0]
                out, delay = self._ship(run.batch, lo, hi, Bp,
                                        _round_up(run.batch.n_events,
                                                  EVENT_QUANTUM))
                outs = [out]
            else:
                outs, delay = self._dispatch_fused(members)
        except Exception as e:
            if classify_failure(e) is None:
                raise
            outs, delay = e, 0.0
        if self._first_dispatch_t is None:
            self._first_dispatch_t = time.monotonic()
            # Time to first dispatch: how long the card sat idle before
            # the source produced its first shippable chunk.
            self.stats["t_first_dispatch_s"] = round(
                self._first_dispatch_t - self._t0, 4)
        self._inc("chunks", len(members))
        for _, lo, hi, Bp in members:
            self._inc("pad_rows", Bp - (hi - lo))
        self._inc("dispatch_busy_s", time.monotonic() - t0)
        return members, outs, delay

    def _dispatch_fused(self, members: List[Tuple]) -> list:
        """The group launch of _dispatch_group: (outs per member, the
        members' summed fault delay)."""
        ok = [self._groupable(run.batch) and not self._dc_for(run.batch)
              for run, _, _, _ in members]
        if ok.count(True) < 2:
            ok = [False] * len(members)
        outs: List = [None] * len(members)
        grouped: List[int] = []
        flat: List = []
        specs: List[Tuple] = []
        rows: List[int] = []
        delay = 0.0
        for pos, (run, lo, hi, Bp) in enumerate(members):
            b = run.batch
            Np = _round_up(b.n_events, EVENT_QUANTUM)
            if not ok[pos]:
                outs[pos], d = self._ship(b, lo, hi, Bp, Np)
                delay += d
                continue
            self._fire("encode")
            flat.extend(self._pad_chunk(b, lo, hi, Bp, Np))
            if self.faults is not None:
                delay += self.faults.sleep_for(self._fire("dispatch"))
            specs.append(self._member_spec(b))
            rows.append(hi - lo)
            grouped.append(pos)
            DISPATCH_LOG.append(("data1fused", b.V, b.W, hi - lo))
        if grouped:
            out_flat = get_fused_kernel(specs)(*flat, rows=rows)
            self._inc("dispatches")
            self._inc("fused_groups")
            for i, pos in enumerate(grouped):
                outs[pos] = tuple(out_flat[3 * i:3 * i + 3])
        return outs, delay

    # ------------------------------------------------ watchdog + ladder
    def _deadline(self, batch: EncodedBatch, rows: int) -> float:
        """Per-chunk decode deadline from the op model: estimated
        lane-ops at a pessimistic sustained rate, a wide safety factor,
        a hard floor, and a one-time grace for shapes this scheduler has
        not awaited before (a first launch builds its CUDA library). An
        active fault plan overrides it (test-scale timings)."""
        if self.faults is not None and self.faults.deadline_s is not None:
            return self.faults.deadline_s
        m = vpu_op_model(batch.V, batch.W, batch.eff_w_live)
        est = rows * batch.n_events * (
            m["per_event"] + (m["w_live"] + 1) * m["per_iteration"])
        d = max(knob("watchdog_min_s"),
                est / knob("watchdog_lane_ops_per_s")
                * knob("watchdog_factor"))
        shape = (batch.V, batch.W, batch.eff_w_live, batch.n_events)
        if shape not in self._awaited_shapes:
            self._awaited_shapes.add(shape)
            d += knob("watchdog_compile_grace_s")
        return d

    def _decode_member(self, out, nb: int, batch: EncodedBatch):
        """Copy one dispatch's outputs back (on the retire thread): fire
        the decode-stage fault, slice off pad rows, apply a corrupt
        fault, validate (corrupt output becomes a retryable fault, never
        a wrong verdict), and shape the frontier per return_frontier. A
        chunk the peel loop decided alone arrives as host arrays with no
        frontier (never under return_frontier=True) and goes through the
        same fault and validation."""
        kind = self._fire("decode")
        if self.faults is not None:
            s = self.faults.sleep_for(kind)
            if s:
                time.sleep(s)
        valid, bad, front = out
        host = isinstance(valid, np.ndarray)
        v = valid[:nb] if host else valid[:nb].cpu().numpy()
        b = bad[:nb] if host else bad[:nb].cpu().numpy()
        if kind == "corrupt":
            v, b = corrupt_arrays(v, b)
        validate_decoded(v, b, batch.n_events)
        fr = None
        if host:
            fr = {} if self.return_frontier == "invalid" else None
        elif self.return_frontier is True:
            fr = front[:nb].cpu().numpy().view(np.uint32)
        elif self.return_frontier == "invalid":
            rows = np.nonzero(~v)[0]
            fr = {}
            if rows.size:
                sel = front[torch.from_numpy(rows).to(front.device)]
                sel = sel.cpu().numpy().view(np.uint32)
                fr = {int(r): sel[i] for i, r in enumerate(rows)}
        return v, b, fr

    def _await(self, out, nb: int, batch: EncodedBatch,
               deadline: float, delay: float = 0.0):
        """Copy one dispatch back on a daemon retire thread under the
        watchdog deadline (WatchdogExpired past it)."""
        def work():
            if delay:
                time.sleep(delay)
            return self._decode_member(out, nb, batch)
        return _watched(self, work, deadline, f"chunk (V={batch.V}, "
                        f"W={batch.W}, rows={nb})")

    def _await_group(self, members: List[Tuple], outs, delay: float):
        """Copy every member of one group launch back on one daemon
        thread under ONE deadline (the sum of the members' deadlines, or
        a fault plan's). Decode-stage faults fire once per member; any
        member failing validation fails the group, and the ladder then
        re-decides each member alone. Returns [(valid, bad, frontier)]
        per member."""
        if self.faults is not None and self.faults.deadline_s is not None:
            deadline = self.faults.deadline_s
        else:
            deadline = sum(self._deadline(run.batch, hi - lo)
                           for run, lo, hi, _ in members)

        def work():
            if delay:
                time.sleep(delay)
            return [self._decode_member(out, hi - lo, run.batch)
                    for (run, lo, hi, _), out in zip(members, outs)]
        rows = sum(hi - lo for _, lo, hi, _ in members)
        return _watched(self, work, deadline, f"group ({len(members)} "
                        f"chunks, {rows} rows)")

    def _exec_once(self, batch: EncodedBatch, lo: int, hi: int, Bp: int):
        """One synchronous guarded pass over rows [lo, hi): dispatch in
        <= Bp-row sub-ranges, each awaited under the watchdog. Every
        launch allocates its outputs afresh, so a late worker of an
        abandoned attempt never shares a buffer with the retry."""
        Np = _round_up(batch.n_events, EVENT_QUANTUM)
        pieces = []
        for s in range(lo, hi, Bp):
            e = min(s + Bp, hi)
            out, delay = self._ship(batch, s, e, Bp, Np, "data1retry")
            pieces.append(
                (self._await(out, e - s, batch,
                             self._deadline(batch, Bp), delay), e - s))
        return _concat_pieces(pieces, self.return_frontier)

    def _exec_retry(self, batch: EncodedBatch, lo: int, hi: int, Bp: int):
        """Bounded retry with exponential backoff around _exec_once. An
        OOM escapes at once (halving Bp is its cure, not patience);
        unclassified errors propagate."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._inc("retries")
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                return self._exec_once(batch, lo, hi, Bp)
            except Exception as e:
                c = classify_failure(e)
                if c is None or c == "oom":
                    raise
                if isinstance(e, CorruptOutput):
                    self._inc("corrupt_chunks")
                last = e
        raise _ChunkFailed(last)

    def _exec_event_chunked(self, batch: EncodedBatch, lo: int, hi: int):
        """The rung past the bisection floor: the event-chunked resume
        kernel bounds peak memory by the event axis instead."""
        sub = _slice_rows(batch, lo, hi)
        v, b, fr = run_event_chunked(sub, self.event_chunk,
                                     return_frontier=bool(
                                         self.return_frontier),
                                     device=self.device)
        validate_decoded(v, b, batch.n_events)
        return v, b, self._frontier_mode(v, fr)

    def _placeholder(self, batch: EncodedBatch, n: int):
        """Inert verdicts for quarantined rows, shaped like a clean
        chunk; the caller's host engine overwrites them."""
        v = np.ones(n, bool)
        b = np.full(n, INT32_MAX, np.int32)
        if self.return_frontier is True:
            fr = np.zeros((n, n_state_words(batch.V), 1 << batch.W),
                          np.uint32)
        elif self.return_frontier == "invalid":
            fr = {}
        else:
            fr = None
        return v, b, fr

    def _quarantine(self, batch: EncodedBatch, row: int,
                    cause: BaseException):
        i = batch.indices[row]
        reason = f"{type(cause).__name__}: {cause}"
        self.quarantined[i] = reason
        self.row_provenance[i] = "host-fallback"
        self._inc("quarantined_rows")
        log.warning("quarantining history %s after exhausting the "
                    "device ladder (%s); the host engine decides it", i,
                    reason)
        return self._placeholder(batch, 1)

    def _hunt_poison(self, batch: EncodedBatch, lo: int, hi: int,
                     Bp: int):
        """Binary-search a persistently failing range down to the poison
        rows. Each level gets ONE attempt (the range already used its
        retries); a row still failing alone is quarantined."""
        if hi - lo == 1:
            try:
                return self._exec_once(batch, lo, hi, min(Bp, ROW_QUANTUM))
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                return self._quarantine(batch, lo, e)
        mid = (lo + hi) // 2
        pieces = []
        for a, c in ((lo, mid), (mid, hi)):
            try:
                piece = self._exec_once(batch, a, c, Bp)
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                piece = self._hunt_poison(batch, a, c, Bp)
            pieces.append((piece, c - a))
        return _concat_pieces(pieces, self.return_frontier)

    def _exec_range(self, batch: EncodedBatch, lo: int, hi: int,
                    Bp: int, first_cause: Optional[BaseException] = None):
        """The ladder for rows [lo, hi): retry → OOM Bp-bisection (the
        learned safe size sticks for the run) → event-chunked dispatch
        → poison-row hunt. Always returns a full (valid, bad, frontier);
        rows it could not decide are quarantined placeholders."""
        cls = (batch.V, batch.W)
        cap = self._safe_bp.get(cls)
        if cap:
            Bp = min(Bp, cap)
        oom = first_cause is not None and \
            classify_failure(first_cause) == "oom"
        while True:
            if not oom:
                try:
                    return self._exec_retry(batch, lo, hi, Bp)
                except _ChunkFailed:
                    return self._hunt_poison(batch, lo, hi, Bp)
                except Exception as e:
                    if classify_failure(e) != "oom":
                        raise
                    self._inc("oom_events")
                    oom = True
                    continue
            if Bp > self.bisect_floor_rows:
                Bp = max(self.bisect_floor_rows, Bp // 2)
                self._inc("bisections")
                self._safe_bp[cls] = Bp
                log.warning("OOM on chunk (V=%s, W=%s): bisecting to "
                            "%s rows/dispatch", batch.V, batch.W, Bp)
                oom = False
                continue
            try:
                return self._exec_event_chunked(batch, lo, hi)
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                return self._hunt_poison(batch, lo, hi, Bp)

    def _recover(self, batch: EncodedBatch, lo: int, hi: int, Bp: int,
                 cause: BaseException):
        """The ladder's entry from a failed pipelined chunk; tags the
        surviving rows device-retried (quarantined rows are already
        host-fallback)."""
        if classify_failure(cause) == "oom":
            self._inc("oom_events")
        if isinstance(cause, CorruptOutput):
            self._inc("corrupt_chunks")
        log.warning("chunk (V=%s, W=%s, rows %s:%s) failed in the "
                    "pipeline (%s: %s); entering the degradation "
                    "ladder", batch.V, batch.W, lo, hi,
                    type(cause).__name__, cause)
        # The ladder's first pass re-dispatches work the pipeline already
        # shipped once: that is a retry, whatever happens after.
        self._inc("retries")
        out = self._exec_range(batch, lo, hi, Bp, first_cause=cause)
        for r in range(lo, hi):
            self.row_provenance.setdefault(batch.indices[r],
                                           "device-retried")
        return out

    def _retire(self, item) -> None:
        members, outs, delay = item
        t0 = time.monotonic()
        results = None
        if isinstance(outs, BaseException):
            cause = outs           # the dispatch itself failed
        else:
            try:
                if len(members) == 1:
                    run, lo, hi, _ = members[0]
                    results = [self._await(
                        outs[0], hi - lo, run.batch,
                        self._deadline(run.batch, hi - lo), delay)]
                else:
                    results = self._await_group(members, outs, delay)
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                cause = e
        if results is None:
            # The group failed as a unit: every member walks the ladder
            # alone.
            results = [self._recover(run.batch, lo, hi, Bp, cause)
                       for run, lo, hi, Bp in members]
        self._inc("device_wait_s", time.monotonic() - t0)
        self._mark_retired()
        for (run, lo, hi, _), (v, b, fr) in zip(members, results):
            if self.on_chunk is not None:
                self.on_chunk(run.batch, lo, hi, v, b, fr)
            run.collect(v, b, fr)

    def _mark_retired(self) -> None:
        self._last_retire_t = time.monotonic()
        if self.stats["t_first_verdict_s"] is None:
            self.stats["t_first_verdict_s"] = round(
                self._last_retire_t - self._t0, 4)

    def _frontier_mode(self, v, fr):
        """A whole-bucket route's frontier in return_frontier's shape."""
        if self.return_frontier == "invalid":
            return {int(r): fr[r] for r in np.nonzero(~v)[0]}
        return fr if self.return_frontier else None

    def _run_event_routed(self, mb: EncodedBatch):
        """Long-history route: the whole bucket runs through the
        event-chunked resume kernel (carried frontier, ``event_chunk``-
        step launches). One attempt: a classified failure returns None
        and the bucket falls through to the chunked pipeline, whose
        ladder is the retry."""
        n_disp = -(-mb.n_events // self.event_chunk)
        try:
            out = self._exec_event_chunked(mb, 0, mb.batch)
        except Exception as e:
            if classify_failure(e) is None:
                raise
            log.warning("event-chunked route failed for bucket (V=%s, "
                        "W=%s, %s rows): %s; falling back to the chunk "
                        "pipeline", mb.V, mb.W, mb.batch, e)
            return None
        self._inc("dispatches", n_disp)
        self._inc("event_routed_dispatches", n_disp)
        self._inc("event_routed_rows", mb.batch)
        return out

    def _run_wide(self, mb: EncodedBatch):
        """Blocking dispatch of a wide or sharded bucket through
        ``run_encoded_batch`` (W > DATA_MAX_SLOTS: the frontier-sharded
        route, or one card's device-memory tier; a large narrow bucket on
        a mesh: the batch-sharded route) with bounded retry. A window
        past what the devices host returns the WindowOverflow, and a
        failure
        that persists returns ChunkAbandoned: either way the caller's
        host engine decides the rows."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._inc("retries")
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                self._inc("dispatches")
                v, b, fr = run_encoded_batch(mb, bool(self.return_frontier),
                                             device=self.device)
                if attempt:
                    for i in mb.indices:
                        self.row_provenance.setdefault(i, "device-retried")
                return v, b, self._frontier_mode(v, fr)
            except WindowOverflow as e:
                return e
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                last = e
        self._inc("abandoned_buckets")
        for i in mb.indices:
            self.row_provenance[i] = "host-fallback"
        log.warning("wide bucket (V=%s, W=%s, %s rows) abandoned after %s "
                    "attempts (%s); its rows go to the host engine", mb.V,
                    mb.W, mb.batch, self.max_retries + 1, last)
        return ChunkAbandoned(
            f"device failure persisted across {self.max_retries + 1} "
            f"attempts: {last}")

    # ---------------------------------------------------------- class plan
    def _freeze_classes(self, group: Sequence[EncodedBatch]) -> Dict:
        if not self.consolidate:
            return {(b.V, b.W): b.W for b in group}
        stats: Dict[Tuple[int, int], float] = {}
        for b in group:
            if b.batch:
                stats[(b.V, b.W)] = (stats.get((b.V, b.W), 0.0)
                                     + b.batch * b.n_events)
        us = measure_dispatch_overhead_us(self.device)
        self.stats["dispatch_overhead_us"] = round(us, 2)
        return choose_w_classes(
            stats, max_classes=self.max_classes,
            overhead=us * 1e-6 * DISPATCH_COST_LANE_OPS_PER_S)

    def _class_of(self, class_map: Dict, V: int, W: int) -> int:
        cw = class_map.get((V, W))
        if cw is None:
            if not self.consolidate or W > DATA_MAX_SLOTS:
                # Exact class: consolidate=False promises exact W for
                # every window, including ones first seen in later
                # groups; and wide windows always stay exact (on the
                # wide route cost is 2^W per row).
                cw = W
            else:
                # A later streaming group surfaced a narrow window the
                # first group never saw: ride the next-wider frozen
                # narrow class, or freeze a new exact class.
                ups = [c for (v, w), c in class_map.items()
                       if v == V and W <= c <= DATA_MAX_SLOTS]
                cw = min(ups) if ups else W
            class_map[(V, W)] = cw
        return cw

    # ------------------------------------------------------------ pipeline
    def run(self, source):
        """Yield (batch, out) per consolidated bucket — see the module
        docstring for the contract."""
        return self._drive_inner(source)

    def _drive_inner(self, source):
        self._t0 = time.monotonic()
        groups = ([list(source)]
                  if isinstance(source, (list, tuple)) else source)
        class_map: Optional[Dict] = None
        acc: Dict[Tuple[int, int], List[EncodedBatch]] = {}
        inflight: deque = deque()
        order: deque = deque()      # _Run FIFO awaiting completion

        def yield_done():
            while order and order[0].done:
                yield order.popleft().result(self.return_frontier)

        def retire_ready():
            # Keep at most `depth` dispatch groups in flight, then
            # yield any bucket whose last chunk has decoded.
            while len(inflight) >= self.depth:
                self._retire(inflight.popleft())
            yield from yield_done()

        def flush():
            # Ship the accumulated chunks as one dispatch group.
            if self._fuse_buf:
                group, self._fuse_buf = self._fuse_buf, []
                yield from retire_ready()
                inflight.append(self._dispatch_group(group))

        def drain():
            yield from flush()
            while inflight:
                self._retire(inflight.popleft())
            yield from yield_done()

        def blocking(mb, out):
            if not isinstance(out, WindowOverflow):
                self._mark_retired()
                if self.on_chunk is not None:
                    self.on_chunk(mb, 0, mb.batch, *out)
            return mb, out

        def feed(mb: EncodedBatch):
            self._inc("rows", mb.batch)
            if (mb.W >= DATA_MAX_SLOTS
                    and 0 < mb.batch < self.min_device_rows):
                yield mb, DIVERTED
                return
            ev = int((mb.ev_type != 0).sum())        # != EV_PAD
            self._inc("events", ev)
            self._inc("orig_events",
                      int(mb.orig_n_events.sum())
                      if mb.orig_n_events is not None else ev)
            mesh = production_mesh(1, self.device)
            if self.shard_min_rows is None:
                from ..parallel.mesh import should_shard
                shard = should_shard(mb.batch, mesh)
            else:
                shard = mesh is not None and mb.batch >= self.shard_min_rows
            if mb.W > DATA_MAX_SLOTS or shard:
                # The wide, frontier and sharded routes keep their own
                # dispatch (run_encoded_batch): drain the pipeline so
                # yields stay in dispatch order, then run blocking.
                yield from drain()
                yield blocking(mb, self._run_wide(mb))
                return
            if (self.event_route_events
                    and mb.n_events >= self.event_route_events):
                yield from drain()
                out = self._run_event_routed(mb)
                if out is not None:
                    yield blocking(mb, out)
                    return
            Bp, chunks = self._chunk_plan(mb)
            st = _Run(mb, len(chunks))
            order.append(st)
            for lo, hi in chunks:
                # While the pipeline has room a chunk ships at once
                # (keeps the card busy, first verdicts early); once
                # `depth` groups are in flight chunks accumulate and
                # ship as one group launch of up to fuse_width members.
                # With max_queue set, a full hand-off behind a full
                # pipeline forces the flush, counted as backpressure.
                self._fuse_buf.append((st, lo, hi, Bp))
                full = bool(self.max_queue
                            and len(self._fuse_buf) >= self.max_queue
                            and len(inflight) >= self.depth)
                if full:
                    self._inc("backpressure_events")
                if (len(inflight) < self.depth
                        or len(self._fuse_buf) >= self.fuse_width
                        or full):
                    yield from flush()

        it = iter(groups)
        while True:
            te = time.monotonic()
            try:
                group = next(it)
            except StopIteration:
                break
            self._inc("encode_busy_s", time.monotonic() - te)
            group = [b for b in group if b.batch]
            self._inc("input_buckets", len(group))
            if class_map is None and group:
                # Freeze on the first NON-empty group: an all-failures
                # prefix must not freeze an empty plan and silently
                # disable consolidation for the whole run.
                class_map = self._freeze_classes(group)
            fresh: Dict[Tuple[int, int], List[EncodedBatch]] = {}
            for b in group:
                key = (b.V, self._class_of(class_map, b.V, b.W))
                fresh.setdefault(key, []).append(b)
            for (V, cw), bs in sorted(fresh.items()):
                pend = acc.setdefault((V, cw), [])
                pend.extend(bs)
                rows = sum(b.batch for b in pend)
                chunk = self._class_chunk(V, cw)
                if rows >= chunk:
                    mb = merge_batches(pend, cw)
                    full = (rows // chunk) * chunk
                    yield from feed(_slice_rows(mb, 0, full))
                    acc[(V, cw)] = ([_slice_rows(mb, full, rows)]
                                    if full < rows else [])
        # Final flush of sub-chunk accumulations.
        for (V, cw), pend in sorted(acc.items()):
            if pend:
                yield from feed(merge_batches(pend, cw))
        yield from drain()
        assert not order, "every dispatched bucket must have retired"

        self.stats["wall_s"] = round(time.monotonic() - self._t0, 4)
        if self.faults is not None:
            self.stats["faults_injected"] = len(self.faults.log)
        if self.stats["events"]:
            # Scan steps saved by event fusion: original (unfused)
            # events per dispatched step, >= 1.0.
            self.stats["fusion_ratio"] = round(
                self.stats["orig_events"] / self.stats["events"], 4)
        if class_map:
            seen: Dict[Tuple[int, int], List[int]] = {}
            for (v, w), c in class_map.items():
                seen.setdefault((v, c), []).append(w)
            self.stats["classes"] = [
                {"V": v, "W": c, "folds": sorted(ws)}
                for (v, c), ws in sorted(seen.items())]
        if self._first_dispatch_t is not None and \
                self._last_retire_t is not None:
            span = self._last_retire_t - self._first_dispatch_t
            if span > 0:
                # Fraction of the device-active span the host spent NOT
                # blocked on results: 1.0 = fully pipelined, 0.0 =
                # serial.
                self.stats["overlap_ratio"] = round(
                    max(0.0, 1.0 - self.stats["device_wait_s"] / span), 4)


def _concat_pieces(pieces, return_frontier):
    """Stitch sub-range (valid, bad, frontier) pieces — each paired
    with its row count — back into one range result, preserving the
    frontier mode's shape ("invalid" dicts re-key by range offset)."""
    vs = [p[0] for p, _ in pieces]
    bs = [p[1] for p, _ in pieces]
    valid = np.concatenate(vs) if len(vs) > 1 else vs[0]
    bad = np.concatenate(bs) if len(bs) > 1 else bs[0]
    if return_frontier is True:
        frs = [p[2] for p, _ in pieces]
        fr = np.concatenate(frs) if len(frs) > 1 else frs[0]
    elif return_frontier == "invalid":
        fr = {}
        off = 0
        for (_, _, fm), n in pieces:
            for r, row in fm.items():
                fr[off + int(r)] = row
            off += n
    else:
        fr = None
    return valid, bad, fr


def _slice_rows(b: EncodedBatch, lo: int, hi: int) -> EncodedBatch:
    if lo == 0 and hi == b.batch:
        return b
    return EncodedBatch(
        ev_type=b.ev_type[lo:hi], ev_slot=b.ev_slot[lo:hi],
        ev_slots=b.ev_slots[lo:hi], ev_opidx=b.ev_opidx[lo:hi],
        target=b.target if b.shared_target else b.target[lo:hi],
        V=b.V, W=b.W, indices=list(b.indices[lo:hi]),
        failures=list(b.failures) if lo == 0 else [],
        spaces=(b.spaces[lo:hi] if b.spaces else b.spaces),
        shared_target=b.shared_target, w_live=b.w_live,
        orig_n_events=(b.orig_n_events[lo:hi]
                       if b.orig_n_events is not None else None))


# ----------------------------------------- dependency-graph scheduler

def _concat_graph_pieces(pieces):
    if len(pieces) == 1:
        return pieces[0]
    return (np.concatenate([p[0] for p in pieces]),
            np.concatenate([p[1] for p in pieces]))


class GraphScheduler:
    """Vertex-bucket scheduler for the dependency-graph closure kernels
    (ops.graph, ops.txn_graph), the reference's GraphScheduler: the
    graph twin of BucketScheduler, sharing its fault model end to end.
    Each bucket splits into chunks of ``chunk_rows`` graphs (the
    ``graph_chunk_rows`` knob, JT_GRAPH_CHUNK_ROWS); every chunk
    dispatches through the one sequence ``_ship`` (the encode and
    dispatch fault hooks, the copy to the device, the launch), is copied
    back on a daemon retire thread under a watchdog deadline priced by
    the op model (the decode fault hook there), shape-validated
    (validate_graph_decoded), and on a classified failure walks the
    ladder: bounded retry with backoff, row bisection on an
    out-of-memory (the learned size sticks per vertex bucket), and the
    poison-row hunt, whose rows are quarantined.

    ``family``/``kernel``/``levels``/``op_model`` say which closure
    family it drives: by default the anomaly planes of ops.graph
    (``close_planes``, 3 levels, ``mxu_op_model``); the isolation ladder
    passes ``close_txn_planes``, 5 and ``txn_op_model``. A ``kernel``
    takes (int32 [B, L_in, V, words(V)] planes on the device, V) and
    returns (cyc bool [B, levels], node int32 [B, levels]) there.

    Contract as in the reference: ``run(buckets)`` yields ``(bucket,
    (cyc, node))`` per non-empty bucket with numpy arrays;
    ``quarantined`` maps each row the ladder gave up on to the reason
    (its in-band verdict is an inert placeholder the caller must
    re-decide on the host oracle); ``row_provenance`` tags the rows off
    the happy path (``device-retried`` / ``host-fallback``);
    ``on_chunk(bucket, lo, hi, cyc, node)`` fires per decided chunk (the
    chunk journal's hook). ``stats`` has the reference's keys:
    ``closure_matmuls`` and ``mxu_macs`` price each dispatch as the
    reference pads it, to ``min(chunk_rows, max(8, pow2(rows)))``
    graphs, by the same op model (retries included), so that both
    packages' stats compare equal; the padding rows themselves are not
    launched here. ``timings`` holds host-clock seconds of the copy to
    the device, the launch (its enqueue), the copy back (which waits
    for the kernel) and the validation.
    """

    def __init__(self, *, chunk_rows: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 max_retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 on_chunk=None, resident: Optional[ResidentState] = None,
                 family: str = "graph", kernel=None,
                 levels: Optional[int] = None, op_model=None,
                 device=None):
        self.family = family
        self.kernel = close_planes if kernel is None else kernel
        self.levels = N_LEVELS if levels is None else int(levels)
        self.op_model = mxu_op_model if op_model is None else op_model
        self.chunk_rows = (knob("graph_chunk_rows") if chunk_rows is None
                           else max(1, int(chunk_rows)))
        self.device = resolve_device(device)
        self.on_chunk = on_chunk
        self.faults = faults if faults is not None \
            else FaultInjector.from_env()
        self.max_retries = (knob("retry_max") if max_retries is None
                            else max(0, int(max_retries)))
        if backoff_s is None and self.faults is not None:
            backoff_s = self.faults.backoff_s
        self.backoff_s = (knob("retry_backoff_s") if backoff_s is None
                          else float(backoff_s))
        self.quarantined: Dict[int, str] = {}
        self.row_provenance: Dict[int, str] = {}
        self._safe_bp: Dict[int, int] = {}
        self._awaited_shapes: set = set()
        if resident is not None:
            # Graph buckets key safe_bp by bare V (the WGL side by (V, W)),
            # so one ResidentState serves both families.
            resident.adopt(self)
        self._stats_lock = threading.Lock()
        self.stats: dict = {
            "graphs": 0, "buckets": 0, "chunks": 0,
            "closure_matmuls": 0, "mxu_macs": 0.0, "wall_s": None,
            "retries": 0, "bisections": 0, "watchdog_fired": 0,
            "oom_events": 0, "corrupt_chunks": 0, "quarantined_rows": 0,
            "faults_injected": 0,
        }
        self.timings = {"upload_s": 0.0, "launch_s": 0.0,
                        "copy_back_s": 0.0, "validate_s": 0.0}

    def _inc(self, key: str, n=1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    def _lap(self, key: str, t0: float) -> float:
        t = time.perf_counter()
        with self._stats_lock:
            self.timings[key] += t - t0
        return t

    def _fire(self, stage: str) -> Optional[str]:
        return self.faults.fire(stage) if self.faults is not None else None

    def _deadline(self, b, rows: int) -> float:
        """As BucketScheduler._deadline, priced in closure MACs."""
        if self.faults is not None and self.faults.deadline_s is not None:
            return self.faults.deadline_s
        est = rows * self.op_model(b.V)["macs"]
        d = max(knob("watchdog_min_s"),
                est / knob("watchdog_mxu_macs_per_s")
                * knob("watchdog_factor"))
        if b.V not in self._awaited_shapes:
            self._awaited_shapes.add(b.V)
            d += knob("watchdog_compile_grace_s")
        return d

    def _ship(self, b, lo: int, hi: int, Bp: int):
        """The ONE dispatch sequence of the happy path and every ladder
        re-dispatch: the encode-stage fault, the copy of rows [lo, hi) to
        the device, the dispatch-stage fault, the asynchronous launch.
        Returns (out, delay)."""
        t = time.perf_counter()
        self._fire("encode")
        adj = torch.from_numpy(np.ascontiguousarray(b.adj[lo:hi],
                                                    np.int32))
        adj = adj.to(self.device)
        t = self._lap("upload_s", t)
        delay = 0.0
        if self.faults is not None:
            delay = self.faults.sleep_for(self._fire("dispatch"))
        out = self.kernel(adj, b.V)
        m = self.op_model(b.V)
        self._inc("chunks")
        self._inc("closure_matmuls", Bp * int(m["matmuls"]))
        self._inc("mxu_macs", Bp * m["macs"])
        self._lap("launch_s", t)
        return out, delay

    def _await(self, out, nb: int, b, deadline: float,
               delay: float = 0.0):
        """Copy one dispatch back on a daemon retire thread under the
        watchdog: the decode-stage fault fires there, and the verdicts
        are shape-validated (corrupt output is a retryable fault, never a
        wrong verdict)."""
        def work():
            if delay:
                time.sleep(delay)
            kind = self._fire("decode")
            if self.faults is not None:
                s = self.faults.sleep_for(kind)
                if s:
                    time.sleep(s)
            t = time.perf_counter()
            cyc, node = out
            c, nd = cyc[:nb].cpu().numpy(), node[:nb].cpu().numpy()
            t = self._lap("copy_back_s", t)
            if kind == "corrupt":
                c, nd = corrupt_arrays(c, nd)
            if c.ndim != 2 or c.shape[1] != self.levels:
                raise CorruptOutput(f"{self.family} chunk decoded "
                                    f"{c.shape}, expected [rows, "
                                    f"{self.levels}]")
            validate_graph_decoded(c, nd, b.V)
            self._lap("validate_s", t)
            return c, nd
        return _watched(self, work, deadline,
                        f"{self.family} chunk (V={b.V}, rows={nb})")

    # ------------------------------------------------ watchdog + ladder
    def _exec_once(self, b, lo: int, hi: int, Bp: int):
        pieces = []
        for s in range(lo, hi, Bp):
            e = min(s + Bp, hi)
            out, delay = self._ship(b, s, e, Bp)
            pieces.append(self._await(out, e - s, b,
                                      self._deadline(b, Bp), delay))
        return _concat_graph_pieces(pieces)

    def _exec_retry(self, b, lo: int, hi: int, Bp: int):
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._inc("retries")
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                return self._exec_once(b, lo, hi, Bp)
            except Exception as e:
                c = classify_failure(e)
                if c is None or c == "oom":
                    raise
                if isinstance(e, CorruptOutput):
                    self._inc("corrupt_chunks")
                last = e
        raise _ChunkFailed(last)

    def _placeholder(self, n: int):
        return (np.zeros((n, self.levels), bool),
                np.full((n, self.levels), INT32_MAX, np.int32))

    def _quarantine(self, b, row: int, cause: BaseException):
        i = b.indices[row]
        reason = f"{type(cause).__name__}: {cause}"
        self.quarantined[i] = reason
        self.row_provenance[i] = "host-fallback"
        self._inc("quarantined_rows")
        log.warning("quarantining graph %s after exhausting the device "
                    "ladder (%s); the host oracle decides it", i, reason)
        return self._placeholder(1)

    def _hunt_poison(self, b, lo: int, hi: int, Bp: int):
        if hi - lo == 1:
            try:
                return self._exec_once(b, lo, hi, min(Bp, 8))
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                return self._quarantine(b, lo, e)
        mid = (lo + hi) // 2
        pieces = []
        for a, c in ((lo, mid), (mid, hi)):
            try:
                piece = self._exec_once(b, a, c, Bp)
            except Exception as e:
                if classify_failure(e) is None:
                    raise
                piece = self._hunt_poison(b, a, c, Bp)
            pieces.append(piece)
        return _concat_graph_pieces(pieces)

    def _exec_range(self, b, lo: int, hi: int, Bp: int,
                    first_cause: Optional[BaseException] = None):
        """retry → OOM row bisection (the learned size sticks per vertex
        bucket) → poison-row hunt with quarantine. Always returns a full
        (cyc, node) for the range."""
        cap = self._safe_bp.get(b.V)
        if cap:
            Bp = min(Bp, cap)
        oom = first_cause is not None and \
            classify_failure(first_cause) == "oom"
        while True:
            if not oom:
                try:
                    return self._exec_retry(b, lo, hi, Bp)
                except _ChunkFailed:
                    return self._hunt_poison(b, lo, hi, Bp)
                except Exception as e:
                    if classify_failure(e) != "oom":
                        raise
                    self._inc("oom_events")
                    oom = True
                    continue
            if Bp > 1:
                Bp = max(1, Bp // 2)
                self._inc("bisections")
                self._safe_bp[b.V] = Bp
                log.warning("OOM on graph chunk (V=%s): bisecting to %s "
                            "rows/dispatch", b.V, Bp)
                oom = False
                continue
            return self._hunt_poison(b, lo, hi, 1)

    def _recover(self, b, lo: int, hi: int, Bp: int,
                 cause: BaseException):
        if classify_failure(cause) == "oom":
            self._inc("oom_events")
        if isinstance(cause, CorruptOutput):
            self._inc("corrupt_chunks")
        log.warning("graph chunk (V=%s, rows %s:%s) failed (%s: %s); "
                    "entering the degradation ladder", b.V, lo, hi,
                    type(cause).__name__, cause)
        self._inc("retries")
        out = self._exec_range(b, lo, hi, Bp, first_cause=cause)
        for r in range(lo, hi):
            self.row_provenance.setdefault(b.indices[r], "device-retried")
        return out

    # ----------------------------------------------------------------- run
    def run(self, buckets):
        """Yield (bucket, (cyc, node)) per vertex bucket — see the class
        docstring for the contract."""
        t0 = time.monotonic()
        for b in buckets:
            if not b.batch:
                continue
            self._inc("buckets")
            self._inc("graphs", b.batch)
            pieces = []
            for lo in range(0, b.batch, self.chunk_rows):
                hi = min(lo + self.chunk_rows, b.batch)
                Bp = min(self.chunk_rows, max(8, _pow2_ceil(hi - lo)))
                # A bisection learned this bucket's memory wall: later
                # chunks dispatch under it.
                cap = self._safe_bp.get(b.V)
                if cap:
                    Bp = min(Bp, cap)
                try:
                    cyc, node = self._exec_once(b, lo, hi, Bp)
                except Exception as e:
                    if classify_failure(e) is None:
                        raise
                    cyc, node = self._recover(b, lo, hi, Bp, e)
                if self.on_chunk is not None:
                    self.on_chunk(b, lo, hi, cyc, node)
                pieces.append((cyc, node))
            yield b, _concat_graph_pieces(pieces)
        self.stats["wall_s"] = round(time.monotonic() - t0, 4)
        if self.faults is not None:
            self.stats["faults_injected"] = len(self.faults.log)


def run_buckets_streamed(batches, return_frontier=False, **kw):
    """Pipelined successor to linearize.run_buckets: the same (batch,
    out) yield contract, but the yielded buckets are the scheduler's
    consolidated W classes — scatter through batch.indices, never
    positional zips. Accepts every BucketScheduler knob."""
    sch = BucketScheduler(return_frontier=return_frontier, **kw)
    return sch.run(batches)


def iter_columnar_groups(space, cols, *, max_slots: int = 16,
                         encode_rows: int = ENCODE_ROWS,
                         failures: Optional[list] = None,
                         fuse: bool = False, renumber: bool = False):
    """Chunked columnar encode: yield bucket groups of ``encode_rows``
    rows each, with indices remapped to the full batch — the streaming
    source for BucketScheduler.run, so the encode walk of group k+1 runs
    while the card still works on group k. Overflow failures append to
    ``failures`` as (row, reason). ``fuse``/``renumber`` enable the
    encode-side shrink passes (ops.encode)."""
    from .encode import encode_columnar
    rows = cols.batch
    # One composed-kind registry across all groups: stable fused ids
    # with append-only table content, so the scheduler can merge
    # buckets from different groups under ONE shared target table.
    fuse_registry = {} if fuse else None
    for lo in range(0, rows, encode_rows):
        hi = min(lo + encode_rows, rows)
        sub = type(cols)(
            type=cols.type[lo:hi], process=cols.process[lo:hi],
            kind=cols.kind[lo:hi], kinds=cols.kinds,
            index=cols.index[lo:hi] if cols.index is not None else None)
        buckets, fails = encode_columnar(space, sub, max_slots=max_slots,
                                         fuse=fuse, renumber=renumber,
                                         fuse_registry=fuse_registry)
        for b in buckets:
            b.indices = [i + lo for i in b.indices]
            b.failures = []
        if failures is not None:
            failures.extend((i + lo, why) for i, why in fails)
        yield buckets


def iter_synth_groups(space, spec, *, max_slots: int = 16,
                      rows_per_group: int = ENCODE_ROWS,
                      partition: bool = True,
                      failures: Optional[list] = None,
                      fuse: bool = False, renumber: bool = False,
                      device=None):
    """Device synthesis as a scheduler source: generate → partition →
    encode in row groups, so group k+1 synthesizes while the card still
    works on group k and no full batch ever materializes. ``spec`` is an
    ops.synth_device.SynthSpec of the cas or wide family; the generator
    keys by global row id, so grouped generation is bit-identical to
    one-shot generation at any group size.

    Keyed specs strain each group through the per-key pre-partition;
    yielded bucket indices are then global SUB ordinals (ascending
    (history, key) within a group, groups in row order). Unkeyed specs
    yield global history rows, like iter_columnar_groups. ``space`` must
    be enumerated over the family's kind vocabulary. Overflow failures
    append to ``failures`` in the same index namespace."""
    from .encode import encode_columnar
    from .partition import partition_columnar
    from .synth_device import synthesize
    if spec.family not in ("cas", "wide"):
        raise ValueError(f"synth groups take the cas and wide families, "
                         f"not {spec.family!r}")
    fuse_registry = {} if fuse else None
    base = 0
    for lo in range(0, spec.n, rows_per_group):
        hi = min(lo + rows_per_group, spec.n)
        cols, _meta = synthesize(spec, rows=(lo, hi), key_meta=False,
                                 device=device)
        if partition and getattr(cols, "key", None) is not None:
            pb = partition_columnar(cols)
            if pb is not None:
                cols = pb.cols
        buckets, fails = encode_columnar(space, cols,
                                         max_slots=max_slots,
                                         fuse=fuse, renumber=renumber,
                                         fuse_registry=fuse_registry)
        for b in buckets:
            b.indices = [i + base for i in b.indices]
            b.failures = []
        if failures is not None:
            failures.extend((i + base, why) for i, why in fails)
        base += cols.batch
        yield buckets
