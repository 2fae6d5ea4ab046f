"""Decrease-and-conquer peel loop: a certifying pre-filter for the
register class, and the router's W-flat WGL backend.

Every frontier backend pays ``events * 2^W``: the packed frontier
enumerates the pending window's powerset. "Efficient Decrease-and-Conquer
Linearizability Monitoring" (arXiv 2410.04581) shows the register class
never needs the powerset: repeatedly *peel* an extremal value cluster (a
write and the reads that observed it) whose members can all linearize
before everything still alive; the history is valid iff peeling runs to
exhaustion. Cost is near-linear in events and flat in W, exactly the
unkeyed wide-window tail (W 11+) where the frontier search is dearest.

A copy of the reference's ``ops/dc_monitor.py``, trimmed to what the
batch path, the router and the online daemon run:

  * ``dc_plan(batch)`` derives, from the ``EncodedBatch`` alone and on
    the host, each op's invocation event (the first snapshot holding
    it), its response event (its completion's own index) and its value
    cluster (the event of the write whose target state the op's kind
    requires). Capability comes from the row's transition table: a
    "write" is a kind valid from every state with one target, a "read" a
    kind that is the identity on exactly one state. Rows with fused
    events, pinned (info) ops at the close, duplicate written values,
    reads of a never-written value, cas-like kinds or a read responding
    before its write is invoked are not capable and ride the frontier
    search unchanged.
  * the peel loop itself is K4: ``dc_peel`` in ``csrc/dc_peel.cu``
    (``ops/cuda_dc.py``) on the card, ``plain_dc_peel`` on CPU tensors,
    bit for bit the reference's ``get_dc_kernel`` in ``decided`` and
    ``rounds``; ``dc_host_decide`` is the reference's numpy twin.
  * the loop only ever certifies validity ("every op peeled"). Stuck or
    incapable rows, the residue, fall through to the frontier search in
    the scheduler's one ``_ship`` sequence, so invalid verdicts, bad ops
    and counterexamples keep exact parity with the frontier-only path.

Soundness of a peel: let Z be value v's cluster, I the largest
invocation over Z and t_out the earliest response among alive ops
outside Z. If I <= t_out, every member of Z can take its linearization
point just after I, inside its own interval and before every remaining
op's response, and any valid linearization of the remainder re-places
above I. Conversely a valid history always has a peelable cluster: the
one holding the first-linearized write. So "peeled to exhaustion" is
"valid" for capable rows; stuck rows are left to the scan, which owns
the counterexample.

``IncrementalDC`` is the peel loop at the online daemon's delta tick
($JT_ONLINE_DC=1, default off): host numpy over the ops since the last
quiescent cut, certify-only; a tick it cannot serve falls through to
the resident frontier with verdicts unchanged.

``JT_ROUTER_DC=0`` removes the backend from pricing, routing and forced
dispatch; with no probed or pinned ``dc_events_per_s`` rate the router
never selects it, so default routing is unchanged.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_dc
from .device import resolve_device, time_launch
from .encode import EV_CLOSE, EV_FUSED, EV_OK, EncodedBatch

_BIG = np.int32(1 << 30)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length()


# ------------------------------------------------------------- gates

def dc_available() -> bool:
    """$JT_ROUTER_DC=0 removes the peel backend from pricing, auto
    routing and forced dispatch alike."""
    return os.environ.get("JT_ROUTER_DC", "1") != "0"


def dc_max_rounds() -> int:
    """$JT_DC_MAX_ROUNDS caps peel rounds per dispatch (0 = the sound
    structural bound, one round per event plus one). A lower cap turns
    slow-converging rows into residue for the scan."""
    try:
        return max(0, int(os.environ.get("JT_DC_MAX_ROUNDS", "0")))
    except ValueError:
        return 0


def dc_residue_max_frac() -> float:
    """$JT_DC_RESIDUE_MAX_FRAC: in auto routing the pre-filter engages
    only when at most this fraction of a bucket's rows would fall
    through to the scan anyway (capability measured on the real plan):
    a mostly-incapable bucket must not pay peel plus scan."""
    try:
        return min(1.0, max(0.0, float(
            os.environ.get("JT_DC_RESIDUE_MAX_FRAC", "0.5"))))
    except ValueError:
        return 0.5


def online_dc_enabled() -> bool:
    """$JT_ONLINE_DC=1 wires the incremental peel monitor into the
    online daemon's delta tick (default off: the daemon's default
    behaviour stays bit-identical)."""
    return os.environ.get("JT_ONLINE_DC", "0") != "0"


# ------------------------------------------------- history-level sniff

def dc_capable_history(history) -> bool:
    """Cheap Op-list sniff the router prices from (the real decision
    replays on the encoded plan): every client op completes ok, ops are
    plain read/write, written values are distinct, and every observed
    read value was written. False only means the router does not price
    the peel backend for this unit."""
    writes: set = set()
    reads: List[object] = []
    open_inv: Dict[object, str] = {}
    for op in history:
        if not getattr(op, "is_client", True):
            continue
        if op.type == "invoke":
            if op.f not in ("read", "write"):
                return False
            open_inv[op.process] = op.f
        elif op.type == "ok":
            open_inv.pop(op.process, None)
            if op.f == "write":
                if op.value in writes:
                    return False
                writes.add(op.value)
            elif op.f == "read":
                if op.value is not None:
                    reads.append(op.value)
            else:
                return False
        else:                      # fail/info: pending forever
            return False
    if open_inv:
        return False
    return all(v in writes for v in reads)


# ---------------------------------------------------- space capability

def _space_roles(space) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]:
    """Classify one StateSpace's kinds from its transition table:
    (is_write[K], is_read[K], state_of[K]), a write being a constant map
    valid from every state (state_of = its target) and a read the
    identity on exactly one state (state_of = it); None when a
    non-identity kind fits neither role (cas-like). Identity kinds have
    both flags False and constrain nothing."""
    tgt = np.asarray(space.target)
    K, S = tgt.shape
    is_w = np.zeros(K, bool)
    is_r = np.zeros(K, bool)
    st = np.full(K, -1, np.int32)
    ident = space.identity_kinds
    states = np.arange(S)
    for k in range(K):
        row = tgt[k]
        if k in ident:
            continue
        if (row >= 0).all() and len(np.unique(row)) == 1:
            is_w[k] = True
            st[k] = int(row[0])
        else:
            ok = row == states
            if int(ok.sum()) == 1 and (row[~ok] < 0).all():
                is_r[k] = True
                st[k] = int(states[ok][0])
            else:
                return None
    return is_w, is_r, st


# ----------------------------------------------------------- the plan

@dataclass
class DCPlan:
    """Host-derived peel-loop inputs for one encoded bucket. Ops are
    indexed by their completion event (one event per ok completion), so
    an op's response time is its event index."""

    inv: np.ndarray        # int32 [B, E] first-appearance event index
    cluster: np.ndarray    # int32 [B, E] event index of the value's write
    active: np.ndarray     # bool  [B, E] capable-row op events
    capable: np.ndarray    # bool  [B]

    @property
    def capable_frac(self) -> float:
        b = len(self.capable)
        return float(self.capable.sum()) / b if b else 0.0


def dc_plan(batch: EncodedBatch) -> Optional[DCPlan]:
    """The peel plan from the encoded arrays alone: invocation events from
    a per-slot first-seen walk over the snapshots (reset at each
    completion of the slot; the snapshot at a completion still holds the
    completing op), value clusters from the transition-table roles. None
    when no row is capable or the batch carries no spaces."""
    if not batch.spaces or len(batch.spaces) != batch.batch:
        return None
    B, E = batch.ev_type.shape
    K = batch.target.shape[1] - 1              # empty-slot sentinel
    etype = np.asarray(batch.ev_type)
    eslot = np.asarray(batch.ev_slot).astype(np.int64)
    slots = np.asarray(batch.ev_slots)

    capable = ~(etype == EV_FUSED).any(axis=1)
    is_ok = etype == EV_OK
    # The close snapshot is the end-of-history pending table: pinned
    # info ops stay optional to linearize forever, which the peel loop
    # does not model.
    close = etype == EV_CLOSE
    has_close = close.any(axis=1)
    capable &= has_close
    ci = np.argmax(close, axis=1)
    capable &= (slots[np.arange(B), ci] == K).all(axis=1)

    # The completing op's kind per event: the snapshot row at its slot.
    kind = np.take_along_axis(slots, eslot[:, :, None],
                              axis=2)[:, :, 0].astype(np.int64)
    kind = np.where(is_ok, kind, K)

    # Per-slot first-seen walk -> invocation event index per op.
    inv = np.zeros((B, E), np.int32)
    occ = np.full((B, batch.ev_slots.shape[2]), -1, np.int32)
    comp = is_ok | (etype == EV_FUSED)
    for e in range(E):
        snap = slots[:, e, :]
        newly = (snap != K) & (occ < 0)
        occ[newly] = e
        r = np.flatnonzero(comp[:, e])
        if r.size:
            s = eslot[r, e]
            inv[r, e] = occ[r, s]
            occ[r, s] = -1

    active = np.zeros((B, E), bool)
    cluster = np.full((B, E), -1, np.int32)

    # Group rows by their StateSpace: role tables are per vocabulary.
    by_space: Dict[int, List[int]] = {}
    spaces: Dict[int, object] = {}
    for b in np.flatnonzero(capable):
        sp = batch.spaces[b]
        by_space.setdefault(id(sp), []).append(int(b))
        spaces[id(sp)] = sp
    for sid, rws in by_space.items():
        sp = spaces[sid]
        roles = _space_roles(sp)
        r = np.asarray(rws)
        if roles is None:
            capable[r] = False
            continue
        is_w, is_r, st = roles
        nk = len(is_w)
        k = kind[r]                      # [b, E], sentinel K when pad
        known = k < nk
        # Fused-composed or foreign kind ids under a merged table.
        capable[r[((k != K) & ~known).any(axis=1)]] = False
        k = np.where(known, k, 0)
        w_ev = known & is_w[k] & is_ok[r]
        r_ev = known & is_r[k] & is_ok[r]
        act = w_ev | r_ev                # identity kinds drop out
        val = np.where(act, st[k], -1)   # register state == value id
        S = sp.n_states
        # One write per target state per row; duplicates: incapable.
        wcount = np.zeros((len(r), S), np.int64)
        bw, ew = np.nonzero(w_ev)
        np.add.at(wcount, (bw, val[bw, ew]), 1)
        capable[r[(wcount > 1).any(axis=1)]] = False
        wpos = np.full((len(r), S), -1, np.int32)
        wpos[bw, val[bw, ew]] = ew
        cl = np.where(act, wpos[np.arange(len(r))[:, None],
                                np.clip(val, 0, S - 1)], -1)
        # A read of a never-written (initial) state: incapable, the
        # virtual initial write has no interval to peel against.
        capable[r[(act & (cl < 0)).any(axis=1)]] = False
        # Static order: a read's write must be invoked before the read
        # responds, else the history cannot be valid; the scan decides
        # it and finds the witness.
        inv_w = inv[r[:, None], np.clip(cl, 0, E - 1)]
        bad = act & (cl >= 0) & (inv_w > np.arange(E)[None, :])
        capable[r[bad.any(axis=1)]] = False
        active[r] = act
        cluster[r] = cl

    active &= capable[:, None]
    if not capable.any():
        return None
    return DCPlan(inv=inv, cluster=np.where(active, cluster, 0),
                  active=active, capable=capable)


_PLAN_MISS = object()


def dc_plan_for(batch: EncodedBatch) -> Optional[DCPlan]:
    """Per-batch memo of ``dc_plan``, kept on the batch object: chunks
    of one bucket share one plan."""
    p = getattr(batch, "_dc_plan", _PLAN_MISS)
    if p is _PLAN_MISS:
        p = dc_plan(batch)
        batch._dc_plan = p
    return p


# ------------------------------------------------------ the host twin

def dc_host_decide(inv: np.ndarray, cluster: np.ndarray,
                   active: np.ndarray,
                   max_rounds: int = 0) -> np.ndarray:
    """The reference's numpy parity oracle for the peel loop: the same
    round structure (segment folds, two minima, batch peel), a row at a
    time. Returns decided-valid [B] bool."""
    B, E = active.shape
    resp = np.arange(E, dtype=np.int32)
    cap = max_rounds or E + 1
    decided = np.zeros(B, bool)
    for b in range(B):
        alive = active[b].copy()
        rounds = 0
        while alive.any() and rounds < cap:
            rounds += 1
            cl = cluster[b]
            m_resp = np.full(E, _BIG, np.int32)
            np.minimum.at(m_resp, cl[alive], resp[alive])
            m_inv = np.full(E, -1, np.int32)
            np.maximum.at(m_inv, cl[alive], inv[b][alive])
            has = m_resp < _BIG
            a1 = int(np.argmin(m_resp))
            g1 = m_resp[a1]
            m2 = m_resp.copy()
            m2[a1] = _BIG
            g2 = m2.min()
            t_out = np.where(np.arange(E) == a1, g2, g1)
            peel = has & (m_inv <= t_out)
            new_alive = alive & ~peel[cl]
            if (new_alive == alive).all():
                break
            alive = new_alive
        decided[b] = not alive.any()
    return decided


# ------------------------------------------------------ the peel loop

def plain_dc_peel(inv: torch.Tensor, cluster: torch.Tensor,
                  active: torch.Tensor, max_rounds: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K4 on CPU tensors: ``inv``,
    ``cluster`` int32 [B, E] (cluster in [0, E)), ``active`` bool [B, E]
    -> (decided bool [B], rounds int32 [B]), bit for bit the reference's
    ``get_dc_kernel(E, max_rounds)``. Each round runs over the rows still
    going: a scatter-min of alive ops' event index and a scatter-max of
    their invocation by cluster, the two smallest cluster minima as the
    outside bound, and one gather killing every peelable cluster. A row
    stops on no progress, on no alive op or at the cap (``max_rounds``,
    else E + 1); ``rounds`` counts its round bodies, the last one without
    progress included."""
    if inv.device.type != "cpu":
        raise ValueError(f"plain_dc_peel runs on CPU tensors, got "
                         f"{inv.device}; cuda_dc.dc_peel is the kernel")
    B, E = active.shape
    cap = max_rounds or E + 1
    big = int(_BIG)
    cluster = cluster.long()
    alive = active.clone()
    rounds = torch.zeros(B, dtype=torch.int32)
    resp = torch.arange(E, dtype=torch.int32)
    idx = torch.arange(E)
    running = alive.any(dim=1)
    while bool(running.any()):
        r = running.nonzero().squeeze(1)
        a, cl = alive[r], cluster[r]
        n = len(r)
        at = torch.where(a, cl, 0)
        m_resp = torch.full((n, E), big, dtype=torch.int32).scatter_reduce_(
            1, at, torch.where(a, resp, big).to(torch.int32), "amin",
            include_self=True)
        m_inv = torch.full((n, E), -1, dtype=torch.int32).scatter_reduce_(
            1, at, torch.where(a, inv[r], -1).to(torch.int32), "amax",
            include_self=True)
        a1 = m_resp.argmin(dim=1, keepdim=True)
        g1 = m_resp.gather(1, a1)
        g2 = m_resp.scatter(1, a1, big).min(dim=1, keepdim=True).values
        t_out = torch.where(idx[None, :] == a1, g2, g1)
        peel = (m_resp < big) & (m_inv <= t_out)
        new_alive = a & ~peel.gather(1, cl)
        prog = (new_alive != a).any(dim=1)
        alive[r] = new_alive
        rounds[r] += 1
        running[r] = prog & new_alive.any(dim=1) & (rounds[r] < cap)
    return ~alive.any(dim=1), rounds


def pad_plan(inv: np.ndarray, cluster: np.ndarray, active: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's padding: B and E up to powers of two, padding ops
    inactive, ``cluster`` clipped to [0, Ep)."""
    B, E = active.shape
    Bp, Ep = _pow2(max(B, 1)), _pow2(max(E, 1))
    pinv = np.zeros((Bp, Ep), np.int32)
    pcl = np.zeros((Bp, Ep), np.int32)
    pact = np.zeros((Bp, Ep), bool)
    pinv[:B, :E] = inv
    pcl[:B, :E] = np.clip(cluster, 0, Ep - 1)
    pact[:B, :E] = active
    return pinv, pcl, pact


def dc_decide(inv: np.ndarray, cluster: np.ndarray, active: np.ndarray,
              *, device=None, rounds_out: Optional[list] = None
              ) -> np.ndarray:
    """Run the peel loop over plan rows, padded as the reference pads
    them, on ``device`` (the card unless the caller names another).
    Returns decided-valid [B] bool: True only for rows every op of which
    was peeled. ``rounds_out``, when given a list, gets the rows' round
    counts."""
    device = resolve_device(device)
    B = active.shape[0]
    pinv, pcl, pact = pad_plan(inv, cluster, active)
    ts = [torch.from_numpy(a).to(device) for a in (pinv, pcl, pact)]
    cap = dc_max_rounds()
    if device.type == "cuda":
        # K4 launches or raises; the plain version runs on CPU tensors.
        decided, rounds = cuda_dc.dc_peel(*ts, cap or pinv.shape[1] + 1)
    else:
        decided, rounds = plain_dc_peel(*ts, cap)
    if rounds_out is not None:
        rounds_out.extend(rounds[:B].cpu().tolist())
    return decided[:B].cpu().numpy()


def dc_prefilter_chunk(batch: EncodedBatch, lo: int, hi: int, *,
                       device=None) -> Optional[np.ndarray]:
    """The scheduler's per-chunk entry: peel rows [lo, hi) of a bucket.
    Returns decided-valid [hi - lo] bool (False = residue, the scan
    decides), or None when the chunk has no capable row (the dispatch
    proceeds as before)."""
    plan = dc_plan_for(batch)
    if plan is None or not plan.capable[lo:hi].any():
        return None
    decided = dc_decide(plan.inv[lo:hi], plan.cluster[lo:hi],
                        plan.active[lo:hi], device=device)
    return decided & plan.capable[lo:hi]


# --------------------------------------------------------- rate probe

def make_probe_plan(rows: int = 64, events: int = 128,
                    w: int = 12) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """A deterministic dc-capable synthetic plan (inv, cluster, active)
    shaped like the unkeyed wide-window workload: W-overlapped
    write+read pairs, every cluster peelable. The rate probe times the
    kernel on it."""
    E = events - (events % 2)
    inv = np.maximum(0, np.arange(E, dtype=np.int32) - int(w) + 1)
    cluster = (np.arange(E, dtype=np.int32) // 2) * 2
    active = np.ones(E, bool)
    return (np.broadcast_to(inv, (rows, E)).copy(),
            np.broadcast_to(cluster, (rows, E)).copy(),
            np.broadcast_to(active, (rows, E)).copy())


def probe_rates(rows: int = 64, events: int = 128, repeats: int = 3, *,
                device=None) -> Dict[str, object]:
    """The peel loop's event rate (events/s across the batch) on the
    synthetic wide-window plan, the router's ``dc_events_per_s``: on the
    card the kernel alone by CUDA events, on the CPU the plain version
    by the host clock; best of ``repeats`` after a warm-up. Includes a
    parity bit against ``dc_host_decide`` on the probe itself; a probe
    that disagrees reports rate 0, which prices the backend out."""
    out: Dict[str, object] = {"dc_events_per_s": 0.0, "probe_s": 0.0,
                              "parity": None}
    if not dc_available():
        return out
    device = resolve_device(device)
    t0 = time.monotonic()
    plan = make_probe_plan(rows=rows, events=events)
    ts = [torch.from_numpy(a).to(device) for a in pad_plan(*plan)]
    cap = dc_max_rounds()
    got: list = []
    if device.type == "cuda":
        launch, decided, _ = cuda_dc.prepare(*ts, cap or ts[0].shape[1] + 1)
        got.append(decided)
    else:
        def launch():
            got[:] = [plain_dc_peel(*ts, cap)[0]]
    best = time_launch(launch, device, repeats)
    dev = got[0]
    host = dc_host_decide(*plan)
    out["parity"] = bool((dev[:rows].cpu().numpy() == host).all())
    if best and best > 0 and out["parity"]:
        out["dc_events_per_s"] = (rows * events) / best
    out["probe_s"] = round(time.monotonic() - t0, 4)
    return out


def router_prefers_dc(w: int, n_events: int, rows: int,
                      rates: Optional[dict] = None, *,
                      device=None) -> bool:
    """Would the cost router run the peel pre-filter for this bucket
    shape? True when the dc term prices below the frontier search (the
    pre-filter's worst case adds its cost to the scan's, so it must be
    cheap beside the scan to be worth skipping scans with)."""
    from ..fleet import CostRouter
    costs = CostRouter(rates=rates, device=device).price_wgl(
        w, n_events, rows, dc=True)
    dc = costs.get("wgl-dc")
    return dc is not None and dc < costs["wgl-device"]


# ------------------------------------------------------ batch checking

def dc_check_batch(model, histories: Sequence, *,
                   details: object = "invalid", device=None) -> List[dict]:
    """Check a batch with the peel pre-filter pinned on
    (``wgl_backend="dc"``): decided chunks skip their frontier launch,
    residue rides the unchanged search inside the same dispatch. Rows
    whose scan was skipped carry ``provenance="wgl-dc"``; residue rows
    keep the scan's provenance. The reference-parity seam of the dc
    path; ``fleet.route_check`` makes the same pinned call inline for its
    ``wgl-dc`` group, as the reference's does."""
    from .linearize import check_batch_columnar
    rs = check_batch_columnar(model, histories, details=details,
                              device=device,
                              scheduler_opts={"wgl_backend": "dc"})
    for r in rs:
        r.setdefault("provenance", "wgl-dc")
    return rs


# --------------------------------------------- incremental (online) DC

class IncrementalDC:
    """The peel loop's decrement structure at the online daemon's
    ResidentFrontier seam ($JT_ONLINE_DC): each tick peels only the
    carried segment — the ops since the last *quiescent cut* — plus
    whatever arrived since the last tick, never the whole prefix.

    The cut rule is the soundness anchor: when a tick certifies the
    carry AND no invocation is open, the entire carry seals (drops)
    and its OVERWRITTEN values are remembered; the current epoch's
    write — when real time makes it the unique final — re-carries as
    a cut-pinned pseudo-write so live-value reads stay served. Everything after the cut
    is invoked in real time after everything before it responded, so
    a witness for the suffix composes with the sealed prefix's
    witness by pure concatenation — writes are valid from every
    state, suffix reads must observe suffix writes, and any late op
    touching a sealed value latches the carry undecided (the full
    engine owns that verdict; this monitor only ever *certifies*).

    ``advance`` returns True only for a certified-valid prefix and
    None whenever it cannot serve the tick — the caller falls through
    to the resident frontier, verdicts unchanged. Callers must drop
    the carry on ANY mid-advance fault (the engine's soundness guard
    does), exactly like the frontier itself."""

    def __init__(self):
        self.pos = 0                   # consumed history lines
        self.dead = False
        self.sealed_values: set = set()
        self._open: Dict[object, Tuple[str, object, int]] = {}
        # carried completed client ops since the cut: (inv, resp, f, v)
        self.ops: List[Tuple[int, int, str, object]] = []
        self.last_delta_ops = 0
        self.seals = 0

    def _latch(self) -> None:
        self.dead = True
        self.ops = []

    def advance(self, history: Sequence) -> Optional[bool]:
        if self.dead:
            return None
        new = history[self.pos:]
        self.last_delta_ops = len(new)
        t = self.pos
        for op in new:
            if getattr(op, "is_client", True):
                if op.type == "invoke":
                    if op.f not in ("read", "write"):
                        self._latch()
                        return None
                    self._open[op.process] = (op.f, op.value, t)
                elif op.type == "ok":
                    ent = self._open.pop(op.process, None)
                    if ent is None:
                        self._latch()
                        return None
                    f, _, inv_t = ent
                    if op.value in self.sealed_values:
                        # A late op on a sealed epoch: either invalid
                        # or beyond this monitor — never certified.
                        self._latch()
                        return None
                    if f == "read" and op.value is None:
                        # A read of the initial state: once any write
                        # sealed the initial value is history, and
                        # before that the peel order would need a
                        # virtual epoch — outside this monitor's
                        # class either way (the full engine decides).
                        self._latch()
                        return None
                    # Times are doubled so a cut-pinned pseudo-write
                    # can sit STRICTLY between two history lines.
                    self.ops.append((2 * inv_t, 2 * t, f, op.value))
                else:                   # fail / info: pending forever
                    self._latch()
                    return None
            t += 1
        self.pos = len(history)
        writes = [v for (_, _, f, v) in self.ops if f == "write"]
        if len(set(writes)) != len(writes):
            self._latch()
            return None
        vals = set(writes)
        # Reads must observe carried (completed) writes: a read of a
        # still-pending write means the completed part alone is not
        # the whole story — not servable this tick, maybe the next.
        for (_, _, f, v) in self.ops:
            if f == "read" and v is not None and v not in vals:
                return None
        if not self._run_peel():
            return None
        if not self._open:
            # Quiescent cut: the certified carry seals wholesale —
            # except the CURRENT epoch. When one carried write strictly
            # follows every other carried write in real time, EVERY
            # valid linearization ends with it, so its value is the
            # register's unique state at the cut: it re-carries as a
            # zero-width pseudo-write pinned just before the cut and
            # later reads of the live value keep being served. An
            # ambiguous final (overlapping tail writes) seals
            # everything — conservative, still sound.
            ws = [(i_, r_, v) for (i_, r_, f, v) in self.ops
                  if f == "write"]
            cur = None
            if ws:
                cand = max(ws, key=lambda e: e[0])
                if all(cand[0] > r_ for (i_, r_, _) in ws
                       if (i_, r_) != (cand[0], cand[1])):
                    cur = cand[2]
            self.sealed_values |= {v for v in vals if v != cur}
            cut = 2 * self.pos - 1
            self.ops = ([] if cur is None
                        else [(cut, cut, "write", cur)])
            self.seals += 1
        return True

    def _run_peel(self) -> bool:
        """Host peel over the carry. Open invocations are simply not
        linearized — a valid completed part IS a valid prefix (the
        pending set stays pending), so excluding them is sound for a
        monitor that only certifies."""
        if not self.ops:
            return True
        n = len(self.ops)
        inv = np.fromiter((o[0] for o in self.ops), np.int64, n)
        resp = np.fromiter((o[1] for o in self.ops), np.int64, n)
        wid = {v: k for k, (_, _, f, v) in enumerate(self.ops)
               if f == "write"}
        cl = np.fromiter((wid[o[3]] for o in self.ops), np.int64, n)
        alive = np.ones(n, bool)
        # Within-cluster feasibility, aggregated PER CLUSTER: the
        # write must be invoked before every member read responds
        # (inv_w < resp_r), or no linearization point exists and the
        # cluster can never peel — the carry stays undecided and the
        # tick answers None (the full engine owns the verdict).
        bad = np.zeros(n, bool)
        np.logical_or.at(bad, cl, inv[cl] > resp)
        while alive.any():
            m_resp = np.full(n, _BIG, np.int64)
            np.minimum.at(m_resp, cl[alive], resp[alive])
            m_inv = np.full(n, -1, np.int64)
            np.maximum.at(m_inv, cl[alive], inv[alive])
            a1 = int(np.argmin(m_resp))
            m2 = m_resp.copy()
            m2[a1] = _BIG
            t_out = np.where(np.arange(n) == a1, m2.min(), m_resp[a1])
            peel = (m_resp < _BIG) & (m_inv <= t_out) & ~bad
            new_alive = alive & ~peel[cl]
            if (new_alive == alive).all():
                return False
            alive = new_alive
        return True
