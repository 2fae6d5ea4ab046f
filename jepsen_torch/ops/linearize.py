"""Packed-frontier WGL linearizability check on torch tensors.

The WGL configuration set (see jepsen_torch.checkers.linearizable for the
algorithm spec; the reference delegates the same search to Knossos at
jepsen/src/jepsen/checker.clj:82-107) is a *state-packed* boolean
frontier: config (state s, linearized-pending-set m) is bit ``s % 32`` of
word ``F[s // 32][m]``, one int32 bit pattern per (word, mask), with
``m`` ranging over all 2^W subsets of the W pending-op slots. The host
encoder (ops.encode) reduces a history to ok-completion events, each
carrying a snapshot of the pending-slot table, and the device walks the
events in order:

  * close F under application of pending ops: for each occupied slot i,
    (s, m without i) → (target[s], m | i), to fixpoint;
  * keep exactly the configs whose mask holds the completing slot's bit,
    cleared. An empty survivor set means the completed op cannot be
    linearized: the history is invalid, the event index is recorded, and
    the pre-completion closure is latched so the host can decode a
    Knossos-style counterexample config sample.

Two implementations of that step exist, and ``get_kernel`` picks by the
device of the tensors it is given: on a CUDA tensor the hand-written
kernel (ops.cuda_wgl, ``csrc/wgl_frontier.cu``) launches or raises; on a
CPU tensor ``plain_wgl``, the plain PyTorch version, runs. Both take and
return the same carry ``(F, Fb, valid, bad)``, so one entry serves the
one-shot check, the event-chunked walk and carried frontiers.
``get_fused_kernel`` does the same for a dispatch group of several
bucket chunks: the CUDA group entry in one launch, or ``plain_fused_wgl``.

The entry points (``check_batch``, ``check_one``, ``check_columnar``,
``check_batch_columnar``, ``check_synth``) stream through the bucket
scheduler (ops.schedule) by default, after the per-key pre-partition
(ops.partition); ``scheduler=False`` keeps the exact-W flow, the parity
oracle. Rows the card does not decide go to the host engines: the C++
batch engine (jepsen_torch.native) for small buckets
(``min_device_batch``) and for the verdicts of rows that failed inside a
fused run, ``wgl_check`` (or the caller's ``host_fallback``) for the
rows that need a full result dict.

Packed words are int32 bit patterns throughout (torch has no CPU shifts
on uint32); they are viewed as uint32 only at the numpy boundary, which
keeps frontiers and the journal format identical to the reference's.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checkers.linearizable import prepare_history, wgl_check
from ..history.core import index as index_history
from ..history.ops import Op
from ..models.core import Model
from . import cuda_wgl
from .cuda_wgl import n_state_words
from .device import resolve_device, time_launch
from .encode import (EV_CLOSE, EV_FUSED, EV_OK, EncodedBatch, bucket_encode,
                     slot_ops_at_event)
from .faults import INT32_MAX

# Widest state space the packed kernel accepts: two 32-state words.
MAX_PACKED_STATES = cuda_wgl.MAX_STATES

# Frontier-words budget per device launch: B * words(V) * 2^W int32.
MAX_FRONTIER_ELEMENTS = 1 << 26

# Pending-window width of the main route ("data1"); wider windows split
# their mask axis over 2^(W - DATA_MAX_SLOTS) frontier devices of the
# production mesh ("frontier", jepsen_torch.parallel.frontier). Without
# enough devices one card still hosts SINGLE_DEVICE_EXTRA_SLOTS more
# ("data1wide", frontier in device memory instead of shared memory);
# wider windows raise WindowOverflow and their rows go to the host
# engine.
DATA_MAX_SLOTS = 16
SINGLE_DEVICE_EXTRA_SLOTS = 2

# Batches below this many rows per device stay on one device: the
# batch-sharded route's default floor ($JT_SHARD_MIN_ROWS,
# parallel.mesh.shard_min_rows).
MIN_ROWS_PER_DEVICE = 8

# (route, V, W, B) per bucket dispatch — "data1" (one device),
# "data1wide", "dataN" (batch sharded over the mesh), "frontier" (mask
# axis sharded); tests assert the route taken.
DISPATCH_LOG: "deque" = deque(maxlen=256)

_PROD_MESHES: Dict[tuple, object] = {}


class WindowOverflow(Exception):
    """A cost bucket's pending window exceeds what the devices can host; the
    rows belong on the host engine."""


def _w_live(W: int, w_live: Optional[int]) -> int:
    return W if w_live is None else max(1, min(int(w_live), W))


# ------------------------------------------------------ the plain version

def _bit_table(device) -> torch.Tensor:
    """int32 bit patterns of 1 << s for s in 0..31."""
    return torch.tensor([1 << s for s in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)


def pack_rows(target: torch.Tensor, V: int) -> torch.Tensor:
    """Lower a transition table to packed one-hot target rows.

    target: [..., K1, V] int32 (-1 = inconsistent; final row = empty-slot
    sentinel, all -1). Returns [words(V), ..., K1, V] int32: entry
    [w, ..., k, s] has bit (target[k, s] - 32w) set when the target state
    lands in word w, else 0.
    """
    bits = _bit_table(target.device)
    out = []
    for w in range(n_state_words(V)):
        t = target - 32 * w
        in_word = (t >= 0) & (t < 32)
        out.append(torch.where(in_word, bits[t.clamp(0, 31).long()],
                               torch.zeros((), dtype=torch.int32,
                                           device=target.device)))
    return torch.stack(out)


def _unpack_states(words: torch.Tensor, V: int) -> torch.Tensor:
    """[B, NW, P] packed words → [B, P, V] float 0/1 of states 0..V-1."""
    s = torch.arange(V, device=words.device)
    bits = (words[:, s >> 5, :] >> (s & 31)[None, :, None]) & 1
    return bits.transpose(1, 2).to(torch.float32)


def _pack_states(bits: torch.Tensor, NW: int) -> torch.Tensor:
    """[B, P, NW*32] bool → [B, NW, P] int32 packed words."""
    B, P = bits.shape[:2]
    x = bits.reshape(B, P, NW, 32).to(torch.int64)
    val = (x << torch.arange(32, device=bits.device)).sum(-1)
    val = torch.where(val >= 2**31, val - 2**32, val).to(torch.int32)
    return val.permute(0, 2, 1)


def _transition(src: torch.Tensor, rows: torch.Tensor,
                V: int) -> torch.Tensor:
    """T(src): each packed config of ``src`` [B, NW, P] mapped to the OR
    of its states' target rows. ``rows`` holds each source state's
    packed target row, either as int32 words [B, V, NW] (a loop over
    states, the CPU's form) or unpacked as float [B, V, NW*32] (a 0/1
    matrix product, for a device where each operation is a kernel
    launch; counts <= 64 are exact in any float format the card might
    use)."""
    if rows.dtype == torch.int32:
        img = torch.zeros_like(src)
        for s in range(V):
            bit = (src[:, s >> 5, :] >> (s & 31)) & 1        # [B, P]
            img |= bit[:, None, :] * rows[:, s, :, None]
        return img
    new = torch.bmm(_unpack_states(src, V), rows) > 0
    return _pack_states(new, src.shape[1])


def _apply_slot(F: torch.Tensor, i: int, rows_i: torch.Tensor,
                V: int) -> torch.Tensor:
    """Close F one step under the op in slot ``i``: every config without
    bit i spawns (target-state, mask | bit i). ``rows_i`` holds each
    source state's packed target row in either form of
    ``_transition``."""
    B, NW, M = F.shape
    hi, lo = M >> (i + 1), 1 << i
    Fr = F.reshape(B, NW, hi, 2, lo)
    src = Fr[:, :, :, 0, :].reshape(B, NW, hi * lo)
    spawned = _transition(src, rows_i, V).reshape(B, NW, hi, lo)
    out = Fr.clone()
    out[:, :, :, 1, :] |= spawned
    return out.reshape(B, NW, M)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits per row of an int32 [B, ...] tensor, as int64 [B]."""
    table = torch.tensor([bin(v).count("1") for v in range(256)],
                         dtype=torch.int64, device=x.device)
    octets = x.reshape(x.shape[0], -1).contiguous().view(torch.uint8)
    return table[octets.long()].sum(1)


def _complete_slot(F: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """OK-completion of the op in each row's slot: keep configs whose
    mask has the slot bit set, with the bit cleared."""
    B, NW, M = F.shape
    m = torch.arange(M, device=F.device)
    bit = torch.ones_like(slot) << slot
    src = (m[None, :] | bit[:, None])[:, None, :].expand(B, NW, M)
    kept = torch.gather(F, 2, src)
    has_bit = ((m[None, :] & bit[:, None]) != 0)[:, None, :]
    return torch.where(has_bit, torch.zeros_like(kept), kept)


def plain_wgl(ev_type: torch.Tensor, ev_slot: torch.Tensor,
              ev_slots: torch.Tensor, target: torch.Tensor, idx0: int,
              F: torch.Tensor, Fb: torch.Tensor, valid: torch.Tensor,
              bad: torch.Tensor, *, V: int, W: int,
              w_live: Optional[int] = None,
              iters: Optional[torch.Tensor] = None,
              ops: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the WGL step, the twin of the
    reference's ``make_kernel`` (``check_resume`` form): the same carry
    contract as ``cuda_wgl.wgl_frontier`` and bit-identical outputs.

    Vectorised over [B, words, 2^W]; Python loops over events, closure
    sweeps (until no row changes — re-sweeping a converged row is a
    no-op) and slots. ``iters`` ([B] int64, optional) accumulates what
    the reference's ``make_kernel(instrument=True)`` counts, the measured
    input to ``vpu_op_model``: on EVERY event of the row's event axis
    (pads and events after the first failure included), the closure's
    sweeps, the last one that changes nothing included. A pad event's
    closure runs on the current frontier and its result is dropped, and
    the closure of an empty frontier (a failed row) is one sweep.
    ``ops`` ([B] int64, optional) accumulates the
    32-bit integer operations the step needs on the row's data: on each
    non-pad event, every configuration of the closure expanded once under
    each slot whose transition row reaches a state (one OR per state
    word), and on an OK completion one word test per kept mask; a row
    already invalid needs none."""
    if V > MAX_PACKED_STATES:
        raise ValueError(f"V={V} exceeds the packed kernel's "
                         f"{MAX_PACKED_STATES} states")
    B, N = ev_type.shape
    NW = n_state_words(V)
    WL = _w_live(W, w_live)
    K1 = target.shape[-2]
    dev = ev_type.device
    rows = pack_rows(target, V)             # [NW, (B,) K1, V]
    shifts = torch.arange(32, device=dev)
    typ_all = ev_type.to(torch.int64)
    slot_all = ev_slot.to(torch.int64).clamp(0, WL - 1)
    kinds_all = ev_slots[:, :, :WL].to(torch.int64)
    kinds_all = torch.where(kinds_all < 0, kinds_all + K1,
                            kinds_all).clamp(0, K1 - 1)
    ar = torch.arange(B, device=dev)[:, None]
    F, Fb, valid, bad = F.clone(), Fb.clone(), valid.clone(), bad.clone()
    # An event that is padding in every row changes nothing: skip it,
    # unless its closure sweeps are counted.
    live_any = ((typ_all == EV_OK) | (typ_all == EV_FUSED)
                | (typ_all == EV_CLOSE)).any(0).tolist()
    for e in range(N):
        if not live_any[e] and iters is None:
            continue
        typ = typ_all[:, e]
        is_ok = (typ == EV_OK) | (typ == EV_FUSED)
        is_close = typ == EV_CLOSE
        k = kinds_all[:, e]                                  # [B, WL]
        r = rows[:, k] if target.dim() == 2 else rows[:, ar, k]
        if dev.type == "cpu":
            # [NW, B, WL, V] → [B, WL, V, NW] packed target words
            rb = r.permute(1, 2, 3, 0)
        else:
            # [NW, B, WL, V] → [B, WL, V, NW*32] unpacked target bits
            rb = ((r[..., None] >> shifts) & 1).permute(1, 2, 3, 0, 4)
            rb = rb.reshape(B, WL, V, NW * 32).to(torch.float32)
        live_ev = is_ok | is_close
        Fc = F
        active = torch.ones(B, dtype=torch.bool, device=dev)
        while True:
            F0 = Fc
            for i in range(WL):
                Fc = _apply_slot(Fc, i, rb[:, i], V)
            changed = (Fc != F0).reshape(B, -1).any(1)
            if iters is not None:
                iters += active.to(iters.dtype)
            active &= changed
            if not bool(changed.any()):
                break
        if ops is not None:
            M = Fc.shape[2]
            reach = (r != 0).any(0).any(-1)                  # [B, WL]
            need = is_ok.to(torch.int64) * (NW * (M >> 1))
            for i in range(WL):
                src = Fc.reshape(B, NW, M >> (i + 1), 2, 1 << i)[:, :, :, 0]
                need += reach[:, i] * NW * _popcount(src)
            ops += torch.where(live_ev & valid, need,
                               torch.zeros_like(need))
        F_ok = _complete_slot(Fc, slot_all[:, e])
        empty = is_ok & ~(F_ok != 0).reshape(B, -1).any(1)
        first = empty & valid
        F = torch.where(is_ok[:, None, None], F_ok,
                        torch.where(is_close[:, None, None], Fc, F))
        Fb = torch.where(first[:, None, None], Fc, Fb)
        valid = valid & ~empty
        bad = torch.minimum(bad, torch.where(
            empty, torch.full_like(bad, idx0 + e),
            torch.full_like(bad, int(INT32_MAX))))
    return valid, bad, F, Fb


def initial_carry(B: int, V: int, W: int, device) -> tuple:
    """(F, Fb, valid, bad) of B fresh rows: the initial config (state 0,
    empty mask) present, verdict valid, no bad event."""
    NW, M = n_state_words(V), 1 << W
    F = torch.zeros((B, NW, M), dtype=torch.int32, device=device)
    F[:, 0, 0] = 1
    return (F, torch.zeros_like(F),
            torch.ones(B, dtype=torch.bool, device=device),
            torch.full((B,), int(INT32_MAX), dtype=torch.int32,
                       device=device))


def _plain_check(V, W, w_live, ev_type, ev_slot, ev_slots, target):
    """The check form of the plain version: a fresh carry, one walk, and
    the final frontier of a valid row or the latched closure of an
    invalid one."""
    carry = initial_carry(ev_type.shape[0], V, W, ev_type.device)
    valid, bad, F, Fb = plain_wgl(ev_type, ev_slot, ev_slots, target, 0,
                                  *carry, V=V, W=W, w_live=w_live)
    return valid, bad, torch.where(valid[:, None, None], F, Fb)


def plain_fused_wgl(members, flat) -> tuple:
    """The plain PyTorch version of a dispatch group, the twin of the
    reference's ``make_fused_kernel``: ``members`` is a sequence of
    ``(V, W, w_live, shared_target)`` per bucket chunk, ``flat`` four
    tensors per member (ev_type, ev_slot, ev_slots, target); returns
    three per member (valid, bad, frontier), each member checked on its
    own by ``plain_wgl``."""
    out = []
    for i, (V, W, w_live, _) in enumerate(members):
        out.extend(_plain_check(V, W, _w_live(W, w_live),
                                *flat[4 * i:4 * i + 4]))
    return tuple(out)


def get_fused_kernel(members):
    """The check of one dispatch group — the group twin of
    ``get_kernel``: ``members`` as in ``plain_fused_wgl``; the callable
    takes the four flat tensors per member and, optionally, ``rows=``,
    each member's count of real rows (the rest must be padding rows).
    On CUDA tensors the group entry (``cuda_wgl.wgl_frontier_group``)
    retires every member in one launch, skipping padding rows; on CPU
    tensors ``plain_fused_wgl`` runs."""
    members = tuple(tuple(m) for m in members)
    for V, _, _, _ in members:
        if V > MAX_PACKED_STATES:
            raise ValueError(f"V={V} exceeds the packed kernel's "
                             f"{MAX_PACKED_STATES} states")

    def fused(*flat, rows=None):
        dev = flat[0].device
        if dev.type == "cuda":
            return cuda_wgl.wgl_frontier_group(members, flat, rows)
        if dev.type != "cpu":
            raise ValueError(f"no WGL kernel for device {dev}")
        if rows is None:
            return plain_fused_wgl(members, flat)
        # Check the real rows only; the padding rows' outputs are what
        # the walk leaves an all-EV_PAD row: the initial carry.
        real = []
        for i, ((_, _, _, shared), nb) in enumerate(zip(members, rows)):
            ev = [t[:nb] for t in flat[4 * i:4 * i + 3]]
            tgt = flat[4 * i + 3]
            real += ev + [tgt if shared else tgt[:nb]]
        out = list(plain_fused_wgl(members, real))
        for i, (V, W, _, _) in enumerate(members):
            B = flat[4 * i].shape[0]
            full = initial_carry(B, V, W, dev)
            for j, init in enumerate((full[2], full[3], full[0])):
                init[:rows[i]] = out[3 * i + j]
                out[3 * i + j] = init
        return tuple(out)

    return fused


def get_kernel(V: int, W: int, *, w_live: Optional[int] = None,
               resume: bool = False, instrument: bool = False,
               kind: str = "data1", mesh=None,
               shared_target: bool = False):
    """The WGL step for static bounds (V, W), dispatching by the device
    of the tensors it is called with: a CUDA tensor launches the CUDA
    kernel (which raises on anything it does not take), a CPU tensor
    runs ``plain_wgl``.

    ``kind`` "data1" (default) is the single-device step below; "data"
    shards the batch over ``mesh``'s batch axes
    (parallel.mesh.data_sharded_kernel) and "frontier" splits the mask
    axis over its frontier devices
    (parallel.frontier.frontier_sharded_kernel, always at the full W).
    Both return the check form, ``shared_target`` saying whether the
    target is one [K1, V] table.

    ``resume=False`` returns ``check(ev_type, ev_slot, ev_slots, target)
    -> (valid, bad, frontier)``, frontier being the final config set of
    a valid row and the latched pre-failure closure of an invalid one.
    ``resume=True`` returns ``check(ev_type, ev_slot, ev_slots, target,
    idx0, F, Fb, valid, bad) -> (valid, bad, F, Fb)``. ``target`` is
    [K1, V] when every row shares it, else [B, K1, V].

    ``instrument=True`` (check form only, as in the reference) appends a
    fourth output, each row's closure passes summed over every event
    (int32 [B], the reference's ``make_kernel(instrument=True)``): the
    CUDA kernel's instrumented entry, or ``plain_wgl(iters=...)``."""
    if V > MAX_PACKED_STATES:
        raise ValueError(f"V={V} exceeds the packed kernel's "
                         f"{MAX_PACKED_STATES} states; use the host engine")
    if instrument and resume:
        raise ValueError("the instrumented kernel has the check form only")
    if kind == "frontier":
        from ..parallel.frontier import frontier_sharded_kernel
        return frontier_sharded_kernel(V, W, mesh, shared_target)
    if kind == "data":
        from ..parallel.mesh import data_sharded_kernel
        return data_sharded_kernel(V, W, mesh, shared_target,
                                   w_live=w_live)
    if kind != "data1":
        raise ValueError(f"unknown kernel kind {kind!r}")
    WL = _w_live(W, w_live)

    def step(ev_type, ev_slot, ev_slots, target, idx0, F, Fb, valid, bad,
             iters=None):
        if ev_type.device.type == "cuda":
            fn = cuda_wgl.wgl_frontier
        elif ev_type.device.type == "cpu":
            fn = plain_wgl
        else:
            raise ValueError(f"no WGL kernel for device {ev_type.device}")
        return fn(ev_type, ev_slot, ev_slots, target, idx0, F, Fb, valid,
                  bad, V=V, W=W, w_live=WL, iters=iters)

    if resume:
        return step

    def check(ev_type, ev_slot, ev_slots, target):
        carry = initial_carry(ev_type.shape[0], V, W, ev_type.device)
        iters = (torch.zeros(ev_type.shape[0], dtype=torch.int32,
                             device=ev_type.device) if instrument else None)
        valid, bad, F, Fb = step(ev_type, ev_slot, ev_slots, target, 0,
                                 *carry, iters=iters)
        out = (valid, bad, torch.where(valid[:, None, None], F, Fb))
        return out + (iters,) if instrument else out

    return check


def measure_closure_iters(buckets: Sequence[EncodedBatch], *,
                          device=None) -> dict:
    """The measured input of the op-count roofline (the reference bench's
    instrumented pass, ``bench.py:569-593``): every dispatched narrow
    bucket (W <= DATA_MAX_SLOTS) runs through the instrumented kernel over
    its own event axis, chunked by MAX_FRONTIER_ELEMENTS, and each row's
    closure passes are summed. Returns ``{"iters": total passes,
    "lane_ops": the vpu_op_model count (passes x per_iteration + rows x
    events x per_event), "rows", "buckets"}``. ``device=None`` means the
    card."""
    device = resolve_device(device)
    iters_total = 0
    lane_ops = 0.0
    rows = n_buckets = 0
    for b in buckets:
        if b.W > DATA_MAX_SLOTS or not b.batch:
            continue
        kern = get_kernel(b.V, b.W, w_live=b.eff_w_live, instrument=True)
        per_hist = n_state_words(b.V) << b.W
        chunk = max(1, MAX_FRONTIER_ELEMENTS // per_hist)
        tgt = _on(b.target[0], device) if b.shared_target else None
        iters = 0
        for lo in range(0, b.batch, chunk):
            hi = min(lo + chunk, b.batch)
            out = kern(_on(b.ev_type[lo:hi], device),
                       _on(b.ev_slot[lo:hi], device),
                       _on(b.ev_slots[lo:hi], device),
                       tgt if tgt is not None
                       else _on(b.target[lo:hi], device))
            iters += int(out[3].to(torch.int64).sum())
        m = vpu_op_model(b.V, b.W, b.eff_w_live)
        lane_ops += (iters * m["per_iteration"]
                     + b.batch * b.ev_opidx.shape[-1] * m["per_event"])
        iters_total += iters
        rows += b.batch
        n_buckets += 1
    return {"iters": iters_total, "lane_ops": lane_ops, "rows": rows,
            "buckets": n_buckets}


# ------------------------------------------------- scan-rate probe

def make_probe_batch(V: int = 4, W: int = 6, rows: int = 32,
                     events: int = 64):
    """Synthetic always-valid encoded arrays that run the full closure
    and completion arithmetic with no model machinery: one identity op
    resident in slot 0, completed every event. The router's scan-rate
    probe times the frontier kernel on it."""
    K1 = 2
    ev_type = np.full((rows, events), EV_OK, np.int8)
    ev_slot = np.zeros((rows, events), np.int8)
    ev_slots = np.full((rows, events, W), K1 - 1, np.int8)
    ev_slots[:, :, 0] = 0
    target = np.full((K1, V), -1, np.int32)
    target[0] = np.arange(V, dtype=np.int32)
    return ev_type, ev_slot, ev_slots, target


def probe_rates(rows: int = 32, events: int = 64, V: int = 4, W: int = 6,
                repeats: int = 3, *, device=None) -> dict:
    """The router's scan-rate probe: the frontier search's sustained rate
    on ``make_probe_batch`` in the cost router's units (frontier-lane
    events per second, the ``n_events * 2^W / rate`` basis of
    ``fleet.CostRouter.price_wgl``). On the card the kernel alone by
    CUDA events, on the CPU the plain version by the host clock; best of
    ``repeats`` after a warm-up. Returns ``{"lane_ops_per_s",
    "pallas_lane_ops_per_s", "probe_s"}``; the pallas rate is always 0.0:
    the reference's two TPU forms of the search are one CUDA kernel here,
    and a zero rate prices that term out as an unprobed reference does."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    args = [_on(a, device) for a in make_probe_batch(V, W, rows, events)]
    carry = initial_carry(rows, V, W, device)
    init = [c.clone() for c in carry]
    if device.type == "cuda":
        launch = cuda_wgl.prepare_frontier(*args, 0, *carry, V=V, W=W)
    else:
        def launch():
            plain_wgl(*args, 0, *carry, V=V, W=W, w_live=W)

    def reset():
        for c, i in zip(carry, init):
            c.copy_(i)
    best = time_launch(launch, device, repeats, reset=reset)
    return {"lane_ops_per_s": rows * events * float(1 << W) / max(best, 1e-9),
            "pallas_lane_ops_per_s": 0.0,
            "probe_s": round(time.perf_counter() - t0, 4)}


# ------------------------------------------------------------- dispatch

def _on(a: np.ndarray, device) -> torch.Tensor:
    # a shared target is a read-only broadcast view: copy it first
    return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(device)


def _mesh_devices(device) -> list:
    """The production routes' devices (jepsen_torch.provision) of
    ``device``'s type: a mesh serves the callers that run there."""
    from ..provision import devices
    if device is None:
        return devices()
    kind = torch.device(device).type
    return [d for d in devices() if d.type == kind]


def device_frontier_capacity(device=None) -> int:
    """Extra pending-window bits the devices can host beyond
    DATA_MAX_SLOTS: log2 of the largest power-of-two count of the
    production devices of ``device``'s type (the frontier-sharded
    route), and never less than the single-device margin (the data1wide
    route). The encoder windows up to DATA_MAX_SLOTS + capacity slots
    before a history must go to the host engine."""
    nd = len(_mesh_devices(device))
    return max(nd.bit_length() - 1, SINGLE_DEVICE_EXTRA_SLOTS)


def production_mesh(n_frontier: int = 1, device=None):
    """The process-wide ("data", "frontier") mesh over the production
    devices of ``device``'s type, or None when they cannot host the
    frontier axis (or there is one device and no frontier need)."""
    devs = _mesh_devices(device)
    nd = len(devs)
    if n_frontier > nd or (nd < 2 and n_frontier == 1):
        return None
    key = (tuple(devs), n_frontier)
    mesh = _PROD_MESHES.get(key)
    if mesh is None:
        from ..parallel.mesh import checker_mesh
        mesh = checker_mesh(n_data=nd // n_frontier, n_frontier=n_frontier,
                            devices=devs)
        _PROD_MESHES[key] = mesh
    return mesh


def _pad_rows(batch: EncodedBatch, bp: int, lo: int = 0,
              hi: Optional[int] = None) -> tuple:
    """Rows lo..hi of a batch's arrays padded to ``bp`` rows with inert
    histories (all events PAD, empty slot tables, all-invalid targets):
    they walk to valid and are sliced off after the device call. The
    target is None for a shared-target batch (its one table ships
    once)."""
    hi = batch.batch if hi is None else hi
    b, n, w = hi - lo, batch.n_events, batch.ev_slots.shape[2]
    K1, V = batch.target.shape[1], batch.target.shape[2]
    ev_type = np.zeros((bp, n), batch.ev_type.dtype)
    ev_slot = np.zeros((bp, n), batch.ev_slot.dtype)
    ev_slots = np.full((bp, n, w), K1 - 1, batch.ev_slots.dtype)
    ev_type[:b] = batch.ev_type[lo:hi]
    ev_slot[:b] = batch.ev_slot[lo:hi]
    ev_slots[:b] = batch.ev_slots[lo:hi]
    if batch.shared_target:
        return ev_type, ev_slot, ev_slots, None
    target = np.full((bp, K1, V), -1, np.int32)
    target[:b] = batch.target[lo:hi]
    return ev_type, ev_slot, ev_slots, target


def _round_up_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dispatch_sharded(kind: str, batch: EncodedBatch, mesh,
                      return_frontier: bool) -> list:
    """Run one bucket through a sharded kernel ("dataN" or "frontier"),
    padding each chunk to the batch shards' multiple and chunking to
    MAX_FRONTIER_ELEMENTS a distinct device. Returns [(valid, bad,
    frontier|None)] per chunk, padding rows sliced off."""
    from ..parallel.mesh import batch_cells
    n_data = len(batch_cells(mesh))
    kern = get_kernel(batch.V, batch.W,
                      kind="frontier" if kind == "frontier" else "data",
                      mesh=mesh, shared_target=batch.shared_target,
                      w_live=batch.eff_w_live)
    # Per-device budget: a device holds (chunk / n_data) rows x
    # (per_hist / n_frontier) words for each of the size / n_devices
    # cells it fills (one card named n times fills n), so
    # chunk x per_hist / n_devices <= MAX_FRONTIER_ELEMENTS.
    per_hist = n_state_words(batch.V) << batch.W
    n_devices = len(set(mesh.devices.flat))
    chunk = _round_up_to(
        max(n_data, MAX_FRONTIER_ELEMENTS * n_devices // max(per_hist, 1)),
        n_data)
    DISPATCH_LOG.append((kind, batch.V, batch.W, batch.batch))
    out = []
    for lo in range(0, batch.batch, chunk):
        hi = min(lo + chunk, batch.batch)
        nb = hi - lo
        ev_type, ev_slot, ev_slots, target = _pad_rows(
            batch, _round_up_to(nb, n_data), lo, hi)
        valid, bad, front = kern(
            ev_type, ev_slot, ev_slots,
            batch.target[0] if batch.shared_target else target)
        out.append((valid[:nb], bad[:nb],
                    front[:nb] if return_frontier else None))
    return out


def _route(batch: EncodedBatch, device):
    """(route, mesh) of one bucket: "frontier" when the window is past
    DATA_MAX_SLOTS and the production mesh has 2^(W - 16) frontier
    devices, else "data1wide" up to SINGLE_DEVICE_EXTRA_SLOTS past it;
    "dataN" for a batch of at least shard_min_rows() rows per data
    device, else "data1". Raises WindowOverflow past what the devices
    host."""
    from ..parallel.mesh import should_shard
    if batch.W > DATA_MAX_SLOTS:
        D = 1 << (batch.W - DATA_MAX_SLOTS)
        mesh = production_mesh(D, device)
        if mesh is not None:
            return "frontier", mesh
        if batch.W - DATA_MAX_SLOTS > SINGLE_DEVICE_EXTRA_SLOTS:
            raise WindowOverflow(
                f"window W={batch.W} needs {D} frontier devices")
        return "data1wide", None
    mesh = production_mesh(1, device)
    if should_shard(batch.batch, mesh):
        return "dataN", mesh
    return "data1", None


def _launch(batch: EncodedBatch, return_frontier: bool, device) -> list:
    """Queue one bucket on the route ``_route`` picks. One device: batch
    chunks so the in-flight frontier words stay inside
    MAX_FRONTIER_ELEMENTS (wide windows get proportionally smaller
    chunks). Returns [(valid, bad, frontier|None)] tensors per chunk;
    raises WindowOverflow past what the devices host."""
    if batch.batch == 0:
        NW, M = n_state_words(batch.V), 1 << batch.W
        return [(torch.zeros(0, dtype=torch.bool),
                 torch.zeros(0, dtype=torch.int32),
                 torch.zeros((0, NW, M), dtype=torch.int32)
                 if return_frontier else None)]
    label, mesh = _route(batch, device)
    if mesh is not None:
        return _dispatch_sharded(label, batch, mesh, return_frontier)
    kern = get_kernel(batch.V, batch.W, w_live=batch.eff_w_live)
    per_hist = n_state_words(batch.V) << batch.W
    chunk = max(1, MAX_FRONTIER_ELEMENTS // per_hist)
    DISPATCH_LOG.append((label, batch.V, batch.W, batch.batch))
    shared_tgt = (_on(batch.target[0], device) if batch.shared_target
                  else None)
    pending = []
    for lo in range(0, batch.batch, chunk):
        hi = min(lo + chunk, batch.batch)
        valid, bad, front = kern(
            _on(batch.ev_type[lo:hi], device),
            _on(batch.ev_slot[lo:hi], device),
            _on(batch.ev_slots[lo:hi], device),
            shared_tgt if shared_tgt is not None
            else _on(batch.target[lo:hi], device))
        pending.append((valid, bad, front if return_frontier else None))
    return pending


def _collect(pending: list, return_frontier: bool):
    valid = np.concatenate([v.cpu().numpy() for v, _, _ in pending])
    bad = np.concatenate([b.cpu().numpy() for _, b, _ in pending])
    frontier = None
    if return_frontier:
        frontier = np.concatenate(
            [f.cpu().numpy().view(np.uint32) for _, _, f in pending])
    return valid, bad, frontier


def run_encoded_batch(batch: EncodedBatch, return_frontier: bool = False,
                      *, device=None):
    """Check one cost bucket on the route its window and the production
    devices give it (``_route``):

      * W <= DATA_MAX_SLOTS, a small batch or one device: "data1", the
        single-device kernel, chunked to bound memory;
      * W <= DATA_MAX_SLOTS, a large batch on a mesh of several devices:
        "dataN", the batch axis sharded over "data"
        (jepsen_torch.parallel.mesh);
      * W > DATA_MAX_SLOTS: "frontier", the mask axis split over
        2^(W - 16) frontier devices (jepsen_torch.parallel.frontier);
        without them "data1wide" up to SINGLE_DEVICE_EXTRA_SLOTS past
        it (the kernel keeps such frontiers in device memory), and
        WindowOverflow beyond, whose rows go to the host engine.

    Returns numpy (valid [B] bool, bad [B] int32, frontier [B, words(V),
    2^W] uint32 or None)."""
    return _collect(_launch(batch, return_frontier, resolve_device(device)),
                    return_frontier)


def run_buckets(batches: Sequence[EncodedBatch], *, device=None,
                return_frontier: bool = False):
    """Run many cost buckets and yield (batch, (valid, bad, frontier) |
    WindowOverflow) in submission order. Launches are asynchronous, so
    bucket k+1 is queued on the card before bucket k's results are
    copied back: the host's per-bucket decode overlaps the device's next
    bucket, with at most two buckets' frontiers in flight. A bucket on a
    sharded route ("dataN", "frontier") runs blocking, after the queued
    ones."""
    device = resolve_device(device)
    queued: "deque" = deque()

    def launch(b):
        try:
            return _launch(b, return_frontier, device)
        except WindowOverflow as e:
            return e

    def finish(b, p):
        if isinstance(p, WindowOverflow):
            return b, p
        return b, _collect(p, return_frontier)

    def sharded(b):
        try:
            return b.batch and _route(b, device)[1] is not None
        except WindowOverflow:
            return False

    for b in batches:
        if sharded(b):
            # The sharded routes are driven from the host (the frontier
            # walk reads its flags every round): drain, then run it
            # blocking.
            while queued:
                yield finish(*queued.popleft())
            yield finish(b, launch(b))
            continue
        queued.append((b, launch(b)))
        if len(queued) > 1:
            yield finish(*queued.popleft())
    while queued:
        yield finish(*queued.popleft())


def run_event_chunked(batch: EncodedBatch, events_per_chunk: int,
                      return_frontier: bool = False, *, device=None):
    """One-device check with the EVENT axis chunked: the packed carry
    ([words, 2^W] per row) flows between launches, so a 100k-op history
    never needs one 100k-event launch. Each chunk launches at its own
    length. Same (valid, bad, frontier) contract as
    run_encoded_batch."""
    if batch.W > DATA_MAX_SLOTS + SINGLE_DEVICE_EXTRA_SLOTS:
        raise WindowOverflow(f"window W={batch.W} exceeds one device")
    device = resolve_device(device)
    B, N = batch.batch, batch.n_events
    NW, M = n_state_words(batch.V), 1 << batch.W
    if B == 0:
        return (np.zeros((0,), bool), np.zeros((0,), np.int32),
                np.zeros((0, NW, M), np.uint32) if return_frontier
                else None)
    kern = get_kernel(batch.V, batch.W, w_live=batch.eff_w_live,
                      resume=True)
    C = max(8, int(events_per_chunk))
    tgt = _on(batch.target[0] if batch.shared_target else batch.target,
              device)
    F, Fb, valid, bad = initial_carry(B, batch.V, batch.W, device)
    for lo in range(0, N, C):
        valid, bad, F, Fb = kern(_on(batch.ev_type[:, lo:lo + C], device),
                                 _on(batch.ev_slot[:, lo:lo + C], device),
                                 _on(batch.ev_slots[:, lo:lo + C], device),
                                 tgt, lo, F, Fb, valid, bad)
    frontier = None
    if return_frontier:
        frontier = torch.where(valid[:, None, None], F, Fb)
        frontier = frontier.cpu().numpy().view(np.uint32)
    return valid.cpu().numpy(), bad.cpu().numpy(), frontier


# ------------------------------------------------ carried-frontier seam
#
# The resume form of the step carries (F, Fb, valid, bad) out of one
# launch and into the next. run_event_chunked uses the carry within one
# call; these helpers hold it ACROSS calls — and across processes, via
# export/import (zlib+b64, the reference's journal frontier-checkpoint
# row format, unchanged).

def frontier_carry_init(V: int, W: int) -> dict:
    """A fresh single-row carry: the initial config (state 0, empty
    mask) present, verdict valid, no bad event."""
    NW, M = n_state_words(V), 1 << W
    F = np.zeros((1, NW, M), np.uint32)
    F[0, 0, 0] = 1
    return {"valid": np.ones(1, bool),
            "bad": np.full(1, INT32_MAX, np.int32),
            "F": F,
            "Fb": np.zeros((1, NW, M), np.uint32)}


def run_carried_events(V: int, W: int, target: np.ndarray,
                       ev_type: np.ndarray, ev_slot: np.ndarray,
                       ev_slots: np.ndarray, idx0: int,
                       carry: dict, *, device=None) -> dict:
    """Advance a carried frontier over ``N`` new events (single row,
    shared target) in one launch and return the new carry as numpy
    arrays. ``bad`` in the carry is a GLOBAL event ordinal (``idx0``
    continues the event numbering across calls)."""
    device = resolve_device(device)
    if int(ev_type.shape[0]) == 0:
        return {k: np.array(v) for k, v in carry.items()}
    kern = get_kernel(V, W, resume=True)
    tgt = _on(target, device)
    valid = _on(carry["valid"], device)
    bad = _on(carry["bad"], device)
    F = _on(carry["F"].view(np.int32), device)
    Fb = _on(carry["Fb"].view(np.int32), device)
    valid, bad, F, Fb = kern(
        _on(np.asarray(ev_type, np.int8)[None], device),
        _on(np.asarray(ev_slot, np.int8)[None], device),
        _on(np.asarray(ev_slots, np.int32)[None], device),
        tgt, idx0, F, Fb, valid, bad)
    return {"valid": valid.cpu().numpy(), "bad": bad.cpu().numpy(),
            "F": F.cpu().numpy().view(np.uint32),
            "Fb": Fb.cpu().numpy().view(np.uint32)}


def export_frontier(carry: dict) -> dict:
    """Serialize a carry for the journal frontier-checkpoint row. The
    packed bitsets compress hard (config sets are sparse), so the row
    stays journal-sized."""
    import base64
    import zlib

    def pack(a):
        return base64.b64encode(
            zlib.compress(np.ascontiguousarray(a).tobytes())).decode()

    return {"v": 1, "shape": list(carry["F"].shape),
            "valid": bool(carry["valid"][0]),
            "bad": int(carry["bad"][0]),
            "F": pack(carry["F"]), "Fb": pack(carry["Fb"])}


def import_frontier(d: dict, V: int, W: int) -> Optional[dict]:
    """Deserialize an exported carry; None on any mismatch (a stale or
    foreign checkpoint is a cache miss, never a failure mode)."""
    import base64
    import binascii
    import zlib
    try:
        if d.get("v") != 1:
            return None
        shape = tuple(d["shape"])
        if shape != (1, n_state_words(V), 1 << W):
            return None

        def unpack(s):
            a = np.frombuffer(zlib.decompress(base64.b64decode(s)),
                              np.uint32)
            return a.reshape(shape).copy()

        return {"valid": np.array([bool(d["valid"])]),
                "bad": np.array([int(d["bad"])], np.int32),
                "F": unpack(d["F"]), "Fb": unpack(d["Fb"])}
    except (AttributeError, KeyError, TypeError, ValueError,
            binascii.Error, zlib.error):
        return None


def grow_frontier_states(carry: dict, old_words: int,
                         new_words: int) -> dict:
    """Widen a carry's state axis (an appended vocabulary reached new
    states past the current word pad): new states' bits start 0 in every
    config, which is exactly right — no existing config holds them. The
    mask axis (2^W) is untouched."""
    if new_words == old_words:
        return carry
    if new_words < old_words:
        raise ValueError("a carry's state axis only grows")
    out = dict(carry)
    for k in ("F", "Fb"):
        a = carry[k]
        wide = np.zeros((a.shape[0], new_words, a.shape[2]), np.uint32)
        wide[:, :old_words] = a
        out[k] = wide
    return out


def fused_bad_rows(batch: EncodedBatch, valid, bad) -> np.ndarray:
    """Row positions (within ``batch``) whose first impossible completion
    landed on an EV_FUSED step: the device only knows such a run's FIRST
    member, so the entry points re-derive their exact bad op on the
    host."""
    v = np.asarray(valid)
    b = np.asarray(bad)
    inv = np.nonzero(~v)[0]
    return inv[batch.ev_type[inv, b[inv]] == EV_FUSED]


def vpu_op_model(V: int, W: int, w_live: Optional[int] = None) -> dict:
    """Analytic 32-bit integer lane-op counts of the reference's dense
    formulation of the packed step, which tests every state bit of every
    mask on every sweep. It is not the kernel's bound: the CUDA kernel
    skips empty masks and walks only set bits, and the bound counts the
    operations the data needs (``plain_wgl(ops=...)``).

    Per closure ITERATION (one sweep over the slots): each of the
    ``w_live`` slot applications walks V states, paying 2 lane-ops to
    extract the state bit and, per packed word, a multiply + OR over
    the M/2 spawned-mask lanes, plus the OR-merge back into the mask
    halves; the convergence check compares + reduces every frontier
    word. Per EVENT on top: the completion shift-half, the emptiness
    union/any, and the three latch selects, all over full [NW, M]
    words. The measured input (sweeps per row) comes from
    ``plain_wgl(iters=...)``."""
    NW = n_state_words(V)
    M = 1 << W
    WL = _w_live(W, w_live)
    per_apply = (M // 2) * (V * (2 + 2 * NW) + NW)
    per_iteration = WL * per_apply + 2 * NW * M
    per_event = 5 * NW * M
    return {"per_iteration": per_iteration, "per_event": per_event,
            "words": NW, "masks": M, "w_live": WL}


# ---------------------------------------------------------- host decode

def decode_frontier(frontier: np.ndarray, space, slot_to_op: Dict[int, int],
                    n: int = 10) -> List[dict]:
    """Decode a packed [words, M] frontier into a bounded, deterministic
    config sample matching the host engine's shape
    (checkers.linearizable._sample_configs): ``{"model": repr(state),
    "pending": sorted linearized op indices}``, sorted, truncated to n —
    the reference's truncate-to-10 discipline (checker.clj:104-107)."""
    words, masks = np.nonzero(np.asarray(frontier))
    configs = []
    for w, m in zip(words.tolist(), masks.tolist()):
        bits = int(frontier[w, m])
        s = 0
        while bits:
            if bits & 1:
                state = 32 * w + s
                if state < len(space.states):
                    pend = sorted(slot_to_op[i] for i in range(32)
                                  if (m >> i) & 1 and i in slot_to_op)
                    configs.append({"model": repr(space.states[state]),
                                    "pending": pend})
            bits >>= 1
            s += 1
    configs.sort(key=lambda c: (c["model"], c["pending"]))
    return configs[:n]


def _decode_result(space, ops: List[Op], valid: bool,
                   op_index: int, frontier_row,
                   predropped: bool = False) -> dict:
    """Host-shaped result dict from a kernel verdict: {"valid"} plus, on
    failure, the impossible op and a decoded config sample."""
    if valid:
        out = {"valid": True}
        if space is not None:
            table = slot_ops_at_event(space, ops, None,
                                      predropped=predropped)
            out["configs"] = decode_frontier(frontier_row, space, table)
        return out
    op = next((o for o in ops if o.index == op_index), None)
    out = {"valid": False,
           "op": op.to_dict() if op is not None else {"index": op_index}}
    if space is not None:
        # Locate the pending table by the bad op's history index, the
        # coordinate that stays stable whatever the event axis holds.
        table = slot_ops_at_event(space, ops, None, predropped=predropped,
                                  op_index=op_index)
        out["configs"] = decode_frontier(frontier_row, space, table)
    return out


def _result_for(row: int, batch: EncodedBatch, valid: np.ndarray,
                bad: np.ndarray, frontier: np.ndarray, model: Model,
                prepared: List[Op]) -> dict:
    space = batch.spaces[row] if batch.spaces else None
    ev = int(bad[row])
    op_index = int(batch.ev_opidx[row, ev]) if not bool(valid[row]) else -1
    return _decode_result(space, prepared, bool(valid[row]), op_index,
                          frontier[row])


# ---------------------------------------------------------- entry points

def _rehydrate_verdict(valid: bool, bad: Optional[int],
                       prov: str) -> dict:
    """Result dict of a row a previous interrupted run decided (the
    chunk journal): bare (the journal records verdicts, not frontiers)
    and marked ``resumed``."""
    out: dict = {"valid": valid, "provenance": prov, "resumed": True}
    if valid is False:
        out["op"] = {"index": bad}
    return out


def _sink_verdict(sink, row: int, r: dict) -> None:
    """Journal one host-decided row's final verdict through a write
    callable (a check_columnar sink that remaps sub-batch rows, or
    ChunkJournal.record): the ONE result-dict-to-record translation of
    both checkers. A verdict that is not a boolean ("unknown") is not
    journaled; a resumed run re-derives it."""
    if r.get("valid") is True:
        sink([row], [True], [None], ["host-fallback"])
    elif r.get("valid") is False:
        sink([row], [False], [r.get("op", {}).get("index")],
             ["host-fallback"])


def _journal_result(journal, i: int, r: dict) -> None:
    """Journal one host-decided row's final verdict (no-op without a
    journal)."""
    if journal is not None:
        _sink_verdict(journal.record, i, r)


def _chunk_recorder(sch, sink, bad_index):
    """on_chunk hook journaling device chunk verdicts as they retire:
    ``bad_index(b, row, line)`` maps a row's bad event line to the
    journaled op index. Rows whose first failure fell inside a fused run
    and quarantined rows are skipped: they journal when their host
    verdict lands."""
    def on_chunk(b, lo, hi, v, bad, fr):
        rows, vals, bads, provs = [], [], [], []
        for k in range(hi - lo):
            rp = lo + k
            i = b.indices[rp]
            if i in sch.quarantined:
                continue
            vk = bool(v[k])
            bd = None
            if not vk:
                ev = int(bad[k])
                if b.ev_type[rp, ev] == EV_FUSED:
                    continue
                bd = bad_index(i, int(b.ev_opidx[rp, ev]))
            rows.append(i)
            vals.append(vk)
            bads.append(bd)
            provs.append(sch.row_provenance.get(i, "device"))
        sink(rows, vals, bads, provs)
    return on_chunk


def _batch_chunk_recorder(sch, journal):
    """check_batch's recorder: ``bad`` is the history-op index."""
    return _chunk_recorder(sch, journal.record, lambda i, line: line)


def _columnar_chunk_recorder(sch, cols, sink):
    """check_columnar's recorder: ``bad`` is the caller-level op index,
    mapped through cols.index."""
    def bad_index(i, line):
        return int(cols.index[i, line]) if cols.index is not None \
            else line
    return _chunk_recorder(sch, sink, bad_index)


def _decided_on_host(r: dict, scheduler: bool, why=None) -> dict:
    """Tag a host-engine result the way the reference does."""
    if why is not None:
        r.setdefault("fallback", why)
    if scheduler:
        r.setdefault("provenance", "host-fallback")
    return r


def check_batch(model: Model, histories: Sequence[List[Op]], *,
                device=None, max_slots: int = 16,
                max_states: int = MAX_PACKED_STATES,
                host_fallback=None, min_device_batch: int = 1,
                scheduler: bool = True, faults=None, journal=None,
                scheduler_opts: Optional[dict] = None,
                partition: object = "auto") -> List[dict]:
    """Check many raw histories on the device; per-history result dicts
    (``valid``, on failure ``op``, and a ``configs`` sample).

    ``device=None`` means the CUDA card and raises when there is none;
    ``device="cpu"`` runs the plain version. Histories the encoder cannot
    bound (state-space explosion, a pending window past the devices) are
    decided by ``host_fallback(model, history)`` (default: the exact host
    engine) and carry a ``fallback`` key naming why. Cost buckets
    smaller than ``min_device_batch`` go to the C++ batch engine
    (native.check_batch_native; under the scheduler only wide, W >=
    DATA_MAX_SLOTS, ones: narrow small buckets merge into classes).

    ``scheduler=True`` (default) encodes with event fusion and streams
    through the bucket scheduler (ops.schedule: W-class consolidation,
    chunked pipeline, group launches); every result then carries a
    ``provenance`` tag (``device``, ``device-retried`` or
    ``host-fallback``: which engine decided the row, and how hard the
    degradation ladder had to work). Rows whose first failure falls
    inside a fused run re-derive on the host, and so do the rows the
    ladder quarantines, so every history gets a verdict under any fault
    schedule. ``scheduler=False`` keeps one launch per exact (V, W)
    bucket — the parity oracle. ``scheduler_opts`` forwards
    BucketScheduler knobs (chunk_rows, max_classes, fuse_width,
    max_retries, resident, ...). ``faults`` injects the checker nemesis
    (an ops.faults.FaultInjector; $JT_FAULT_PLAN when None); ``journal``
    (a store.ChunkJournal) makes retired chunk verdicts durable and
    resumes from them: rows it holds are never re-dispatched and come
    back bare, marked ``resumed``.

    ``partition`` is the per-key pre-partition (ops.partition): KV-valued
    histories strain into per-key sub-histories before encoding, each
    key checks at its own pending window, and verdicts recombine with
    the witness key (``independent_key``). ``"auto"`` (default) samples
    each history's head for KV values; True forces the strain; False
    keeps the unpartitioned path. The journal's row namespace is then
    the sub-history list."""
    from .encode import take_rows
    opts = dict(scheduler_opts or {})
    device = resolve_device(device)
    if partition:
        from .partition import partition_histories, recombine_details
        parts = partition_histories(histories, force=partition is True)
        if parts is not None:
            subs, sub_hist, sub_key = parts
            inner = check_batch(
                model, subs, device=device, max_slots=max_slots,
                max_states=max_states, host_fallback=host_fallback,
                min_device_batch=min_device_batch, scheduler=scheduler,
                faults=faults, journal=journal, scheduler_opts=opts,
                partition=False)
            return recombine_details(inner, sub_hist, sub_key,
                                     len(histories))
    if host_fallback is None:
        _cache: dict = {}

        def host_fallback(m, h):
            return wgl_check(m, h, space_cache=_cache)

    for h in histories:
        if any(op.index is None for op in h):
            index_history(h)
    prepared = [prepare_history(h) for h in histories]
    eff_slots = max_slots + (device_frontier_capacity(device)
                             if max_slots >= DATA_MAX_SLOTS else 0)
    buckets = bucket_encode(model, prepared,
                            max_states=min(max_states, MAX_PACKED_STATES),
                            max_slots=eff_slots, fuse=scheduler)

    results: List[Optional[dict]] = [None] * len(histories)
    decided: dict = {}
    if journal is not None and scheduler:
        decided = {i: d for i, d in journal.decided().items()
                   if 0 <= i < len(histories)}
        for i, (vl, bd, pv) in decided.items():
            results[i] = _rehydrate_verdict(vl, bd, pv)

    def on_host(i, why=None):
        results[i] = _decided_on_host(host_fallback(model, histories[i]),
                                      scheduler, why)
        if scheduler:
            _journal_result(journal, i, results[i])

    device_batches = []
    for batch in buckets:
        if decided:
            # Resume: rows with journaled verdicts never re-dispatch.
            batch = take_rows(batch, [r for r, i in enumerate(batch.indices)
                                      if i not in decided])
        if 0 < batch.batch < min_device_batch and \
                (not scheduler or batch.W >= DATA_MAX_SLOTS):
            from ..native import check_batch_native
            rs = check_batch_native(model,
                                    [histories[i] for i in batch.indices])
            for i, r in zip(batch.indices, rs):
                results[i] = _decided_on_host(r, scheduler)
                if scheduler:
                    _journal_result(journal, i, r)
        elif batch.batch:
            device_batches.append(batch)
        for i, reason in batch.failures:
            if i not in decided:
                on_host(i, reason)
    sch = None
    if scheduler:
        from .schedule import BucketScheduler
        sch = BucketScheduler(return_frontier=True, device=device,
                              faults=faults, **opts)
        if journal is not None:
            sch.on_chunk = _batch_chunk_recorder(sch, journal)
        stream = sch.run(device_batches)
    else:
        stream = run_buckets(device_batches, device=device,
                             return_frontier=True)
    for batch, out in stream:
        if isinstance(out, WindowOverflow):
            for i in batch.indices:
                on_host(i, str(out))
            continue
        valid, bad, front = out
        fused = set(fused_bad_rows(batch, valid, bad).tolist())
        for row, i in enumerate(batch.indices):
            if sch is not None and i in sch.quarantined:
                continue           # placeholder; re-decided below
            if row in fused:
                # The first impossible completion fell inside a fused
                # run: the device only knows the run's first member.
                on_host(i)
                continue
            results[i] = _result_for(row, batch, valid, bad, front,
                                     model, prepared[i])
            if sch is not None:
                results[i]["provenance"] = sch.row_provenance.get(
                    i, "device")
    if sch is not None:
        # Rows the ladder quarantined: the exact host oracle decides
        # them.
        for i, why in sch.quarantined.items():
            on_host(i, f"quarantined: {why}")
            results[i]["provenance"] = "host-fallback"
    return results


def check_one(model: Model, history: List[Op], **kw) -> dict:
    """Single-history device check (the Checker-protocol CUDA backend)."""
    return check_batch(model, [history], **kw)[0]


# ------------------------------------------------------ the columnar path

def check_columnar(model: Model, cols, *, device=None, max_slots: int = 16,
                   host_fallback=None, details=False,
                   min_device_batch: int = 1,
                   timings: Optional[dict] = None, scheduler: bool = True,
                   faults=None, journal=None,
                   scheduler_opts: Optional[dict] = None,
                   partition: object = "auto",
                   stats_out: Optional[dict] = None):
    """Check a ColumnarOps batch end to end: a vectorised encode walk,
    kernel launches per bucket, verdicts decoded per row.

    Returns (valid [B] bool, bad [B] int32): ``bad`` is the op index of
    the first impossible completion (the original-history index for
    converted batches, else the line position; INT32_MAX when valid).
    ``details=True`` returns per-row result dicts of the host engine's
    shape ({"valid", "op", "configs"}, configs truncated to 10), decoded
    from the latched frontiers; ``details="invalid"`` decodes only the
    invalid rows and returns valid ones as {"valid": True}.

    ``scheduler=True`` (default) streams through the bucket scheduler
    (ops.schedule): the encode walk runs in row groups with event fusion
    and state renumbering, exact windows consolidate into few W classes,
    chunks pipeline against decode, and several chunks share one group
    launch. Detail dicts of device rows then carry ``provenance``. Rows
    whose first failure falls inside a fused run are re-derived on the
    host after the stream drains: with ``details=False`` their verdicts
    and bad ops come from the C++ batch engine (native.
    check_batch_native), with details from ``host_fallback``'s full
    dicts. ``scheduler=False`` keeps the fully encoded exact-W flow, the
    parity oracle.

    ``min_device_batch`` (verdict-only and ``details="invalid"`` callers):
    wide buckets (W >= DATA_MAX_SLOTS; under the scheduler, consolidated
    ones) with fewer rows than this are decided by the C++ batch engine
    on a daemon thread while the card runs the rest (an invalid row of a
    ``details="invalid"`` call then takes ``host_fallback``'s full
    dict).

    Fault tolerance (scheduler path): chunks run under the degradation
    ladder (watchdog and retry, row bisection on an out-of-memory,
    poison-row quarantine to ``host_fallback``), so every row gets a
    verdict under any single fault; ``faults`` injects the checker
    nemesis (ops.faults). ``journal`` (a store.ChunkJournal) makes
    retired chunk verdicts durable: rows it already holds are sliced out
    BEFORE encoding and never re-dispatched, and fresh verdicts append
    as chunks retire. Resumed rows' detail dicts are bare verdicts
    marked ``resumed``.

    ``partition`` (default ``"auto"``): a KEYED batch (``cols.key``)
    strains into its per-key sub-batch before encoding (ops.partition)
    and verdicts recombine per history: valid iff every key is, ``bad``
    the smallest original bad-op index over the invalid keys, and
    (details mode) the witness sub's result plus ``independent_key``.
    The journal then rides the sub-batch's row order.

    Rows the encoder cannot bound (a pending window past the devices) are
    converted to Op lists and decided by ``host_fallback(model,
    history)`` (default: the exact host engine), their dicts carrying
    ``fallback`` and ``provenance``. ``device=None`` means the CUDA card
    and raises when there is none; ``device="cpu"`` runs the plain
    versions.

    ``timings``, when given a dict, gets the host-clock seconds of the
    layers: ``partition_s`` (keyed batches: the strain), ``encode_s``
    (state space and encode walk; on the scheduler path the encode
    groups), ``device_s`` (launches, copies back and the per-bucket
    verdict decode) and ``fallback_s`` (host-engine rows). ``stats_out``,
    when given a dict, gets the scheduler's ``stats`` (scheduler path
    only)."""
    if details not in (False, True, "invalid"):
        raise ValueError(f"details={details!r}: False, True or 'invalid'")
    opts = dict(scheduler_opts or {})
    device = resolve_device(device)
    if partition and getattr(cols, "key", None) is not None:
        from .partition import (partition_columnar, recombine_details,
                                recombine_verdicts)
        t0 = time.perf_counter()
        pb = partition_columnar(cols)
        if timings is not None:
            timings["partition_s"] = time.perf_counter() - t0
        if pb is not None:
            inner = check_columnar(
                model, pb.cols, device=device, max_slots=max_slots,
                host_fallback=host_fallback, details=details,
                min_device_batch=min_device_batch,
                timings=timings, scheduler=scheduler, faults=faults,
                journal=journal, scheduler_opts=opts, partition=False,
                stats_out=stats_out)
            if details:
                return recombine_details(inner, pb.sub_history,
                                         pb.sub_key, cols.batch)
            v, b, _ = recombine_verdicts(inner[0], inner[1],
                                         pb.sub_history, pb.sub_key,
                                         cols.batch)
            return v, b
    impl = dict(device=device, max_slots=max_slots,
                host_fallback=host_fallback, details=details,
                min_device_batch=min_device_batch,
                timings=timings, faults=faults, opts=opts,
                stats_out=stats_out)
    if journal is None or not scheduler:
        return _check_columnar_impl(model, cols, scheduler=scheduler,
                                    sink=None, **impl)
    decided = {r: d for r, d in journal.decided().items()
               if 0 <= r < cols.batch}
    keep = [r for r in range(cols.batch) if r not in decided]
    if len(keep) == cols.batch:
        sub = cols
        sink = journal.record
    else:
        sub = _cols_take(cols, keep)

        def sink(rows, valid, bad, prov):
            journal.record([keep[int(r)] for r in rows], valid, bad, prov)
    inner = _check_columnar_impl(model, sub, scheduler=True, sink=sink,
                                 **impl)
    if not decided:
        return inner
    if details:
        results: List[Optional[dict]] = [None] * cols.batch
        for r, (vl, bd, pv) in decided.items():
            results[r] = _rehydrate_verdict(vl, bd, pv)
        for j, r in enumerate(keep):
            results[r] = inner[j]
        return results
    valid = np.ones(cols.batch, bool)
    bad = np.full(cols.batch, INT32_MAX, np.int32)
    for r, (vl, bd, pv) in decided.items():
        valid[r] = vl
        if vl is False and bd is not None:
            bad[r] = bd
    if keep:
        k = np.asarray(keep)
        valid[k], bad[k] = inner
    return valid, bad


def _cols_take(cols, rows):
    """Row subset of a ColumnarOps batch (the journal-resume filter)."""
    r = np.asarray(rows, np.int64)
    key = getattr(cols, "key", None)
    return type(cols)(
        type=cols.type[r], process=cols.process[r], kind=cols.kind[r],
        kinds=cols.kinds,
        index=cols.index[r] if cols.index is not None else None,
        key=key[r] if key is not None else None)


class _NativeTailWorker:
    """Decides small wide buckets with the C++ batch engine
    (native.check_batch_native) on a daemon thread while the card runs
    the rest of the batch. ``add`` queues row indices as the stream
    yields them; ``finish`` returns [(row, result)] and raises what the
    engine raised. The thread runs host code only: numpy and ctypes,
    no torch."""

    def __init__(self, model: Model, cols):
        self.model = model
        self.cols = cols
        self._q: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue(1)
        self._thread: Optional[threading.Thread] = None

    def add(self, indices) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="jepsen-native-tail", daemon=True)
            self._thread.start()
        self._q.put(list(indices))

    def finish(self) -> list:
        if self._thread is None:
            return []
        self._q.put(None)
        out, err = self._done.get()
        if err is not None:
            raise err
        return out

    def _run(self) -> None:
        from ..history.columnar import columnar_to_ops
        from ..native import check_batch_native
        out = []
        try:
            while (idxs := self._q.get()) is not None:
                out.extend(zip(idxs, check_batch_native(
                    self.model,
                    [columnar_to_ops(self.cols, i) for i in idxs])))
        except BaseException as e:   # noqa: BLE001 — re-raised by finish
            self._done.put((None, e))
            return
        self._done.put((out, None))


def _check_columnar_impl(model: Model, cols, *, device, max_slots,
                         host_fallback, details, min_device_batch,
                         timings, scheduler, faults, opts, stats_out,
                         sink):
    from ..history.columnar import columnar_to_ops
    from .encode import encode_columnar
    from .statespace import enumerate_statespace

    t_start = time.perf_counter()
    space = enumerate_statespace(model, cols.kinds, MAX_PACKED_STATES)
    eff_slots = max_slots + (device_frontier_capacity(device)
                             if max_slots >= DATA_MAX_SLOTS else 0)
    valid = np.ones(cols.batch, bool)
    bad = np.full(cols.batch, INT32_MAX, np.int32)
    results: List[Optional[dict]] = [None] * cols.batch if details else None
    failures: List = []
    fused_refine: List[int] = []
    host_fallback = host_fallback or wgl_check
    # Small wide buckets ride the C++ batch engine on a side thread,
    # under the card's work (verdict-only and lazy-details callers:
    # full-details rows keep device-derived config samples).
    tail = None
    if min_device_batch > 1 and details in (False, "invalid"):
        tail = _NativeTailWorker(model, cols)
    sch = None
    if scheduler:
        from .schedule import (DIVERTED, BucketScheduler,
                               iter_columnar_groups)
        groups = iter_columnar_groups(space, cols, max_slots=eff_slots,
                                      failures=failures, fuse=True,
                                      renumber=True)
        sch = BucketScheduler(
            return_frontier=details, device=device, faults=faults,
            min_device_rows=min_device_batch if tail is not None else 0,
            **opts)
        if sink is not None:
            sch.on_chunk = _columnar_chunk_recorder(sch, cols, sink)
        stream = sch.run(groups)
    else:
        DIVERTED = object()       # never yielded by the exact flow
        buckets, fails = encode_columnar(space, cols, max_slots=eff_slots)
        failures.extend(fails)
        if tail is not None:
            device_buckets = []
            for b in buckets:
                if b.W >= DATA_MAX_SLOTS and 0 < b.batch < min_device_batch:
                    tail.add(b.indices)
                else:
                    device_buckets.append(b)
            buckets = device_buckets
        stream = run_buckets(buckets, device=device,
                             return_frontier=bool(details))
    laps = [time.perf_counter()]
    for batch, out in stream:
        if out is DIVERTED:
            tail.add(batch.indices)
            continue
        if isinstance(out, WindowOverflow):
            failures.extend((i, str(out)) for i in batch.indices)
            continue
        v, b, front = out
        idx = np.asarray(batch.indices)
        valid[idx] = v
        inv = np.nonzero(~v)[0]
        bad_rows = idx[~v]
        bad_lines = batch.ev_opidx[inv, b[~v]]
        bad[bad_rows] = (cols.index[bad_rows, bad_lines]
                         if cols.index is not None else bad_lines)
        # Rows whose first impossible completion fell inside a fused
        # run only know the run's FIRST member: re-derive exactly on
        # the host after the stream drains.
        fb = fused_bad_rows(batch, v, b)
        fused_refine.extend(int(idx[x]) for x in fb)
        fused_local = set(fb.tolist())
        if not details:
            continue
        for bi, row in enumerate(batch.indices):
            if sch is not None and row in sch.quarantined:
                continue           # placeholder; host-decided below
            if details == "invalid" and bool(v[bi]):
                # The bare contract dict; provenance appears only when it
                # says more than the default (the peel loop decided it).
                results[row] = {"valid": True}
                if sch is not None and row in sch.row_provenance:
                    results[row]["provenance"] = sch.row_provenance[row]
                continue
            if bi in fused_local:
                continue               # refined below
            # The columnar form already applied the prepared-history
            # contract: rebuild with propagated invokes and skip the
            # per-op drop recompute. Renumbered rows decode against
            # their own sub-space (batch.spaces).
            ops = columnar_to_ops(cols, row, propagated=True)
            sp = batch.spaces[bi] if batch.spaces else space
            results[row] = _decode_result(
                sp, ops, bool(v[bi]),
                int(bad[row]) if not bool(v[bi]) else -1, front[bi],
                predropped=True)
            if sch is not None:
                results[row]["provenance"] = sch.row_provenance.get(
                    row, "device")
    laps.append(time.perf_counter())
    if sch is not None:
        # Rows the ladder quarantined carry inert placeholders: the host
        # engine re-decides them with the rows the encoder could not
        # bound.
        failures.extend((i, f"quarantined: {why}")
                        for i, why in sch.quarantined.items())
    if tail is not None:
        for i, r in tail.finish():
            valid[i] = r["valid"] is True
            if r["valid"] is False:
                bad[i] = r["op"].get("index", -1)
            if details == "invalid":
                # The engine's dicts carry no config sample: an invalid
                # row re-derives its full counterexample on the host.
                results[i] = ({"valid": True} if r["valid"] is True
                              else host_fallback(
                                  model, columnar_to_ops(cols, i)))
                results[i].setdefault("provenance", "host-fallback")
            if sink is not None:
                _sink_verdict(sink, i, r)
    if fused_refine:
        # The exact bad op of rows that failed inside a fused run: the
        # C++ batch engine for verdicts, the host engine's full dicts
        # for details callers.
        hs = [columnar_to_ops(cols, i) for i in fused_refine]
        if details:
            rs = [host_fallback(model, h) for h in hs]
        else:
            from ..native import check_batch_native
            rs = check_batch_native(model, hs)
        for i, r in zip(fused_refine, rs):
            valid[i] = r["valid"] is True
            if r["valid"] is False:
                bad[i] = r["op"].get("index", -1)
            if details:
                results[i] = _decided_on_host(r, True)
            if sink is not None:
                _sink_verdict(sink, i, r)
    for row, reason in failures:
        r = host_fallback(model, columnar_to_ops(cols, row))
        valid[row] = r["valid"] is True
        if r["valid"] is False:
            bad[row] = r["op"].get("index", -1)
        if details:
            results[row] = _decided_on_host(r, True, reason)
        if sink is not None:
            _sink_verdict(sink, row, r)
    laps.append(time.perf_counter())
    if timings is not None:
        encode_s = laps[0] - t_start
        device_s = laps[1] - laps[0]
        if sch is not None:
            # The encode groups run inside the stream, between
            # dispatches.
            encode_s += sch.stats["encode_busy_s"]
            device_s -= sch.stats["encode_busy_s"]
        timings.update(encode_s=encode_s, device_s=device_s,
                       fallback_s=laps[2] - laps[1])
    if stats_out is not None and sch is not None:
        stats_out.update(sch.stats)
    if details:
        return results
    return valid, bad


def check_batch_columnar(model: Model, histories: Sequence[List[Op]], *,
                         device=None, max_slots: int = 16,
                         max_states: int = 64, host_fallback=None,
                         details=True, min_device_batch: int = 1,
                         scheduler: bool = True, faults=None,
                         journal=None,
                         scheduler_opts: Optional[dict] = None,
                         partition: object = "auto") -> List[dict]:
    """Check recorded Op-list histories through the columnar path: one
    conversion walk (``ops_to_columnar``), one vectorised encode, kernel
    launches per cost bucket. Per-history result dicts; ``details=
    "invalid"`` skips the valid rows' decode. KV-valued histories
    pre-partition into per-key sub-histories before conversion
    (``partition``, as in check_batch). When the shared vocabulary's
    state space explodes, the batch goes through ``check_batch``
    instead. ``min_device_batch`` and the scheduler knobs are
    check_columnar's (check_batch's on that route)."""
    from ..history.columnar import ops_to_columnar
    from .statespace import StateSpaceExplosion

    if not histories:
        return []
    opts = dict(scheduler_opts or {})
    if partition:
        from .partition import partition_histories, recombine_details
        parts = partition_histories(histories, force=partition is True)
        if parts is not None:
            subs, sub_hist, sub_key = parts
            inner = check_batch_columnar(
                model, subs, device=device, max_slots=max_slots,
                max_states=max_states, host_fallback=host_fallback,
                details=details, min_device_batch=min_device_batch,
                scheduler=scheduler, faults=faults, journal=journal,
                scheduler_opts=opts, partition=False)
            return recombine_details(inner, sub_hist, sub_key,
                                     len(histories))
    try:
        cols = ops_to_columnar(model, histories,
                               max_states=min(max_states,
                                              MAX_PACKED_STATES))
    except StateSpaceExplosion:
        return check_batch(model, histories, device=device,
                           max_states=max_states, max_slots=max_slots,
                           host_fallback=host_fallback,
                           min_device_batch=min_device_batch,
                           scheduler=scheduler, faults=faults,
                           journal=journal, scheduler_opts=opts)
    if details not in (True, "invalid"):    # the contract is List[dict]
        raise ValueError(f"details={details!r}: True or 'invalid'")
    return check_columnar(model, cols, device=device, max_slots=max_slots,
                          details=details, host_fallback=host_fallback,
                          min_device_batch=min_device_batch,
                          scheduler=scheduler, faults=faults,
                          journal=journal, scheduler_opts=opts)


def check_synth(model: Model, spec, *, synth: str = "device", device=None,
                return_meta: bool = False, **kw):
    """Generate and check a deterministic synthetic batch
    (ops.synth_device.SynthSpec): the histories are born in the columnar
    layout (``synth="device"`` or ``"numpy"``: the generator kernel on
    the card, its plain version on the CPU; ``"host"``: the legacy
    lockstep stream of workloads.synth, cas only) and ride
    ``check_columnar`` — per-key partition of keyed specs and the bucket
    scheduler by default. The cas and wide families check here. Returns
    check_columnar's shapes, plus the SynthMeta (None for ``"host"``)
    when ``return_meta=True``. ``faults`` and ``journal``
    among ``kw`` take check_columnar's fault ladder and resume (a
    synthesized batch's journal keys on ``store.spec_digest(spec)``: the
    spec names the batch). A ``timings`` dict among ``kw``
    also gets ``synth_s``, the generation with its copy back."""
    from .synth_device import synthesize
    if spec.family not in ("cas", "wide"):
        raise ValueError(f"check_synth takes the cas and wide families, "
                         f"not {spec.family!r}")
    if synth == "host" and spec.family != "cas":
        # The legacy wide generator returns Op lists.
        raise ValueError("check_synth takes the cas family under "
                         "synth='host'")
    device = resolve_device(device)
    t0 = time.perf_counter()
    cols, meta = synthesize(spec, synth, key_meta=False, device=device)
    if kw.get("timings") is not None:
        kw["timings"]["synth_s"] = time.perf_counter() - t0
    out = check_columnar(model, cols, device=device, **kw)
    return (out, meta) if return_meta else out
