"""Seeded history generators that run where the histories are checked.

The CAS-register and wide-window families of the reference's device
generators, emitting batches directly in the prepared columnar layout
(history.columnar.ColumnarOps): no per-op Python objects, and
``columnar_to_ops`` recovers an Op list on demand.

  * **Counter-based PRNG.** Every random draw is a pure function of
    ``(campaign seed, history, stream, counter)`` through a splitmix32
    mixer (``fold_in``) in wrapping uint32 arithmetic: one key per
    (seed, history), split per draw class (schedule, op values, fault
    schedule, corruption), a counter per op. The stream keys are derived
    on the host in numpy (``history_keys_for``), from global row ids, so
    rows [lo, hi) of a batch equal the same rows of the full batch.

  * **Closed-form schedule.** Op ``i`` runs on process ``i % P``,
    completes in op order, and invokes ``d_i`` completions early, where
    ``d`` is a clipped ±1 random walk over ``[0, min(i, P-1)]``. Invoke
    and completion orders are both monotone in the op index, so each
    line's op follows from a closed form (``_op_positions``,
    ``_line_decode``). The one sequential piece is the lag walk with the
    per-key register.

  * **Faults.** ``p_info`` times out completions (the op possibly
    applied), and a nemesis window ``(crash_lo, crash_hi, p_crash)``
    crashes ops (an invoke with no completion). ``corrupt`` perturbs one
    observed read per hit row.

  * **Metadata.** Each batch carries a SynthMeta: per-history peak
    pending window and, for keyed batches, per-(history, key) windows.

Two implementations of the generator body exist, and the entry points
pick by device: on the card ``cuda_synth`` launches the hand-written
kernel (``csrc/synth_device.cu``) or raises; on the CPU
``plain_cas_core``/``plain_wide_core``, the plain PyTorch version, runs.
Both give the reference's arrays bit for bit.

  * **List-append.** The la family shares the schedule and the lag walk;
    op ``i`` appends a fresh element (ids 1, 2, ... per row) to one key
    or reads it, every op completes ok, and a read observes the key's
    append count at its completion. The corruption is a stale read: a
    read whose invoke came after some append to its key completed
    observes a shorter prefix, an anti-dependency cycle (G2) the graph
    checker convicts. Batches are ``LaBatch``; ``decode_la`` gives Op
    lists for ``checkers.cycle.check_graphs_batch(family="list-append")``.

  * **Fuzz neighbourhoods.** ``neighbor_keys`` perturbs one stream of a
    row's keys (the schedule, the values, or the fault stream with a
    shifted crash window); ``synth_cas_neighbors`` generates such rows
    in one batch for the fuzz loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..history.columnar import PAD, C_INVOKE, C_OK, C_INFO, ColumnarOps
from ..history.core import index as index_history
from ..history.ops import Op, invoke_op, ok_op
from ..workloads.synth import cas_kind_vocabulary
from . import cuda_synth
from .device import resolve_device

# splitmix32 finalizer constants and the golden-ratio stream stride. All
# arithmetic is wrapping uint32.
_M1 = 0x21F0AAAD
_M2 = 0x735A2D97
_GOLD = 0x9E3779B9
_ROOT = 0x6A09E667
MASK32 = 0xFFFFFFFF

# Stream tags: one sub-key per draw class, split from the history key.
# "fault" covers the whole fault schedule: timeout (:info) draws, crash
# draws, and the applied? coin.
_S_SCHED, _S_VALS, _S_FAULT, _S_CORR = 0x51, 0x52, 0x54, 0x55
STREAMS = ("sched", "vals", "fault", "corr")
# The streams the list-append family draws from (it has no faults).
LA_STREAMS = ("sched", "vals", "corr")


# ------------------------------------------------ host half (numpy keys)

def _mix(x):
    x = (x ^ (x >> 16)) * np.uint32(_M1)
    x = (x ^ (x >> 15)) * np.uint32(_M2)
    return x ^ (x >> 15)


def fold_in(key, data):
    """Derive a child key or draw: ``mix(key + (data + 1) * GOLD)`` in
    wrapping uint32; ``key`` and ``data`` broadcast."""
    with np.errstate(over="ignore"):
        key = np.asarray(key).astype(np.uint32)
        data = np.asarray(data).astype(np.uint32)
        return _mix(key + (data + np.uint32(1)) * np.uint32(_GOLD))


def history_keys_for(seed: int, rows) -> Dict[str, np.ndarray]:
    """Per-history stream keys for global row ids ``rows`` under
    campaign ``seed``."""
    root = fold_in(np.uint32(_ROOT), np.uint32(seed & MASK32))
    hk = fold_in(root, np.asarray(rows))
    return {name: fold_in(hk, tag)
            for name, tag in zip(STREAMS,
                                 (_S_SCHED, _S_VALS, _S_FAULT, _S_CORR))}


def _thresh24(p: float) -> np.uint32:
    """Probability -> 24-bit integer threshold: ``draw >> 8 < t`` is an
    exact, float-free Bernoulli(p)."""
    return np.uint32(int(min(max(float(p), 0.0), 1.0) * (1 << 24)))


def _thresh14(p: float) -> np.uint32:
    """14-bit Bernoulli threshold for the packed per-op draw fields."""
    return np.uint32(int(min(max(float(p), 0.0), 1.0) * (1 << 14)))


@dataclass(frozen=True)
class SynthSpec:
    """One deterministic synthetic batch: the spec names the histories.
    ``crash_lo/crash_hi/p_crash`` is the nemesis window (op-index
    space): ops invoked inside it crash (no completion) with probability
    ``p_crash``. ``width``/``invalid`` only apply to the ``wide``
    family. The same fields as the reference's SynthSpec: the same spec
    names the same batch in both packages."""

    family: str = "cas"          # "cas" | "la" | "wide"
    n: int = 1024
    seed: int = 0
    n_procs: int = 5
    n_ops: int = 40
    n_values: int = 5
    n_keys: int = 1
    corrupt: float = 0.0
    p_info: float = 0.0
    crash_lo: int = 0
    crash_hi: int = 0
    p_crash: float = 0.0
    width: int = 17
    invalid: bool = False


@dataclass
class SynthMeta:
    """Generator-side metadata. ``peak_w`` is each history's peak pending
    window (the encode walk's ``max_live``: invokes allocate, only
    ok-completions free); ``key_peak_w``/``key_present`` are the
    per-(history, key) windows of keyed batches (None when unkeyed)."""

    peak_w: np.ndarray                       # [B] int32
    key_peak_w: Optional[np.ndarray] = None  # [B, K] int32
    key_present: Optional[np.ndarray] = None  # [B, K] bool
    spec: Optional[SynthSpec] = None


def _resolve_keys(spec: SynthSpec, rows, keys) -> Dict[str, np.ndarray]:
    """Per-row stream keys, derived on the host in numpy."""
    if keys is not None:
        return {s: np.asarray(keys[s]).astype(np.uint32) for s in STREAMS}
    lo, hi = rows if rows is not None else (0, spec.n)
    return history_keys_for(spec.seed, np.arange(lo, hi, dtype=np.uint32))


def _crash_arrays(spec: SynthSpec, B, crash_lo=None, crash_hi=None):
    lo = (np.full(B, spec.crash_lo, np.int32) if crash_lo is None
          else np.asarray(crash_lo, np.int32))
    hi = (np.full(B, spec.crash_hi, np.int32) if crash_hi is None
          else np.asarray(crash_hi, np.int32))
    return lo, hi


def check_cas_bounds(n_procs: int, n_ops: int, n_values: int,
                     n_keys: int) -> None:
    """The generator's packing limits: the payload's kind field is 24
    bits and its key field 4 bits, and ``peak_w`` counts in 15 bits."""
    if not (1 <= n_keys <= 16 and n_values >= 1
            and 1 + 2 * n_values + n_values * n_values < (1 << 24)):
        raise ValueError(f"n_keys={n_keys}, n_values={n_values} outside "
                         "the packed payload")
    if not (1 <= n_ops < (1 << 15) and 1 <= n_procs < (1 << 15)):
        raise ValueError(f"n_ops={n_ops}, n_procs={n_procs} outside "
                         "1..32767")


# ------------------------------------------------ the plain version

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c``, in 16-bit halves so no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), _M1)
    x = _mul32(x ^ (x >> 15), _M2)
    return x ^ (x >> 15)


def _fold_in_t(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` on int64 tensors holding uint32 values."""
    return _mix_t((key + _mul32((data + 1) & MASK32, _GOLD)) & MASK32)


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 uint32 values."""
    return bits.to(torch.int64) & MASK32


def _op_positions(d: torch.Tensor, n: int, P: int):
    """Closed-form line positions for the monotone-block schedule.

    ``d`` [B, n] is the lag walk (``d_i <= min(i, P-1)`` and ``d_{i+1}
    <= d_i + 1``, so invoke blocks ``j_i = i - d_i`` are nondecreasing:
    invoke order is op order). Lines run block-0 invokes, completion 0,
    block-1 invokes, completion 1, ..., so ``comp_line(i) = 2i + 1 +
    #{l in 1..P-1 : j_{i+l} <= i}`` (future invokes that jumped
    ahead)."""
    i = torch.arange(n, device=d.device)[None, :]
    j = i - d
    ahead = torch.zeros_like(d)
    for off in range(1, min(P, n)):
        # j_{i+off} <= i  <=>  d_{i+off} >= off
        ahead[:, :n - off] += (d[:, off:] >= off).to(d.dtype)
    return 2 * i + 1 + ahead, j


def _line_decode(comp_line: torch.Tensor, n: int, P: int):
    """Invert the monotone merge: for every line ``t`` of the [0, 2n)
    grid, its op and whether it is the completion line. ``comp_line`` is
    strictly increasing with ``2i + 1 <= comp_line(i) <= 2i + P``, so the
    completions before line t are ``base`` plus a count over a P//2-wide
    window of candidates; the r-th invoke line belongs to op r."""
    B = comp_line.shape[0]
    t = torch.arange(2 * n, device=comp_line.device)[None, :]
    base = torch.div(t - P + 1, 2, rounding_mode="floor").clamp(0, n)
    n_comp = base.expand(B, 2 * n).clone()
    for off in range(P // 2):
        cand = base + off
        got = comp_line.gather(1, cand.clamp(0, n - 1).expand(B, 2 * n))
        n_comp += ((cand < n) & (got < t)).to(n_comp.dtype)
    is_comp = (n_comp < n) & (comp_line.gather(
        1, n_comp.clamp(0, n - 1)) == t)
    op = torch.where(is_comp, n_comp, t - n_comp)
    return op, is_comp


def _cas_scan(step, k, a, b2, eff_w, eff_c, P: int, K: int):
    """The sequential piece: the lag walk (clipped ±1 over [0, min(i,
    P-1)]) and the per-key register in completion (= op) order. The
    register starts at -1 (None); writes set it, a cas sets it iff it
    matches, reads observe it."""
    B, n = k.shape
    d = torch.zeros(B, dtype=torch.int64, device=k.device)
    reg = torch.full((B, K), -1, dtype=torch.int64, device=k.device)
    d_out = torch.empty_like(k)
    obs = torch.empty_like(k)
    for t in range(n):
        d = (d + step[:, t]).clamp(0, min(t, P - 1))
        d_out[:, t] = d
        kt = k[:, t:t + 1]
        cur = reg.gather(1, kt)[:, 0]
        obs[:, t] = cur
        mt = cur == a[:, t]
        new = torch.where(eff_w[:, t], a[:, t],
                          torch.where(eff_c[:, t] & mt, b2[:, t], cur))
        reg.scatter_(1, kt, new[:, None])
    return d_out, obs, obs == a


def plain_cas_core(keys: Dict[str, torch.Tensor], crash_lo: torch.Tensor,
                   crash_hi: torch.Tensor, p_info_t: int, corrupt_t: int,
                   p_crash_t: int, *, n_procs: int, n_ops: int,
                   n_values: int, n_keys: int, with_info: bool,
                   with_crash: bool, with_corrupt: bool,
                   key_meta: bool) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the CAS/register generator, the twin
    of the reference's ``_cas_core``: ``keys`` are int32 bit patterns
    [B] per stream, ``crash_lo/hi`` int32 [B], thresholds integers.
    Returns ``type`` int8, ``process`` int16, ``kind`` int32 [B, 2n],
    ``peak_w`` int32 [B] and, when ``n_keys > 1``, ``key`` int32 [B, 2n]
    (with ``key_meta``, ``key_peak_w`` int32 and ``key_present`` bool
    [B, K]). uint32 values ride in int64, masked after each product."""
    P, n, V, K = n_procs, n_ops, n_values, n_keys
    check_cas_bounds(P, n, V, K)
    dev = keys["sched"].device
    B = keys["sched"].shape[0]
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    none = torch.zeros((B, n), dtype=torch.bool, device=dev)

    bits_s = _fold_in_t(_u32(keys["sched"])[:, None], i)
    bits_v = _fold_in_t(_u32(keys["vals"])[:, None], i)
    step = bits_s % 3 - 1
    f = (bits_v >> 2) % 3
    a = (bits_v >> 4) % V
    b2 = (bits_v >> 12) % V
    k = (bits_v >> 20) % K if K > 1 else torch.zeros_like(a)

    info = crash = applies = none
    if with_info or with_crash:
        bits_f = _fold_in_t(_u32(keys["fault"])[:, None], i)
        applies = (bits_f & 1) == 1
        if with_info:
            info = ((bits_f >> 2) & 0x3FFF) < p_info_t
        if with_crash:
            crash = ((i >= crash_lo.to(torch.int64)[:, None])
                     & (i < crash_hi.to(torch.int64)[:, None])
                     & (((bits_f >> 16) & 0x3FFF) < p_crash_t))
            info = info & ~crash
    ok = ~info & ~crash

    is_r, is_w, is_c = f == 0, f == 1, f == 2
    eff_w = is_w & (ok | applies)
    eff_c = is_c & (ok | applies)        # applies iff it also matches
    d, obs, match = _cas_scan(step, k, a, b2, eff_w, eff_c, P, K)

    READ0, WRITE0, CAS0 = 0, 1 + V, 1 + 2 * V
    kind_read = torch.where(obs < 0, READ0, READ0 + 1 + obs)
    kind_inv = torch.where(is_r, kind_read,
                           torch.where(is_w, WRITE0 + a, CAS0 + a * V + b2))
    # Retractions: a failed cas never happened; never-ok reads observed
    # nothing and are total identities, so they drop.
    drop = (is_r & ~ok) | (is_c & ok & ~match)
    has_comp = ~crash & ~drop

    if with_corrupt and V > 1:
        # Perturb one observed read per hit row: the first eligible op of
        # the largest draw, old -1 for read(None), new = 1 + (old +
        # delta) % V.
        corr = _u32(keys["corr"])
        hb = _fold_in_t(corr, 0)
        sc = _fold_in_t(corr[:, None], i + 1)
        eligible = is_r & ~drop
        m = torch.where(eligible, (sc >> 1) + 1, 0)
        pick = m.argmax(1)
        do = ((hb >> 8) < corrupt_t) & eligible.any(1)
        delta = 1 + (hb & 0xFF) % (V - 1)
        newk = READ0 + 1 + (kind_inv - (READ0 + 1) + delta[:, None]) % V
        at_pick = (i == pick[:, None]) & do[:, None]
        kind_inv = torch.where(at_pick, newk, kind_inv)

    # Line assembly through the closed-form schedule; the per-op payload
    # packs into one word: kind+1 (24 bits) | drop | crash | info | key.
    comp_line, j = _op_positions(d, n, P)
    op_t, is_comp = _line_decode(comp_line, n, P)
    pay = ((kind_inv + 1) | (drop.to(torch.int64) << 24)
           | (crash.to(torch.int64) << 25) | (info.to(torch.int64) << 26)
           | (k << 27))
    pay_t = pay.gather(1, op_t)
    dead = (((pay_t >> 24) & 1) == 1) | (is_comp & (((pay_t >> 25) & 1)
                                                    == 1))
    typ = torch.where(dead, PAD, torch.where(
        ~is_comp, C_INVOKE, torch.where(((pay_t >> 26) & 1) == 1, C_INFO,
                                        C_OK))).to(torch.int8)
    real = ~dead
    out = {"type": typ,
           "process": torch.where(real, op_t % P, 0).to(torch.int16),
           "kind": torch.where(real & ~is_comp, (pay_t & 0xFFFFFF) - 1,
                               -1).to(torch.int32)}

    # Pending right after the invoke of op i: (real invokes <= i) - (ok
    # completions among ops < j_i).
    okflag = has_comp & ~info
    jm1 = (j - 1).clamp(0, n - 1)

    def pend_peak(mine):
        live = mine & ~drop
        inv = torch.cumsum(live.to(torch.int64), 1)
        okc = torch.cumsum((mine & okflag).to(torch.int64), 1)
        okb = torch.where(j > 0, okc.gather(1, jm1), 0)
        pend = torch.where(live, inv - okb, 0)
        return pend.max(1).values.clamp(min=1).to(torch.int32)

    out["peak_w"] = pend_peak(torch.ones_like(drop))
    if K > 1:
        out["key"] = torch.where(real, (pay_t >> 27) & 0xF,
                                 -1).to(torch.int32)
        if key_meta:
            out["key_peak_w"] = torch.stack(
                [pend_peak(k == kk) for kk in range(K)], 1)
            out["key_present"] = torch.stack(
                [((k == kk) & ~drop).any(1) for kk in range(K)], 1)
    return out


def plain_wide_core(vals_key: torch.Tensor, *, width: int, n_values: int,
                    invalid: bool) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the wide-window generator (the twin
    of the reference's ``_wide_core``): per row, ``width - 1`` crashed
    writes of seeded values, then one read that completes ok while all
    are pending. ``invalid`` makes the read observe the extra kind
    appended after the cas vocabulary, a value no write produced."""
    dev = vals_key.device
    B, w1, N = vals_key.shape[0], width - 1, width + 1
    c = torch.arange(w1, dtype=torch.int64, device=dev)[None, :]
    v = _fold_in_t(_u32(vals_key)[:, None], c) % n_values
    typ = torch.full((B, N), C_INVOKE, dtype=torch.int8, device=dev)
    typ[:, N - 1] = C_OK
    proc = torch.arange(N, device=dev).clamp(max=w1).to(torch.int16)
    read_kind = 1 + 2 * n_values + n_values * n_values if invalid else 0
    kind = torch.cat([1 + n_values + v,
                      torch.full((B, 1), read_kind, device=dev),
                      torch.full((B, 1), -1, device=dev)], 1)
    return {"type": typ, "process": proc[None, :].expand(B, N).contiguous(),
            "kind": kind.to(torch.int32),
            "peak_w": torch.full((B,), width, dtype=torch.int32,
                                 device=dev)}


# Append coin of the la family: an op appends when its value draw's top
# 24 bits fall below this threshold (the reference's 0.55 * 2^24).
_LA_APPEND_T = int(0.55 * (1 << 24))
# The corruption stream's counter for the dropped-prefix draw.
_LA_DROP_CTR = 0xD00D


def check_la_bounds(n_procs: int, n_ops: int, n_keys: int) -> None:
    """The la generator's shapes: at least one process, op and key."""
    if not (n_procs >= 1 and n_ops >= 1 and n_keys >= 1):
        raise ValueError(f"n_procs={n_procs}, n_ops={n_ops}, "
                         f"n_keys={n_keys}: each must be at least 1")


def plain_walk(step: torch.Tensor, P: int) -> torch.Tensor:
    """The lag walk alone (the twin of the reference's ``_walk_scan``):
    ``d_t = clip(d_{t-1} + step_t, 0, min(t, P-1))`` from ``d = 0``."""
    B, n = step.shape
    d = torch.zeros(B, dtype=step.dtype, device=step.device)
    d_out = torch.empty_like(step)
    for t in range(n):
        d = (d + step[:, t]).clamp(0, min(t, P - 1))
        d_out[:, t] = d
    return d_out


def plain_la_core(keys: Dict[str, torch.Tensor], corrupt_t: int, *,
                  n_procs: int, n_ops: int,
                  n_keys: int) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the list-append generator, the twin
    of the reference's ``_la_core``: ``keys`` are int32 bit patterns [B]
    for the sched, vals and corr streams, ``corrupt_t`` a 24-bit
    threshold. Returns ``type`` int8, ``process`` int16, ``fn`` int8 (0
    append, 1 read), ``key`` int32, ``val`` int32 [B, 2n] and
    ``corrupted`` bool [B]. ``val`` is the element id on append lines,
    the observed prefix length on ok reads and -1 on read invokes. uint32
    values ride in int64, so shifts and remainders are unsigned."""
    P, n, K = n_procs, n_ops, n_keys
    check_la_bounds(P, n, K)
    dev = keys["sched"].device
    B = keys["sched"].shape[0]
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :]

    bits_s = _fold_in_t(_u32(keys["sched"])[:, None], i)
    bits_v = _fold_in_t(_u32(keys["vals"])[:, None], i)
    d = plain_walk(bits_s % 3 - 1, P)
    comp_line, j = _op_positions(d, n, P)

    is_app = (bits_v >> 8) < _LA_APPEND_T
    key = (bits_v >> 4) % K if K > 1 else torch.zeros_like(bits_v)
    elem = torch.cumsum(is_app.to(torch.int64), 1)     # 1-based ids

    # Per-key append counts: the observed length at each op (inclusive;
    # a read is not an append, so a read counts only earlier appends)
    # and at op j - 1, the last op completed before its invoke block.
    obs_len = torch.zeros_like(bits_v)
    len_inv = torch.zeros_like(bits_v)
    jm1 = (j - 1).clamp(0, n - 1)
    for kk in range(K):
        mine = key == kk
        ac = torch.cumsum((is_app & mine).to(torch.int64), 1)
        obs_len += torch.where(mine, ac, 0)
        at_inv = torch.where(j > 0, ac.gather(1, jm1), 0)
        len_inv += torch.where(mine, at_inv, 0)

    corr = _u32(keys["corr"])
    hb = _fold_in_t(corr, 0)
    db = _fold_in_t(corr, _LA_DROP_CTR)
    sc = _fold_in_t(corr[:, None], i + 1)
    eligible = ~is_app & (len_inv >= 1)
    m = torch.where(eligible, (sc >> 1) + 1, 0)
    pick = m.argmax(1)
    do = ((hb >> 8) < corrupt_t) & eligible.any(1)
    lai = len_inv.gather(1, pick[:, None])[:, 0].clamp(min=1)
    j_drop = db % lai
    at_pick = (i == pick[:, None]) & do[:, None]
    obs_len = torch.where(at_pick, j_drop[:, None], obs_len)

    # Line assembly: every la op invokes and completes ok.
    op_t, is_comp = _line_decode(comp_line, n, P)
    app_t = is_app.gather(1, op_t)
    val = torch.where(app_t, elem.gather(1, op_t),
                      torch.where(is_comp, obs_len.gather(1, op_t), -1))
    return {"type": torch.where(is_comp, C_OK, C_INVOKE).to(torch.int8),
            "process": (op_t % P).to(torch.int16),
            "fn": torch.where(app_t, 0, 1).to(torch.int8),
            "key": key.gather(1, op_t).to(torch.int32),
            "val": val.to(torch.int32), "corrupted": do}


# ------------------------------------------------ dispatch by device

def cas_core(keys, crash_lo, crash_hi, p_info_t, corrupt_t, p_crash_t,
             **static) -> Dict[str, torch.Tensor]:
    """The generator body on the tensors' device: the CUDA kernel on a
    CUDA tensor (it launches or raises), the plain version on a CPU
    tensor."""
    dev = keys["sched"].device
    if dev.type == "cuda":
        fn = cuda_synth.synth_cas
    elif dev.type == "cpu":
        fn = plain_cas_core
    else:
        raise ValueError(f"no generator kernel for device {dev}")
    return fn(keys, crash_lo, crash_hi, p_info_t, corrupt_t, p_crash_t,
              **static)


def wide_core(vals_key, **static) -> Dict[str, torch.Tensor]:
    """As ``cas_core``, for the wide-window family."""
    dev = vals_key.device
    if dev.type == "cuda":
        return cuda_synth.synth_wide(vals_key, **static)
    if dev.type == "cpu":
        return plain_wide_core(vals_key, **static)
    raise ValueError(f"no generator kernel for device {dev}")


def la_core(keys, corrupt_t, **static) -> Dict[str, torch.Tensor]:
    """As ``cas_core``, for the list-append family."""
    dev = keys["sched"].device
    if dev.type == "cuda":
        return cuda_synth.synth_la(keys, corrupt_t, **static)
    if dev.type == "cpu":
        return plain_la_core(keys, corrupt_t, **static)
    raise ValueError(f"no generator kernel for device {dev}")


def _bits_on(a: np.ndarray, device) -> torch.Tensor:
    """uint32 or int32 numpy values as int32 bit patterns on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def cas_inputs(spec: SynthSpec, *, rows=None, keys=None, crash_lo=None,
               crash_hi=None, device) -> tuple:
    """The generator's inputs on ``device``: ``(keys, crash_lo, crash_hi,
    p_info_t, corrupt_t, p_crash_t)``, for ``cas_core``."""
    kd = _resolve_keys(spec, rows, keys)
    B = int(kd["sched"].shape[0])
    lo, hi = _crash_arrays(spec, B, crash_lo, crash_hi)
    return ({s: _bits_on(kd[s], device) for s in STREAMS},
            _bits_on(lo, device), _bits_on(hi, device),
            int(_thresh14(spec.p_info)), int(_thresh24(spec.corrupt)),
            int(_thresh14(spec.p_crash)))


def wide_inputs(spec: SynthSpec, *, rows=None, device) -> torch.Tensor:
    """The wide generator's input on ``device``: the per-row value-stream
    keys, for ``wide_core``."""
    return _bits_on(_resolve_keys(spec, rows, None)["vals"], device)


def la_inputs(spec: SynthSpec, *, rows=None, keys=None, device) -> tuple:
    """The la generator's inputs on ``device``: ``(keys, corrupt_t)``,
    for ``la_core``."""
    kd = _resolve_keys(spec, rows, keys)
    return ({s: _bits_on(kd[s], device) for s in LA_STREAMS},
            int(_thresh24(spec.corrupt)))


def la_static(spec: SynthSpec) -> dict:
    """The la generator's static shape for ``spec``."""
    return dict(n_procs=spec.n_procs, n_ops=spec.n_ops,
                n_keys=spec.n_keys)


def cas_static(spec: SynthSpec, key_meta: bool = True) -> dict:
    """The generator's static flags for ``spec``."""
    return dict(n_procs=spec.n_procs, n_ops=spec.n_ops,
                n_values=spec.n_values, n_keys=spec.n_keys,
                with_info=spec.p_info > 0, with_crash=spec.p_crash > 0,
                with_corrupt=spec.corrupt > 0, key_meta=key_meta)


def _numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


# ------------------------------------------------ entry points

def synth_cas_device(spec: SynthSpec, *, rows=None, keys=None,
                     crash_lo=None, crash_hi=None, key_meta: bool = True,
                     device=None) -> Tuple[ColumnarOps, SynthMeta]:
    """Generate ``spec`` (or its ``rows`` slice, or an explicit ``keys``
    neighbourhood) in the prepared columnar layout. ``device=None``
    means the CUDA card and raises when there is none; ``device="cpu"``
    runs the plain version. The arrays come back as numpy, equal to the
    reference's ``synth_cas_device`` bit for bit. ``key_meta=False``
    skips the per-key window metadata."""
    if spec.family != "cas":
        raise ValueError(f"synth_cas_device takes the cas family, not "
                         f"{spec.family!r}")
    dev = resolve_device(device)
    out = _numpy(cas_core(*cas_inputs(spec, rows=rows, keys=keys,
                                      crash_lo=crash_lo, crash_hi=crash_hi,
                                      device=dev),
                          **cas_static(spec, key_meta)))
    meta = SynthMeta(peak_w=out["peak_w"], key_peak_w=out.get("key_peak_w"),
                     key_present=out.get("key_present"), spec=spec)
    cols = ColumnarOps(type=out["type"], process=out["process"],
                       kind=out["kind"],
                       kinds=cas_kind_vocabulary(spec.n_values),
                       key=out.get("key"), meta=meta)
    return cols, meta


def synth_wide_device(spec: SynthSpec, *, rows=None,
                      device=None) -> Tuple[ColumnarOps, SynthMeta]:
    """Seeded wide-window batch: per history, width-1 crashed writes
    (seeded values) pin slots forever, then one read completes ok while
    all are pending; ``invalid=True`` makes the read observe a value no
    write could produce. Device rules as ``synth_cas_device``."""
    if spec.family != "wide":
        raise ValueError(f"synth_wide_device takes the wide family, not "
                         f"{spec.family!r}")
    if spec.width < 1 or spec.n_values < 1:
        raise ValueError(f"width={spec.width}, n_values={spec.n_values}")
    out = _numpy(wide_core(wide_inputs(spec, rows=rows,
                                       device=resolve_device(device)),
                           width=spec.width, n_values=spec.n_values,
                           invalid=spec.invalid))
    kinds = cas_kind_vocabulary(spec.n_values)
    if spec.invalid:
        kinds = kinds + [("read", spec.n_values + 5)]
    meta = SynthMeta(peak_w=out["peak_w"], spec=spec)
    cols = ColumnarOps(type=out["type"], process=out["process"],
                       kind=out["kind"], kinds=kinds, meta=meta)
    return cols, meta


@dataclass
class LaBatch:
    """A batch of list-append histories in a compact layout: ``fn`` 0 =
    append / 1 = read; ``val`` carries the row-unique element on append
    lines, the observed prefix length on ok-read lines (lists are
    append-only, so every observation, the corrupted stale read too, is
    a prefix of the key's final list), and -1 on read invokes.
    ``decode_la`` recovers the Op lists. The reference's LaBatch, field
    for field."""

    type: np.ndarray      # [B, N] int8
    process: np.ndarray   # [B, N] int16
    fn: np.ndarray        # [B, N] int8
    key: np.ndarray       # [B, N] int32
    val: np.ndarray       # [B, N] int32
    n_keys: int
    corrupted: np.ndarray = None   # [B] bool

    @property
    def batch(self) -> int:
        return int(self.type.shape[0])

    @property
    def n_lines(self) -> int:
        return int(self.type.shape[1])


def synth_la_device(spec: SynthSpec, *, rows=None, keys=None,
                    device=None) -> LaBatch:
    """Seeded list-append batch (``synth_la_history`` semantics: unique
    elements, reads observe the key's full list at completion, and the
    corruption is a stale read: a truncation that drops an element whose
    append completed before the read invoked, a G2 anti-dependency
    cycle). Device rules as ``synth_cas_device``; the arrays equal the
    reference's ``synth_la_device`` bit for bit."""
    if spec.family != "la":
        raise ValueError(f"synth_la_device takes the la family, not "
                         f"{spec.family!r}")
    out = _numpy(la_core(*la_inputs(spec, rows=rows, keys=keys,
                                    device=resolve_device(device)),
                         **la_static(spec)))
    return LaBatch(type=out["type"], process=out["process"], fn=out["fn"],
                   key=out["key"], val=out["val"], n_keys=spec.n_keys,
                   corrupted=out["corrupted"])


def decode_la(batch: LaBatch, row: int) -> List[Op]:
    """One row back to the host Op-list form the graph checker takes
    (``synth_la_history`` value shapes): append ``[k, elem]``, read
    invoke ``[k, None]``, ok read ``[k, [elements...]]``."""
    lists: Dict[int, list] = {k: [] for k in range(batch.n_keys)}
    out: List[Op] = []
    for jl in range(batch.n_lines):
        t = int(batch.type[row, jl])
        if t == PAD:
            continue
        p = int(batch.process[row, jl])
        k = int(batch.key[row, jl])
        v = int(batch.val[row, jl])
        append = batch.fn[row, jl] == 0
        if t == C_INVOKE:
            out.append(invoke_op(p, "append", [k, v]) if append
                       else invoke_op(p, "read", [k, None]))
        elif append:
            lists[k].append(v)
            out.append(ok_op(p, "append", [k, v]))
        else:
            out.append(ok_op(p, "read", [k, list(lists[k][:v])]))
    return index_history(out)


SYNTH_LABELS = ("device", "numpy", "host")


def synthesize(spec: SynthSpec, synth: str = "device", *, rows=None,
               key_meta: bool = True, device=None):
    """The batch source the check, campaign and fuzz paths share.

    ``synth="device"`` or ``"numpy"`` (the reference's two labels of its
    generator family, bit-identical): the generator kernel on the card,
    its plain version on the CPU (``device``). They return
    ``(ColumnarOps, SynthMeta)`` for the cas and wide families and
    ``(LaBatch, None)`` for list-append, whose rows lower to dependency
    graphs (``decode_la``, then ``checkers.cycle``). ``synth="host"``:
    the legacy lockstep generators of workloads.synth, on the host, the
    reference's historical stream byte for byte; cas returns
    ``(ColumnarOps, None)``, la and wide return Op lists with None."""
    if synth not in SYNTH_LABELS:
        raise ValueError(f"unknown synth {synth!r}: one of {SYNTH_LABELS}")
    if synth == "host":
        return _synthesize_host(spec, rows)
    if spec.family == "cas":
        return synth_cas_device(spec, rows=rows, key_meta=key_meta,
                                device=device)
    if spec.family == "wide":
        return synth_wide_device(spec, rows=rows, device=device)
    if spec.family == "la":
        return synth_la_device(spec, rows=rows, device=device), None
    raise ValueError(f"unknown synth family {spec.family!r}")


def _synthesize_host(spec: SynthSpec, rows):
    from ..workloads import synth as hsynth
    lo, hi = rows if rows is not None else (0, spec.n)
    if spec.family == "cas":
        # The stream depends only on (seed, n): a rows slice generates
        # the batch of its end row and slices it.
        cols = hsynth.synth_cas_columnar(
            hi, seed=spec.seed, n_procs=spec.n_procs, n_ops=spec.n_ops,
            n_values=spec.n_values, corrupt=spec.corrupt,
            p_info=spec.p_info, n_keys=spec.n_keys)
        if lo:
            cols = ColumnarOps(
                type=cols.type[lo:], process=cols.process[lo:],
                kind=cols.kind[lo:], kinds=cols.kinds,
                key=cols.key[lo:] if cols.key is not None else None)
        return cols, None
    if spec.family == "la":
        return [hsynth.synth_la_history(
            s, n_procs=spec.n_procs, n_ops=spec.n_ops,
            n_keys=spec.n_keys, corrupt=spec.corrupt)
            for s in hsynth.seed_stream(spec.seed, hi)[lo:]], None
    if spec.family == "wide":
        return [hsynth.synth_wide_window_history(
            width=spec.width, n_values=spec.n_values,
            invalid=spec.invalid, seed=s)
            for s in hsynth.seed_stream(spec.seed, hi)[lo:]], None
    raise ValueError(f"unknown synth family {spec.family!r}")


# ------------------------------------------------ fuzz neighbourhoods

NEIGHBOR_MODES = ("order", "values", "nemesis")


def neighbor_keys(spec: SynthSpec,
                  neighbors: Sequence[Tuple[int, str, int]]):
    """Stream keys and crash windows for a neighbourhood batch: each
    entry is ``(history_row, mode, variant)`` around ``spec``'s batch.
    ``order`` perturbs only the schedule stream (same ops, new
    interleavings), ``values`` only the op-value stream (value
    collisions against the same schedule), ``nemesis`` re-draws the
    fault stream and shifts the crash window. Deterministic: the same
    (spec, row, mode, variant) always names the same history, in both
    packages."""
    rows = np.asarray([r for r, _, _ in neighbors], np.uint32)
    base = history_keys_for(spec.seed, rows)
    keys = {s: np.array(base[s], np.uint32, copy=True) for s in STREAMS}
    lo = np.full(len(neighbors), spec.crash_lo, np.int32)
    hi = np.full(len(neighbors), spec.crash_hi, np.int32)
    step = max(1, spec.n_ops // 16)
    for i, (_, mode, variant) in enumerate(neighbors):
        salt = np.uint32(0xF00D + variant)
        if mode == "order":
            keys["sched"][i] = fold_in(keys["sched"][i], salt)
        elif mode == "values":
            keys["vals"][i] = fold_in(keys["vals"][i], salt)
        elif mode == "nemesis":
            keys["fault"][i] = fold_in(keys["fault"][i], salt)
            shift = ((variant // 2) + 1) * step * (1 if variant % 2 else -1)
            lo[i] = max(0, int(lo[i]) + shift)
            hi[i] = max(int(lo[i]), int(hi[i]) + shift)
        else:
            raise ValueError(f"unknown neighborhood mode {mode!r}")
    return keys, lo, hi


def synth_cas_neighbors(spec: SynthSpec,
                        neighbors: Sequence[Tuple[int, str, int]], *,
                        device=None) -> Tuple[ColumnarOps, SynthMeta]:
    """One batch holding every neighbourhood history (row i of the
    output is ``neighbors[i]``): the fuzz loop's re-dispatch unit. The
    generator batch pads to a power of two and slices back, as the
    reference's does, so the rows and metadata are the reference's."""
    keys, lo, hi = neighbor_keys(spec, neighbors)
    R = len(neighbors)
    Rp = 1 << max(R - 1, 1).bit_length()
    if Rp != R:
        pad = Rp - R
        keys = {s: np.concatenate([v, np.zeros(pad, np.uint32)])
                for s, v in keys.items()}
        lo = np.concatenate([lo, np.zeros(pad, np.int32)])
        hi = np.concatenate([hi, np.zeros(pad, np.int32)])
    cols, meta = synth_cas_device(spec, keys=keys, crash_lo=lo, crash_hi=hi,
                                  key_meta=False, device=device)
    if cols.batch != R:
        meta = SynthMeta(peak_w=meta.peak_w[:R], spec=meta.spec)
        cols = ColumnarOps(
            type=cols.type[:R], process=cols.process[:R],
            kind=cols.kind[:R], kinds=cols.kinds,
            key=cols.key[:R] if cols.key is not None else None,
            meta=meta)
    return cols, meta
