"""Seeded synthetic CAS-register, read/write-register and list-append
histories.

Simulates a *real* linearizable system executing a register workload —
operations linearize at their completion point against a true register —
then optionally corrupts reads to produce invalid histories. One seed ↦
one history, so a seed range yields the deterministic batch the checker
consumes (one workload × N nemesis seeds). ``synth_cas_columnar`` is
the batch form of the CAS generator, lockstep over a whole batch in
numpy: the legacy host stream. The generators are the same code as the
reference package's, so one seed gives the same history in both
packages.
"""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np

from ..history.core import index
from ..history.ops import Op, invoke_op, ok_op, fail_op, info_op


def seed_stream(seed0: int, n: int) -> List[int]:
    """The per-history seed sequence every batch entry point shares:
    ``seed0 .. seed0 + n - 1``."""
    return [seed0 + i for i in range(n)]


def seeded_rngs(seed0: int, n: int):
    """(seed, random.Random) pairs down ``seed_stream``."""
    return [(s, random.Random(s)) for s in seed_stream(seed0, n)]


def synth_cas_history(seed: int, *, n_procs: int = 5, n_ops: int = 40,
                      n_values: int = 5, corrupt: float = 0.0,
                      p_info: float = 0.0,
                      rng: Optional[random.Random] = None) -> List[Op]:
    """One simulated CAS-register history (read/write/cas over n_values).

    corrupt — probability the history is made invalid by perturbing one
              observed read.
    p_info  — probability a completion is indeterminate (timeout), the op
              possibly (50%) having taken effect; these ops stay pending
              to the end of the history, the hard case for checkers.
    rng     — pre-seeded generator state (seeded_rngs); default derives
              it from ``seed``.
    """
    rng = rng if rng is not None else random.Random(seed)
    reg: Optional[int] = None
    h: List[Op] = []
    live = {}
    free = list(range(n_procs))
    started = 0
    while started < n_ops or live:
        if free and started < n_ops and (not live or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            f = rng.choice(("read", "write", "cas"))
            if f == "read":
                h.append(invoke_op(p, "read", None))
                live[p] = ("read", None)
            elif f == "write":
                v = rng.randrange(n_values)
                h.append(invoke_op(p, "write", v))
                live[p] = ("write", v)
            else:
                v = [rng.randrange(n_values), rng.randrange(n_values)]
                h.append(invoke_op(p, "cas", v))
                live[p] = ("cas", v)
            started += 1
        else:
            p = rng.choice(sorted(live.keys()))
            f, v = live.pop(p)
            r = rng.random()
            if f == "read":
                if r < p_info:
                    h.append(info_op(p, "read", None, error="timeout"))
                else:
                    h.append(ok_op(p, "read", reg))
            elif f == "write":
                if r < p_info:
                    if rng.random() < 0.5:
                        reg = v
                    h.append(info_op(p, "write", v, error="timeout"))
                else:
                    reg = v
                    h.append(ok_op(p, "write", v))
            else:  # cas
                if r < p_info:
                    if rng.random() < 0.5 and reg == v[0]:
                        reg = v[1]
                    h.append(info_op(p, "cas", v, error="timeout"))
                elif reg == v[0]:
                    reg = v[1]
                    h.append(ok_op(p, "cas", v))
                else:
                    h.append(fail_op(p, "cas", v, error="mismatch"))
            free.append(p)
    if rng.random() < corrupt:
        reads = [i for i, op in enumerate(h)
                 if op.type == "ok" and op.f == "read"]
        if reads:
            i = rng.choice(reads)
            h[i].value = (h[i].value or 0) + rng.randrange(1, n_values)
    return index(h)


def synth_cas_batch(n: int, seed0: int = 0, **kw) -> List[List[Op]]:
    """n seeded histories down the shared ``seed_stream``."""
    return [synth_cas_history(s, rng=rng, **kw)
            for s, rng in seeded_rngs(seed0, n)]


def cas_kind_vocabulary(n_values: int):
    """The shared op-kind vocabulary for a CAS-register value domain:
    read(None), read(v), write(v), cas(a, b) — index-aligned with the
    columnar ``kind`` arrays the device generators emit
    (ops.synth_device)."""
    kinds = [("read", None)]
    kinds += [("read", v) for v in range(n_values)]
    kinds += [("write", v) for v in range(n_values)]
    kinds += [("cas", (a, b)) for a in range(n_values)
              for b in range(n_values)]
    return kinds


def synth_rw_history(seed: int, *, n_procs: int = 12, n_ops: int = 48,
                     p_read: float = 0.55, stale: float = 0.0,
                     rng: Optional[random.Random] = None) -> List[Op]:
    """One unkeyed wide-window read/write register history, the
    decrease-and-conquer workload: every op completes ok, written values
    are distinct within the history, and the pending window sits at
    about ``n_procs`` (so W = 11+ is just n_procs = 11+; every frontier
    search pays 2^W here, the peel loop does not).

    stale — probability an observed read is drawn from ALL past writes
            instead of the register (possibly stale): invalid histories
            that stay in the peel loop's capable class, so they exercise
            its stuck residue rather than its capability test.
    """
    rng = rng if rng is not None else random.Random(seed)
    reg: Optional[int] = None
    written: List[int] = []
    h: List[Op] = []
    live = {}
    free = list(range(n_procs))
    started = 0
    nextv = 1
    while started < n_ops or live:
        # Invoke-biased: keep about n_procs ops open at once, so the
        # pending window sits at the process count.
        if free and started < n_ops and (not live or rng.random() < 0.75):
            p = free.pop(rng.randrange(len(free)))
            if rng.random() < p_read:
                h.append(invoke_op(p, "read", None))
                live[p] = ("read", None)
            else:
                h.append(invoke_op(p, "write", nextv))
                live[p] = ("write", nextv)
                nextv += 1
            started += 1
        else:
            p = rng.choice(sorted(live.keys()))
            f, v = live.pop(p)
            if f == "write":
                reg = v
                written.append(v)
                h.append(ok_op(p, "write", v))
            else:
                val = reg
                if stale and written and rng.random() < stale:
                    val = rng.choice(written)
                h.append(ok_op(p, "read", val))
            free.append(p)
    return index(h)


def synth_rw_batch(n: int, seed0: int = 0, **kw) -> List[List[Op]]:
    """n seeded wide-window register histories down ``seed_stream``."""
    return [synth_rw_history(s, rng=rng, **kw)
            for s, rng in seeded_rngs(seed0, n)]


def synth_la_history(seed: int, *, n_procs: int = 4, n_ops: int = 24,
                     n_keys: int = 2, corrupt: float = 0.0,
                     rng: Optional[random.Random] = None) -> List[Op]:
    """One simulated serializable list-append history (Elle's workhorse
    workload, the dependency-graph checker's native shape): ``append``
    ops carry ``[k, element]`` with globally unique elements, ok
    ``read`` ops observe ``[k, [elements...]]`` — the key's full list
    at the read's completion point.

    corrupt — probability the history is made invalid by a STALE read:
    one observed list is truncated to drop an element whose append
    completed before the read even invoked. That is exactly an
    anti-dependency cycle (read → rw → dropped append → rt → read), so
    the cycle checker must report a G2 anomaly; uncorrupted histories
    lower to graphs whose every edge points forward in completion
    order and are therefore acyclic.
    """
    rng = rng if rng is not None else random.Random(seed)
    counter = 0
    lists: dict = {k: [] for k in range(n_keys)}
    applied_at: dict = {}            # element -> append completion line
    reads = []                       # (ok line, invoke line, key)
    h: List[Op] = []
    live: dict = {}
    free = list(range(n_procs))
    started = 0
    while started < n_ops or live:
        if free and started < n_ops and (not live or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            k = rng.randrange(n_keys)
            if rng.random() < 0.55:
                counter += 1
                h.append(invoke_op(p, "append", [k, counter]))
                live[p] = ("append", k, counter, len(h) - 1)
            else:
                h.append(invoke_op(p, "read", [k, None]))
                live[p] = ("read", k, None, len(h) - 1)
            started += 1
        else:
            p = rng.choice(sorted(live.keys()))
            f, k, v, inv_idx = live.pop(p)
            if f == "append":
                lists[k].append(v)
                applied_at[v] = len(h)
                h.append(ok_op(p, "append", [k, v]))
            else:
                h.append(ok_op(p, "read", [k, list(lists[k])]))
                reads.append((len(h) - 1, inv_idx, k))
            free.append(p)
    if rng.random() < corrupt and reads:
        rng.shuffle(reads)
        for ok_idx, inv_idx, k in reads:
            obs = h[ok_idx].value[1]
            drops = [j for j, e in enumerate(obs)
                     if applied_at[e] < inv_idx]
            if drops:
                j = rng.choice(drops)
                h[ok_idx].value = [k, obs[:j]]
                break
    return index(h)


def synth_la_batch(n: int, seed0: int = 0, **kw) -> List[List[Op]]:
    """n seeded list-append histories down the shared ``seed_stream``."""
    return [synth_la_history(s, rng=rng, **kw)
            for s, rng in seeded_rngs(seed0, n)]


def synth_wide_window_history(*, width: int = 17, n_values: int = 2,
                              invalid: bool = False,
                              seed: Optional[int] = None) -> List[Op]:
    """A history whose pending window is exactly ``width``: width-1
    crashed writes pin slots forever, then one read completes ok while
    all of them are pending. The checker must close the frontier over
    2^(width-1) linearization subsets — the shape that exceeds one
    device's window and takes the frontier-sharded route
    (jepsen_torch.parallel.frontier). ``invalid=True`` makes the read
    observe a value no write could have produced. ``seed`` draws the
    pinned write values from the seed; None keeps the ``p % n_values``
    pattern."""
    rng = random.Random(seed) if seed is not None else None
    h: List[Op] = []
    for p in range(width - 1):
        v = rng.randrange(n_values) if rng is not None else p % n_values
        h.append(invoke_op(p, "write", v))
    h.append(invoke_op(width - 1, "read", None))
    h.append(ok_op(width - 1, "read", n_values + 5 if invalid else None))
    return index(h)


def synth_cas_columnar(n: int, seed: int = 0, *, n_procs: int = 5,
                       n_ops: int = 40, n_values: int = 5,
                       corrupt: float = 0.0, p_info: float = 0.0,
                       n_keys: int = 1):
    """Vectorized batch twin of ``synth_cas_history``: simulate ``n``
    register histories in lockstep with one numpy step loop (every
    iteration advances every unfinished history by one line). Returns a
    prepared ColumnarOps (history.columnar contract: failed ops and
    never-ok identity reads are PAD; invoke lines carry final op kinds).

    One (n, seed, params) tuple ↦ one deterministic batch: the legacy
    host stream (``synth="host"`` in ops.synth_device.synthesize), draw
    for draw the reference package's, so one tuple gives the same bytes
    in both packages.

    ``n_keys > 1`` simulates ``n_keys`` independent registers per
    history (the jepsen ``independent`` workload shape): each op picks
    a key, both its lines carry the key id in the batch's ``key``
    column, and linearizability decomposes per key (Herlihy–Wing
    locality — the P-compositional pre-partition in ops.partition
    strains the batch before encoding). ``n_keys=1`` is draw-for-draw
    identical to the historical single-register generator (no key
    column, same rng sequence)."""
    from ..history.columnar import (ColumnarOps, C_INVOKE, C_OK, C_INFO,
                                    PAD)
    rng = np.random.default_rng(seed)
    B, P, N = n, n_procs, 2 * n_ops
    keyed = n_keys > 1
    READ0 = 0                     # kind ids: read(None)=0, read(v)=1+v
    WRITE0 = 1 + n_values         # write(v)
    CAS0 = 1 + 2 * n_values      # cas(a,b) = CAS0 + a*n_values + b

    typ = np.full((B, N), PAD, np.int8)
    proc = np.zeros((B, N), np.int16)
    kind = np.full((B, N), -1, np.int32)

    # Per-key register state; column 0 is the whole register when
    # unkeyed (reg[i, 0] reads/writes reproduce the historical arrays).
    reg = np.full((B, max(n_keys, 1)), -1, np.int32)   # -1 = None
    busy_f = np.full((B, P), -1, np.int8)   # 0=read 1=write 2=cas
    busy_a = np.zeros((B, P), np.int32)
    busy_b = np.zeros((B, P), np.int32)
    busy_k = np.zeros((B, P), np.int32)     # key per live op (0 unkeyed)
    key_col = np.full((B, N), -1, np.int32) if keyed else None
    inv_pos = np.zeros((B, P), np.int32)
    started = np.zeros(B, np.int32)
    n_live = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    rows = np.arange(B)

    for _ in range(N):
        active = (started < n_ops) | (n_live > 0)
        if not active.any():
            break
        can_start = active & (n_live < P) & (started < n_ops)
        do_start = can_start & ((n_live == 0) | (rng.random(B) < 0.6))
        do_complete = active & ~do_start & (n_live > 0)

        i = rows[do_start]
        if len(i):
            # random free process: max random score over free slots
            score = rng.random((len(i), P))
            score[busy_f[i] != -1] = -1.0
            p = score.argmax(1).astype(np.int16)
            f = rng.integers(0, 3, len(i)).astype(np.int8)
            a = rng.integers(0, n_values, len(i)).astype(np.int32)
            b = rng.integers(0, n_values, len(i)).astype(np.int32)
            typ[i, pos[i]] = C_INVOKE
            proc[i, pos[i]] = p
            busy_f[i, p] = f
            busy_a[i, p] = a
            busy_b[i, p] = b
            if keyed:
                # Key draw gated on keyed so n_keys=1 keeps the
                # historical rng sequence draw-for-draw.
                k = rng.integers(0, n_keys, len(i)).astype(np.int32)
                busy_k[i, p] = k
                key_col[i, pos[i]] = k
            inv_pos[i, p] = pos[i]
            started[i] += 1
            n_live[i] += 1
            pos[i] += 1

        i = rows[do_complete]
        if len(i):
            score = rng.random((len(i), P))
            score[busy_f[i] == -1] = -1.0
            p = score.argmax(1).astype(np.int16)
            f = busy_f[i, p]
            a, b = busy_a[i, p], busy_b[i, p]
            k = busy_k[i, p]
            is_info = rng.random(len(i)) < p_info
            applies = rng.random(len(i)) < 0.5     # info ops: took effect?
            ip = inv_pos[i, p]
            j = pos[i]
            typ[i, j] = C_OK
            proc[i, j] = p
            if keyed:
                key_col[i, j] = k

            rd, wr, cs = f == 0, f == 1, f == 2
            # read: observes reg; info-read observed nothing -> identity
            # -> drop both lines (the shared never-ok identity rule)
            obs = reg[i, k]
            kind[i, ip] = np.where(obs < 0, READ0, READ0 + 1 + obs)
            drop = rd & is_info
            typ[i[drop], j[drop]] = PAD
            typ[i[drop], ip[drop]] = PAD
            kind[i[drop], ip[drop]] = -1
            # write: reg = v on ok; on info, half apply
            kind[i[wr], ip[wr]] = WRITE0 + a[wr]
            w_apply = wr & (~is_info | applies)
            reg[i[w_apply], k[w_apply]] = a[w_apply]
            # cas: ok iff reg == a (else FAIL: both lines PAD);
            # info: half apply when it would have matched
            kind[i[cs], ip[cs]] = CAS0 + a[cs] * n_values + b[cs]
            match = reg[i, k] == a
            c_apply = cs & match & (~is_info | applies)
            reg[i[c_apply], k[c_apply]] = b[c_apply]
            fail = cs & ~match & ~is_info
            typ[i[fail], j[fail]] = PAD
            typ[i[fail], ip[fail]] = PAD
            kind[i[fail], ip[fail]] = -1
            info = is_info & ~rd
            typ[i[info], j[info]] = C_INFO

            busy_f[i, p] = -1
            n_live[i] -= 1
            pos[i] += 1

    if corrupt > 0:
        # perturb one observed read per selected row -> likely invalid
        hit = rng.random(B) < corrupt
        is_read_inv = (typ == C_INVOKE) & (kind >= READ0) & \
                      (kind < READ0 + 1 + n_values)
        score = rng.random((B, N))
        score[~is_read_inv] = -1.0
        col = score.argmax(1)
        hit &= score[rows, col] > 0          # row actually has a read
        i, c = rows[hit], col[hit]
        old = kind[i, c] - (READ0 + 1)       # -1 when read(None)
        delta = rng.integers(1, n_values, len(i))
        kind[i, c] = READ0 + 1 + (old + delta) % n_values

    return ColumnarOps(type=typ, process=proc, kind=kind,
                       kinds=cas_kind_vocabulary(n_values),
                       key=key_col)
