"""Seeded synthetic CAS-register, read/write-register and list-append
histories.

Simulates a *real* linearizable system executing a register workload —
operations linearize at their completion point against a true register —
then optionally corrupts reads to produce invalid histories. One seed ↦
one history, so a seed range yields the deterministic batch the checker
consumes (one workload × N nemesis seeds). The generator is the same
code as the reference package's, so one seed gives the same history in
both packages.
"""
from __future__ import annotations

import random
from typing import List, Optional

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
