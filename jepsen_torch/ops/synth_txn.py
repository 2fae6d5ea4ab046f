"""Seeded multi-key transactional history synthesis with per-level
anomaly injection — the txn family's workload generator, copied from
the reference's ``ops/synth_txn.py`` so that one spec gives the same
histories in both packages.

Host-side (transactional extraction is host preprocessing anyway), in
the synth_device discipline: every draw is a pure function of
``(seed, history, stream)`` through the splitmix32 ``fold_in`` mixer,
with the schedule/values/fault streams split per class so perturbing
one leaves the others untouched.

Each history is a SERIAL base — ``n_txns`` committed multi-key
transactions of reads, unique-value writes, and (with probability
``p_predicate``) a full-snapshot predicate read — followed by an
injected anomaly SUFFIX on reserved keys/values that caps the
certifiable isolation level at exactly EXPECTED_CAP[anomaly]:

  ==================  ====================  =========================
  anomaly             Adya phenomenon       expected max level
  ==================  ====================  =========================
  None (clean)        —                     serializability
  write-skew          G2 (item, SI-safe)    snapshot-isolation
  phantom             G2 + G-SI             repeatable-read
  lost-update         G2-item + G-SI        read-committed
  fractured-read      G2-item + G-SI        read-committed
  aborted-read        G1a                   read-uncommitted
  intermediate-read   G1b                   read-uncommitted
  dirty-write         G0 (ww cycle)         none
  ==================  ====================  =========================

The constructions are documented edge-by-edge in doc/isolation.md;
tests/test_torch_isolation.py pins each against both engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..history.ops import Op, INVOKE, OK, FAIL
from .synth_device import fold_in, _ROOT

#: Injectable anomaly classes, in ladder order (strongest cap first).
ANOMALIES = ("write-skew", "phantom", "lost-update", "fractured-read",
             "aborted-read", "intermediate-read", "dirty-write")

#: The highest isolation level a history carrying the anomaly can
#: certify at (None key = clean history).
EXPECTED_CAP = {
    None: "serializability",
    "write-skew": "snapshot-isolation",
    "phantom": "repeatable-read",
    "lost-update": "read-committed",
    "fractured-read": "read-committed",
    "aborted-read": "read-uncommitted",
    "intermediate-read": "read-uncommitted",
    "dirty-write": "none",
}


@dataclass(frozen=True)
class TxnSpec:
    """One seeded batch of transactional histories.

    anomaly — None for clean histories, one of ANOMALIES to inject it
    into every history, or "mix" to draw per history from the fault
    stream (index 0 stays clean so a mix always has a SER baseline)."""

    n: int = 8
    seed: int = 0
    n_txns: int = 12
    n_keys: int = 4
    n_procs: int = 3
    ops_per_txn: int = 3
    p_predicate: float = 0.15
    anomaly: Optional[str] = None


def _rng(seed: int, i: int, stream: str) -> np.random.Generator:
    hk = fold_in(np.uint32(_ROOT), np.uint32(seed & 0xFFFFFFFF))
    hk = fold_in(hk, np.uint32(i))
    tag = sum(ord(c) << (8 * j) for j, c in enumerate(stream[:4]))
    return np.random.default_rng(int(fold_in(hk, np.uint32(tag))))


def _push(ops: List[Op], proc, typ, value):
    ops.append(Op(process=proc, type=typ, f="txn", value=value,
                  time=len(ops), index=len(ops)))


def _snapshot(state: dict) -> list:
    return [[k, v] for k, v in sorted(state.items()) if v is not None]


def synth_txn_history(spec: TxnSpec, i: int) -> Tuple[List[Op], Optional[str]]:
    """History ``i`` of the batch: (ops, injected-anomaly-or-None)."""
    if spec.n_procs < 2:
        raise ValueError("txn synthesis needs n_procs >= 2 "
                         "(concurrent anomaly constructions)")
    sched = _rng(spec.seed, i, "sched")
    anomaly = spec.anomaly
    if anomaly == "mix":
        fault = _rng(spec.seed, i, "fault")
        anomaly = (None if i == 0
                   else ANOMALIES[int(fault.integers(len(ANOMALIES)))])
    elif anomaly is not None and anomaly not in ANOMALIES:
        raise ValueError(f"unknown anomaly {anomaly!r}")

    keys = [f"k{j}" for j in range(spec.n_keys)]
    state = {k: None for k in keys}
    ops: List[Op] = []
    nextval = 1
    for t in range(spec.n_txns):
        proc = t % spec.n_procs
        invoke, okc = [], []
        used_pred = False
        for _ in range(spec.ops_per_txn):
            r = sched.random()
            if not used_pred and r < spec.p_predicate:
                used_pred = True
                invoke.append(["p", None, None])
                okc.append(["p", None, _snapshot(state)])
                continue
            k = keys[int(sched.integers(spec.n_keys))]
            if r < 0.5 + spec.p_predicate / 2:
                invoke.append(["r", k, None])
                okc.append(["r", k, state[k]])
            else:
                v = nextval
                nextval += 1
                invoke.append(["w", k, v])
                okc.append(["w", k, v])
                state[k] = v
        _push(ops, proc, INVOKE, invoke)
        _push(ops, proc, OK, okc)

    if anomaly is not None:
        _inject(ops, anomaly, state)
    return ops, anomaly


def synth_txn_batch(spec: TxnSpec
                    ) -> List[Tuple[List[Op], Optional[str]]]:
    """All ``spec.n`` histories, each (ops, injected anomaly)."""
    return [synth_txn_history(spec, i) for i in range(spec.n)]


# ------------------------------------------------- anomaly constructions
#
# Reserved keys ("x!", "y!", "k!") and negative values keep the suffix
# disjoint from the serial base, so the designed cycle is exactly what
# the extraction sees. Realtime edges from base txns point INTO the
# suffix and cannot close a cycle.

def _inject(ops: List[Op], anomaly: str, state: dict) -> None:
    pa, pb, pc = 0, 1, 0
    if anomaly == "dirty-write":
        # Two append txns, a reader observing contradictory list
        # orders: a ww 2-cycle (G0), below read-uncommitted.
        _push(ops, pa, INVOKE, [["append", "x!", -1], ["append", "y!", -2]])
        _push(ops, pa, OK, [["append", "x!", -1], ["append", "y!", -2]])
        _push(ops, pb, INVOKE, [["append", "x!", -3], ["append", "y!", -4]])
        _push(ops, pb, OK, [["append", "x!", -3], ["append", "y!", -4]])
        _push(ops, pc, INVOKE, [["r", "x!", None], ["r", "y!", None]])
        _push(ops, pc, OK, [["r", "x!", [-1, -3]], ["r", "y!", [-4, -2]]])
    elif anomaly == "aborted-read":
        # b reads a's write, but a ABORTED: G1a, caps at RU.
        _push(ops, pa, INVOKE, [["w", "k!", -1]])
        _push(ops, pa, FAIL, [["w", "k!", -1]])
        _push(ops, pb, INVOKE, [["r", "k!", None]])
        _push(ops, pb, OK, [["r", "k!", -1]])
    elif anomaly == "intermediate-read":
        # b reads a's NON-final write: G1b, caps at RU.
        _push(ops, pa, INVOKE, [["w", "k!", -1], ["w", "k!", -2]])
        _push(ops, pa, OK, [["w", "k!", -1], ["w", "k!", -2]])
        _push(ops, pb, INVOKE, [["r", "k!", None]])
        _push(ops, pb, OK, [["r", "k!", -1]])
    elif anomaly == "lost-update":
        # Both read the initial version, both overwrite: ww a→b plus
        # rwi b→a — a G2-item cycle that also breaks SI, caps at RC.
        _push(ops, pa, INVOKE, [["r", "k!", None], ["w", "k!", -1]])
        _push(ops, pa, OK, [["r", "k!", None], ["w", "k!", -1]])
        _push(ops, pb, INVOKE, [["r", "k!", None], ["w", "k!", -2]])
        _push(ops, pb, OK, [["r", "k!", None], ["w", "k!", -2]])
    elif anomaly == "fractured-read":
        # b sees a's write to x! but not to y!: wr a→b plus rwi b→a,
        # caps at RC.
        _push(ops, pa, INVOKE, [["w", "x!", -1], ["w", "y!", -2]])
        _push(ops, pa, OK, [["w", "x!", -1], ["w", "y!", -2]])
        _push(ops, pb, INVOKE, [["r", "x!", None], ["r", "y!", None]])
        _push(ops, pb, OK, [["r", "x!", -1], ["r", "y!", None]])
    elif anomaly == "write-skew":
        # Concurrent disjoint read-write pairs: rwi both ways and
        # nothing else — the cycle has two consecutive anti-deps, so
        # SI holds while repeatable-read fails: caps at SI.
        _push(ops, pa, INVOKE, [["r", "y!", None], ["w", "x!", -1]])
        _push(ops, pb, INVOKE, [["r", "x!", None], ["w", "y!", -2]])
        _push(ops, pa, OK, [["r", "y!", None], ["w", "x!", -1]])
        _push(ops, pb, OK, [["r", "x!", None], ["w", "y!", -2]])
    elif anomaly == "phantom":
        # b commits a row a's concurrent predicate read missed, and a
        # overwrites b on y!: ww b→a plus rwp a→b. The item planes
        # stay acyclic (RR holds); the predicate cycle has no two
        # consecutive anti-deps, so SI breaks too: caps at RR.
        snap = _snapshot(state)
        _push(ops, pa, INVOKE, [["p", None, None], ["w", "y!", -3]])
        _push(ops, pb, INVOKE, [["w", "k!", -1], ["w", "y!", -2]])
        _push(ops, pb, OK, [["w", "k!", -1], ["w", "y!", -2]])
        _push(ops, pa, OK, [["p", None, snap], ["w", "y!", -3]])
    else:                               # pragma: no cover - guarded above
        raise ValueError(f"unknown anomaly {anomaly!r}")
