"""Checker nemesis: deterministic fault injection for the pipeline itself.

A copy of the reference's ``ops/faults.py`` (the checker half; the run
half, ``RunFaultInjector``, belongs to the runtime). The batched device
checker is itself a distributed system (host encoder, CUDA runtime,
card, decode path), so it gets the treatment Jepsen gives databases: a
FaultPlan names which fault fires at which pipeline-stage boundary on
which chunk, a FaultInjector executes it deterministically, and the
schedulers' degradation ladder (ops.schedule) must keep every verdict
field for field equal to the fault-free run.

Stages mirror the streaming pipeline's boundaries:

  * ``encode``   — host-side chunk padding (before any bytes move);
  * ``dispatch`` — the kernel launch;
  * ``decode``   — the blocking copy back of the verdicts.

Fault kinds:

  * ``oom``     — raises an InjectedFault that classifies as an
                  out-of-memory, driving the row bisection;
  * ``timeout`` — the chunk runs long enough to trip the watchdog once,
                  then completes (late results are dropped; the retry
                  wins);
  * ``wedge``   — like timeout, far past the deadline;
  * ``corrupt`` — the decoded verdict arrays are garbage, caught by
                  ``validate_decoded`` and retried (persistent
                  corruption bisects down to the poison rows, which
                  quarantine to the host engine);
  * ``kill``    — an unclassified error that aborts the whole check
                  (the process-death model the chunk journal's resume
                  path is for); the scheduler never absorbs it.

Every injection is seeded by (stage, chunk ordinal), so a plan over the
same input fires the same fault at the same point. ``classify_failure``
sorts injected and real failures through one function, so the tested
path is the production path; its rules for real failures are torch's
(an out-of-memory from the allocator or a kernel launch), not XLA's.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ._build import CUDA_ERROR_MEMORY_ALLOCATION, CudaLaunchError

STAGES = ("encode", "dispatch", "decode")
KINDS = ("oom", "timeout", "wedge", "corrupt", "kill")

INT32_MAX = np.int32(2**31 - 1)


class InjectedFault(RuntimeError):
    """A synthetic pipeline fault; ``kind == "oom"`` classifies as an
    out-of-memory, as a real one does."""

    def __init__(self, kind: str, stage: str, ordinal: int):
        self.kind, self.stage, self.ordinal = kind, stage, ordinal
        msg = f"injected {kind} at {stage} chunk {ordinal}"
        if kind == "oom":
            msg = "RESOURCE_EXHAUSTED: " + msg
        super().__init__(msg)


class InjectedKill(RuntimeError):
    """Deliberately unclassified: aborts the check mid-stream (the
    process-death fault the chunk journal's resume path is for)."""


class CorruptOutput(RuntimeError):
    """A decoded chunk failed the verdict-shape invariants
    (validate_decoded) — garbage from the device or the transfer."""


class WatchdogExpired(RuntimeError):
    """A chunk's decode exceeded its op-model deadline."""


def classify_failure(e: BaseException) -> Optional[str]:
    """Map a failure to the degradation ladder's branch: ``"oom"``
    (bisect the chunk), ``"transient"`` (bounded retry with backoff), or
    None (not a pipeline fault: it propagates untouched).

    Real failures: torch's ``OutOfMemoryError`` and a kernel launch that
    returned ``cudaErrorMemoryAllocation`` are ``"oom"``. Every other
    CUDA error is None: an illegal address or a failed launch poisons
    the context, so a retry would fail again and a poison hunt would
    quarantine every row to the host, a fallback that hides the kernel.
    Injected faults, corrupt output and an expired watchdog are the
    reference's."""
    if isinstance(e, InjectedKill):
        return None
    if isinstance(e, InjectedFault):
        return "oom" if e.kind == "oom" else "transient"
    if isinstance(e, (CorruptOutput, WatchdogExpired)):
        return "transient"
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return "oom"
    if isinstance(e, CudaLaunchError) and \
            e.code == CUDA_ERROR_MEMORY_ALLOCATION:
        return "oom"
    return None


def validate_decoded(valid: np.ndarray, bad: np.ndarray,
                     n_events: int) -> None:
    """Verdict-shape invariants every decoded chunk must satisfy: valid
    rows carry the INT32_MAX sentinel, invalid rows a bad-event index
    inside the real event axis. Always on: this is how corrupt device
    output becomes a retryable fault instead of a wrong verdict."""
    v = np.asarray(valid)
    b = np.asarray(bad)
    if v.dtype != np.bool_ or v.shape != b.shape:
        raise CorruptOutput(
            f"verdict arrays malformed: valid {v.dtype}{v.shape} "
            f"bad {b.dtype}{b.shape}")
    if v.size and not (b[v] == INT32_MAX).all():
        raise CorruptOutput("valid row without the INT32_MAX sentinel")
    inv = b[~v]
    if inv.size and ((inv < 0) | (inv >= n_events)).any():
        raise CorruptOutput(
            f"invalid row with bad-event index outside [0, {n_events})")


def corrupt_arrays(valid: np.ndarray, bad: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The ``corrupt`` fault's payload: verdicts flipped, bad indices
    insane — what validate_decoded must catch."""
    v = np.asarray(valid).copy()
    b = np.asarray(bad).copy()
    v[:] = ~v
    b[:] = -7
    return v, b


@dataclass(frozen=True)
class FaultSpec:
    """One fault: ``kind`` at ``stage``, firing on chunk ordinal
    ``chunk`` (a per-stage counter) or on EVERY chunk when ``chunk`` is
    None (a sticky fault)."""

    stage: str
    kind: str
    chunk: Optional[int] = 0

    def __post_init__(self):
        assert self.stage in STAGES, self.stage
        assert self.kind in KINDS, self.kind

    def matches(self, stage: str, ordinal: int) -> bool:
        return self.stage == stage and (self.chunk is None
                                        or self.chunk == ordinal)


class FaultPlan:
    """A deterministic fault schedule plus the timing the nemesis runs
    under. An active plan shrinks the watchdog deadline and the retry
    backoff to test scale; ``deadline_s=None`` keeps the scheduler's
    own op-model deadline."""

    def __init__(self, specs: List[FaultSpec], *,
                 deadline_s: Optional[float] = 0.75,
                 sleep_timeout_s: float = 1.2,
                 sleep_wedge_s: float = 2.5,
                 backoff_s: float = 0.01):
        self.specs = list(specs)
        self.deadline_s = deadline_s
        self.sleep_timeout_s = sleep_timeout_s
        self.sleep_wedge_s = sleep_wedge_s
        self.backoff_s = backoff_s

    @classmethod
    def single(cls, stage: str, kind: str, chunk: int = 0,
               **kw) -> "FaultPlan":
        """One fault, once, at one chunk."""
        return cls([FaultSpec(stage, kind, chunk)], **kw)

    @classmethod
    def sticky(cls, stage: str, kind: str, **kw) -> "FaultPlan":
        """The fault fires on EVERY chunk at that stage."""
        return cls([FaultSpec(stage, kind, None)], **kw)

    @classmethod
    def parse(cls, text: str, **kw) -> "FaultPlan":
        """``"stage:kind[:chunk]"`` specs, comma- or semicolon-separated;
        chunk ``*`` means sticky (the $JT_FAULT_PLAN syntax)."""
        specs = []
        for part in text.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            stage, kind = bits[0], bits[1]
            chunk: Optional[int] = 0
            if len(bits) > 2:
                chunk = None if bits[2] == "*" else int(bits[2])
            specs.append(FaultSpec(stage, kind, chunk))
        return cls(specs, **kw)

    def match(self, stage: str, ordinal: int) -> Optional[FaultSpec]:
        for s in self.specs:
            if s.matches(stage, ordinal):
                return s
        return None


def single_fault_schedules() -> List[Tuple[str, FaultPlan]]:
    """The single-fault matrix the parity tests sweep: OOM at every
    stage, one deadline-tripping timeout, one wedge and one corrupt
    output, each fired once, on the first chunk that reaches its
    stage."""
    out = [(f"oom@{stage}", FaultPlan.single(stage, "oom"))
           for stage in STAGES]
    out.append(("timeout@dispatch", FaultPlan.single("dispatch",
                                                     "timeout")))
    out.append(("wedge@dispatch", FaultPlan.single("dispatch", "wedge")))
    out.append(("corrupt@decode", FaultPlan.single("decode", "corrupt")))
    return out


class FaultInjector:
    """Executes a FaultPlan at the pipeline's stage boundaries.

    ``fire(stage)`` is called once per chunk per stage (thread-safe:
    decode fires on the retire threads). It raises for oom and kill and
    otherwise returns the fired kind; the caller applies timeout and
    wedge (``sleep_for``, where the watchdog sees it) and corrupt
    (``corrupt_arrays``). ``log`` records every firing as (stage,
    ordinal, kind)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log: List[Tuple[str, int, str]] = []
        self._ordinal: Dict[str, int] = {s: 0 for s in STAGES}
        self._lock = threading.Lock()

    @property
    def deadline_s(self) -> Optional[float]:
        return self.plan.deadline_s

    @property
    def backoff_s(self) -> Optional[float]:
        return self.plan.backoff_s

    def sleep_for(self, kind: Optional[str]) -> float:
        if kind == "timeout":
            return self.plan.sleep_timeout_s
        if kind == "wedge":
            return self.plan.sleep_wedge_s
        return 0.0

    def fire(self, stage: str) -> Optional[str]:
        with self._lock:
            n = self._ordinal[stage]
            self._ordinal[stage] = n + 1
            spec = self.plan.match(stage, n)
            if spec is None:
                return None
            self.log.append((stage, n, spec.kind))
        if spec.kind == "kill":
            raise InjectedKill(f"injected kill at {stage} chunk {n}")
        if spec.kind == "oom":
            raise InjectedFault("oom", stage, n)
        return spec.kind

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        """$JT_FAULT_PLAN (e.g. ``dispatch:oom:0,decode:corrupt:*``)
        turns the nemesis on process-wide."""
        text = os.environ.get("JT_FAULT_PLAN")
        if not text:
            return None
        return cls(FaultPlan.parse(text))
