"""Operation records.

A history is a flat sequence of operation events. Each client operation
appears (up to) twice: once as an ``invoke`` when a worker begins it, and
once as a completion — ``ok`` (definitely happened), ``fail`` (definitely
did not happen) or ``info`` (indeterminate: it may or may not have taken
effect, now or at any point before the end of the test).

Mirrors the op maps of the reference framework (ops are built at
jepsen/src/jepsen/core.clj:153-177 and interpreted by knossos); we use a
slotted dataclass instead of a hash map so a million-op history stays cheap
to build and scan on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

TYPES = (INVOKE, OK, FAIL, INFO)

NEMESIS = "nemesis"  # the process id used by the fault-injection actor


@dataclass(slots=True)
class Op:
    """One history event.

    process: int worker process id, or "nemesis".
    type:    one of invoke/ok/fail/info.
    f:       operation function name, e.g. "read", "write", "cas", "enqueue".
    value:   op payload; convention follows the reference models
             (e.g. cas value is a (from, to) pair).
    time:    test-relative monotonic nanoseconds.
    index:   position in the history (assigned when the history is frozen).
    error:   optional error detail for fail/info completions.
    """

    process: Any
    type: str
    f: Optional[str]
    value: Any = None
    time: Optional[int] = None
    index: Optional[int] = None
    error: Any = None
    extra: Optional[dict] = None  # open slot for suite-specific fields

    # -- predicates ---------------------------------------------------------
    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    @property
    def is_completion(self) -> bool:
        return self.type in (OK, FAIL, INFO)

    @property
    def is_client(self) -> bool:
        return isinstance(self.process, int)

    @property
    def is_nemesis(self) -> bool:
        return self.process == NEMESIS

    def with_(self, **kw) -> "Op":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        d = {
            "process": self.process,
            "type": self.type,
            "f": self.f,
            "value": self.value,
            "time": self.time,
            "index": self.index,
        }
        if self.error is not None:
            d["error"] = self.error
        if self.extra:
            d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Op":
        known = {"process", "type", "f", "value", "time", "index", "error"}
        extra = {k: v for k, v in d.items() if k not in known}
        return cls(
            process=d["process"],
            type=d["type"],
            f=d.get("f"),
            value=d.get("value"),
            time=d.get("time"),
            index=d.get("index"),
            error=d.get("error"),
            extra=extra or None,
        )

    def __str__(self) -> str:  # compact, line-oriented, log friendly
        err = f"\t{self.error}" if self.error is not None else ""
        return f"{self.process}\t{self.type}\t{self.f}\t{self.value!r}{err}"


# -- constructors mirroring knossos.op helpers used by reference tests ------

def invoke_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=INVOKE, f=f, value=value, **kw)


def ok_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=OK, f=f, value=value, **kw)


def fail_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=FAIL, f=f, value=value, **kw)


def info_op(process, f, value=None, **kw) -> Op:
    return Op(process=process, type=INFO, f=f, value=value, **kw)
