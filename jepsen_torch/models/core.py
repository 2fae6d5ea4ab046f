"""Functional sequential models of datatype behavior.

A model consumes one operation at a time via ``step`` and returns the next
model state, or an ``Inconsistent`` marker when the op is impossible from
the current state. Semantics mirror the reference's model records
(jepsen/src/jepsen/model.clj:21-105) and knossos' Model protocol; these are
the specs both the host linearizability oracle and the CUDA kernel are
tested against.

Models are immutable; ``step`` never mutates.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Tuple


class Model:
    def step(self, op) -> "Model":
        raise NotImplementedError


@dataclass(frozen=True)
class Inconsistent(Model):
    msg: str

    def step(self, op) -> "Model":
        return self


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


@dataclass(frozen=True)
class NoOp(Model):
    def step(self, op) -> "Model":
        return self


noop = NoOp()


@dataclass(frozen=True)
class CASRegister(Model):
    """A compare-and-set register over :read/:write/:cas.

    A read with value None always succeeds (the test recorded no
    observation); cas takes a (from, to) pair.
    """

    value: Any = None

    def step(self, op) -> "Model":
        f = op.f
        if f == "write":
            return CASRegister(op.value)
        if f == "cas":
            cur, new = op.value[0], op.value[1]
            if cur == self.value:
                return CASRegister(new)
            return inconsistent(
                f"can't CAS {self.value!r} from {cur!r} to {new!r}")
        if f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(
                f"can't read {op.value!r} from register {self.value!r}")
        return inconsistent(f"unknown op {f!r} for CASRegister")


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


@dataclass(frozen=True)
class Mutex(Model):
    locked: bool = False

    def step(self, op) -> "Model":
        if op.f == "acquire":
            if self.locked:
                return inconsistent("already held")
            return Mutex(True)
        if op.f == "release":
            if self.locked:
                return Mutex(False)
            return inconsistent("not held")
        return inconsistent(f"unknown op {op.f!r} for Mutex")


def mutex() -> Mutex:
    return Mutex(False)


@dataclass(frozen=True)
class SetModel(Model):
    s: frozenset = frozenset()

    def step(self, op) -> "Model":
        if op.f == "add":
            return SetModel(self.s | {op.value})
        if op.f == "read":
            # A read with no recorded observation constrains nothing
            # (same convention as CASRegister's None read).
            if op.value is None or set(op.value) == set(self.s):
                return self
            return inconsistent(
                f"can't read {op.value!r} from {set(self.s)!r}")
        return inconsistent(f"unknown op {op.f!r} for Set")


def set_model() -> SetModel:
    return SetModel()


class UnorderedQueue(Model):
    """A queue whose pending elements are an unordered multiset."""

    __slots__ = ("pending",)

    def __init__(self, pending: Counter = None):
        self.pending = pending if pending is not None else Counter()

    def step(self, op) -> "Model":
        if op.f == "enqueue":
            p = self.pending.copy()
            p[op.value] += 1
            return UnorderedQueue(p)
        if op.f == "dequeue":
            if self.pending.get(op.value, 0) > 0:
                p = self.pending.copy()
                p[op.value] -= 1
                if p[op.value] == 0:
                    del p[op.value]
                return UnorderedQueue(p)
            return inconsistent(f"can't dequeue {op.value!r}")
        return inconsistent(f"unknown op {op.f!r} for UnorderedQueue")

    def __eq__(self, other):
        return (isinstance(other, UnorderedQueue)
                and self.pending == other.pending)

    def __hash__(self):
        return hash(frozenset(self.pending.items()))

    def __repr__(self):
        # Value-based and order-stable (Counter iteration order is
        # insertion order, which differs between equal states reached
        # by different paths): counterexample configs embed this
        # string, and equal states must render identically.
        items = sorted(self.pending.items(), key=lambda kv: repr(kv[0]))
        return f"UnorderedQueue(pending={dict(items)!r})"


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


class FIFOQueue(Model):
    __slots__ = ("pending",)

    def __init__(self, pending: Tuple = ()):
        self.pending = tuple(pending)

    def step(self, op) -> "Model":
        if op.f == "enqueue":
            return FIFOQueue(self.pending + (op.value,))
        if op.f == "dequeue":
            if not self.pending:
                return inconsistent(
                    f"can't dequeue {op.value!r} from empty queue")
            if self.pending[0] == op.value:
                return FIFOQueue(self.pending[1:])
            return inconsistent(f"can't dequeue {op.value!r}")
        return inconsistent(f"unknown op {op.f!r} for FIFOQueue")

    def __eq__(self, other):
        return isinstance(other, FIFOQueue) and self.pending == other.pending

    def __hash__(self):
        return hash(self.pending)

    def __repr__(self):
        return f"FIFOQueue(pending={list(self.pending)!r})"


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()
