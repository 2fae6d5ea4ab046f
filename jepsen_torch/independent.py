"""Independent keys: the (key, value) wrapper and the per-key strainer.

A single-register test lifts to a *map* of keys (jepsen/src/jepsen/
independent.clj:1-8): keyed sub-tests run concurrently, every client
value is wrapped as ``KV(key, value)``, and the recorded history strains
into per-key subhistories that check independently. This module keeps
only what the port's pre-partition (ops.partition) needs: the wrapper,
its test, and the strainer. The keyed generators and the lifted checker
belong to the test-runtime side of the system, which the port does not
carry.
"""
from __future__ import annotations

from typing import List, Sequence

from .history.ops import Op


class KV(tuple):
    """A (key, value) tuple marking values produced by independent
    generators (independent.clj:20-28)."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"KV({self[0]!r}, {self[1]!r})"


def is_kv(v) -> bool:
    return isinstance(v, KV)


def tuple_(k, v) -> KV:
    return KV(k, v)


def history_keys(history: Sequence[Op]) -> List:
    """Distinct KV keys in a history, in first-seen order
    (independent.clj:221-231)."""
    seen, out = set(), []
    for op in history:
        v = op.value
        if isinstance(v, KV) and v.key not in seen:
            seen.add(v.key)
            out.append(v.key)
    return out


def subhistory(k, history: Sequence[Op]) -> List[Op]:
    """All ops without a *differing* key, KV values unwrapped — unkeyed
    ops (nemesis, logging) appear in every subhistory
    (independent.clj:233-244)."""
    out = []
    for op in history:
        v = op.value
        if not isinstance(v, KV):
            out.append(op)
        elif v.key == k:
            out.append(op.with_(value=v.value))
    return out
