"""Checker protocol.

A checker validates a history against a model and returns a result dict
with at least ``{"valid": True | False | "unknown"}``. Composition merges
sub-results under the priority lattice true < unknown < false — a single
false dominates (mirrors jepsen/src/jepsen/checker.clj:23-44,376-388).
"""
from __future__ import annotations

from typing import Optional

VALID_PRIORITIES = {True: 0, "unknown": 0.5, False: 1}


def merge_valid(valids) -> object:
    """The merged verdict of several sub-results: the highest-priority
    ``valid`` value among them (True when there are none)."""
    out = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid value")
        if VALID_PRIORITIES[v] > VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    """Base checker. Subclasses implement ``check``."""

    def check(self, test: dict, model, history: list,
              opts: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, model, history, opts=None) -> dict:
        return self.check(test, model, history, opts)
