"""Checker protocol.

A checker validates a history against a model and returns a result dict
with at least ``{"valid": True | False | "unknown"}`` (mirrors
jepsen/src/jepsen/checker.clj:23-44).
"""
from __future__ import annotations

from typing import Optional


class Checker:
    """Base checker. Subclasses implement ``check``."""

    def check(self, test: dict, model, history: list,
              opts: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, model, history, opts=None) -> dict:
        return self.check(test, model, history, opts)
