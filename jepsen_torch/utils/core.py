"""Small shared utilities (counterparts of jepsen/src/jepsen/util.clj):
the two the fold checkers' result dicts are made of."""
from __future__ import annotations

from fractions import Fraction
from typing import List


def fraction(a: int, b: int):
    """a/b, but 1 when b is zero (util.clj fraction)."""
    if b == 0:
        return 1
    return Fraction(a, b)


def integer_interval_set_str(s) -> str:
    """Render a set of integers compactly as e.g. "#{1-5 7 9-11}"
    (util.clj:484-509). Non-integers are rendered individually."""
    if s is None:
        return "#{}"
    ints = sorted(x for x in s if isinstance(x, int))
    other = sorted((repr(x) for x in s if not isinstance(x, int)))
    parts: List[str] = []
    i = 0
    while i < len(ints):
        j = i
        while j + 1 < len(ints) and ints[j + 1] == ints[j] + 1:
            j += 1
        parts.append(str(ints[i]) if i == j else f"{ints[i]}-{ints[j]}")
        i = j + 1
    parts.extend(other)
    return "#{" + " ".join(parts) + "}"
