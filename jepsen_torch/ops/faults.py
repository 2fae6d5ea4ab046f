"""The verdict sentinel and the corrupt-output fault of the checkers.

A trimmed copy of the reference's ``ops/faults.py``: only the INT32_MAX
sentinel that acyclic planes and valid rows carry, and the error a
malformed decoded chunk raises. The checker nemesis (fault plans and
injection) and the failure classifier come with the fault-ladder slice.
"""
from __future__ import annotations

import numpy as np

INT32_MAX = np.int32(2**31 - 1)


class CorruptOutput(RuntimeError):
    """A decoded chunk failed the verdict-shape invariants
    (validate_decoded) — garbage from the device or the transfer."""
