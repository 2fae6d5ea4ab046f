from .ops import (
    Op,
    INVOKE,
    OK,
    FAIL,
    INFO,
    invoke_op,
    ok_op,
    fail_op,
    info_op,
)
from .core import complete, index, without_failures

__all__ = [
    "Op", "INVOKE", "OK", "FAIL", "INFO",
    "invoke_op", "ok_op", "fail_op", "info_op",
    "complete", "index", "without_failures",
]
