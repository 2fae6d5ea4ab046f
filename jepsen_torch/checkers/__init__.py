from .core import Checker
from .linearizable import (LinearizableChecker, linearizable,
                           prepare_history, wgl_check)

__all__ = ["Checker", "LinearizableChecker", "linearizable",
           "prepare_history", "wgl_check"]
