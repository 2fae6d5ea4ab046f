from .core import Checker
from .cycle import (CycleChecker, HostCycleChecker, check_graphs_batch,
                    cycle_checker, host_cycle_checker)
from .linearizable import (LinearizableChecker, linearizable,
                           prepare_history, wgl_check)
from .simple import (CounterChecker, QueueChecker, SetChecker,
                     TotalQueueChecker, UniqueIdsChecker, counter_checker,
                     expand_queue_drain_ops, queue_checker, set_checker,
                     total_queue_checker, unique_ids_checker)
from ..ops.folds import (BatchFoldChecker, check_counters_batch,
                         check_crdb_sets_batch, check_fifo_queues_batch,
                         check_queues_batch, check_sets_batch,
                         check_total_queues_batch, check_unique_ids_batch,
                         counter_checker_cuda, crdb_set_checker_cuda,
                         fifo_queue_checker_cuda, queue_checker_cuda,
                         set_checker_cuda, total_queue_checker_cuda,
                         unique_ids_checker_cuda)

__all__ = [
    "Checker", "LinearizableChecker", "linearizable", "prepare_history",
    "wgl_check",
    "CycleChecker", "HostCycleChecker", "check_graphs_batch",
    "cycle_checker", "host_cycle_checker",
    "SetChecker", "QueueChecker", "TotalQueueChecker", "UniqueIdsChecker",
    "CounterChecker", "set_checker", "queue_checker", "total_queue_checker",
    "unique_ids_checker", "counter_checker", "expand_queue_drain_ops",
    "BatchFoldChecker", "check_sets_batch", "check_crdb_sets_batch",
    "check_total_queues_batch", "check_unique_ids_batch",
    "check_counters_batch", "check_queues_batch", "check_fifo_queues_batch",
    "set_checker_cuda", "crdb_set_checker_cuda", "total_queue_checker_cuda",
    "unique_ids_checker_cuda", "counter_checker_cuda", "queue_checker_cuda",
    "fifo_queue_checker_cuda",
]
