"""Where the port's entry points run (the CUDA card unless told
otherwise), and how its rate probes time one launch there."""
from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch version on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# GPU cycles the card sleeps before a timed launch, so that the host
# enqueues the launch and its closing event while the card is still busy
# and the window holds the kernel alone (about 50 us at 1.98 GHz).
SLEEP_CYCLES = 100_000


def time_launch(launch, device: torch.device, repeats: int = 3,
                reset=None) -> float:
    """Best seconds of ``launch()`` over ``repeats`` runs after a warm-up:
    on a CUDA device the kernel alone, by CUDA events around the launch
    after a device sleep; on the CPU by the host clock. ``reset()``, when
    given, restores the launch's inputs before each run, outside the
    window."""
    if reset is not None:
        reset()
    launch()
    best = None
    for _ in range(max(1, repeats)):
        if reset is not None:
            reset()
        if device.type == "cuda":
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) * 1e-3
        else:
            t0 = time.perf_counter()
            launch()
            dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best
