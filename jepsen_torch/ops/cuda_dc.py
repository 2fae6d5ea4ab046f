"""Build, load and launch the hand-written CUDA kernel of the peel loop.

The counterpart of the reference's ``get_dc_kernel``
(``ops/dc_monitor.py``), a vmapped ``lax.while_loop``: ``csrc/dc_peel.cu``
holds the kernel, the rounds of a plan row inside one launch, and this
module is its wrapper. A round needs no per-cluster minimum: an event
belongs to one cluster, so the reference's two smallest cluster minima
are g1, the least alive event, and g2, the least alive event outside
g1's cluster (the tie-break of its argmin cannot matter, since distinct
clusters' minima are distinct events). ``tier`` names the kernel's three
tiers at a width: ``warp`` (E <= 256, every plan of the dc path: a warp
a row, eight rows a block, the events in registers and only the row's
scatter-max in shared memory), ``smem`` (a block a row, its state in
shared memory) and ``global`` (a block a row, its state in a device
scratch). ``dc_peel`` checks device, dtype, shape and contiguity, raises
on anything the kernel does not take, allocates the outputs and, in the
``global`` tier, the rows' scratch, launches on PyTorch's current stream
and counts the launch in ``LAUNCHES``. ``prepare`` does the checks and
allocations and returns the launch itself, so that a caller can time the
kernel alone. A CUDA tensor launches the kernel or raises: nothing here
falls back to the plain version or to another tier.

The library is built at first use by ``_build.build_library``; nothing
here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Tuple

import torch

from ._build import CudaLaunchError, build_library

SRC = Path(__file__).resolve().parent / "csrc" / "dc_peel.cu"

# The warp tier's widest row (kWarpEvents in the source: eight events a
# lane) and its rows a block (kWarps).
WARP_EVENTS = 256
WARP_ROWS = 8
# Dynamic shared memory one block may use (kSmemLimit in the source) and
# the bytes a row of the smem tier takes there per event: inv, cluster and
# m_inv as int32, alive as one byte.
SMEM_LIMIT_BYTES = 232448 - 256
SMEM_BYTES_PER_EVENT = 13

# Launches of the kernel in this process; callers reset it to 0 and read
# it back to show that a path ran on the card.
LAUNCHES = 0

_LIB = None


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB = build_library(SRC, {
            "dc_peel": ([p, p, p, i, i, i, p, p, p, p], i),
            "dc_peel_error": ([i], ctypes.c_char_p)})
    return _LIB


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def tier(E: int) -> str:
    """The kernel's tier at width ``E``: ``warp`` (a warp a row, E <=
    WARP_EVENTS), ``smem`` (a block a row, its state in shared memory) or
    ``global`` (a block a row, its state in a device-memory scratch)."""
    if E <= WARP_EVENTS:
        return "warp"
    return "smem" if SMEM_BYTES_PER_EVENT * E <= SMEM_LIMIT_BYTES \
        else "global"


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dc_peel: {msg}")


def prepare(inv: torch.Tensor, cluster: torch.Tensor, active: torch.Tensor,
            cap: int
            ) -> Tuple[Callable[[], None], torch.Tensor, torch.Tensor]:
    """The checks and allocations of ``dc_peel``, without the launch:
    returns ``(launch, decided, rounds)``."""
    _check(inv.device.type == "cuda",
           f"plan tensors must be on a CUDA device, got {inv.device}")
    for t, dtype in ((inv, torch.int32), (cluster, torch.int32),
                     (active, torch.bool)):
        _check(t.device == inv.device and t.dtype == dtype
               and t.dim() == 2 and t.shape == inv.shape
               and t.is_contiguous(),
               f"want contiguous int32 inv, int32 cluster and bool active "
               f"[B, E] on one device, got {t.dtype} {tuple(t.shape)} on "
               f"{t.device} beside {tuple(inv.shape)}")
    B, E = inv.shape
    _check(E >= 1, "rows must have at least one event")
    _check(cap >= 1, f"round cap {cap} must be >= 1")
    dev = inv.device
    decided = torch.empty(B, dtype=torch.bool, device=dev)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = None
    if tier(E) == "global" and B:
        scratch = torch.empty(B * 2 * E, dtype=torch.int32, device=dev)
    fn = _library().dc_peel

    def launch() -> None:
        global LAUNCHES
        if B == 0:
            return
        with torch.cuda.device(dev):
            err = fn(inv.data_ptr(), cluster.data_ptr(), active.data_ptr(),
                     B, E, cap,
                     scratch.data_ptr() if scratch is not None else None,
                     decided.data_ptr(), rounds.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise CudaLaunchError(
                "dc_peel", err, _library().dc_peel_error(err).decode())
        LAUNCHES += 1
    return launch, decided, rounds


def dc_peel(inv: torch.Tensor, cluster: torch.Tensor, active: torch.Tensor,
            cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The peel loop on the card: ``(decided bool [B], rounds int32
    [B])``, bit for bit ``dc_monitor.plain_dc_peel`` with the round cap
    ``cap`` (the reference's ``max_rounds or E + 1``). ``cluster`` must
    lie in [0, E)."""
    launch, decided, rounds = prepare(inv, cluster, active, cap)
    launch()
    return decided, rounds
