"""Build, load and launch the hand-written CUDA kernels of the invariant
fold checkers.

The counterparts of the reference's seven XLA programs in
``ops/folds.py``: ``csrc/folds.cu`` holds four kernels and this module is
their wrapper. ``fold_counts`` launches the count kernel of a family
(set, crdb, tq, ids: the reference's ``_set_kernel``,
``_crdb_set_kernel``, ``_tq_kernel`` and ``_ids_kernel``);
``counter_scan``, ``queue_scan`` and ``fifo_scan`` launch the per-row
scans (``_counter_kernel``, ``_queue_kernel``, ``_fifo_kernel``). Each
counts its launches in ``LAUNCHES[entry]`` (one a call, whatever number
of kernels the call runs), checks device, dtype, shape and contiguity,
raises on anything its kernels do not take, allocates the outputs and
the scratch, and launches on PyTorch's current stream. ``tier`` says
where a kernel keeps its per-row state, ``count_plan`` how
``fold_counts`` cuts each row's vocabulary into slices, one block each,
``queue_plan`` how ``queue_scan`` does (and cuts each row's lines into
chunks, one warp each), and ``scan_plan`` how ``counter_scan`` and
``fifo_scan`` cut each row's lines into segments, one warp each.
``prepare_*`` do a wrapper's checks and allocations and return the
launch itself, so that a caller can time
the kernels alone.

The library is built at first use by ``_build.build_library``; nothing
here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from ._build import CudaLaunchError, build_library

SRC = Path(__file__).resolve().parent / "csrc" / "folds.cu"

ENTRIES = ("fold_counts", "counter_scan", "queue_scan", "fifo_scan")

# Each count family: its code in the source, its histograms (C) and its
# output planes (L) with their dtype.
FAMILIES = {
    "set": (0, 2, 5, torch.uint8),
    "crdb": (1, 4, 7, torch.uint8),
    "tq": (2, 3, 6, torch.int32),
    "ids": (3, 1, 1, torch.int32),
}

# Dynamic shared memory one block may use (kSmemLimit in the source);
# the counter's carry stays in shared memory to P words
# (kCounterSmemP); the FIFO walk's block keeps WALK_RED_BYTES of its own
# beside the ring it stages (kWalkRedBytes).
SMEM_LIMIT_BYTES = 232448 - 64
COUNTER_SMEM_P = 64
WALK_RED_BYTES = 256

# counter_scan's and fifo_scan's segments: a warp takes SEGMENT lines of
# a row, SCAN_WARPS warps a block (kScanWarps). A row is cut into more
# segments, down to SCAN_MIN_SEGMENT lines each, until the batch has
# SCAN_TARGET_BLOCKS blocks (two for each of an H100's 132 SMs); the
# segment is a whole number of 32-line tiles. FIFO_WALK_TILE dequeues
# (kWalkThreads x kWalkPer) is the tile of fifo_scan's walk.
SCAN_WARPS = 8
SCAN_MIN_SEGMENT = 256
SCAN_TARGET_BLOCKS = 264
FIFO_WALK_TILE = 1024 * 4

# fold_counts' slices: each block holds its slice's C histograms in at
# most COUNT_SLICE_BYTES of shared memory (four blocks of COUNT_THREADS
# to an SM); a row is cut into more slices, up to one per
# COUNT_MIN_SLICE values, until the batch has COUNT_TARGET_BLOCKS blocks
# (two for each of an H100's 132 SMs). Slice widths are whole multiples
# of 32 values.
COUNT_THREADS = 256
COUNT_SLICE_BYTES = 48 * 1024
COUNT_MIN_SLICE = 1024
COUNT_TARGET_BLOCKS = 264

# queue_scan's slices: a block of QUEUE_WARPS warps (kQueueWarps) keeps
# a (sum, lowest prefix) pair of int32 and a byte of lane tag for each
# warp and each value of its slice (QUEUE_BYTES_PER_VALUE a warp), at
# most QUEUE_SLICE_BYTES of shared memory (three blocks to an SM), so a
# slice is at most 1,024 values; slice widths are whole multiples of 32
# values. Each warp walks a chunk of the row's lines, whole 32-line
# tiles.
QUEUE_WARPS = 8
QUEUE_BYTES_PER_VALUE = 9
QUEUE_SLICE_BYTES = 72 * 1024

# Launches of each entry in this process; callers reset them to 0 and
# read them back to show that a path ran on the card.
LAUNCHES = dict.fromkeys(ENTRIES, 0)

_LIB = None


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _LIB = build_library(SRC, {
            "fold_counts": ([i, p, p, p, p, i, i, i, i, i, p, p, p], i),
            "counter_scan": ([p, p, p, p, i, i, i, i, p, ll, p, p, p, p, p],
                             i),
            "queue_scan": ([p, p, p, i, i, i, i, i, i, p, p, p, p, p],
                           i),
            "fifo_scan": ([p, p, p, i, i, i, i, p, ll, p, p, p, p, p, p],
                          i),
            "folds_error": ([i], ctypes.c_char_p)})
    return _LIB


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    launch)."""
    _library()


def count_plan(family: str, V: int, rows: int = 1) -> dict:
    """How ``fold_counts`` cuts a batch of ``rows`` rows at vocabulary
    width V: ``slices`` blocks a row, each counting ``slice_width``
    values (the last one the rest) in ``smem_bytes`` of shared memory
    with ``threads`` threads; ``blocks`` in all. One slice is the
    ``smem`` tier, more the ``sliced`` tier."""
    C = FAMILIES[family][1]
    widest = COUNT_SLICE_BYTES // (4 * C) // 32 * 32
    fit = -(-V // widest)
    fill = min(-(-COUNT_TARGET_BLOCKS // max(rows, 1)),
               -(-V // COUNT_MIN_SLICE))
    width = -(-V // max(fit, fill, 1))
    width = -(-width // 32) * 32
    slices = -(-V // width)
    return {"tier": "smem" if slices == 1 else "sliced", "slices": slices,
            "slice_width": width, "threads": COUNT_THREADS,
            "smem_bytes": 4 * C * width, "blocks": rows * slices}


def queue_plan(N: int, V: int, rows: int = 1) -> dict:
    """How ``queue_scan`` cuts a batch of ``rows`` rows of N lines at
    vocabulary width V: ``slices`` blocks a row, each walking the row
    for ``slice_width`` values (the last one the rest; the widest
    multiple of 32 whose pairs and tags fit) in ``smem_bytes`` of shared
    memory, its ``warps`` warps each a ``chunk`` of lines; ``blocks``
    in all. One slice is the ``smem`` tier, more the ``sliced`` tier."""
    per_value = QUEUE_BYTES_PER_VALUE * QUEUE_WARPS
    widest = QUEUE_SLICE_BYTES // per_value // 32 * 32
    width = min(widest, -(-V // 32) * 32)
    slices = -(-V // width)
    chunk = -(-max(-(-N // QUEUE_WARPS), 1) // 32) * 32
    return {"tier": "smem" if slices == 1 else "sliced", "slices": slices,
            "slice_width": width, "warps": QUEUE_WARPS, "chunk": chunk,
            "smem_bytes": per_value * width, "blocks": rows * slices}


def scan_plan(N: int, rows: int = 1, segment: Optional[int] = None
              ) -> dict:
    """How ``counter_scan`` and ``fifo_scan`` cut a batch of ``rows``
    rows of N lines: ``segment`` lines a warp (the plan's own unless
    given), ``segments`` warps a row (whole blocks of ``warps``, the
    last ones possibly empty), ``blocks_per_row`` and ``blocks`` in
    all."""
    if segment is None:
        want = -(-SCAN_TARGET_BLOCKS * SCAN_WARPS // max(rows, 1))
        segment = max(SCAN_MIN_SEGMENT, -(-N // want))
        segment = -(-segment // 32) * 32
    per_row = -(-max(-(-N // segment), 1) // SCAN_WARPS)
    return {"segment": segment, "warps": SCAN_WARPS,
            "segments": per_row * SCAN_WARPS, "blocks_per_row": per_row,
            "blocks": rows * per_row}


def tier(entry: str, width: int, family: Optional[str] = None,
         rows: int = 1) -> str:
    """Where ``entry`` keeps a row's state at ``width`` (V for the counts
    and the queue, P for the counter, Nmax for the FIFO): ``smem``
    (shared memory) or ``global`` (device memory); for ``fold_counts``
    and ``queue_scan`` (always in shared memory) ``smem`` when one block
    takes a row and ``sliced`` when several do (``count_plan`` over
    ``rows`` rows, ``queue_plan``). The counter's state is each warp's
    per-process carry, the FIFO's the ring of enqueued values its walk
    reads (staged in shared memory, or read where the compaction wrote
    it)."""
    if entry == "fold_counts":
        return count_plan(family, width, rows)["tier"]
    if entry == "queue_scan":
        return queue_plan(1, width, rows)["tier"]
    if entry == "counter_scan":
        return "smem" if width <= COUNTER_SMEM_P else "global"
    return ("smem" if 4 * (width - 1) + WALK_RED_BYTES
            <= SMEM_LIMIT_BYTES else "global")


def _check(entry: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{entry}: {msg}")


def _check_lines(entry: str, *lines: torch.Tensor) -> Tuple[int, int]:
    """The line tensors must be contiguous int32 [B, N] CUDA tensors of
    one shape on one device, N >= 1; returns (B, N)."""
    t0 = lines[0]
    _check(entry, t0.device.type == "cuda",
           f"line tensors must be on a CUDA device, got {t0.device}")
    for t in lines:
        _check(entry, t.device == t0.device,
               f"line tensors on {t.device} and {t0.device}")
        _check(entry, t.dtype == torch.int32 and t.dim() == 2
               and t.shape == t0.shape and t.is_contiguous(),
               f"line tensors must be contiguous int32 [B, N] of one "
               f"shape, got {t.dtype} {tuple(t.shape)} beside "
               f"{tuple(t0.shape)}")
    B, N = t0.shape
    _check(entry, N >= 1, "rows must have at least one line")
    return B, N


def _launcher(entry: str, dev: torch.device, B: int, call
              ) -> Callable[[], None]:
    """The launch of ``entry``: ``call(stream)`` on PyTorch's current
    stream, raising if the kernel did not launch, counted in
    LAUNCHES."""
    def launch() -> None:
        if B == 0:
            return
        with torch.cuda.device(dev):
            err = call(torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise CudaLaunchError(entry, err,
                                  _library().folds_error(err).decode())
        LAUNCHES[entry] += 1
    return launch


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def prepare_counts(family: str, typ: torch.Tensor, f: torch.Tensor,
                   val: torch.Tensor, final: Optional[torch.Tensor], V: int
                   ) -> Tuple[Callable[[], None], torch.Tensor,
                              Optional[torch.Tensor]]:
    """The checks and allocations of ``fold_counts``, without the launch:
    returns ``(launch, planes, attempted)``."""
    entry = "fold_counts"
    _check(entry, family in FAMILIES, f"unknown family {family!r}")
    code, C, L, dtype = FAMILIES[family]
    B, N = _check_lines(entry, typ, f, val)
    _check(entry, V >= 1 and C * V < 2**31,
           f"V={V} is not a vocabulary width the kernel takes")
    dev = typ.device
    if family in ("set", "crdb"):
        _check(entry, final is not None and final.device == dev
               and final.dtype == torch.uint8
               and tuple(final.shape) == (B, V) and final.is_contiguous(),
               f"{family} needs a contiguous uint8 [{B}, {V}] final-read "
               f"bitmap on {dev}")
    else:
        _check(entry, final is None, f"{family} takes no final read")
    planes = torch.empty((B, L, V), dtype=dtype, device=dev)
    attempted = (torch.empty(B, dtype=torch.int32, device=dev)
                 if family == "ids" else None)
    plan = count_plan(family, V, B)
    _check(entry, B * plan["slices"] < 2**31,
           f"{B} rows of {plan['slices']} slices exceed the grid")
    fn = _library().fold_counts
    launch = _launcher(entry, dev, B, lambda s: fn(
        code, typ.data_ptr(), f.data_ptr(), val.data_ptr(), _ptr(final), B,
        N, V, plan["slices"], plan["slice_width"], planes.data_ptr(),
        _ptr(attempted), s))
    return launch, planes, attempted


def fold_counts(family: str, typ: torch.Tensor, f: torch.Tensor,
                val: torch.Tensor, final: Optional[torch.Tensor], V: int
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A family's count planes on the card: ``planes`` [B, L, V] (uint8
    for set and crdb, int32 for tq and ids) and, for ids, ``attempted``
    int32 [B]; bit for bit ``plain_fold_counts``."""
    launch, planes, attempted = prepare_counts(family, typ, f, val, final, V)
    launch()
    return planes, attempted


def counter_scratch_words(B: int, N: int, P: int,
                          segment: Optional[int] = None) -> int:
    """int32 words of ``counter_scan``'s scratch: a summary (two sums
    and three words a process) of every segment and of every block of
    segments, and in the ``global`` tier each segment's carry."""
    plan = scan_plan(N, B, segment)
    words = B * (plan["segments"] + plan["blocks_per_row"]) * (2 + 3 * P)
    if tier("counter_scan", P) == "global":
        words += B * plan["segments"] * 3 * P
    return words


def prepare_counter(typ: torch.Tensor, f: torch.Tensor, val: torch.Tensor,
                    proc: torch.Tensor, P: int,
                    segment: Optional[int] = None
                    ) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """The checks and allocations of ``counter_scan``: returns
    ``(launch, (lows, vals, ups, emits))``. ``segment`` overrides the
    plan's lines a warp (``scan_plan``)."""
    entry = "counter_scan"
    B, N = _check_lines(entry, typ, f, val, proc)
    _check(entry, 1 <= P and 3 * P < 2**31, f"P={P} out of range")
    _check(entry, segment is None or 1 <= segment < 2**31,
           f"segment={segment} out of range")
    plan = scan_plan(N, B, segment)
    _check(entry, plan["blocks"] < 2**31,
           f"{B} rows of {plan['blocks_per_row']} blocks exceed the grid")
    dev = typ.device
    outs = tuple(torch.empty((B, N), dtype=torch.int32, device=dev)
                 for _ in range(3))
    emits = torch.empty((B, N), dtype=torch.uint8, device=dev)
    words = counter_scratch_words(B, N, P, segment)
    scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    fn = _library().counter_scan
    launch = _launcher(entry, dev, B, lambda s: fn(
        typ.data_ptr(), f.data_ptr(), val.data_ptr(), proc.data_ptr(), B, N,
        P, plan["segment"], scratch.data_ptr(), words,
        *(o.data_ptr() for o in outs), emits.data_ptr(), s))
    return launch, (*outs, emits)


def counter_scan(typ, f, val, proc, P: int, segment: Optional[int] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The counter's bounds on the card: (lows, vals, ups int32 [B, N],
    emits uint8 [B, N]), bit for bit ``plain_counter_scan``. ``proc``
    holds each row's densified processes, in [0, P)."""
    launch, outs = prepare_counter(typ, f, val, proc, P, segment)
    launch()
    return outs


def prepare_queue(typ: torch.Tensor, f: torch.Tensor, val: torch.Tensor,
                  V: int
                  ) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """The checks and allocations of ``queue_scan``: returns
    ``(launch, (valid, bad, counts))``."""
    entry = "queue_scan"
    B, N = _check_lines(entry, typ, f, val)
    _check(entry, 1 <= V < 2**31, f"V={V} out of range")
    plan = queue_plan(N, V, B)
    _check(entry, plan["blocks"] < 2**31,
           f"{B} rows of {plan['slices']} slices exceed the grid")
    dev = typ.device
    valid = torch.empty(B, dtype=torch.uint8, device=dev)
    bad = torch.empty(B, dtype=torch.int32, device=dev)
    counts = torch.empty((B, V), dtype=torch.int32, device=dev)
    # Every (row, slice) writes its word of the scratch: no zeroing.
    scratch = torch.empty(max(plan["blocks"], 1), dtype=torch.int32,
                          device=dev)
    fn = _library().queue_scan
    launch = _launcher(entry, dev, B, lambda s: fn(
        typ.data_ptr(), f.data_ptr(), val.data_ptr(), B, N, V,
        plan["slices"], plan["slice_width"], plan["chunk"],
        scratch.data_ptr(), valid.data_ptr(), bad.data_ptr(),
        counts.data_ptr(), s))
    return launch, (valid, bad, counts)


def queue_scan(typ, f, val, V: int) -> Tuple[torch.Tensor, ...]:
    """The unordered queue's fold on the card: (valid uint8 [B], bad
    int32 [B], counts int32 [B, V]), bit for bit ``plain_queue_scan``."""
    launch, outs = prepare_queue(typ, f, val, V)
    launch()
    return outs


def fifo_scratch_words(B: int, N: int, segment: Optional[int] = None
                       ) -> int:
    """int32 words of ``fifo_scan``'s scratch: each row's enqueued
    values and its dequeues' lines, values and enqueue counts (N words
    each: ranks stay below N), two counts a segment and the row's
    dequeue count."""
    return B * (4 * N + 2 * scan_plan(N, B, segment)["segments"] + 1)


def prepare_fifo(typ: torch.Tensor, f: torch.Tensor, val: torch.Tensor,
                 Nmax: int, segment: Optional[int] = None
                 ) -> Tuple[Callable[[], None], Tuple[torch.Tensor, ...]]:
    """The checks and allocations of ``fifo_scan``: returns
    ``(launch, (valid, bad, bad_head, head, tail))``. ``segment``
    overrides the plan's lines a warp (``scan_plan``)."""
    entry = "fifo_scan"
    B, N = _check_lines(entry, typ, f, val)
    _check(entry, 1 <= Nmax < 2**31, f"Nmax={Nmax} out of range")
    _check(entry, segment is None or 1 <= segment < 2**31,
           f"segment={segment} out of range")
    plan = scan_plan(N, B, segment)
    _check(entry, plan["blocks"] < 2**31,
           f"{B} rows of {plan['blocks_per_row']} blocks exceed the grid")
    dev = typ.device
    valid = torch.empty(B, dtype=torch.uint8, device=dev)
    outs = tuple(torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(4))
    # Every scratch word the walk reads is written first by the
    # compaction: the scratch needs no zeroing.
    words = fifo_scratch_words(B, N, segment)
    scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    fn = _library().fifo_scan
    launch = _launcher(entry, dev, B, lambda s: fn(
        typ.data_ptr(), f.data_ptr(), val.data_ptr(), B, N, Nmax,
        plan["segment"], scratch.data_ptr(), words, valid.data_ptr(),
        *(o.data_ptr() for o in outs), s))
    return launch, (valid, *outs)


def fifo_scan(typ, f, val, Nmax: int, segment: Optional[int] = None
              ) -> Tuple[torch.Tensor, ...]:
    """The FIFO queue's fold on the card: (valid uint8 [B], bad,
    bad_head, head, tail int32 [B]), bit for bit ``plain_fifo_scan``."""
    launch, outs = prepare_fifo(typ, f, val, Nmax, segment)
    launch()
    return outs
