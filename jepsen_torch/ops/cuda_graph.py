"""Build, load and launch the hand-written CUDA closure kernel of the
dependency-graph checkers.

The counterpart of the reference's XLA programs ``ops/graph.py``
``graph_kernel`` and ``ops/txn_graph.py`` ``txn_kernel``:
``csrc/graph_closure.cu`` holds the kernel and this module is its
wrapper. ``graph_closure`` launches the graph entry (3 cumulative anomaly
planes) and counts its launches in ``LAUNCHES``; ``txn_closure`` launches
the txn entry (4 packed ladder planes in, the SI plane derived, 5 planes
closed) and counts in ``TXN_LAUNCHES``. Each checks device, dtype, shape
and contiguity, raises on anything the kernel does not take, allocates
the outputs and, past shared memory, the rows' scratch, and launches on
PyTorch's current stream. ``tier`` says which tier a vertex bucket takes
and ``tile_plan`` how a tiled block is laid out.
``prepare`` does a wrapper's checks and allocations and returns the
launch itself, so that a caller can time the kernel alone.

The library is built at first use by ``_build.build_library``; nothing
here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Tuple

import torch

from ._build import CudaLaunchError, build_library
from .graph import words

SRC = Path(__file__).resolve().parent / "csrc" / "graph_closure.cu"

# The warp tier takes V <= WARP_MAX_V (one word per row, one warp per
# plane); above it one block per plane runs blocked Warshall on 32 x 32
# bit tiles, with the tiles in shared memory while they and the warps'
# TABLE_WORDS each fit in SMEM_LIMIT_BYTES (kWarpMaxV, kTableWords and
# kSmemLimit in the source), else in a device-memory scratch slice. A
# tiled block has a warp a tile, at most BLOCK_MAX_THREADS threads.
WARP_MAX_V = 32
SMEM_LIMIT_BYTES = 232448 - 64
TABLE_WORDS = 128
BLOCK_MAX_THREADS = 1024

# In shared memory a plane spreads over a thread-block cluster of up to
# MAX_CLUSTER CTAs (kMaxCluster, the portable size), each holding an
# equal share of its row blocks: the widest cluster that keeps the
# batch's CTAs within TARGET_CTAS, one for each of an H100's SMs.
MAX_CLUSTER = 8
TARGET_CTAS = 132

# The widest vertex bucket: a plane of V·V/32 words keeps 32-bit
# indices (2^25 words, 128 MiB).
MAX_V = 1 << 15

# Planes in and out of each entry.
ENTRIES = {"graph": (3, 3), "txn": (4, 5)}

# Launches of the graph and the txn entry in this process; callers reset
# them to 0 and read them back to show that a path ran on the card.
LAUNCHES = 0
TXN_LAUNCHES = 0

_LIB = None


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entry = ([p, i, i, i, p, p, p, p], ctypes.c_int)
        _LIB = build_library(SRC, {
            "graph_closure": entry, "txn_closure": entry,
            "graph_closure_error": ([ctypes.c_int], ctypes.c_char_p)})
    return _LIB


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def tile_plan(V: int, planes: int = 1) -> dict:
    """A tiled launch's layout at V >= 64 for ``planes`` planes:
    ``tiles`` (T x T tiles of 32 rows' words), ``cluster`` CTAs a plane,
    ``threads`` a CTA, ``blocks`` in all, and
    ``smem_bytes`` of dynamic shared memory a CTA: its share of the
    tiles and the warps' tables (the ``smem`` tier), or the tables alone
    with the tiles in device memory (``global``, one CTA a plane)."""
    T = V // 32

    def layout(c):
        threads = min(BLOCK_MAX_THREADS, 32 * (T // c) * T)
        return threads, threads // 32 * TABLE_WORDS * 4

    threads, tables = layout(1)
    if V * T * 4 + tables > SMEM_LIMIT_BYTES:
        c, tier_name, tiles_bytes = 1, "global", 0
    else:
        tier_name = "smem"
        c = next(
            (c for c in (8, 4, 2) if c <= min(T, MAX_CLUSTER)
             and planes * c <= TARGET_CTAS), 1)
        threads, tables = layout(c)
        tiles_bytes = V * T * 4 // c
    return {"tiles": T, "cluster": c, "threads": threads, "tier": tier_name,
            "smem_bytes": tiles_bytes + tables, "blocks": planes * c}


def tier(V: int) -> str:
    """The tier a vertex bucket takes: ``warp`` (V <= 32), ``smem`` (a
    plane's tiles in shared memory) or ``global`` (tiles in a
    device-memory scratch)."""
    if V <= WARP_MAX_V:
        return "warp"
    return tile_plan(V)["tier"]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"graph_closure: {msg}")


def prepare(adj: torch.Tensor, V: int, entry: str = "graph"
            ) -> Tuple[Callable[[], None], torch.Tensor, torch.Tensor]:
    """The checks and allocations of ``graph_closure`` (``entry`` =
    "graph") or ``txn_closure`` ("txn"), without the launch: returns
    ``(launch, cyc, node)``, where each call of ``launch`` is one launch
    of the entry (counted in LAUNCHES or TXN_LAUNCHES) that fills ``cyc``
    bool [B, L] and ``node`` int32 [B, L]; a tiled plane takes
    ``tile_plan``'s CTAs."""
    l_in, l_out = ENTRIES[entry]
    _check(adj.device.type == "cuda",
           f"adj must be on a CUDA device, got {adj.device}")
    _check(V >= 8 and V & (V - 1) == 0 and V <= MAX_V,
           f"V={V} is not a vertex bucket the kernel takes (a power of "
           f"two from 8 to {MAX_V})")
    _check(adj.dtype == torch.int32 and adj.dim() == 4
           and tuple(adj.shape[1:]) == (l_in, V, words(V))
           and adj.is_contiguous(),
           f"adj must be a contiguous int32 [B, {l_in}, {V}, {words(V)}] "
           f"tensor, got {adj.dtype} {tuple(adj.shape)}")
    B = adj.shape[0]
    c = tile_plan(V, B * l_out)["cluster"] if V > WARP_MAX_V else 1
    dev = adj.device
    cyc = torch.empty((B, l_out), dtype=torch.bool, device=dev)
    node = torch.empty((B, l_out), dtype=torch.int32, device=dev)
    scratch = None
    if tier(V) == "global" and B:
        scratch = torch.empty(B * l_out * V * words(V), dtype=torch.int32,
                              device=dev)
    fn = getattr(_library(), f"{entry}_closure")

    def launch() -> None:
        global LAUNCHES, TXN_LAUNCHES
        if B == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(adj.data_ptr(), B, V, c,
                     scratch.data_ptr() if scratch is not None else None,
                     cyc.data_ptr(), node.data_ptr(), stream)
        if err != 0:
            raise CudaLaunchError(
                f"{entry}_closure", err,
                _library().graph_closure_error(err).decode())
        if entry == "txn":
            TXN_LAUNCHES += 1
        else:
            LAUNCHES += 1

    return launch, cyc, node


def graph_closure(adj: torch.Tensor, V: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Close B graphs' 3 cumulative planes on the card: adj int32
    [B, 3, V, words(V)] packed rows -> (cyc bool [B, 3], node int32
    [B, 3]), bit for bit ``plain_graph_closure``."""
    launch, cyc, node = prepare(adj, V, "graph")
    launch()
    return cyc, node


def txn_closure(adj: torch.Tensor, V: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Close B transactional graphs' ladder on the card: adj int32
    [B, 4, V, words(V)] (G0, G1c, G2-item, G2) -> (cyc bool [B, 5],
    node int32 [B, 5]) with the derived SI plane last, bit for bit
    ``plain_txn_closure``."""
    launch, cyc, node = prepare(adj, V, "txn")
    launch()
    return cyc, node
