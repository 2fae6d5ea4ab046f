"""Build, load and launch the hand-written CUDA history generators.

The counterpart of the reference's jitted generator programs
(``ops/synth_device.py`` ``_cas_core``, ``_la_core`` and ``_wide_core``):
``csrc/synth_device.cu`` holds the kernels and this module is their
wrapper. ``synth_cas`` launches the CAS/register kernel and ``synth_la``
the list-append kernel (one warp per history row walks its ops in tiles
of 32 and stores each line from its op; ``synth_plan`` places each
warp's ring of recent ops and la's per-key counts), ``synth_wide`` the
wide-window kernel (a warp a row, lanes over its lines). ``prepare_cas``,
``prepare_la`` and ``prepare_wide`` do a wrapper's checks and
allocations and return the launch alone. Each checks device, dtype,
shape and contiguity, raises on anything the kernels do not take,
allocates outputs and scratch, launches on PyTorch's current stream, and
adds one to ``LAUNCHES`` (``LA_LAUNCHES`` for ``synth_la``,
``WIDE_LAUNCHES`` for ``synth_wide``). The library is built at first use
by ``_build.build_library``; nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ._build import CudaLaunchError, build_library

SRC = Path(__file__).resolve().parent / "csrc" / "synth_device.cu"

# Launches of the CAS generator kernel in this process (one per wrapper
# call); callers reset it to 0 and read it back to show that a path ran
# on the card. ``LA_LAUNCHES`` counts the list-append kernel and
# ``WIDE_LAUNCHES`` the wide one.
LAUNCHES = 0
LA_LAUNCHES = 0
WIDE_LAUNCHES = 0

# The row kernels' shared memory (kRowWarps warps a block in the source):
# a warp's share of the 48 KB a block takes without opting in, the cas
# kernel's per-key words (kCasKeyWords) before its ring, and the per-key
# append counts the la kernel keeps there at most.
ROW_WARPS = 4
WARP_SMEM_BYTES = 48 * 1024 // ROW_WARPS
CAS_KEY_WORDS = 64
LA_SMEM_KEYS = 1024


def synth_plan(family: str, n_procs: int, n_ops: int, n_keys: int = 1
               ) -> dict:
    """Where a row kernel keeps a warp's state, in a warp's share of
    shared memory or else in a device scratch row: ``ring``, the ops its
    ring holds (a power of two at least min(P, n) + 32: the window of
    P - 1 ops back that completions and counts read, and the tile), and
    whether it fits (one word an op for "cas", two for "la");
    ``counts_in_smem`` (la), whether the K per-key append counts do;
    ``lines``, the staged line buffer (a power of two at least
    min(P, n) + 67: the lines a tile may store before they are all
    complete, and the three a flush may leave to stop at a multiple of
    four), and whether it fits after those (else lines are stored
    straight to the outputs); ``smem_bytes``, the block's dynamic shared
    memory."""
    w = min(n_procs, n_ops)
    ring = 1 << (w + 31).bit_length()
    lines = 1 << (w + 66).bit_length()
    if family == "cas":
        counts_in_smem = True
        fixed = 4 * CAS_KEY_WORDS
        ring_bytes = 4 * ring
        line_bytes = lines * (7 + (4 if n_keys > 1 else 0))
    elif family == "la":
        counts_in_smem = n_keys <= LA_SMEM_KEYS
        fixed = 4 * (-(-n_keys // 4) * 4) if counts_in_smem else 0
        ring_bytes = 8 * ring
        line_bytes = 12 * lines
    else:
        raise ValueError(f"no row kernel for family {family!r}")
    ring_in_smem = fixed + ring_bytes <= WARP_SMEM_BYTES
    used = fixed + (ring_bytes if ring_in_smem else 0)
    lines_in_smem = used + line_bytes <= WARP_SMEM_BYTES
    used += line_bytes if lines_in_smem else 0
    return {"ring": ring, "ring_in_smem": ring_in_smem,
            "counts_in_smem": counts_in_smem, "lines": lines,
            "lines_in_smem": lines_in_smem,
            "smem_bytes": ROW_WARPS * used}


_LIB = None


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        _LIB = build_library(SRC, {
            "synth_cas_launch": (
                [p, p, p, p, p, p, u, u, u, i, i, i, i, i, i, i, i, i,
                 p, i, p, p, p, p, p, p, p, p], ctypes.c_int),
            "synth_la_launch": (
                [p, p, p, u, i, i, i, i, i, p, p, i, p, p, p, p, p, p, p],
                ctypes.c_int),
            "synth_wide_launch": ([p, i, i, i, i, p, p, p, p, p],
                                  ctypes.c_int),
            "synth_device_error": ([ctypes.c_int], ctypes.c_char_p)})
    return _LIB


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    launch)."""
    _library()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"synth_device: {msg}")


def _check_rows(tensors: Dict[str, torch.Tensor]) -> torch.device:
    first = next(iter(tensors.values()))
    dev = first.device
    _check(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} on {t.device}, expected {dev}")
        _check(t.dtype == torch.int32 and t.dim() == 1
               and t.shape[0] == first.shape[0] and t.is_contiguous(),
               f"{name} must be a contiguous int32 [B] tensor")
    return dev


def _raise_on(err: int) -> None:
    if err != 0:
        raise CudaLaunchError("synth_device", err,
                              _library().synth_device_error(err).decode())


def prepare_cas(keys: Dict[str, torch.Tensor], crash_lo: torch.Tensor,
                crash_hi: torch.Tensor, p_info_t: int, corrupt_t: int,
                p_crash_t: int, *, n_procs: int, n_ops: int, n_values: int,
                n_keys: int, with_info: bool, with_crash: bool,
                with_corrupt: bool, key_meta: bool):
    """``synth_cas``'s checks and allocations, without the launch: returns
    ``(launch, out)``, where each ``launch()`` runs the CAS kernel into
    ``out`` (counted in ``LAUNCHES``)."""
    from .synth_device import STREAMS, check_cas_bounds
    P, n, V, K = n_procs, n_ops, n_values, n_keys
    check_cas_bounds(P, n, V, K)
    rows = {s: keys[s] for s in STREAMS}
    rows.update(crash_lo=crash_lo, crash_hi=crash_hi)
    dev = _check_rows(rows)
    for name, t in (("p_info_t", p_info_t), ("corrupt_t", corrupt_t),
                    ("p_crash_t", p_crash_t)):
        _check(0 <= int(t) <= (1 << 24), f"{name}={t} outside 0..2^24")
    B = keys["sched"].shape[0]
    meta = key_meta and K > 1

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"type": empty((B, 2 * n), torch.int8),
           "process": empty((B, 2 * n), torch.int16),
           "kind": empty((B, 2 * n), torch.int32),
           "peak_w": empty((B,), torch.int32)}
    if K > 1:
        out["key"] = empty((B, 2 * n), torch.int32)
    if meta:
        out["key_peak_w"] = empty((B, K), torch.int32)
        out["key_present"] = empty((B, K), torch.bool)
    plan = synth_plan("cas", P, n, K)
    ring = None if plan["ring_in_smem"] else empty((B, plan["ring"]),
                                                   torch.int32)

    def ptr(name):
        return out[name].data_ptr() if name in out else None

    lib = _library()
    args = (*(keys[s].data_ptr() for s in STREAMS), crash_lo.data_ptr(),
            crash_hi.data_ptr(), int(p_info_t), int(corrupt_t),
            int(p_crash_t), B, n, P, V, K, int(with_info), int(with_crash),
            int(with_corrupt), plan["ring"],
            None if ring is None else ring.data_ptr(),
            plan["lines"] if plan["lines_in_smem"] else 0, ptr("peak_w"),
            ptr("key_peak_w"), ptr("key_present"), ptr("type"),
            ptr("process"), ptr("kind"), ptr("key"))

    # The default argument keeps the inputs and scratch alive as long as
    # the launch is.
    def launch(_alive=(keys, crash_lo, crash_hi, ring)):
        global LAUNCHES
        if B == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(lib.synth_cas_launch(*args, stream))
        LAUNCHES += 1
    return launch, out


def synth_cas(keys: Dict[str, torch.Tensor], crash_lo: torch.Tensor,
              crash_hi: torch.Tensor, p_info_t: int, corrupt_t: int,
              p_crash_t: int, **static) -> Dict[str, torch.Tensor]:
    """Generate B CAS/register histories on the card. The same contract
    as ``ops.synth_device.plain_cas_core``, bit for bit: ``keys`` are
    int32 bit patterns [B] per stream (sched, vals, fault, corr),
    ``crash_lo/hi`` int32 [B], thresholds integers below 2^24."""
    launch, out = prepare_cas(keys, crash_lo, crash_hi, p_info_t, corrupt_t,
                              p_crash_t, **static)
    launch()
    return out


def prepare_la(keys: Dict[str, torch.Tensor], corrupt_t: int, *,
               n_procs: int, n_ops: int, n_keys: int):
    """``synth_la``'s checks and allocations, without the launch: returns
    ``(launch, out)``, where each ``launch()`` runs the list-append
    kernel into ``out`` (counted in ``LA_LAUNCHES``)."""
    from .synth_device import LA_STREAMS, check_la_bounds
    P, n, K = n_procs, n_ops, n_keys
    check_la_bounds(P, n, K)
    dev = _check_rows({s: keys[s] for s in LA_STREAMS})
    _check(0 <= int(corrupt_t) <= (1 << 24),
           f"corrupt_t={corrupt_t} outside 0..2^24")
    B = keys["sched"].shape[0]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"type": empty((B, 2 * n), torch.int8),
           "process": empty((B, 2 * n), torch.int16),
           "fn": empty((B, 2 * n), torch.int8),
           "key": empty((B, 2 * n), torch.int32),
           "val": empty((B, 2 * n), torch.int32),
           "corrupted": empty((B,), torch.bool)}
    # A warp's ring (key and append bit, value) and per-key counts, where
    # they do not fit its shared memory.
    plan = synth_plan("la", P, n, K)
    ring = None if plan["ring_in_smem"] else empty((B, 2 * plan["ring"]),
                                                   torch.int32)
    counts = None if plan["counts_in_smem"] else empty((B, K), torch.int32)
    lib = _library()
    args = (*(keys[s].data_ptr() for s in LA_STREAMS), int(corrupt_t), B, n,
            P, K, plan["ring"], None if ring is None else ring.data_ptr(),
            None if counts is None else counts.data_ptr(),
            plan["lines"] if plan["lines_in_smem"] else 0,
            *(out[f].data_ptr() for f in ("type", "process", "fn", "key",
                                          "val", "corrupted")))

    # The default argument keeps the inputs and scratch alive as long as
    # the launch is.
    def launch(_alive=(keys, ring, counts)):
        global LA_LAUNCHES
        if B == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(lib.synth_la_launch(*args, stream))
        LA_LAUNCHES += 1
    return launch, out


def synth_la(keys: Dict[str, torch.Tensor], corrupt_t: int, *,
             n_procs: int, n_ops: int, n_keys: int
             ) -> Dict[str, torch.Tensor]:
    """Generate B list-append histories on the card. The same contract as
    ``ops.synth_device.plain_la_core``, bit for bit: ``keys`` are int32
    bit patterns [B] for the sched, vals and corr streams, ``corrupt_t``
    a threshold below 2^24."""
    launch, out = prepare_la(keys, corrupt_t, n_procs=n_procs, n_ops=n_ops,
                             n_keys=n_keys)
    launch()
    return out


def prepare_wide(vals_key: torch.Tensor, *, width: int, n_values: int,
                 invalid: bool):
    """``synth_wide``'s checks and allocations, without the launch:
    returns ``(launch, out)``, where each ``launch()`` runs the wide
    kernel into ``out`` (counted in ``WIDE_LAUNCHES``)."""
    dev = _check_rows({"vals_key": vals_key})
    _check(1 <= width < (1 << 15) and n_values >= 1,
           f"width={width}, n_values={n_values}")
    B, N = vals_key.shape[0], width + 1
    out = {"type": torch.empty((B, N), dtype=torch.int8, device=dev),
           "process": torch.empty((B, N), dtype=torch.int16, device=dev),
           "kind": torch.empty((B, N), dtype=torch.int32, device=dev),
           "peak_w": torch.empty((B,), dtype=torch.int32, device=dev)}
    lib = _library()
    args = (vals_key.data_ptr(), B, width, n_values, int(invalid),
            *(out[f].data_ptr() for f in ("type", "process", "kind",
                                          "peak_w")))

    def launch(_alive=vals_key):
        global WIDE_LAUNCHES
        if B == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(lib.synth_wide_launch(*args, stream))
        WIDE_LAUNCHES += 1
    return launch, out


def synth_wide(vals_key: torch.Tensor, *, width: int, n_values: int,
               invalid: bool) -> Dict[str, torch.Tensor]:
    """Generate B wide-window histories on the card; the same contract as
    ``ops.synth_device.plain_wide_core``, bit for bit."""
    launch, out = prepare_wide(vals_key, width=width, n_values=n_values,
                               invalid=invalid)
    launch()
    return out
