"""Build, load and launch the hand-written CUDA history generators.

The counterpart of the reference's jitted generator programs
(``ops/synth_device.py`` ``_cas_core``, ``_la_core`` and ``_wide_core``):
``csrc/synth_device.cu`` holds the kernels and this module is their
wrapper. ``synth_cas`` launches the CAS/register pair and ``synth_la``
the list-append pair (one thread per history row walks its ops; one
thread per (row, line) assembles the line grid), ``synth_wide`` the
elementwise wide-window kernel. Each checks device, dtype, shape and
contiguity, raises on anything the kernels do not take, allocates
outputs and scratch, launches on PyTorch's current stream, and adds one
to ``LAUNCHES`` (``LA_LAUNCHES`` for ``synth_la``). The library is built at first use
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

# Launches of the generator kernels in this process (one per wrapper
# call); callers reset it to 0 and read it back to show that a path ran
# on the card. ``LA_LAUNCHES`` counts the list-append pair apart.
LAUNCHES = 0
LA_LAUNCHES = 0

# Keys whose append counts the la row walk keeps in a local array
# (kLaLocalKeys in the source); more go to a [B, K] device scratch.
LA_LOCAL_KEYS = 16

_LIB = None


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        _LIB = build_library(SRC, {
            "synth_cas_launch": (
                [p, p, p, p, p, p, u, u, u, i, i, i, i, i, i, i, i,
                 p, p, p, p, p, p, p, p, p, p], ctypes.c_int),
            "synth_la_launch": (
                [p, p, p, u, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p],
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


def synth_cas(keys: Dict[str, torch.Tensor], crash_lo: torch.Tensor,
              crash_hi: torch.Tensor, p_info_t: int, corrupt_t: int,
              p_crash_t: int, *, n_procs: int, n_ops: int, n_values: int,
              n_keys: int, with_info: bool, with_crash: bool,
              with_corrupt: bool, key_meta: bool) -> Dict[str, torch.Tensor]:
    """Generate B CAS/register histories on the card. The same contract
    as ``ops.synth_device.plain_cas_core``, bit for bit: ``keys`` are
    int32 bit patterns [B] per stream (sched, vals, fault, corr),
    ``crash_lo/hi`` int32 [B], thresholds integers below 2^24."""
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
    if B == 0:
        return out
    # Per-op scratch: the packed payload, and the lag walk overwritten in
    # place by each op's completion line.
    pay = empty((B, n), torch.int32)
    comp = empty((B, n), torch.int32)

    def ptr(name):
        return out[name].data_ptr() if name in out else None

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.synth_cas_launch(
            *(keys[s].data_ptr() for s in STREAMS), crash_lo.data_ptr(),
            crash_hi.data_ptr(), int(p_info_t), int(corrupt_t),
            int(p_crash_t), B, n, P, V, K, int(with_info), int(with_crash),
            int(with_corrupt), pay.data_ptr(), comp.data_ptr(),
            ptr("peak_w"), ptr("key_peak_w"), ptr("key_present"),
            ptr("type"), ptr("process"), ptr("kind"), ptr("key"), stream)
    _raise_on(err)
    global LAUNCHES
    LAUNCHES += 1
    return out


def prepare_la(keys: Dict[str, torch.Tensor], corrupt_t: int, *,
               n_procs: int, n_ops: int, n_keys: int):
    """``synth_la``'s checks and allocations, without the launch: returns
    ``(launch, out)``, where each ``launch()`` runs the list-append pair
    into ``out`` (counted in ``LA_LAUNCHES``)."""
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
    # Per-op scratch: key and append bit, value, and the lag walk
    # overwritten in place by each op's completion line; per-key counts
    # past the kernel's local array.
    opk = empty((B, n), torch.int32)
    opv = empty((B, n), torch.int32)
    comp = empty((B, n), torch.int32)
    counts = empty((B, K), torch.int32) if K > LA_LOCAL_KEYS else None
    lib = _library()
    args = (*(keys[s].data_ptr() for s in LA_STREAMS), int(corrupt_t), B, n,
            P, K, opk.data_ptr(), opv.data_ptr(), comp.data_ptr(),
            None if counts is None else counts.data_ptr(),
            *(out[f].data_ptr() for f in ("type", "process", "fn", "key",
                                          "val", "corrupted")))

    # The default argument keeps the inputs and scratch alive as long as
    # the launch is.
    def launch(_alive=(keys, opk, opv, comp, counts)):
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


def synth_wide(vals_key: torch.Tensor, *, width: int, n_values: int,
               invalid: bool) -> Dict[str, torch.Tensor]:
    """Generate B wide-window histories on the card; the same contract as
    ``ops.synth_device.plain_wide_core``, bit for bit."""
    dev = _check_rows({"vals_key": vals_key})
    _check(1 <= width < (1 << 15) and n_values >= 1,
           f"width={width}, n_values={n_values}")
    B, N = vals_key.shape[0], width + 1
    out = {"type": torch.empty((B, N), dtype=torch.int8, device=dev),
           "process": torch.empty((B, N), dtype=torch.int16, device=dev),
           "kind": torch.empty((B, N), dtype=torch.int32, device=dev),
           "peak_w": torch.empty((B,), dtype=torch.int32, device=dev)}
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.synth_wide_launch(
            vals_key.data_ptr(), B, width, n_values, int(invalid),
            out["type"].data_ptr(), out["process"].data_ptr(),
            out["kind"].data_ptr(), out["peak_w"].data_ptr(), stream)
    _raise_on(err)
    global LAUNCHES
    LAUNCHES += 1
    return out
