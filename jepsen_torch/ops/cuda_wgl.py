"""Build, load and launch the hand-written CUDA WGL frontier kernel.

The counterpart of the reference's Pallas module (``ops/pallas_wgl.py``):
``csrc/wgl_frontier.cu`` holds the kernel, one thread block per history
row, and this module builds it with ``nvcc`` into a shared library with a
plain C interface, loads it with ``ctypes`` and launches it on PyTorch's
current stream. ``smem_plan`` decides where a row's frontier lives (the
role ``vmem_plan`` plays for the TPU kernel). ``wgl_frontier`` is the
wrapper: it checks device, dtype, shape and contiguity, raises on
anything the kernel does not take, and counts its launches in
``LAUNCHES``.

The library is built at first use by ``_build.build_library`` (a
hash-named cache under ``build/jepsen_torch/``). Nothing here runs when
the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ._build import build_library

SRC = Path(__file__).resolve().parent / "csrc" / "wgl_frontier.cu"

# Widest state space (two packed 32-state words) and pending window the
# kernel takes: the widest window one card hosts (ops.linearize's data1wide
# route).
MAX_STATES = 64
MAX_W = 18

# Shared memory one block may use on an H100 (227 KB), and the default
# above which the kernel must opt in.
SMEM_LIMIT_BYTES = 232448
SMEM_DEFAULT_BYTES = 48 * 1024

# Launches of the kernel in this process; callers reset it to 0 and read
# it back to show that a path ran on the card.
LAUNCHES = 0

_LIB = None


def n_state_words(V: int) -> int:
    return (V + 31) // 32


def smem_plan(V: int, W: int, w_live: Optional[int] = None) -> dict:
    """Static shared-memory plan of one block (one history row).

    The block stages the packed transition rows of its event's ``w_live``
    slots (``[w_live, words(V), V]`` uint32) and, when it fits beside
    them in the 227 KB a block may use, the row's whole frontier
    ``[words(V), 2^W]`` uint32. Otherwise the frontier stays in the row's
    slice of the output tensor in device memory (W = 16..18 at one word).
    The kind vocabulary does not enter: only the event's own slots are
    staged. ``threads`` is the block size: one thread per mask pair, at
    least a warp, at most 512."""
    NW, M = n_state_words(V), 1 << int(W)
    WL = W if w_live is None else max(1, min(int(w_live), W))
    rows = WL * NW * V * 4
    frontier = NW * M * 4
    resident = rows + frontier <= SMEM_LIMIT_BYTES
    return {"rows_bytes": rows, "frontier_bytes": frontier,
            "frontier_in_smem": resident,
            "smem_bytes": rows + (frontier if resident else 0),
            "threads": min(max(M // 2, 32), 512),
            "limit_bytes": SMEM_LIMIT_BYTES}


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB = build_library(SRC, {
            "wgl_frontier_launch": (
                [p, p, p, i, p, ctypes.c_longlong, p, p, p, p,
                 i, i, i, i, i, i, i, i, i, i, i, i, p], ctypes.c_int),
            "wgl_frontier_error": ([ctypes.c_int], ctypes.c_char_p)})
    return _LIB


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wgl_frontier: {msg}")


def wgl_frontier(ev_type: torch.Tensor, ev_slot: torch.Tensor,
                 ev_slots: torch.Tensor, target: torch.Tensor, idx0: int,
                 F: torch.Tensor, Fb: torch.Tensor, valid: torch.Tensor,
                 bad: torch.Tensor, *, V: int, W: int,
                 w_live: Optional[int] = None):
    """Advance the packed WGL carry of B rows over N events on the card.

    ``ev_type``/``ev_slot`` int8 [B, N], ``ev_slots`` int8 or int32
    [B, N, Wt] (Wt >= w_live), ``target`` int32 [K1, V] shared or
    [B, K1, V] per row; the carry is ``F``/``Fb`` int32 bit patterns
    [B, words(V), 2^W], ``valid`` bool [B] and ``bad`` int32 [B], with
    ``idx0`` the global index of event 0. Returns the new
    ``(valid, bad, F, Fb)``; the inputs are left as they were. The same
    function as ``ops.linearize.plain_wgl``, bit for bit."""
    global LAUNCHES
    WL = W if w_live is None else max(1, min(int(w_live), W))
    _check(V <= MAX_STATES, f"V={V} > {MAX_STATES} states")
    _check(1 <= W <= MAX_W, f"W={W} outside 1..{MAX_W}")
    dev = ev_type.device
    _check(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    tensors = {"ev_type": ev_type, "ev_slot": ev_slot, "ev_slots": ev_slots,
               "target": target, "F": F, "Fb": Fb, "valid": valid,
               "bad": bad}
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} on {t.device}, expected {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    B, N = ev_type.shape
    NW, M = n_state_words(V), 1 << W
    _check(ev_type.dtype == torch.int8 and ev_slot.dtype == torch.int8,
           "ev_type and ev_slot must be int8")
    _check(tuple(ev_slot.shape) == (B, N), "ev_slot shape")
    _check(ev_slots.dtype in (torch.int8, torch.int32),
           "ev_slots must be int8 or int32")
    _check(ev_slots.dim() == 3 and tuple(ev_slots.shape[:2]) == (B, N)
           and ev_slots.shape[2] >= WL, "ev_slots shape")
    _check(target.dtype == torch.int32, "target must be int32")
    shared = target.dim() == 2
    _check((shared or (target.dim() == 3 and target.shape[0] == B))
           and target.shape[-1] == V and target.shape[-2] >= 1,
           "target must be [K1, V] or [B, K1, V]")
    for name, t in (("F", F), ("Fb", Fb)):
        _check(t.dtype == torch.int32 and tuple(t.shape) == (B, NW, M),
               f"{name} must be int32 [{B}, {NW}, {M}]")
    _check(valid.dtype == torch.bool and tuple(valid.shape) == (B,),
           "valid must be bool [B]")
    _check(bad.dtype == torch.int32 and tuple(bad.shape) == (B,),
           "bad must be int32 [B]")

    F, Fb, valid, bad = F.clone(), Fb.clone(), valid.clone(), bad.clone()
    if B == 0 or N == 0:
        return valid, bad, F, Fb
    plan = smem_plan(V, W, WL)
    K1 = int(target.shape[-2])
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wgl_frontier_launch(
            ev_type.data_ptr(), ev_slot.data_ptr(), ev_slots.data_ptr(),
            int(ev_slots.dtype == torch.int32), target.data_ptr(),
            0 if shared else K1 * V, F.data_ptr(), Fb.data_ptr(),
            valid.data_ptr(), bad.data_ptr(), B, N, int(ev_slots.shape[2]),
            K1, V, NW, W, WL, int(idx0), int(plan["frontier_in_smem"]),
            plan["threads"], plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError("wgl_frontier launch failed: "
                           + lib.wgl_frontier_error(err).decode())
    LAUNCHES += 1
    return valid, bad, F, Fb
