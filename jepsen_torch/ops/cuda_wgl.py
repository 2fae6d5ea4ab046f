"""Build, load and launch the hand-written CUDA WGL frontier kernel.

The counterpart of the reference's Pallas module (``ops/pallas_wgl.py``):
``csrc/wgl_frontier.cu`` holds the kernel, one thread block per history
row, and this module builds it with ``nvcc`` into a shared library with a
plain C interface, loads it with ``ctypes`` and launches it on PyTorch's
current stream. ``smem_plan`` decides where a row's frontier lives (the
role ``vmem_plan`` plays for the TPU kernel). ``wgl_frontier`` is the
wrapper of the single-bucket entry: it checks device, dtype, shape and
contiguity, raises on anything the kernel does not take, and counts its
launches in ``LAUNCHES``. ``wgl_frontier_group`` wraps the group entry,
which checks several bucket chunks of different shapes in one launch
(the counterpart of the reference's ``make_fused_kernel``), and counts
its launches in ``GROUP_LAUNCHES``.

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

# Launches of the single-bucket and the group entry in this process;
# callers reset them to 0 and read them back to show that a path ran on
# the card.
LAUNCHES = 0
GROUP_LAUNCHES = 0

# Members one group launch takes (kMaxMembers in the source).
MAX_GROUP_MEMBERS = 8

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


class _Member(ctypes.Structure):
    """One member chunk of a group launch: the WglMember struct of
    ``csrc/wgl_frontier.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "ev_type", "ev_slot", "ev_slots", "target", "frontier", "valid",
        "bad")]
        + [("target_row_stride", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "slots_i32", "N", "Wt", "K1", "V", "NW", "W", "WL",
            "row_start", "rows")])


class _Group(ctypes.Structure):
    _fields_ = [("m", _Member * MAX_GROUP_MEMBERS),
                ("n_members", ctypes.c_int), ("total_rows", ctypes.c_int)]


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib = build_library(SRC, {
            "wgl_frontier_launch": (
                [p, p, p, i, p, ctypes.c_longlong, p, p, p, p,
                 i, i, i, i, i, i, i, i, i, i, i, i, p], ctypes.c_int),
            "wgl_frontier_group_launch": ([p, i, i, p], ctypes.c_int),
            "wgl_frontier_group_desc_bytes": ([], ctypes.c_int),
            "wgl_frontier_error": ([ctypes.c_int], ctypes.c_char_p)})
        size = lib.wgl_frontier_group_desc_bytes()
        if size != ctypes.sizeof(_Group):
            raise RuntimeError(f"wgl_frontier_group: descriptor is {size} "
                               f"bytes in the library, "
                               f"{ctypes.sizeof(_Group)} here")
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wgl_frontier: {msg}")


def _check_events(ev_type, ev_slot, ev_slots, target, V, WL, what):
    """Shapes and types of one bucket's event tables and target, as the
    kernel reads them. Returns (B, N, shared_target)."""
    def check(cond, msg):
        _check(cond, f"{what}{msg}")
    B, N = ev_type.shape
    check(ev_type.dtype == torch.int8 and ev_slot.dtype == torch.int8,
          "ev_type and ev_slot must be int8")
    check(tuple(ev_slot.shape) == (B, N), "ev_slot shape")
    check(ev_slots.dtype in (torch.int8, torch.int32),
          "ev_slots must be int8 or int32")
    check(ev_slots.dim() == 3 and tuple(ev_slots.shape[:2]) == (B, N)
          and ev_slots.shape[2] >= WL, "ev_slots shape")
    check(target.dtype == torch.int32, "target must be int32")
    shared = target.dim() == 2
    check((shared or (target.dim() == 3 and target.shape[0] == B))
          and target.shape[-1] == V and target.shape[-2] >= 1,
          "target must be [K1, V] or [B, K1, V]")
    return B, N, shared


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
    B, N, shared = _check_events(ev_type, ev_slot, ev_slots, target, V,
                                 WL, "")
    NW, M = n_state_words(V), 1 << W
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


def wgl_frontier_group(members, flat, rows=None):
    """Check several bucket chunks in ONE launch of the group entry.

    ``members`` is a sequence of ``(V, W, w_live, shared_target)``, one
    per chunk (at most MAX_GROUP_MEMBERS); ``flat`` holds four tensors
    per member, ``ev_type, ev_slot, ev_slots, target`` as
    ``wgl_frontier`` takes them. ``rows`` (optional) is each member's
    count of real rows: the rows past it must be padding (all EV_PAD)
    and are not launched. Returns three tensors per member, flat —
    ``valid`` bool [B], ``bad`` int32 [B] and the frontier int32
    [B, words(V), 2^W] (the final frontier of a valid row, the latched
    pre-failure closure of an invalid one) — the same, bit for bit, as
    a single-bucket check of each member (ops.linearize.get_kernel) and
    as the plain version ``ops.linearize.plain_fused_wgl``. Every
    member's frontier must fit in shared memory (smem_plan)."""
    global GROUP_LAUNCHES
    members = [tuple(m) for m in members]
    _check(1 <= len(members) <= MAX_GROUP_MEMBERS,
           f"{len(members)} members; the group entry takes 1.."
           f"{MAX_GROUP_MEMBERS}")
    _check(len(flat) == 4 * len(members), "four tensors per member")
    dev = flat[0].device
    _check(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    rows = [None] * len(members) if rows is None else list(rows)
    _check(len(rows) == len(members), "one row count per member")
    group = _Group()
    outs, threads, smem, start = [], 32, 0, 0
    for j, ((V, W, w_live, shared_target), nb) in enumerate(
            zip(members, rows)):
        what = f"member {j}: "
        ev_type, ev_slot, ev_slots, target = flat[4 * j:4 * j + 4]
        for name, t in zip(("ev_type", "ev_slot", "ev_slots", "target"),
                           flat[4 * j:4 * j + 4]):
            _check(t.device == dev, f"{what}{name} on {t.device}")
            _check(t.is_contiguous(), f"{what}{name} is not contiguous")
        _check(V <= MAX_STATES and 1 <= W <= MAX_W,
               f"{what}V={V}, W={W} out of range")
        WL = W if w_live is None else max(1, min(int(w_live), W))
        B, N, shared = _check_events(ev_type, ev_slot, ev_slots, target,
                                     V, WL, what)
        _check(shared == bool(shared_target),
               f"{what}target shape does not match shared_target")
        nb = B if nb is None else int(nb)
        _check(0 <= nb <= B, f"{what}rows={nb} outside 0..{B}")
        plan = smem_plan(V, W, WL)
        _check(plan["frontier_in_smem"],
               f"{what}W={W} at V={V} needs the device-memory frontier; "
               "launch it alone")
        NW, M = n_state_words(V), 1 << W
        K1 = int(target.shape[-2])
        frontier = torch.zeros((B, NW, M), dtype=torch.int32, device=dev)
        frontier[:, 0, 0] = 1
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        bad = torch.full((B,), 2**31 - 1, dtype=torch.int32, device=dev)
        outs += [valid, bad, frontier]
        m = group.m[j]
        m.ev_type, m.ev_slot = ev_type.data_ptr(), ev_slot.data_ptr()
        m.ev_slots, m.target = ev_slots.data_ptr(), target.data_ptr()
        m.frontier, m.valid = frontier.data_ptr(), valid.data_ptr()
        m.bad = bad.data_ptr()
        m.target_row_stride = 0 if shared else K1 * V
        m.slots_i32 = int(ev_slots.dtype == torch.int32)
        m.N, m.Wt, m.K1, m.V, m.NW, m.W, m.WL = (
            N, int(ev_slots.shape[2]), K1, V, NW, W, WL)
        m.row_start, m.rows = start, nb
        start += nb
        threads = max(threads, plan["threads"])
        smem = max(smem, plan["smem_bytes"])
    group.n_members, group.total_rows = len(members), start
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wgl_frontier_group_launch(ctypes.byref(group), threads,
                                            smem, stream)
    if err != 0:
        raise RuntimeError("wgl_frontier_group launch failed: "
                           + lib.wgl_frontier_error(err).decode())
    if start:                 # a group of padding rows launches nothing
        GROUP_LAUNCHES += 1
    return tuple(outs)
