"""Build, load and launch the hand-written CUDA WGL frontier kernel.

The counterpart of the reference's Pallas module (``ops/pallas_wgl.py``):
``csrc/wgl_frontier.cu`` holds the kernel, and this module builds it with
``nvcc`` into a shared library with a plain C interface, loads it with
``ctypes`` and launches it on PyTorch's current stream. ``smem_plan``
picks the kernel's tier for a window and says where a row's frontier and
transition table live (the role ``vmem_plan`` plays for the TPU kernel):
the warp tier (one warp per row, ``W <= W_WARP``), or one of the wide
tiers, which run a delta closure over groups of 32 masks: the block tier
(one block per row, frontier in shared memory), the cluster tier (a
thread-block cluster of 2..8 CTAs per row, the frontier split over their
shared memory by its top mask bits) or the device-memory tier (two state
words at W = 18). ``wgl_frontier`` is the wrapper of the single-bucket
entry: it checks device, dtype, shape and contiguity, raises on anything
the kernel does not take, and counts its launches in ``LAUNCHES`` (those
of a wide tier also in ``WIDE_LAUNCHES``). ``wgl_frontier_group`` wraps the group entry, which checks several bucket
chunks of different shapes in one launch (the counterpart of the
reference's ``make_fused_kernel``), and counts its launches in
``GROUP_LAUNCHES``. ``wgl_frontier(..., iters=)`` launches the
instrumented entry instead (the counterpart of the reference's
``make_kernel(instrument=True)``), which also counts each row's closure
passes as the reference schedules them, on the warp tier's layout (a
warp a row, W <= W_WARP) or a block a row (the count tier, W > W_WARP);
its launches count in ``INSTRUMENT_LAUNCHES``.
``prepare_frontier`` and ``prepare_group`` do a
wrapper's checks and allocations and return the launch itself, so that a
caller can time the kernel alone.

The library is built at first use by ``_build.build_library`` (a
hash-named cache under ``build/jepsen_torch/``). Nothing here runs when
the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ._build import CudaLaunchError, build_library

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

# The warp tier: windows up to W_WARP masks run one warp per row, up to
# WARP_ROWS rows per block (kWarpRows in the source; the group entry's
# blocks are always WARP_ROWS warps), the frontier in registers (at most
# 8 masks per lane and state word: WARP_MAX_W, kWarpMaxW). A block's
# event tiles (TILE_BYTES per row) and staged tables stay within
# WARP_SMEM_BYTES, so that several blocks share an SM; a table that does
# not fit even one row's block is read from device memory.
W_WARP = 8
WARP_MAX_W = 8
WARP_ROWS = 8
TILE_BYTES = 32 * WARP_MAX_W * 4
WARP_SMEM_BYTES = SMEM_DEFAULT_BYTES

# Staged table forms of the warp tier (kTable* in the source): int8 target
# states, or for V <= NIBBLE_MAX_V at one state word the images of every
# nibble of states (two lookups per image instead of a loop over states).
TABLE_FORMS = {"device": 0, "int8": 1, "nibble": 2}
NIBBLE_MAX_V = 8

# Tier codes, as the source numbers them.
TIERS = {"warp": 0, "block": 1, "device": 2, "cluster": 3}

# The wide tiers (kWide* in the source): events staged per tile, the
# widest window, the most warps a CTA and the most CTAs a cluster (the
# portable cluster size).
WIDE_TILE = 32
WIDE_MAX_W = 18
WIDE_MAX_WARPS = 32
MAX_CLUSTER_CTAS = 8

# The instrumented entry's block tier (W > W_WARP, kCount* in the
# source): events staged per tile (each with WIDE_MAX_W slots) and the
# most threads a row's block.
COUNT_TILE = 32
COUNT_MAX_THREADS = 1024

# Launches of the single-bucket and the group entry in this process;
# callers reset them to 0 and read them back to show that a path ran on
# the card.
LAUNCHES = 0
GROUP_LAUNCHES = 0
INSTRUMENT_LAUNCHES = 0
# Of LAUNCHES, those of a wide tier (block, cluster or device memory).
WIDE_LAUNCHES = 0

# Members one group launch takes (kMaxMembers in the source).
MAX_GROUP_MEMBERS = 8

_LIB = None


def n_state_words(V: int) -> int:
    return (V + 31) // 32


def table_form(V: int) -> str:
    """The staged form of a warp-tier table at V states."""
    return "nibble" if V <= NIBBLE_MAX_V else "int8"


def table_bytes(K1: int, V: int, form: Optional[str] = None) -> int:
    """Shared memory of one staged transition table in the warp tier:
    [K1][V] int8 target states, or [K1][2][16] uint32 nibble images, then
    [K1] reach flags, rounded up to 16 (table_bytes in the source)."""
    form = table_form(V) if form is None else form
    entries = K1 * 32 * 4 if form == "nibble" else K1 * V
    return (entries + K1 + 15) & ~15


def wide_fixed_words(groups: int) -> int:
    """Shared-memory words a wide-tier CTA keeps beside its frontier and
    table for ``groups`` 32-mask groups: three bitmaps of a word a group
    (NZ, and the two rounds' dirty masks), the staged event tile (a kind
    per slot, the type and the slot of each of WIDE_TILE events), four
    vote flags and two group counters (wide_fixed_words in the
    source)."""
    return 3 * groups + WIDE_TILE * WIDE_MAX_W + 2 * WIDE_TILE + 6


def count_fixed_words() -> int:
    """Shared-memory words the instrumented entry's block tier keeps
    beside its frontiers and table: the event tile's slot offsets
    (COUNT_TILE events of WIDE_MAX_W slots), live slots and event words
    (count_fixed_words in the source)."""
    return COUNT_TILE * WIDE_MAX_W + 2 * COUNT_TILE


def _count_plan(V: int, W: int, K1: int) -> dict:
    """The instrumented entry's block tier (W > W_WARP): one block of
    min(2^W, COUNT_MAX_THREADS) threads a row. The frontier and its pad
    copy ([words(V), 2^W] uint32 each) stay in shared memory while they
    fit beside the event tile and the table staged as the warp tier
    stages it (``table_form``), then without the table (read from device
    memory); past that both frontiers live in device memory (the
    "device" tier: the output frontier and a scratch copy), the table
    staged when it fits."""
    NW, M = n_state_words(V), 1 << W
    form = table_form(V)
    tb = table_bytes(K1, V, form)
    frontier = 2 * NW * M * 4
    fixed = 4 * count_fixed_words()
    plans = [{"tier": tier, "rows_per_block": 1, "table_form": f,
              "cluster_ctas": 1, "rows_bytes": rows,
              "frontier_bytes": frontier, "frontier_in_smem": tier == "block",
              "smem_bytes": resident + fixed + rows,
              "threads": min(M, COUNT_MAX_THREADS),
              "limit_bytes": SMEM_LIMIT_BYTES}
             for tier, resident in (("block", frontier), ("device", 0))
             for f, rows in ((form, tb), ("device", 0))]
    return next(p for p in plans if p["smem_bytes"] <= SMEM_LIMIT_BYTES)


def wide_threads(groups: int) -> int:
    """Threads of a wide-tier CTA holding ``groups`` groups: a warp per
    8 groups, 4 to WIDE_MAX_WARPS warps."""
    return 32 * min(WIDE_MAX_WARPS, max(4, groups // 8))


def _wide_plan(V: int, W: int, K1: int) -> dict:
    """The wide tiers' plan (W > W_WARP): the fewest CTAs per row, 1, 2,
    4 or 8, whose shared memory holds the row's frontier split by its top
    mask bits ([words(V), 2^W / CTAs] uint32 each) beside the bitmaps and
    tile, with the int8 table staged when it fits too, else read from
    device memory; past 8 CTAs (two state words at W = 18) the
    device-memory tier, one block a row, the frontier in the output
    tensor and only the bitmaps on chip."""
    NW, M = n_state_words(V), 1 << W
    tb = table_bytes(K1, V, "int8")

    def plan(tier, clog, form, cta_frontier):
        groups = (M >> clog) // 32
        rows = tb if form == "int8" else 0
        return {"tier": tier, "rows_per_block": 1, "table_form": form,
                "cluster_ctas": 1 << clog, "rows_bytes": rows,
                "frontier_bytes": NW * M * 4,
                "frontier_in_smem": tier != "device",
                "cta_frontier_bytes": cta_frontier,
                "bitmap_bytes": 3 * groups * 4,
                "smem_bytes": cta_frontier + 4 * wide_fixed_words(groups)
                + rows,
                "threads": wide_threads(groups),
                "limit_bytes": SMEM_LIMIT_BYTES}

    for clog in range(MAX_CLUSTER_CTAS.bit_length()):
        cta = NW * (M >> clog) * 4
        for form in ("int8", "device"):
            p = plan("block" if clog == 0 else "cluster", clog, form, cta)
            if p["smem_bytes"] <= SMEM_LIMIT_BYTES:
                return p
    p = plan("device", 0, "int8", 0)
    return p if p["smem_bytes"] <= SMEM_LIMIT_BYTES else plan(
        "device", 0, "device", 0)


def smem_plan(V: int, W: int, w_live: Optional[int] = None, *,
              K1: int = 1, shared_target: bool = True,
              instrument: bool = False) -> dict:
    """Static launch plan of one bucket: its tier, rows per block,
    CTAs per row, threads and shared memory per block.

    Wide tiers (W > W_WARP, ``_wide_plan``): a delta closure over groups
    of 32 masks, the frontier in the shared memory of one block (the
    block tier: W <= 15 at one state word, 14 at two) or of a cluster of
    ``cluster_ctas`` CTAs (the cluster tier: W = 16..18 at one word,
    15..17 at two), or in device memory (the device-memory tier: W = 18
    at two words). ``smem_bytes`` and ``threads`` are per CTA;
    ``rows_bytes`` is the staged int8 table (``table_form`` "int8"), 0
    when it is read from device memory.

    Warp tier (W <= W_WARP): one warp per row, ``rows_per_block`` rows
    per block, the frontier in the warp's registers (``frontier_in_smem``
    says it is on chip). Shared memory holds each row's event tile
    (TILE_BYTES) and the transition table staged in ``table_form``
    (``table_bytes``: once per block for a shared target, once per row
    otherwise); R is the largest of 8, 4, 2, 1 that keeps a block within
    WARP_SMEM_BYTES, and a table that fits no block stays in device
    memory (``table_form`` "device", R = 8).

    ``instrument=True`` plans the instrumented entry, whose closure
    steps the slots in the reference's order and counts its passes: to
    W_WARP the warp tier's plan (the frontier and its pad copy in the
    warp's registers), past it the count tier's (``_count_plan``: a
    block a row, tier "block" with both frontiers in shared memory, or
    "device" with both in device memory). ``frontier_bytes`` counts the
    frontier and its pad copy."""
    NW, M = n_state_words(V), 1 << int(W)
    frontier = NW * M * 4 * (2 if instrument else 1)
    if instrument and W > W_WARP:
        return _count_plan(V, int(W), int(K1))
    if W > W_WARP:
        return _wide_plan(V, int(W), int(K1))
    form = table_form(V)
    tb = table_bytes(int(K1), V, form)
    plan = {"tier": "warp", "rows_per_block": WARP_ROWS,
            "table_form": "device", "cluster_ctas": 1, "rows_bytes": 0,
            "frontier_bytes": frontier, "frontier_in_smem": True,
            "smem_bytes": WARP_ROWS * TILE_BYTES,
            "threads": WARP_ROWS * 32, "limit_bytes": SMEM_LIMIT_BYTES}
    for R in (WARP_ROWS, 4, 2, 1):
        tables = tb if shared_target else R * tb
        if R * TILE_BYTES + tables <= WARP_SMEM_BYTES:
            plan.update(rows_per_block=R, table_form=form,
                        rows_bytes=tables,
                        smem_bytes=R * TILE_BYTES + tables, threads=R * 32)
            break
    return plan


class _Member(ctypes.Structure):
    """One member chunk of a group launch: the WglMember struct of
    ``csrc/wgl_frontier.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "ev_type", "ev_slot", "ev_slots", "target", "frontier", "valid",
        "bad")]
        + [("target_row_stride", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "slots_i32", "N", "Wt", "K1", "V", "NW", "W", "WL", "tier",
            "rows_per_block", "table_form", "block_start", "rows")])


class _Group(ctypes.Structure):
    _fields_ = [("m", _Member * MAX_GROUP_MEMBERS),
                ("n_members", ctypes.c_int), ("total_blocks", ctypes.c_int)]


def _library():
    """Build (once per source hash) and load the kernel library, and
    check that its descriptor and warp-tier limits match this module."""
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib = build_library(SRC, {
            "wgl_frontier_launch": (
                [p, p, p, i, p, ctypes.c_longlong, p, p, p, p]
                + [i] * 15 + [p], ctypes.c_int),
            "wgl_frontier_instrument_launch": (
                [p, p, p, i, p, ctypes.c_longlong, p, p, p, p, p, p]
                + [i] * 14 + [p], ctypes.c_int),
            "wgl_frontier_group_launch": ([p, i, i, p], ctypes.c_int),
            "wgl_frontier_group_desc_bytes": ([], ctypes.c_int),
            "wgl_frontier_warp_limits": ([ip, ip], ctypes.c_int),
            "wgl_frontier_error": ([ctypes.c_int], ctypes.c_char_p)})
        size = lib.wgl_frontier_group_desc_bytes()
        if size != ctypes.sizeof(_Group):
            raise RuntimeError(f"wgl_frontier_group: descriptor is {size} "
                               f"bytes in the library, "
                               f"{ctypes.sizeof(_Group)} here")
        max_w, rows = ctypes.c_int(), ctypes.c_int()
        lib.wgl_frontier_warp_limits(ctypes.byref(max_w), ctypes.byref(rows))
        if (max_w.value, rows.value) != (WARP_MAX_W, WARP_ROWS):
            raise RuntimeError(
                f"wgl_frontier: the library's warp tier takes W <= "
                f"{max_w.value} in blocks of {rows.value} rows; this module "
                f"expects {WARP_MAX_W} and {WARP_ROWS}")
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


def _check_plan_limits() -> None:
    _check(1 <= W_WARP <= WARP_MAX_W,
           f"W_WARP={W_WARP} outside 1..{WARP_MAX_W}")
    _check(NIBBLE_MAX_V <= 8, f"NIBBLE_MAX_V={NIBBLE_MAX_V} > 8")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise CudaLaunchError(what, err,
                              lib.wgl_frontier_error(err).decode())


def prepare_frontier(ev_type: torch.Tensor, ev_slot: torch.Tensor,
                     ev_slots: torch.Tensor, target: torch.Tensor,
                     idx0: int, F: torch.Tensor, Fb: torch.Tensor,
                     valid: torch.Tensor, bad: torch.Tensor, *, V: int,
                     W: int, w_live: Optional[int] = None,
                     iters: Optional[torch.Tensor] = None):
    """``wgl_frontier``'s checks, without the launch: returns
    ``launch()``, which advances the carry ``F, Fb, valid, bad`` in place
    by one launch of the single-bucket entry (counted in ``LAUNCHES``).
    With ``iters`` (int32 [B] on the card) it launches the instrumented
    entry instead (counted in ``INSTRUMENT_LAUNCHES``), which writes each
    row's closure passes over these events into ``iters``."""
    WL = W if w_live is None else max(1, min(int(w_live), W))
    _check(V <= MAX_STATES, f"V={V} > {MAX_STATES} states")
    _check(1 <= W <= MAX_W, f"W={W} outside 1..{MAX_W}")
    _check_plan_limits()
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
    K1 = int(target.shape[-2])
    if iters is not None:
        _check(iters.device == dev and iters.dtype == torch.int32
               and tuple(iters.shape) == (B,) and iters.is_contiguous(),
               "iters must be a contiguous int32 [B] on the frontier's "
               "device")
        return _prepare_instrument(ev_type, ev_slot, ev_slots, target,
                                   idx0, F, Fb, valid, bad, iters, B, N,
                                   shared, K1, V, NW, W, WL)
    plan = smem_plan(V, W, WL, K1=K1, shared_target=shared)

    def launch() -> None:
        global LAUNCHES, WIDE_LAUNCHES
        if B == 0 or N == 0:
            return
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.wgl_frontier_launch(
                ev_type.data_ptr(), ev_slot.data_ptr(), ev_slots.data_ptr(),
                int(ev_slots.dtype == torch.int32), target.data_ptr(),
                0 if shared else K1 * V, F.data_ptr(), Fb.data_ptr(),
                valid.data_ptr(), bad.data_ptr(), B, N,
                int(ev_slots.shape[2]), K1, V, NW, W, WL, int(idx0),
                TIERS[plan["tier"]], plan["rows_per_block"],
                TABLE_FORMS[plan["table_form"]], plan["cluster_ctas"],
                plan["threads"], plan["smem_bytes"], _stream(dev))
        _raise_on(lib, err, "wgl_frontier")
        LAUNCHES += 1
        WIDE_LAUNCHES += plan["tier"] != "warp"

    return launch


def _prepare_instrument(ev_type, ev_slot, ev_slots, target, idx0, F, Fb,
                        valid, bad, iters, B, N, shared, K1, V, NW, W, WL):
    """The instrumented entry's launch (prepare_frontier with iters=)."""
    plan = smem_plan(V, W, WL, K1=K1, shared_target=shared, instrument=True)
    dev = ev_type.device
    # The pad events' scratch frontier of the device-memory tier (the
    # other tiers keep it on chip); fresh for every launch.
    scratch = (torch.empty((B, NW, 1 << W), dtype=torch.int32, device=dev)
               if plan["tier"] == "device" and B else None)

    def launch() -> None:
        global INSTRUMENT_LAUNCHES
        if B == 0:
            return
        if N == 0:
            iters.zero_()
            return
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.wgl_frontier_instrument_launch(
                ev_type.data_ptr(), ev_slot.data_ptr(), ev_slots.data_ptr(),
                int(ev_slots.dtype == torch.int32), target.data_ptr(),
                0 if shared else K1 * V, F.data_ptr(), Fb.data_ptr(),
                valid.data_ptr(), bad.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                iters.data_ptr(), B, N, int(ev_slots.shape[2]), K1, V, NW,
                W, WL, int(idx0), TIERS[plan["tier"]],
                plan["rows_per_block"], TABLE_FORMS[plan["table_form"]],
                plan["threads"], plan["smem_bytes"], _stream(dev))
        _raise_on(lib, err, "wgl_frontier_instrument")
        INSTRUMENT_LAUNCHES += 1

    return launch


def wgl_frontier(ev_type: torch.Tensor, ev_slot: torch.Tensor,
                 ev_slots: torch.Tensor, target: torch.Tensor, idx0: int,
                 F: torch.Tensor, Fb: torch.Tensor, valid: torch.Tensor,
                 bad: torch.Tensor, *, V: int, W: int,
                 w_live: Optional[int] = None,
                 iters: Optional[torch.Tensor] = None):
    """Advance the packed WGL carry of B rows over N events on the card.

    ``ev_type``/``ev_slot`` int8 [B, N], ``ev_slots`` int8 or int32
    [B, N, Wt] (Wt >= w_live), ``target`` int32 [K1, V] shared or
    [B, K1, V] per row; the carry is ``F``/``Fb`` int32 bit patterns
    [B, words(V), 2^W], ``valid`` bool [B] and ``bad`` int32 [B], with
    ``idx0`` the global index of event 0. Returns the new
    ``(valid, bad, F, Fb)``; the inputs are left as they were. The same
    function as ``ops.linearize.plain_wgl``, bit for bit.

    ``iters`` (an integer [B] tensor on the card, optional) launches the
    instrumented entry, which adds each row's closure passes over these
    events to ``iters`` in place, as ``plain_wgl(iters=...)`` does; the
    carry it returns is the same, bit for bit."""
    F, Fb, valid, bad = F.clone(), Fb.clone(), valid.clone(), bad.clone()
    count = None
    if iters is not None:
        count = torch.empty(ev_type.shape[0], dtype=torch.int32,
                            device=ev_type.device)
    prepare_frontier(ev_type, ev_slot, ev_slots, target, idx0, F, Fb, valid,
                     bad, V=V, W=W, w_live=w_live, iters=count)()
    if iters is not None:
        iters += count.to(iters.dtype)
    return valid, bad, F, Fb


def prepare_group(members, flat, rows=None):
    """``wgl_frontier_group``'s checks and output allocation, without the
    launch: returns ``(launch, outs)``. ``launch()`` runs the group entry
    once on ``outs`` (counted in ``GROUP_LAUNCHES``), which must hold the
    initial carry: they do when returned."""
    members = [tuple(m) for m in members]
    _check(1 <= len(members) <= MAX_GROUP_MEMBERS,
           f"{len(members)} members; the group entry takes 1.."
           f"{MAX_GROUP_MEMBERS}")
    _check(len(flat) == 4 * len(members), "four tensors per member")
    _check_plan_limits()
    dev = flat[0].device
    _check(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    rows = [None] * len(members) if rows is None else list(rows)
    _check(len(rows) == len(members), "one row count per member")
    group = _Group()
    outs, smem, blocks = [], 0, 0
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
        K1 = int(target.shape[-2])
        plan = smem_plan(V, W, WL, K1=K1, shared_target=shared)
        _check(plan["tier"] in ("warp", "block"),
               f"{what}W={W} at V={V} needs the {plan['tier']} tier; "
               "launch it alone")
        NW, M = n_state_words(V), 1 << W
        frontier = torch.zeros((B, NW, M), dtype=torch.int32, device=dev)
        frontier[:, 0, 0] = 1
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        bad = torch.full((B,), 2**31 - 1, dtype=torch.int32, device=dev)
        outs += [valid, bad, frontier]
        R = plan["rows_per_block"]
        m = group.m[j]
        m.ev_type, m.ev_slot = ev_type.data_ptr(), ev_slot.data_ptr()
        m.ev_slots, m.target = ev_slots.data_ptr(), target.data_ptr()
        m.frontier, m.valid = frontier.data_ptr(), valid.data_ptr()
        m.bad = bad.data_ptr()
        m.target_row_stride = 0 if shared else K1 * V
        m.slots_i32 = int(ev_slots.dtype == torch.int32)
        m.N, m.Wt, m.K1, m.V, m.NW, m.W, m.WL = (
            N, int(ev_slots.shape[2]), K1, V, NW, W, WL)
        m.tier, m.rows_per_block = TIERS[plan["tier"]], R
        m.table_form = TABLE_FORMS[plan["table_form"]]
        m.block_start, m.rows = blocks, nb
        blocks += -(-nb // R)
        smem = max(smem, plan["smem_bytes"])
    group.n_members, group.total_blocks = len(members), blocks

    def launch() -> None:
        global GROUP_LAUNCHES
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.wgl_frontier_group_launch(
                ctypes.byref(group), WARP_ROWS * 32, smem, _stream(dev))
        _raise_on(lib, err, "wgl_frontier_group")
        if blocks:            # a group of padding rows launches nothing
            GROUP_LAUNCHES += 1

    return launch, tuple(outs)


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
    as the plain version ``ops.linearize.plain_fused_wgl``. Every member
    must plan the warp or the block tier (smem_plan): a cluster or
    device-memory member launches alone."""
    launch, outs = prepare_group(members, flat, rows)
    launch()
    return outs
