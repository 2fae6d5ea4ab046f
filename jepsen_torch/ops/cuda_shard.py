"""Build, load and launch the frontier-sharded WGL step (K3), with its
plain PyTorch versions.

The counterpart of the reference's ``make_frontier_kernel``
(``jepsen_tpu/parallel/frontier.py``), the single-history checker whose
mask axis is split over D = 2^k devices. ``csrc/wgl_shard.cu`` holds one
shard's part of an event in three entries: ``shard_close`` (merge the
images received from partners, close under the local slots, flag what
changed and whether a config survives the completion), ``shard_image``
(a top slot's image of a bit-clear shard's slice, the send buffer of the
exchange) and ``shard_commit`` (the completion, the latch and the
verdict), the last two a block a row. ``shard_close`` holds a row's slice
on chip in the tier ``close_plan`` picks (a block, a cluster of 2, 4 or
8 CTAs, or device memory), closes it in one sweep by layers of masks
from its fresh slots and dirty masks, and counts its launches per tier
in ``CLOSE_TIERS``. The host loop that drives them, with the copies between
partners and the reductions over the frontier axis, is
``jepsen_torch.parallel.frontier``.

Each wrapper takes its tensors where they lie: on a CUDA tensor it checks
device, dtype, shape and contiguity, raises on anything the kernel does
not take, launches on PyTorch's current stream of that device and counts
the launch in ``LAUNCHES``; on a CPU tensor it runs its plain version
(``plain_shard_close``, ``plain_shard_image``, ``plain_shard_commit``),
which computes the same outputs bit for bit. Frontiers are int32 bit
patterns ``[rows, words(V), 2^WL]``, updated in place.

The library is built at first use by ``_build.build_library``; nothing
here runs when the module is imported.
"""
from __future__ import annotations

import collections
import ctypes
from pathlib import Path
from typing import Optional, Sequence

import torch

from ._build import CudaLaunchError, build_library
from .cuda_wgl import n_state_words
from .encode import EV_CLOSE, EV_FUSED, EV_OK

SRC = Path(__file__).resolve().parent / "csrc" / "wgl_shard.cu"

# The kernels' limits (kMaxWLocal, kMaxTop, kMaxV in the source): the
# widest local window, the most top bits (log2 of the frontier devices)
# and the most states.
MAX_W_LOCAL = 18
MAX_TOP = 8
MAX_STATES = 64
MAX_THREADS = 1024

# shard_close's plan (kCloseMaxClusterLog and kCloseMaxWarps in the
# source): at most 8 CTAs a row and 256 threads a CTA; the shared memory
# a block may take on this card, less a reserve for the kernel's static
# shared memory; the CTAs a launch should reach (four for each of the
# card's SMs, which hold five of the timing batch's CTAs each, all
# resident at once); and the fewest masks a CTA keeps when the plan
# splits a slice further.
CLOSE_MAX_CLUSTER_LOG = 3
CLOSE_MAX_THREADS = 256
SMEM_LIMIT_BYTES = 232448 - 1024
CARD_SMS = 132
CLOSE_FILL_CTAS = 4 * CARD_SMS
CLOSE_SPLIT_MASKS = 1 << 13
CLOSE_TIER_CODES = {"block": 0, "cluster": 1, "device": 2}

# Launches of each entry in this process; callers reset them to 0 and
# read them back to show that a path ran on the card.
LAUNCHES = {"shard_close": 0, "shard_image": 0, "shard_commit": 0}
# shard_close's launches by plan, "tier/CTAs a row" (for example
# "cluster/4"); reset and read as LAUNCHES.
CLOSE_TIERS: collections.Counter = collections.Counter()

_LIB = None


class ShardArgs(ctypes.Structure):
    """One launch's arguments: the ShardArgs struct of
    ``csrc/wgl_shard.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("F", "Fbad", "send")]
                + [("recv", ctypes.c_void_p * MAX_TOP)]
                + [(n, ctypes.c_void_p) for n in (
                    "ev_type", "ev_slot", "ev_slots", "target", "order",
                    "flags")]
                + [("target_row_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_void_p) for n in (
                    "valid", "bad", "nonempty", "changed", "kept")]
                + [(n, ctypes.c_int) for n in (
                    "slots_i32", "N", "Wt", "K1", "V", "NW", "W", "WL",
                    "e", "d", "b", "first_round", "idx", "rows")])


def _library():
    """Build (once per source hash) and load the kernel library, and
    check that its descriptor and limits match this module."""
    global _LIB
    if _LIB is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib = build_library(SRC, {
            "wgl_shard_close_launch": ([p, i, i, i, i, p], i),
            "wgl_shard_image_launch": ([p, i, p], i),
            "wgl_shard_commit_launch": ([p, i, p], i),
            "wgl_shard_close_residency": ([i, i, i, i, ip], i),
            "wgl_shard_args_bytes": ([], i),
            "wgl_shard_limits": ([ip] * 5, i),
            "wgl_shard_error": ([i], ctypes.c_char_p)})
        size = lib.wgl_shard_args_bytes()
        if size != ctypes.sizeof(ShardArgs):
            raise RuntimeError(f"wgl_shard: descriptor is {size} bytes in "
                               f"the library, {ctypes.sizeof(ShardArgs)} "
                               "here")
        lim = [ctypes.c_int() for _ in range(5)]
        lib.wgl_shard_limits(*(ctypes.byref(x) for x in lim))
        mine = [MAX_W_LOCAL, MAX_TOP, MAX_STATES, CLOSE_MAX_CLUSTER_LOG,
                CLOSE_MAX_THREADS]
        if [x.value for x in lim] != mine:
            raise RuntimeError(f"wgl_shard: the library's limits are "
                               f"{[x.value for x in lim]}, this module's "
                               f"{mine}")
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def close_residency(plan: dict, NW: int) -> int:
    """How many clusters (CTAs in the block and device tiers) of a
    shard_close ``plan`` the card keeps resident at once
    (cudaOccupancyMaxActiveClusters): a launch of more takes a second
    wave."""
    lib = _library()
    n = ctypes.c_int()
    err = lib.wgl_shard_close_residency(NW, plan["clog"], plan["threads"],
                                        plan["smem_bytes"], ctypes.byref(n))
    if err != 0:
        raise CudaLaunchError("shard_close", err,
                              lib.wgl_shard_error(err).decode())
    return n.value


def threads(WL: int) -> int:
    """Threads of a row's block in shard_image and shard_commit: one a
    local mask, 32 to MAX_THREADS."""
    return min(MAX_THREADS, max(32, 1 << WL))


def close_smem_words(WL: int, clog: int, NW: int, V: int,
                     in_smem: bool) -> int:
    """Words of dynamic shared memory a shard_close CTA takes (the
    source's close_smem_words): on the block and cluster tiers its
    2^(WL - clog) masks of the slice and a flag byte a mask (whole
    32-mask groups), which the device tier keeps in device memory; and
    the WL local slots' nibble tables (16 entries of NW words for each of
    the ceil(V / 4) nibbles of a state set, padded to an odd count)."""
    Ml = 1 << (WL - clog)
    return ((NW * Ml + 8 * max(1, Ml >> 5) if in_smem else 0)
            + WL * (16 * ((V + 3) // 4) * NW | 1))


_ORDERS: dict = {}


def close_order(bits: int, device) -> torch.Tensor:
    """The 2^bits local masks of a CTA ordered by their bit count, then
    value (int32 on ``device``, made once a process): shard_close's sweep
    takes the masks one bit count at a time."""
    key = (bits, str(device))
    if key not in _ORDERS:
        m = torch.arange(1 << bits, dtype=torch.int64)
        pop = torch.zeros_like(m)
        for b in range(bits):
            pop += (m >> b) & 1
        _ORDERS[key] = m[torch.argsort(pop * (1 << bits) + m)].to(
            device=device, dtype=torch.int32)
    return _ORDERS[key]


def close_plan(WL: int, NW: int, rows: int, V: Optional[int] = None
               ) -> dict:
    """shard_close's static launch plan for ``rows`` rows of a
    2^WL-mask slice of NW state words: ``tier`` "block" (the slice in one
    CTA's shared memory), "cluster" (split by its top ``clog`` local
    mask bits over ``ctas`` = 2^clog CTAs of a thread-block cluster) or
    "device" (the slice and its flags in device memory, where no cluster
    of 8 holds it), with ``threads`` and ``smem_bytes`` a CTA.

    The tier is a pure function of (WL, NW, rows): the fewest CTAs whose
    shared memory holds the slice (with the tables of 32 * NW states),
    then twice as many while the launch has fewer than CLOSE_FILL_CTAS
    CTAs and each keeps at least CLOSE_SPLIT_MASKS masks. ``smem_bytes``
    counts the tables of ``V`` states when given (the launch's), so that
    the most CTAs share an SM."""
    Vt = 32 * NW

    def plan(tier, clog):
        Ml = 1 << (WL - clog)
        groups = max(1, Ml >> 5)
        return {"tier": tier, "clog": clog, "ctas": 1 << clog,
                "masks_per_cta": Ml, "groups": groups,
                "threads": 32 * min(CLOSE_MAX_THREADS // 32, groups),
                "slice_in_smem": tier != "device",
                "smem_bytes": 4 * close_smem_words(WL, clog, NW, V or Vt,
                                                   tier != "device"),
                "ctas_launched": rows << clog}

    for clog in range(min(WL, CLOSE_MAX_CLUSTER_LOG) + 1):
        if 4 * close_smem_words(WL, clog, NW, Vt, True) <= SMEM_LIMIT_BYTES:
            while (clog < min(WL, CLOSE_MAX_CLUSTER_LOG)
                   and rows << clog < CLOSE_FILL_CTAS
                   and 1 << (WL - clog - 1) >= CLOSE_SPLIT_MASKS):
                clog += 1
            return plan("block" if clog == 0 else "cluster", clog)
    p = plan("device", 0)
    if p["smem_bytes"] > SMEM_LIMIT_BYTES:
        raise ValueError(f"wgl_shard: WL={WL} at {NW} words fits no tier")
    return p


# ------------------------------------------------------ the plain versions

def _kinds(ev_slots: torch.Tensor, e: int, lo: int, hi: int,
           K1: int) -> torch.Tensor:
    """The normalised kinds of slots lo..hi-1 at event e, [rows, hi-lo]
    (a negative int8 kind wraps by K1, as the single-device kernel
    reads it)."""
    k = ev_slots[:, e, lo:hi].to(torch.int64)
    return torch.where(k < 0, k + K1, k).clamp(0, K1 - 1)


def _rowwords(target: torch.Tensor, kinds: torch.Tensor,
              V: int) -> torch.Tensor:
    """[rows, S, V, words] int32: each source state's packed target row
    for the S slots' kinds."""
    from .linearize import pack_rows
    rows = pack_rows(target, V)                    # [NW, (rows,) K1, V]
    if target.dim() == 2:
        r = rows[:, kinds]
    else:
        ar = torch.arange(kinds.shape[0], device=kinds.device)[:, None]
        r = rows[:, ar, kinds]                     # [NW, rows, S, V]
    return r.permute(1, 2, 3, 0).contiguous()


def _image(src: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """T(src) of packed words src [rows, NW, P] under one slot's rows
    rw [rows, V, NW]: ``linearize._transition``, in its CPU form on the
    CPU and in its matrix-product form elsewhere."""
    from .linearize import _transition
    V = rw.shape[1]
    if src.device.type != "cpu":
        shifts = torch.arange(32, device=src.device)
        rw = ((rw[..., None] >> shifts) & 1).reshape(
            rw.shape[0], V, -1).to(torch.float32)
    return _transition(src, rw, V)


def _active(ev_type: torch.Tensor, valid: torch.Tensor, e: int):
    typ = ev_type[:, e].to(torch.int64)
    is_ok = (typ == EV_OK) | (typ == EV_FUSED)
    return valid & (is_ok | (typ == EV_CLOSE)), is_ok


def plain_shard_close(F, recv, ev_type, ev_slot, ev_slots, target, valid,
                      *, e, d, WL, W, V, first_round):
    """The plain version of ``shard_close``, with its signature: returns
    (changed, kept), int32 [rows], and closes ``F`` in place."""
    rows = F.shape[0]
    active, is_ok = _active(ev_type, valid, e)
    added = torch.zeros(rows, dtype=torch.bool, device=F.device)
    for r in recv:
        if r is None:
            continue
        new = F | r
        gain = (new != F).reshape(rows, -1).any(1) & active
        added |= gain
        F[gain] = new[gain]
    do = active if first_round else active & added
    if bool(do.any()):
        sel = torch.nonzero(do).flatten()
        rw = _rowwords(target if target.dim() == 2 else target[sel],
                       _kinds(ev_slots[sel], e, 0, WL, target.shape[-2]), V)
        Fc = F[sel]
        n, NW, M = Fc.shape
        while True:
            F0 = Fc.clone()
            for i in range(WL):
                Fr = Fc.view(n, NW, M >> (i + 1), 2, 1 << i)
                src = Fr[:, :, :, 0, :].reshape(n, NW, -1)
                Fr[:, :, :, 1, :] |= _image(src, rw[:, i]).view(
                    n, NW, M >> (i + 1), 1 << i)
            if not bool((Fc != F0).any()):
                break
        F[sel] = Fc
    M = 1 << WL
    q = ev_slot[:, e].to(torch.int64).clamp(0, W - 1)
    m = torch.arange(M, device=F.device)
    nz = F != 0                                     # [rows, NW, M]
    local = (nz & (((m[None, :] >> q.clamp(max=WL - 1)[:, None]) & 1)
                   .bool()[:, None, :])).reshape(rows, -1).any(1)
    top = nz.reshape(rows, -1).any(1) & (
        ((d >> (q - WL).clamp(min=0)) & 1) == 1)
    kept = active & is_ok & torch.where(q < WL, local, top)
    return added.to(torch.int32), kept.to(torch.int32)


def plain_shard_image(F, ev_type, ev_slot, ev_slots, target, valid, *, e,
                      b, d, WL, W, V, send=None):
    """The plain version of ``shard_image``: T of top slot ``b`` on every
    local mask of the active rows, 0 on the others, into ``send``
    (allocated when None), which it returns."""
    active, _ = _active(ev_type, valid, e)
    rw = _rowwords(target, _kinds(ev_slots, e, WL + b, WL + b + 1,
                                  target.shape[-2]), V)[:, 0]
    img = _image(F, rw)
    img = torch.where(active[:, None, None], img, torch.zeros_like(img))
    if send is None:
        return img.contiguous()
    send.copy_(img)
    return send


def plain_shard_commit(F, Fbad, top, ev_type, ev_slot, ev_slots, target,
                       valid, bad, nonempty, *, e, idx, d, WL, W, V):
    """The plain version of ``shard_commit``: completes ``F``, latches
    ``Fbad`` and updates ``valid`` and ``bad``, all in place; ``top[b]``
    is the bit-set partner's closure for top slot b (None where no row
    completes there, or on a shard with bit b set)."""
    from .linearize import _complete_slot
    _, is_ok = _active(ev_type, valid, e)
    act = valid & is_ok
    empty = act & (nonempty == 0)
    if bool(empty.any()):
        Fbad[empty] = F[empty]
        F[empty] = 0
        bad[empty] = torch.clamp(bad[empty], max=int(idx))
        valid[empty] = False
    keep = act & ~empty
    q = ev_slot[:, e].to(torch.int64).clamp(0, W - 1)
    loc = keep & (q < WL)
    if bool(loc.any()):
        F[loc] = _complete_slot(F[loc], q[loc])
    for b in range(W - WL):
        at = keep & (q == WL + b)
        if not bool(at.any()):
            continue
        if (d >> b) & 1 or top[b] is None:
            F[at] = 0
        else:
            F[at] = top[b][at]


# ------------------------------------------------------------ the wrappers

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wgl_shard: {msg}")


def _args(F, ev_type, ev_slot, ev_slots, target, valid, *, e, WL, W, V,
          extra=()) -> ShardArgs:
    """Check one launch's tensors and fill its descriptor."""
    dev = F.device
    _check(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _check(1 <= WL <= MAX_W_LOCAL, f"WL={WL} outside 1..{MAX_W_LOCAL}")
    _check(WL <= W <= WL + MAX_TOP, f"W={W} outside {WL}..{WL + MAX_TOP}")
    _check(1 <= V <= MAX_STATES, f"V={V} outside 1..{MAX_STATES}")
    rows, NW, M = F.shape[0], n_state_words(V), 1 << WL
    named = {"F": F, "ev_type": ev_type, "ev_slot": ev_slot,
             "ev_slots": ev_slots, "target": target, "valid": valid,
             **dict(extra)}
    for name, t in named.items():
        _check(t.device == dev, f"{name} on {t.device}, expected {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    for name in ("F",) + tuple(n for n, _ in extra
                               if n in ("Fbad", "send")
                               or n.startswith("recv")):
        t = named[name]
        _check(t.dtype == torch.int32 and tuple(t.shape) == (rows, NW, M),
               f"{name} must be int32 [{rows}, {NW}, {M}]")
    N = ev_type.shape[1] if ev_type.dim() == 2 else 0
    _check(ev_type.dtype == torch.int8 and ev_slot.dtype == torch.int8
           and tuple(ev_type.shape) == (rows, N)
           and tuple(ev_slot.shape) == (rows, N),
           "ev_type and ev_slot must be int8 [rows, N]")
    _check(0 <= e < N, f"event {e} outside 0..{N - 1}")
    _check(ev_slots.dtype in (torch.int8, torch.int32)
           and ev_slots.dim() == 3
           and tuple(ev_slots.shape[:2]) == (rows, N)
           and ev_slots.shape[2] >= W, "ev_slots must be int8 or int32 "
           "[rows, N, >= W]")
    shared = target.dim() == 2
    _check(target.dtype == torch.int32
           and (shared or (target.dim() == 3 and target.shape[0] == rows))
           and target.shape[-1] == V and target.shape[-2] >= 1,
           "target must be int32 [K1, V] or [rows, K1, V]")
    _check(valid.dtype == torch.bool and tuple(valid.shape) == (rows,),
           "valid must be bool [rows]")
    K1 = int(target.shape[-2])
    a = ShardArgs()
    a.F = F.data_ptr()
    a.ev_type, a.ev_slot = ev_type.data_ptr(), ev_slot.data_ptr()
    a.ev_slots, a.target = ev_slots.data_ptr(), target.data_ptr()
    a.target_row_stride = 0 if shared else K1 * V
    a.valid = valid.data_ptr()
    a.slots_i32 = int(ev_slots.dtype == torch.int32)
    a.N, a.Wt, a.K1, a.V, a.NW = N, int(ev_slots.shape[2]), K1, V, NW
    a.W, a.WL, a.e, a.rows = W, WL, int(e), rows
    return a


def _launch(entry: str, a: ShardArgs, WL: int, dev, plan=None) -> None:
    """Launch one entry: shard_close by its ``plan``, the others a block
    a row of ``threads(WL)``. A refused launch raises."""
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan is None:
            err = getattr(lib, f"wgl_{entry}_launch")(
                ctypes.byref(a), threads(WL), stream)
        else:
            err = lib.wgl_shard_close_launch(
                ctypes.byref(a), CLOSE_TIER_CODES[plan["tier"]],
                plan["clog"], plan["threads"], plan["smem_bytes"], stream)
    if err != 0:
        raise CudaLaunchError(entry, err, lib.wgl_shard_error(err).decode())
    LAUNCHES[entry] += 1
    if plan is not None:
        CLOSE_TIERS[f"{plan['tier']}/{plan['ctas']}"] += 1


def _int32_rows(t, rows, name):
    _check(t.dtype == torch.int32 and tuple(t.shape) == (rows,),
           f"{name} must be int32 [{rows}]")


def shard_close(F: torch.Tensor, recv: Sequence[Optional[torch.Tensor]],
                ev_type, ev_slot, ev_slots, target, valid, *, e: int,
                d: int, WL: int, W: int, V: int, first_round: bool):
    """One shard's closure at event ``e``: ORs ``recv[b]`` (the images
    received for top bit b, or None) into ``F``, closes ``F`` in place
    under the live local slots to its fixpoint (on the first round of an
    event always, later only where something new arrived), and returns
    (changed, kept), int32 [rows]: whether the merge added a config, and
    whether a config of this shard survives the event's completion.
    Padding and invalid rows are left as they are (both flags 0).

    The kernel closes only from what can have changed: on the first
    round the fresh local slots (all at the row's first live event, else
    those whose kind changed since its previous live event and the slot
    that event's completion freed) and the masks the merge changed, on a
    later round those masks alone. So ``F`` must be as the walk
    (``parallel.frontier``) leaves it, closed under every other live
    local slot; on such a slice the result is the plain version's full
    closure, bit for bit."""
    _check(len(recv) <= MAX_TOP, f"{len(recv)} top bits > {MAX_TOP}")
    if F.device.type == "cpu":
        return plain_shard_close(F, recv, ev_type, ev_slot, ev_slots,
                                 target, valid, e=e, d=d, WL=WL, W=W, V=V,
                                 first_round=first_round)
    rows = F.shape[0]
    changed = torch.empty(rows, dtype=torch.int32, device=F.device)
    kept = torch.empty_like(changed)
    extra = [(f"recv{b}", r) for b, r in enumerate(recv) if r is not None]
    a = _args(F, ev_type, ev_slot, ev_slots, target, valid, e=e, WL=WL,
              W=W, V=V, extra=extra)
    for b, r in enumerate(recv):
        a.recv[b] = None if r is None else r.data_ptr()
    a.changed, a.kept = changed.data_ptr(), kept.data_ptr()
    a.d, a.first_round = int(d), int(bool(first_round))
    plan = close_plan(WL, n_state_words(V), rows, V)
    order = close_order(WL - plan["clog"], F.device)
    a.order = order.data_ptr()
    if not plan["slice_in_smem"]:
        flags = torch.empty((rows, 1 << WL), dtype=torch.uint8,
                            device=F.device)
        a.flags = flags.data_ptr()
    _launch("shard_close", a, WL, F.device, plan)
    return changed, kept


def shard_image(F: torch.Tensor, ev_type, ev_slot, ev_slots, target,
                valid, *, e: int, b: int, d: int, WL: int, W: int, V: int,
                send: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The image of shard ``d``'s slice under top slot ``b`` (bit b of d
    clear) at event ``e``: T_b of every local mask of the active rows, 0
    on the others, written into ``send`` (allocated when None) and
    returned, for the partner d | 2^b."""
    _check(0 <= b < W - WL and not (d >> b) & 1,
           f"top bit {b} of shard {d} (W={W}, WL={WL})")
    if F.device.type == "cpu":
        return plain_shard_image(F, ev_type, ev_slot, ev_slots, target,
                                 valid, e=e, b=b, d=d, WL=WL, W=W, V=V,
                                 send=send)
    if send is None:
        send = torch.empty_like(F)
    a = _args(F, ev_type, ev_slot, ev_slots, target, valid, e=e, WL=WL,
              W=W, V=V, extra=[("send", send)])
    a.send, a.d, a.b = send.data_ptr(), int(d), int(b)
    _launch("shard_image", a, WL, F.device)
    return send


def shard_commit(F: torch.Tensor, Fbad: torch.Tensor,
                 top: Sequence[Optional[torch.Tensor]], ev_type, ev_slot,
                 ev_slots, target, valid, bad, nonempty, *, e: int,
                 idx: int, d: int, WL: int, W: int, V: int) -> None:
    """Shard ``d``'s commit of event ``e`` (global index ``idx``), in
    place: ``nonempty`` (int32 [rows]) is the OR of every frontier
    shard's ``kept``; ``top[b]`` the bit-set partner's closure for a row
    completing on top slot b (None where unused)."""
    _check(len(top) <= MAX_TOP, f"{len(top)} top bits > {MAX_TOP}")
    if F.device.type == "cpu":
        plain_shard_commit(F, Fbad, top, ev_type, ev_slot, ev_slots, target,
                           valid, bad, nonempty, e=e, idx=idx, d=d, WL=WL,
                           W=W, V=V)
        return
    rows = F.shape[0]
    extra = [("Fbad", Fbad), ("bad", bad), ("nonempty", nonempty)]
    extra += [(f"recv{b}", t) for b, t in enumerate(top) if t is not None]
    a = _args(F, ev_type, ev_slot, ev_slots, target, valid, e=e, WL=WL,
              W=W, V=V, extra=extra)
    _int32_rows(bad, rows, "bad")
    _int32_rows(nonempty, rows, "nonempty")
    a.Fbad, a.bad, a.nonempty = (Fbad.data_ptr(), bad.data_ptr(),
                                 nonempty.data_ptr())
    for b, t in enumerate(top):
        a.recv[b] = None if t is None else t.data_ptr()
    a.d, a.idx = int(d), int(idx)
    _launch("shard_commit", a, WL, F.device)


# The plain versions by entry name, the ``ops=`` of the frontier walk
# (parallel.frontier) that runs them on tensors of any device.
PLAIN = {"shard_close": plain_shard_close, "shard_image": plain_shard_image,
         "shard_commit": plain_shard_commit}
