"""The port's native host engines (C++), bound with ctypes and the
CPython C API.

Three host hot paths run in C++ here, as in the reference package:

  * the columnar encode walk (``encode_walk``, ``wgl.cpp``
    ``jt_encode_walk``): the slot walk of ``ops.encode.encode_columnar``,
    rows spread over threads;
  * the Op-list ingest walk (``ingest().walk``, ``ingest.cpp``): the
    pairing walk of ``history.columnar.ops_to_columnar``;
  * the WGL search (``wgl_check_native``, ``check_batch_native``,
    ``wgl.cpp`` ``jt_wgl_check`` and ``jt_wgl_check_batch``): the exact
    configuration-set search of ``checkers.linearizable.wgl_check`` over
    flat event arrays, and its threaded batch entry.

They are host code: no device kernel is replaced by them. Each library
is compiled with ``g++`` at first use into ``build/jepsen_torch/`` at the
root of the checkout (``ops._build``), named by a hash of its source and
flags; nothing builds when this module is imported. A library that
cannot be built or loaded raises, with the compiler's output: callers
that want the Python and numpy walks (the oracles) ask for them with
``native=False``. The search's own routing stays: a history whose state
space explodes (``lower_history``) or whose search gives up (window past
56 slots, too many configurations) is decided by ``wgl_check``.
"""
from __future__ import annotations

import ctypes
import os
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..history.ops import Op, INVOKE, OK, INFO
from ..models.core import Model
from ..ops._build import GXX_FLAGS, build_library, load_extension
from ..ops.statespace import (StateSpaceExplosion, enumerate_statespace,
                              history_kinds, op_kind)

_DIR = Path(__file__).resolve().parent
WGL_SRC = _DIR / "wgl.cpp"
INGEST_SRC = _DIR / "ingest.cpp"

# The compiler; tests point it elsewhere to see a failed build raise.
CXX = "g++"

# Event codes shared with wgl.cpp.
EV_INVOKE, EV_OK, EV_INFO = 0, 1, 2

_lock = threading.Lock()
_lib = None
_ingest_mod = None

_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_SYMBOLS = {
    "jt_wgl_check": ([_i32p, _i32p, _i32p, _u8p, ctypes.c_int32, _i32p,
                      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                      ctypes.c_int64, _i32p], ctypes.c_int32),
    "jt_wgl_check_batch": ([_i32p, _i32p, _i32p, _u8p, _i64p, _i32p, _i64p,
                            _i32p, ctypes.c_int32, ctypes.c_int32,
                            ctypes.c_int64, ctypes.c_int32, _i32p], None),
    "jt_encode_walk": ([_i8p, _i16p, _i32p, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_int32, _i8p, ctypes.c_void_p,
                        ctypes.c_int32, _i32p, _i32p, _i32p, _u8p,
                        ctypes.c_int32], None),
}


def lib() -> ctypes.CDLL:
    """The WGL search and encode walk library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build_library(WGL_SRC, _SYMBOLS, compiler=CXX,
                                 flags=GXX_FLAGS, libs=("-lpthread",))
    return _lib


def ingest():
    """The ingest walk extension (``walk(histories, vocab, kinds)`` →
    seven flat line buffers), built at first use."""
    global _ingest_mod
    with _lock:
        if _ingest_mod is None:
            inc = sysconfig.get_paths()["include"]
            _ingest_mod = load_extension(
                "_jt_torch_ingest", INGEST_SRC, (*GXX_FLAGS, f"-I{inc}"),
                compiler=CXX)
    return _ingest_mod


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def default_threads(cap: int) -> int:
    return min(cap, os.cpu_count() or 1)


def encode_walk(typ: np.ndarray, proc: np.ndarray, kind: np.ndarray,
                E: int, S: int, K: int, *,
                n_threads: Optional[int] = None):
    """The columnar encode slot walk (the C twin of the numpy lockstep
    walk in ops.encode.encode_columnar; rows thread-parallel, from 64
    rows). Returns (ev_slot, ev_slots, ev_opidx, max_live, n_events,
    overflow) in the numpy walk's layouts and dtypes: ev_slot int8
    [B, E], ev_slots int8 (int32 when K >= 127) [B, E, S] filled with
    the sentinel K, ev_opidx int32 [B, E] with -1 pads, max_live and
    n_events (ok events + 1) int32 [B], overflow bool [B]."""
    if not 1 <= S <= 32:
        raise ValueError(f"S={S} outside 1..32 (the slot mask is 32 bits)")
    B, N = typ.shape
    if proc.shape != (B, N) or kind.shape != (B, N):
        raise ValueError("typ, proc and kind must share one [B, N] shape")
    if E < N // 2 + 1:
        raise ValueError(f"E={E} below the {N // 2 + 1} events N={N} "
                         "lines can give")
    # The ColumnarOps dtypes, checked rather than cast: a cast would
    # wrap a process id past int16 where the numpy walk indexes by it.
    for name, a, dt in (("type", typ, np.int8), ("process", proc, np.int16),
                        ("kind", kind, np.int32)):
        if a.dtype != dt:
            raise TypeError(f"{name} is {a.dtype}, the walk takes {dt}")
    typ, proc, kind = (np.ascontiguousarray(a) for a in (typ, proc, kind))
    P = int(proc.max(initial=0)) + 1
    slots_wide = K >= 127
    ev_slot = np.zeros((B, E), np.int8)
    ev_slots = np.full((B, E, S), K, np.int32 if slots_wide else np.int8)
    ev_opidx = np.full((B, E), -1, np.int32)
    max_live = np.zeros(B, np.int32)
    cnt = np.zeros(B, np.int32)
    overflow = np.zeros(B, np.uint8)
    lib().jt_encode_walk(
        _ptr(typ, ctypes.c_int8), _ptr(proc, ctypes.c_int16),
        _ptr(kind, ctypes.c_int32), B, N, E, S, K, P,
        _ptr(ev_slot, ctypes.c_int8),
        ev_slots.ctypes.data_as(ctypes.c_void_p), int(slots_wide),
        _ptr(ev_opidx, ctypes.c_int32), _ptr(max_live, ctypes.c_int32),
        _ptr(cnt, ctypes.c_int32), _ptr(overflow, ctypes.c_uint8),
        n_threads or default_threads(16))
    return ev_slot, ev_slots, ev_opidx, max_live, cnt + 1, \
        overflow.astype(bool)


class Lowered:
    """One prepared history as flat arrays plus its state space."""

    __slots__ = ("ev_type", "ev_proc", "ev_kind", "ev_noslot", "ev_opidx",
                 "space", "n", "max_proc")

    def __init__(self, ev_type, ev_proc, ev_kind, ev_noslot, ev_opidx,
                 space, max_proc):
        self.ev_type = ev_type
        self.ev_proc = ev_proc
        self.ev_kind = ev_kind
        self.ev_noslot = ev_noslot
        self.ev_opidx = ev_opidx
        self.space = space
        self.n = len(ev_type)
        self.max_proc = max_proc


def lower_history(model: Model, prepared: Sequence[Op], *,
                  max_states: int = 64,
                  space_cache: Optional[dict] = None) -> Lowered:
    """Prepared history → flat event arrays + transition table.

    Raises StateSpaceExplosion when the model's reachable space exceeds
    ``max_states`` (the caller then decides the history with
    ``wgl_check``, whose configuration states are model objects)."""
    kinds = history_kinds(list(prepared))
    key = (model, tuple(kinds))
    space = space_cache.get(key) if space_cache is not None else None
    if space is None:
        space = enumerate_statespace(model, kinds, max_states)
        if space_cache is not None:
            space_cache[key] = space
    identity = space.identity_kinds

    # Which invocations complete ok? (the identity drop rule needs it)
    open_inv: Dict[object, int] = {}
    oks = set()
    for pos, o in enumerate(prepared):
        if o.type == INVOKE:
            open_inv[o.process] = pos
        elif o.is_completion and o.process in open_inv:
            p = open_inv.pop(o.process)
            if o.type == OK:
                oks.add(p)

    procs: Dict[object, int] = {}
    ev_type = np.zeros(len(prepared), np.int32)
    ev_proc = np.zeros(len(prepared), np.int32)
    ev_kind = np.zeros(len(prepared), np.int32)
    ev_noslot = np.zeros(len(prepared), np.uint8)
    ev_opidx = np.zeros(len(prepared), np.int32)
    n = 0
    for pos, o in enumerate(prepared):
        if o.type == INVOKE:
            code = EV_INVOKE
        elif o.type == OK:
            code = EV_OK
        elif o.type == INFO:
            code = EV_INFO
        else:
            continue
        ev_type[n] = code
        ev_proc[n] = procs.setdefault(o.process, len(procs))
        if o.type == INVOKE:
            ki = space.kind_index[op_kind(o)]
            ev_kind[n] = ki
            ev_noslot[n] = 1 if (ki in identity and pos not in oks) else 0
        ev_opidx[n] = o.index if o.index is not None else pos
        n += 1
    return Lowered(ev_type[:n], ev_proc[:n], ev_kind[:n], ev_noslot[:n],
                   ev_opidx[:n], space, max(len(procs), 1))


def _result(verdict: int, bad: int, low: Lowered, prepared) -> dict:
    if verdict == 1:
        return {"valid": True}
    op_index = int(low.ev_opidx[bad])
    op = next((o for o in prepared if o.index == op_index), None)
    return {"valid": False,
            "op": op.to_dict() if op is not None else {"index": op_index}}


def _prepare(history) -> List[Op]:
    from ..checkers.linearizable import prepare_history
    from ..history.core import index as index_history
    h = list(history)
    if any(op.index is None for op in h):
        index_history(h)
    return prepare_history(h)


def wgl_check_native(model: Model, history: Sequence[Op], *,
                     max_configs: int = 2_000_000,
                     max_states: int = 64,
                     space_cache: Optional[dict] = None) -> dict:
    """Exact linearizability decision in C++ (the twin of
    checkers.linearizable.wgl_check: the same verdict and bad op; the
    dict carries no configuration sample). A state space past
    ``max_states``, a window past 56 slots or more than ``max_configs``
    configurations go to ``wgl_check``."""
    from ..checkers.linearizable import wgl_check
    prepared = _prepare(history)
    try:
        low = lower_history(model, prepared, max_states=max_states,
                            space_cache=space_cache)
    except StateSpaceExplosion:
        return wgl_check(model, list(history), max_configs=max_configs)
    out = np.zeros(2, np.int32)
    target = np.ascontiguousarray(low.space.target, np.int32)
    if target.size == 0:
        target = np.zeros((1, 1), np.int32)
    verdict = lib().jt_wgl_check(
        _ptr(low.ev_type, ctypes.c_int32), _ptr(low.ev_proc, ctypes.c_int32),
        _ptr(low.ev_kind, ctypes.c_int32),
        _ptr(low.ev_noslot, ctypes.c_uint8), low.n,
        _ptr(target, ctypes.c_int32), low.space.n_kinds,
        max(low.space.n_states, 1), low.max_proc, max_configs,
        _ptr(out, ctypes.c_int32))
    if verdict == -1:
        return wgl_check(model, list(history), max_configs=max_configs)
    return _result(verdict, int(out[1]), low, prepared)


def check_batch_native(model: Model, histories: Sequence[Sequence[Op]], *,
                       max_configs: int = 2_000_000, max_states: int = 64,
                       n_threads: Optional[int] = None) -> List[dict]:
    """``wgl_check_native`` over a batch, the rows spread over
    ``n_threads`` (default min(32, cores)); the same routing to
    ``wgl_check``."""
    from ..checkers.linearizable import wgl_check

    n_threads = n_threads or default_threads(32)
    cache: dict = {}
    lows: List[Optional[Lowered]] = []
    prepareds = []
    for h in histories:
        prepared = _prepare(h)
        prepareds.append(prepared)
        try:
            lows.append(lower_history(model, prepared,
                                      max_states=max_states,
                                      space_cache=cache))
        except StateSpaceExplosion:
            lows.append(None)

    rows = [i for i, lo in enumerate(lows) if lo is not None]
    results: List[Optional[dict]] = [None] * len(histories)
    if rows:
        ev_type = np.concatenate([lows[i].ev_type for i in rows])
        ev_proc = np.concatenate([lows[i].ev_proc for i in rows])
        ev_kind = np.concatenate([lows[i].ev_kind for i in rows])
        ev_noslot = np.concatenate([lows[i].ev_noslot for i in rows])
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([lows[i].n for i in rows], out=offsets[1:])

        # One table per distinct state space, shared by its rows.
        tables, toffsets, dims = [], np.zeros(len(rows), np.int64), []
        pos = 0
        seen: Dict[int, int] = {}
        for j, i in enumerate(rows):
            sp = lows[i].space
            if id(sp) not in seen:
                seen[id(sp)] = pos
                t = np.ascontiguousarray(sp.target, np.int32).ravel()
                if t.size == 0:
                    t = np.zeros(1, np.int32)
                tables.append(t)
                pos += t.size
            toffsets[j] = seen[id(sp)]
            dims += [sp.n_kinds, max(sp.n_states, 1)]
        targets = np.concatenate(tables)
        dims = np.asarray(dims, np.int32)
        max_proc = max(lows[i].max_proc for i in rows)
        out = np.zeros((len(rows), 2), np.int32)

        lib().jt_wgl_check_batch(
            _ptr(ev_type, ctypes.c_int32), _ptr(ev_proc, ctypes.c_int32),
            _ptr(ev_kind, ctypes.c_int32), _ptr(ev_noslot, ctypes.c_uint8),
            _ptr(offsets, ctypes.c_int64), _ptr(targets, ctypes.c_int32),
            _ptr(toffsets, ctypes.c_int64), _ptr(dims, ctypes.c_int32),
            len(rows), max_proc, max_configs, n_threads,
            _ptr(out, ctypes.c_int32))

        for j, i in enumerate(rows):
            v, bad = int(out[j, 0]), int(out[j, 1])
            results[i] = (wgl_check(model, list(histories[i]),
                                    max_configs=max_configs) if v == -1
                          else _result(v, bad, lows[i], prepareds[i]))
    for i, lo in enumerate(lows):
        if lo is None:
            results[i] = wgl_check(model, list(histories[i]),
                                   max_configs=max_configs)
    return results
