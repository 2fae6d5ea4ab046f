"""Batched O(n) invariant checkers on the card: the set, cockroach-set,
total-queue, unique-ids, counter, queue and FIFO-queue folds.

The port of the reference's ``ops/folds.py``, the batch twins of
``checkers.simple`` (reference semantics: jepsen/src/jepsen/
checker.clj:109-374). A batch of histories is lowered to int32 [B, N]
line tensors plus a shared value vocabulary (``_encode``), decided in one
launch, and decoded into EXACTLY the dicts the host checkers produce
(interval strings, Counter dicts, fractions):

  * set / cockroach set / total queue / unique ids are order-free
    multiset accounting: masked scatter-adds over the value domain into
    [B, V] count vectors and the family's combination of them
    (``fold_counts``);
  * counter, queue and FIFO queue are order-dependent: a scan over each
    row's lines carries the running bounds, the multiset or the ring of
    enqueued values (``counter_scan``, ``queue_scan``, ``fifo_scan``).

On a CUDA tensor each of the four is a hand-written kernel in
``csrc/folds.cu`` (``cuda_folds``), which launches or raises; on a CPU
tensor it is its plain PyTorch version here (``plain_*``), the
reference's arithmetic. Every batch function takes ``device`` (the card
unless the caller names another) and ``timings``, a dict that gets the
host clock's split: encode_s, upload_s, launch_s, copy_back_s (which
waits for the kernel) and decode_s.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..history.core import complete
from ..history.ops import Op
from ..models.core import FIFOQueue
from ..utils.core import fraction, integer_interval_set_str
from .device import resolve_device

# Line type codes (shared with history.columnar).
PAD = -1
T_INVOKE, T_OK, T_FAIL, T_INFO = 0, 1, 2, 3
_TCODE = {"invoke": T_INVOKE, "ok": T_OK, "fail": T_FAIL, "info": T_INFO}

NONE_SENTINEL = np.int32(-2**31)  # "no value" in int32 value columns

# f codes of each family.
F_ADD, F_READ = 0, 1
F_ENQ, F_DEQ = 0, 1
F_GEN = 0


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length()


@dataclass
class FoldBatch:
    """A batch of histories lowered for the fold kernels.

    typ/f/val/proc — int32 [B, N] (PAD-padded); ``val`` holds dense
    vocabulary ids (``vocab`` maps them back) unless the encoder was
    asked for raw integer values (counter arithmetic).
    """

    typ: np.ndarray
    f: np.ndarray
    val: np.ndarray
    proc: np.ndarray
    vocab: List

    @property
    def batch(self) -> int:
        return int(self.typ.shape[0])


def _encode(histories: Sequence[Sequence[Op]], f_codes: Dict[str, int], *,
            raw_values: bool = False) -> FoldBatch:
    """Lower Op lists to line tensors. Ops whose ``f`` is not in
    ``f_codes`` are skipped (nemesis ops, reads handled separately), and
    so are ops whose process is not an int. ``raw_values``: keep integer
    values verbatim (None -> sentinel) instead of interning them, in
    first-seen order, into the shared vocabulary (lists as tuples, None
    as a value)."""
    vocab_idx: dict = {}
    vocab_list: List = []
    rows = []
    for h in histories:
        lines = []
        for op in h:
            fc = f_codes.get(op.f)
            if fc is None or not isinstance(op.process, int):
                continue
            v = op.value
            if raw_values:
                vi = NONE_SENTINEL if v is None else int(v)
            else:
                if isinstance(v, list):
                    v = tuple(v)
                vi = vocab_idx.get(v)
                if vi is None:
                    vi = vocab_idx[v] = len(vocab_list)
                    vocab_list.append(v)
            lines.append((_TCODE[op.type], fc, vi, op.process))
        rows.append(lines)
    B = len(rows)
    N = max((len(r) for r in rows), default=0)
    typ = np.full((B, max(N, 1)), PAD, np.int32)
    f = np.zeros((B, max(N, 1)), np.int32)
    val = np.full((B, max(N, 1)), NONE_SENTINEL, np.int32)
    proc = np.zeros((B, max(N, 1)), np.int32)
    for r, lines in enumerate(rows):
        if lines:
            a = np.array(lines, dtype=np.int64)
            n = len(lines)
            typ[r, :n], f[r, :n], val[r, :n], proc[r, :n] = a.T
    return FoldBatch(typ=typ, f=f, val=val, proc=proc, vocab=vocab_list)


def _final_read_bitmap(histories, enc: FoldBatch):
    """Lower each row's last ok :read (a value *list*) to a uint8 [B, V]
    bitmap over the batch vocabulary. Never-attempted elements extend
    the vocabulary first so the bitmap allocates once at its final pow2
    width. Returns (V, final, has_read, finals)."""
    vocab_idx = {v: i for i, v in enumerate(enc.vocab)}
    finals: List[Optional[list]] = []
    for h in histories:
        fr = None
        for op in h:
            if op.is_ok and op.f == "read":
                fr = op.value
        finals.append(fr)
        for v in (fr or ()):
            v = tuple(v) if isinstance(v, list) else v
            if v not in vocab_idx:
                vocab_idx[v] = len(enc.vocab)
                enc.vocab.append(v)
    V = _pow2(max(len(enc.vocab), 1))
    final = np.zeros((enc.batch, V), np.uint8)
    has_read = np.zeros(enc.batch, bool)
    for r, fr in enumerate(finals):
        if fr is None:
            continue
        has_read[r] = True
        for v in fr:
            final[r, vocab_idx[tuple(v) if isinstance(v, list) else v]] = 1
    return V, final, has_read, finals


def _counter_overflow_risk(history: Sequence[Op]) -> bool:
    """True when a history's counter arithmetic cannot safely ride the
    int32 device path: a value outside int32 range (which also covers a
    collision with NONE_SENTINEL = -2^31), or running add sums that
    could exceed int32 bounds. Such a row goes to the arbitrary-precision
    host checker, not a downcast int64 column."""
    lim = 2**31 - 1
    total = 0
    for op in history:
        v = op.value
        if v is None or op.f not in ("add", "read"):
            continue
        if not isinstance(v, int) or not (-lim <= v <= lim):
            return True  # non-int (e.g. float) or out of int32 range
        if op.f == "add":
            total += abs(v)
            if total > lim:
                return True
    return False


# ------------------------------------------------ plain versions (CPU)

def _require_cpu(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name} runs on CPU tensors only, got "
                         f"{t.device}; the card runs the CUDA kernel")


def _plain_counts(typ, f, val, t_code, f_code, V):
    """int32 [B, V] counts of value occurrences on (type, f) lines: the
    reference's ``_counts`` (mask, clip to V - 1) over a batch."""
    mask = (typ == t_code) & (f == f_code) & (val >= 0)
    idx = val.clamp(0, V - 1).to(torch.int64)
    return torch.zeros((typ.shape[0], V), dtype=torch.int32).scatter_add_(
        1, idx, mask.to(torch.int32))


def plain_fold_counts(family: str, typ, f, val, final, V: int
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of the ``fold_counts`` kernel: a
    family's planes [B, L, V] (uint8 for set and crdb, int32 for tq and
    ids; the planes in the order of the reference kernel's outputs) and,
    for ids, ``attempted`` int32 [B]."""
    _require_cpu("plain_fold_counts", typ)

    def cnt(t, fc):
        return _plain_counts(typ, f, val, t, fc, V)

    attempted = None
    if family in ("set", "crdb"):
        fr = final.to(torch.bool)
        att, add = cnt(T_INVOKE, F_ADD) > 0, cnt(T_OK, F_ADD) > 0
        if family == "set":
            ok = fr & att
            planes = (att, ok, fr & ~att, add & ~fr, ok & ~add)
        else:
            failed = cnt(T_FAIL, F_ADD) > 0
            unsure = cnt(T_INFO, F_ADD) > 0
            planes = (att, failed, fr & add, fr & ~att, fr & failed,
                      add & ~fr, fr & unsure)
        out = torch.stack(planes, 1).to(torch.uint8)
    elif family == "tq":
        att, enq = cnt(T_INVOKE, F_ENQ), cnt(T_OK, F_ENQ)
        deq = cnt(T_OK, F_DEQ)
        zero = torch.zeros_like(att)
        ok = torch.minimum(deq, att)
        out = torch.stack((
            att, ok, torch.where(att == 0, deq, zero),
            torch.where(att > 0, torch.clamp_min(deq - att, 0), zero),
            torch.clamp_min(enq - deq, 0), torch.clamp_min(ok - enq, 0)), 1)
    elif family == "ids":
        out = cnt(T_OK, F_GEN)[:, None]
        attempted = ((typ == T_INVOKE) & (f == F_GEN)).sum(
            1, dtype=torch.int32)
    else:
        raise ValueError(f"unknown family {family!r}")
    return out, attempted


def plain_counter_scan(typ, f, val, proc, P: int
                       ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of ``counter_scan``: the reference's
    ``_counter_kernel`` scan, one step a line over the whole batch.
    Returns (lows, vals, ups int32 [B, N], emits uint8 [B, N])."""
    _require_cpu("plain_counter_scan", typ)
    B, N = typ.shape
    rows = torch.arange(B)
    i32 = torch.int32
    lower = torch.zeros(B, dtype=i32)
    upper = torch.zeros(B, dtype=i32)
    p_low = torch.zeros((B, P), dtype=i32)
    p_val = torch.full((B, P), int(NONE_SENTINEL), dtype=i32)
    p_act = torch.zeros((B, P), dtype=torch.bool)
    lows = torch.empty((B, N), dtype=i32)
    vals = torch.empty((B, N), dtype=i32)
    ups = torch.empty((B, N), dtype=i32)
    emits = torch.empty((B, N), dtype=torch.uint8)
    zero = torch.zeros(B, dtype=i32)
    for j in range(N):
        t, fc, v, p = typ[:, j], f[:, j], val[:, j], proc[:, j].long()
        is_inv_read = (t == T_INVOKE) & (fc == F_READ)
        is_ok_read = (t == T_OK) & (fc == F_READ)
        pl, pv, pa = p_low[rows, p], p_val[rows, p], p_act[rows, p]
        lows[:, j], vals[:, j], ups[:, j] = pl, pv, upper
        emits[:, j] = is_ok_read & pa
        p_low[rows, p] = torch.where(is_inv_read, lower, pl)
        p_val[rows, p] = torch.where(is_inv_read, v, pv)
        p_act[rows, p] = is_inv_read | (pa & ~is_ok_read)
        add = torch.where(v == int(NONE_SENTINEL), zero, v)
        upper = upper + torch.where((t == T_INVOKE) & (fc == F_ADD), add,
                                    zero)
        lower = lower + torch.where((t == T_OK) & (fc == F_ADD), add, zero)
    return lows, vals, ups, emits


def plain_queue_scan(typ, f, val, V: int) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of ``queue_scan``: the reference's
    ``_queue_kernel`` scan. Returns (valid uint8 [B], bad int32 [B],
    counts int32 [B, V])."""
    _require_cpu("plain_queue_scan", typ)
    B, N = typ.shape
    rows = torch.arange(B)
    counts = torch.zeros((B, V), dtype=torch.int32)
    valid = torch.ones(B, dtype=torch.bool)
    bad = torch.full((B,), -1, dtype=torch.int32)
    for j in range(N):
        t, fc = typ[:, j], f[:, j]
        v = val[:, j].clamp(0, V - 1).long()
        is_enq = (t == T_INVOKE) & (fc == F_ENQ)
        is_deq = (t == T_OK) & (fc == F_DEQ)
        counts[rows, v] += is_enq.to(torch.int32)
        missing = is_deq & (counts[rows, v] == 0)
        counts[rows, v] -= (is_deq & ~missing).to(torch.int32)
        bad = torch.where(missing & valid, torch.full_like(bad, j), bad)
        valid = valid & ~missing
    return valid.to(torch.uint8), bad, counts


def plain_fifo_scan(typ, f, val, Nmax: int) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of ``fifo_scan``: the reference's
    ``_fifo_kernel`` scan. Returns (valid uint8 [B], bad, bad_head, head,
    tail int32 [B])."""
    _require_cpu("plain_fifo_scan", typ)
    B, N = typ.shape
    rows = torch.arange(B)
    i32 = torch.int32
    buf = torch.zeros((B, Nmax), dtype=i32)
    head = torch.zeros(B, dtype=i32)
    tail = torch.zeros(B, dtype=i32)
    valid = torch.ones(B, dtype=torch.bool)
    bad = torch.full((B,), -1, dtype=i32)
    bad_head = torch.full((B,), -1, dtype=i32)
    for j in range(N):
        t, fc, v = typ[:, j], f[:, j], val[:, j]
        is_enq = (t == T_INVOKE) & (fc == F_ENQ)
        is_deq = (t == T_OK) & (fc == F_DEQ)
        ti = tail.clamp(0, Nmax - 1).long()
        buf[rows, ti] = torch.where(is_enq, v, buf[rows, ti])
        tail = tail + is_enq.to(i32)
        at_head = buf[rows, head.clamp(0, Nmax - 1).long()]
        wrong = is_deq & ((head >= tail) | (at_head != v))
        first = wrong & valid
        head = head + (is_deq & ~wrong).to(i32)
        valid = valid & ~wrong
        bad = torch.where(first, torch.full_like(bad, j), bad)
        bad_head = torch.where(first, head, bad_head)
    return valid.to(torch.uint8), bad, bad_head, head, tail


# ------------------------------------------------- kernel or plain

def fold_counts(family: str, typ, f, val, final, V: int):
    """``fold_counts`` on the line tensors' device: the CUDA kernel for a
    CUDA tensor (which launches or raises), the plain version for a CPU
    tensor."""
    if typ.device.type == "cuda":
        from . import cuda_folds
        return cuda_folds.fold_counts(family, typ, f, val, final, V)
    return plain_fold_counts(family, typ, f, val, final, V)


def counter_scan(typ, f, val, proc, P: int):
    """``counter_scan`` on the line tensors' device (as ``fold_counts``)."""
    if typ.device.type == "cuda":
        from . import cuda_folds
        return cuda_folds.counter_scan(typ, f, val, proc, P)
    return plain_counter_scan(typ, f, val, proc, P)


def queue_scan(typ, f, val, V: int):
    """``queue_scan`` on the line tensors' device (as ``fold_counts``)."""
    if typ.device.type == "cuda":
        from . import cuda_folds
        return cuda_folds.queue_scan(typ, f, val, V)
    return plain_queue_scan(typ, f, val, V)


def fifo_scan(typ, f, val, Nmax: int):
    """``fifo_scan`` on the line tensors' device (as ``fold_counts``)."""
    if typ.device.type == "cuda":
        from . import cuda_folds
        return cuda_folds.fifo_scan(typ, f, val, Nmax)
    return plain_fifo_scan(typ, f, val, Nmax)


# ------------------------------------------------------------ lowering

@dataclass
class Lowered:
    """A batch lowered for one kernel: ``entry`` (a ``cuda_folds``
    entry) and, for ``fold_counts``, its ``family``; the kernel's numpy
    inputs ``arrays`` (None for an input the family takes no part of);
    ``width`` (V, P or Nmax); the encoding and what the decoder needs
    besides (``ctx``)."""

    entry: str
    family: Optional[str]
    arrays: tuple
    width: int
    enc: Optional[FoldBatch]
    ctx: dict


def lower(family: str, histories: Sequence[Sequence[Op]]) -> Lowered:
    """Lower a batch for ``family`` (set, crdb, tq, ids, counter, queue
    or fifo): the host half of each batch function before its launch."""
    if family in ("set", "crdb"):
        if family == "crdb":
            histories = [complete(list(h)) for h in histories]
        enc = _encode(histories, {"add": F_ADD})
        V, final, has_read, finals = _final_read_bitmap(histories, enc)
        ctx = {"has_read": has_read}
        if family == "crdb":
            ctx["dups"] = [sorted(v for v, c in Counter(
                tuple(x) if isinstance(x, list) else x
                for x in (fr or ())).items() if c > 1) for fr in finals]
        return Lowered("fold_counts", family, (enc.typ, enc.f, enc.val,
                                               final), V, enc, ctx)
    if family in ("tq", "ids", "queue", "fifo"):
        if family == "tq":
            from ..checkers.simple import expand_queue_drain_ops
            histories = [expand_queue_drain_ops(list(h)) for h in histories]
        codes = ({"generate": F_GEN} if family == "ids"
                 else {"enqueue": F_ENQ, "dequeue": F_DEQ})
        enc = _encode(histories, codes)
        lines = (enc.typ, enc.f, enc.val)
        if family == "fifo":
            return Lowered("fifo_scan", None, lines,
                           _pow2(max(enc.typ.shape[1], 1)), enc, {})
        V = _pow2(max(len(enc.vocab), 1))
        if family == "queue":
            return Lowered("queue_scan", None, lines, V, enc, {})
        return Lowered("fold_counts", family, lines + (None,), V, enc, {})
    if family == "counter":
        histories = [complete(list(h)) for h in histories]
        host = [r for r, h in enumerate(histories)
                if _counter_overflow_risk(h)]
        rows = sorted(set(range(len(histories))) - set(host))
        ctx = {"histories": histories, "host": host, "rows": rows}
        if not rows:
            return Lowered("counter_scan", None, (), 1, None, ctx)
        enc = _encode([histories[r] for r in rows],
                      {"add": F_ADD, "read": F_READ}, raw_values=True)
        # densify processes per row, in first-seen order
        proc = np.zeros_like(enc.proc)
        for r in range(enc.batch):
            dense: dict = {}
            live = np.nonzero(enc.typ[r] != PAD)[0]
            proc[r, live] = [dense.setdefault(p, len(dense))
                             for p in enc.proc[r, live].tolist()]
        P = _pow2(max(int(proc.max(initial=0)) + 1, 1))
        return Lowered("counter_scan", None, (enc.typ, enc.f, enc.val, proc),
                       P, enc, ctx)
    raise ValueError(f"unknown fold family {family!r}")


_SCANS = {"counter_scan": counter_scan, "queue_scan": queue_scan,
          "fifo_scan": fifo_scan}


def run_kernel(lw: Lowered, tensors):
    """The lowered batch's kernel on its tensors' device (the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors)."""
    if lw.entry == "fold_counts":
        return fold_counts(lw.family, *tensors, lw.width)
    return _SCANS[lw.entry](*tensors, lw.width)


class _Clock:
    """The host clock's split of one batch into ``timings`` (nothing is
    kept when ``timings`` is None)."""

    def __init__(self, timings: Optional[dict]):
        self.timings = timings
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        now = time.perf_counter()
        if self.timings is not None:
            self.timings[key] = self.timings.get(key, 0.0) + now - self.t
        self.t = now


def _lower_and_run(family: str, histories, device, timings
                   ) -> Tuple[Lowered, List[Optional[np.ndarray]], _Clock]:
    """Lower a batch, upload its inputs, run its kernel on ``device`` and
    bring the outputs back as numpy arrays, each step on the clock."""
    dev = resolve_device(device)
    clock = _Clock(timings)
    lw = lower(family, histories)
    clock.lap("encode_s")
    if family == "counter":
        from ..checkers.simple import CounterChecker
        lw.ctx["out"] = {r: CounterChecker().check(None, None,
                                                   lw.ctx["histories"][r])
                         for r in lw.ctx["host"]}
        clock.lap("host_detour_s")
        if not lw.ctx["rows"]:
            return lw, [], clock
    ts = [None if a is None else
          torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in lw.arrays]
    clock.lap("upload_s")
    outs = run_kernel(lw, ts)
    clock.lap("launch_s")
    got = [None if o is None else o.cpu().numpy() for o in outs]
    clock.lap("copy_back_s")
    return lw, got, clock


def _finish(clock: _Clock, out: List[dict]) -> List[dict]:
    clock.lap("decode_s")
    return out


# ------------------------------------------------------------------ set

def check_sets_batch(histories: Sequence[Sequence[Op]], *, device=None,
                     timings: Optional[dict] = None) -> List[dict]:
    """Batch twin of checkers.simple.SetChecker — :add ops + a final
    :read of the whole set (checker.clj:131-178); one launch for the
    whole batch."""
    lw, (planes, _), clock = _lower_and_run("set", histories, device,
                                            timings)
    enc, has_read = lw.enc, lw.ctx["has_read"]
    att, ok, unexpected, lost, recovered = (
        planes[:, k].astype(bool) for k in range(5))

    def decode(r: int) -> dict:
        if not has_read[r]:
            return {"valid": "unknown", "error": "Set was never read"}
        els = lambda m: {enc.vocab[i] for i in np.nonzero(m[r])[0]}  # noqa
        n_att = int(att[r].sum())
        return {
            "valid": not lost[r].any() and not unexpected[r].any(),
            "ok": integer_interval_set_str(els(ok)),
            "lost": integer_interval_set_str(els(lost)),
            "unexpected": integer_interval_set_str(els(unexpected)),
            "recovered": integer_interval_set_str(els(recovered)),
            "ok-frac": fraction(int(ok[r].sum()), n_att),
            "unexpected-frac": fraction(int(unexpected[r].sum()), n_att),
            "lost-frac": fraction(int(lost[r].sum()), n_att),
            "recovered-frac": fraction(int(recovered[r].sum()), n_att),
        }

    return _finish(clock, [decode(r) for r in range(enc.batch)])


# ---------------------------------------------- cockroach-style sets

def check_crdb_sets_batch(histories: Sequence[Sequence[Op]], *,
                          device=None, timings: Optional[dict] = None
                          ) -> List[dict]:
    """The cockroach sets checker (cockroachdb/src/jepsen/cockroach/
    sets.clj:21-101), distinct from the knossos-style set fold: ok means
    read AND definitely added; ``revived`` elements were reported failed
    yet appear in the final read; ``recovered`` were indeterminate adds
    that appear; duplicates in the final read list are violations.
    Valid iff no lost, unexpected, duplicate, or revived elements."""
    lw, (planes, _), clock = _lower_and_run("crdb", histories, device,
                                            timings)
    enc, has_read, dups = lw.enc, lw.ctx["has_read"], lw.ctx["dups"]
    att, failed, ok, unexpected, revived, lost, recovered = (
        planes[:, k].astype(bool) for k in range(7))

    def decode(r: int) -> dict:
        if not has_read[r]:
            return {"valid": "unknown", "error": "Set was never read"}
        els = lambda m: {enc.vocab[i] for i in np.nonzero(m[r])[0]}  # noqa
        n_att = int(att[r].sum())
        n_fail = int(failed[r].sum())
        return {
            "valid": (not lost[r].any() and not unexpected[r].any()
                      and not dups[r] and not revived[r].any()),
            "duplicates": dups[r],
            "ok": integer_interval_set_str(els(ok)),
            "lost": integer_interval_set_str(els(lost)),
            "unexpected": integer_interval_set_str(els(unexpected)),
            "recovered": integer_interval_set_str(els(recovered)),
            "revived": integer_interval_set_str(els(revived)),
            "ok-frac": fraction(int(ok[r].sum()), n_att),
            "revived-frac": fraction(int(revived[r].sum()), n_fail),
            "unexpected-frac": fraction(int(unexpected[r].sum()), n_att),
            "lost-frac": fraction(int(lost[r].sum()), n_att),
            "recovered-frac": fraction(int(recovered[r].sum()), n_att),
        }

    return _finish(clock, [decode(r) for r in range(enc.batch)])


# ---------------------------------------------------------- total-queue

def check_total_queues_batch(histories: Sequence[Sequence[Op]], *,
                             device=None, timings: Optional[dict] = None
                             ) -> List[dict]:
    """Batch twin of checkers.simple.TotalQueueChecker — what goes in
    must come out (checker.clj:214-271), drain ops expanded."""
    lw, (planes, _), clock = _lower_and_run("tq", histories, device,
                                            timings)
    enc = lw.enc
    att, ok, unexpected, duplicated, lost, recovered = (
        planes[:, k] for k in range(6))

    def decode(r: int) -> dict:
        cnt = lambda m: {enc.vocab[i]: int(m[r, i])  # noqa: E731
                         for i in np.nonzero(m[r])[0]}
        n_att = int(att[r].sum())
        return {
            "valid": not lost[r].any() and not unexpected[r].any(),
            "lost": cnt(lost),
            "unexpected": cnt(unexpected),
            "duplicated": cnt(duplicated),
            "recovered": cnt(recovered),
            "ok-frac": fraction(int(ok[r].sum()), n_att),
            "unexpected-frac": fraction(int(unexpected[r].sum()), n_att),
            "duplicated-frac": fraction(int(duplicated[r].sum()), n_att),
            "lost-frac": fraction(int(lost[r].sum()), n_att),
            "recovered-frac": fraction(int(recovered[r].sum()), n_att),
        }

    return _finish(clock, [decode(r) for r in range(enc.batch)])


# ----------------------------------------------------------- unique-ids

def check_unique_ids_batch(histories: Sequence[Sequence[Op]], *,
                           device=None, timings: Optional[dict] = None
                           ) -> List[dict]:
    """Batch twin of checkers.simple.UniqueIdsChecker — acknowledged
    :generate ops return distinct ids (checker.clj:273-318)."""
    lw, (planes, attempted), clock = _lower_and_run("ids", histories,
                                                    device, timings)
    enc = lw.enc
    acks = planes[:, 0]

    def decode(r: int) -> dict:
        n_acks = int(acks[r].sum())
        dup_idx = np.nonzero(acks[r] > 1)[0]
        dups = {enc.vocab[i]: int(acks[r, i]) for i in dup_idx}
        seen = [enc.vocab[i] for i in np.nonzero(acks[r] > 0)[0]]
        rng = [min(seen), max(seen)] if seen else [None, None]
        top = dict(sorted(dups.items(), key=lambda kv: -kv[1])[:48])
        return {
            "valid": not dups,
            "attempted-count": int(attempted[r]),
            "acknowledged-count": n_acks,
            "duplicated-count": len(dups),
            "duplicated": top,
            "range": rng,
        }

    return _finish(clock, [decode(r) for r in range(enc.batch)])


# -------------------------------------------------------------- counter

def check_counters_batch(histories: Sequence[Sequence[Op]], *, device=None,
                         timings: Optional[dict] = None,
                         stats_out: Optional[dict] = None) -> List[dict]:
    """Batch twin of checkers.simple.CounterChecker — each ok read lies
    within [ok adds at invoke, attempted adds at completion]
    (checker.clj:321-374). Order-dependent: a scan carries the running
    bounds and per-process pending reads. Rows whose values or running
    sums could overflow int32 detour to the host checker (the
    reference's semantics); ``stats_out`` gets their count
    (``host_rows``) beside ``device_rows``."""
    lw, got, clock = _lower_and_run("counter", histories, device, timings)
    rows, by_host = lw.ctx["rows"], lw.ctx["out"]
    if stats_out is not None:
        stats_out.update(host_rows=len(by_host), device_rows=len(rows))
    out: List[Optional[dict]] = [by_host.get(r) for r in range(
        len(histories))]
    if not rows:
        return out
    lows, vals, ups, emits = got

    def decode(r: int) -> dict:
        em = np.nonzero(emits[r])[0]
        reads = [[int(lows[r, j]),
                  None if vals[r, j] == NONE_SENTINEL else int(vals[r, j]),
                  int(ups[r, j])] for j in em]
        errors = [rd for rd in reads
                  if rd[1] is None or not (rd[0] <= rd[1] <= rd[2])]
        return {"valid": not errors, "reads": reads, "errors": errors}

    for i, r in enumerate(rows):
        out[r] = decode(i)
    return _finish(clock, out)


# ------------------------------------------------- queue (unordered)

def check_queues_batch(histories: Sequence[Sequence[Op]], *, device=None,
                       timings: Optional[dict] = None) -> List[dict]:
    """Batch twin of checkers.simple.QueueChecker with the unordered
    queue model (checker.clj:109-129): assume every non-failing enqueue
    succeeded, only ok dequeues succeeded; a dequeue of an element not
    in the multiset is the violation."""
    lw, (valid, bad, counts), clock = _lower_and_run("queue", histories,
                                                     device, timings)
    enc = lw.enc

    def decode(r: int) -> dict:
        if valid[r]:
            final = {enc.vocab[i]: int(counts[r, i])
                     for i in np.nonzero(counts[r])[0]}
            return {"valid": True, "final-queue": final}
        j = int(bad[r])
        v = enc.vocab[enc.val[r, j]] if enc.val[r, j] >= 0 else None
        return {"valid": False,
                "error": f"can't dequeue {v!r}"}

    return _finish(clock, [decode(r) for r in range(enc.batch)])


# ------------------------------------------------------ queue (FIFO)

def check_fifo_queues_batch(histories: Sequence[Sequence[Op]], *,
                            device=None, timings: Optional[dict] = None
                            ) -> List[dict]:
    """Strict-order queue fold (the FIFOQueue model's semantics,
    model.clj:87-105, folded like checker.clj:109-129): assume every
    non-failing enqueue succeeded in invocation order; each ok dequeue
    must return the element at the head. The scan carries a ring of
    enqueued values per history."""
    lw, (valid, bad, bad_head, head, tail), clock = _lower_and_run(
        "fifo", histories, device, timings)
    enc = lw.enc

    def _value(vi: int):
        # Sequence payloads round-trip the codec as lists; decode the
        # interned tuple form back so parity with the host holds.
        v = enc.vocab[vi]
        return list(v) if isinstance(v, tuple) else v

    def decode(r: int) -> dict:
        if valid[r]:
            # Remaining queue = enqueued values (invoke order) [head:tail].
            enq = [_value(vi) for t, fc, vi in
                   zip(enc.typ[r], enc.f[r], enc.val[r])
                   if t == T_INVOKE and fc == F_ENQ and vi >= 0]
            return {"valid": True,
                    "final-queue": FIFOQueue(
                        enq[int(head[r]):int(tail[r])])}
        j = int(bad[r])
        v = _value(enc.val[r, j]) if enc.val[r, j] >= 0 else None
        # Host-parity error text (models.core.FIFOQueue.step); empty
        # iff the head AT THE FAILURE had consumed every prior enqueue.
        n_enq_before = int(((enc.typ[r, :j] == T_INVOKE)
                            & (enc.f[r, :j] == F_ENQ)).sum())
        if int(bad_head[r]) >= n_enq_before:
            return {"valid": False,
                    "error": f"can't dequeue {v!r} from empty queue"}
        return {"valid": False, "error": f"can't dequeue {v!r}"}

    return _finish(clock, [decode(r) for r in range(enc.batch)])


# ----------------------------------------------- the Checker protocol

class BatchFoldChecker:
    """Checker-protocol adapter over a batch fold (single histories ride
    a batch of one; real scale comes from the *_batch functions /
    independent key batching), on ``device``."""

    def __init__(self, fold, device=None):
        self.fold = fold
        self.device = device

    def check(self, test, model, history, opts=None) -> dict:
        return self.fold([history], device=self.device)[0]


def set_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_sets_batch, device)


def crdb_set_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_crdb_sets_batch, device)


def total_queue_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_total_queues_batch, device)


def unique_ids_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_unique_ids_batch, device)


def counter_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_counters_batch, device)


def queue_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_queues_batch, device)


def fifo_queue_checker_cuda(device=None) -> BatchFoldChecker:
    return BatchFoldChecker(check_fifo_queues_batch, device)
