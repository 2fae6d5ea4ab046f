"""The parallel forms of the fold scans K7b (``counter_scan``), K7c
(``queue_scan``) and K7d (``fifo_scan``), as
``jepsen_torch/ops/csrc/folds.cu`` computes them, held bit for bit to
the plain versions (``plain_counter_scan``, ``plain_queue_scan``,
``plain_fifo_scan``) and to the reference's ``_counter_kernel``,
``_queue_kernel`` and ``_fifo_kernel`` (run by jax on the CPU).

The CUDA kernels cannot run here, so each is modelled in numpy step for
step, following the kernel's own structure:

* the counter: every warp walks its segment of a row in tiles of 32
  lines (the nearest earlier read of a lane's process found from a
  ``__match_any_sync`` mask and two ballots, the sums by an inclusive
  warp scan, the per-process carry updated by the last lane of each
  process), first to summarise the segment (two sums, and per process
  a state word, the low bound and the value of its last invoke-read),
  then each block's warps' summaries folded into the block's; the fill
  folds the row's earlier blocks and the block's earlier warps into the
  warp's incoming carry and walks again, writing every line;
* the unordered queue: a block a slice of the row's values, each warp
  walking a chunk of the row's lines in tiles of 32 and keeping each
  value's (sum, lowest prefix): a line at a time where the tile's
  values are distinct (lane tags tell), else by a ``__match_any_sync``
  group a value, its inclusive prefixes from popcounts, its lowest from
  the group's highest lane's walk over it, folded in by that lane; the
  block folds the chunks in order into the counts and finds w*, the
  first chunk in which some value's prefix reaches -1; the other seven
  warps summarise sub-chunks of chunk w*, their fold from its incoming
  prefixes finds h*, and that warp walks its sub-chunk again for the
  line; the row's bad line is the minimum over its slices;
* the FIFO: each warp counts its segment's enqueues and ok dequeues,
  the compaction gives every enqueue its rank (the value list E) and
  every ok dequeue its line, value and enqueue count, and the walk
  takes the dequeue list in tiles, in alternating success and failure
  runs, each run ended by a block-wide minimum.

The plans (segment length, warps a block; the queue's slices and
chunks) are ``cuda_folds.scan_plan``'s and ``cuda_folds.queue_plan``'s.
Tolerance: none.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jepsen_tpu.ops import folds as R

from jepsen_torch.ops import cuda_folds
from jepsen_torch.ops import folds as F

# One intra-op thread: the plain scans run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

NONE = int(R.NONE_SENTINEL)
M32 = (1 << 32) - 1
LANES = np.arange(32)
BELOW = LANES[None, :] < LANES[:, None]      # [lane, k]: k is below lane
ABOVE = LANES[None, :] > LANES[:, None]


def s32(x):
    """uint32 bit patterns (held in int64) as int32 values."""
    x = np.asarray(x, np.int64) & M32
    return np.where(x >= 1 << 31, x - (1 << 32), x)


# ------------------------------------------------------ counter model

class Summary:
    """A segment's (or a block's) summary: the sums of invoke-add and
    ok-add values (uint32), and per process a state word (4: an
    invoke-read occurred, whose low bound and value are ``low`` and
    ``val``; 2: a read occurred, the last one an invoke-read iff bit 1)
    with ``low`` and ``val``."""

    def __init__(self, P):
        self.up = self.lo = 0
        self.st = np.zeros(P, np.int64)
        self.low = np.zeros(P, np.int64)
        self.val = np.full(P, NONE, np.int64)


def counter_walk(row, start, end, P, carry, lower, upper, out=None):
    """One warp's walk over lines [start, end) of a row, 32 a tile
    (``counter_walk`` in folds.cu). ``carry`` is a Summary whose state,
    low and val the walk updates; ``out`` (lows, vals, ups, emits of the
    row) is written when given. Returns the final (lower, upper)."""
    typ, f, val, proc = row
    for j0 in range(start, end, 32):
        j = j0 + LANES
        inn = j < end
        jj = np.where(inn, j, start)
        t = np.where(inn, typ[jj], -1)
        fc = np.where(inn, f[jj], 0)
        v = np.where(inn, val[jj], 0).astype(np.int64)
        p = np.where(inn, np.clip(proc[jj], 0, P - 1), 0)
        inv = (t == 0) & (fc == 1)
        okr = (t == 1) & (fc == 1)
        read = inv | okr
        add = np.where(v == NONE, 0, v) & M32
        a_up = np.where((t == 0) & (fc == 0), add, 0)
        a_lo = np.where((t == 1) & (fc == 0), add, 0)
        x_up = np.cumsum(a_up) & M32
        x_lo = np.cumsum(a_lo) & M32
        my_low = (lower + x_lo - a_lo) & M32
        same = p[:, None] == p[None, :]                 # __match_any_sync
        ri = same & inv[None, :] & BELOW                # ballots, masked
        rr = same & read[None, :] & BELOW
        ki = np.where(ri, LANES, -1).max(1)             # 31 - __clz
        kr = np.where(rr, LANES, -1).max(1)
        old_st = carry.st[p]
        if out is not None:
            lows, vals, ups, emits = out
            act = np.where(kr >= 0, inv[kr], (old_st & 1) != 0)
            w = j[inn]
            lows[w] = np.where(ki >= 0, s32(my_low[ki]),
                               s32(carry.low[p]))[inn]
            vals[w] = np.where(ki >= 0, v[ki], carry.val[p])[inn]
            ups[w] = s32(upper + x_up - a_up)[inn]
            emits[w] = (okr & act)[inn]
        last_inv = inv & ~(same & inv[None, :] & ABOVE).any(1)
        last_read = read & ~(same & read[None, :] & ABOVE).any(1)
        any_inv = (same & inv[None, :]).any(1)
        carry.low[p[last_inv]] = my_low[last_inv]
        carry.val[p[last_inv]] = v[last_inv]
        carry.st[p[last_read]] = ((old_st & 4) | np.where(any_inv, 4, 0) | 2
                                  | inv)[last_read]
        upper = (upper + int(x_up[-1])) & M32
        lower = (lower + int(x_lo[-1])) & M32
    return lower, upper


def fold_summaries(summaries, P):
    """A block's summary from its warps' in order (the summary kernel's
    epilogue): the low bounds relative to the block's first line."""
    acc = Summary(P)
    for x in summaries:
        has = (x.st & 4) != 0
        acc.low = np.where(has, (acc.lo + x.low) & M32, acc.low)
        acc.val = np.where(has, x.val, acc.val)
        acc.st = np.where((x.st & 2) != 0, (acc.st & 4) | (x.st & 3),
                          acc.st) | (x.st & 4)
        acc.lo = (acc.lo + x.lo) & M32
        acc.up = (acc.up + x.up) & M32
    return acc


def incoming(summaries, P):
    """The fill's fold of the summaries before a warp's segment into its
    carry (the reference's carry at the segment's first line) and its
    sums."""
    c = Summary(P)
    lower = upper = 0
    for x in summaries:
        has = (x.st & 4) != 0
        c.low = np.where(has, (lower + x.low) & M32, c.low)
        c.val = np.where(has, x.val, c.val)
        c.st = np.where((x.st & 2) != 0, x.st & 1, c.st)
        lower = (lower + x.lo) & M32
        upper = (upper + x.up) & M32
    return c, lower, upper


def counter_model(typ, f, val, proc, P, segment=None, stats=None):
    """counter_scan as the kernels compute it: summaries, combine, fill."""
    B, N = typ.shape
    plan = cuda_folds.scan_plan(N, B, segment)
    seg, S, W = plan["segment"], plan["segments"], plan["warps"]
    lows = np.empty((B, N), np.int64)
    vals = np.empty((B, N), np.int64)
    ups = np.empty((B, N), np.int64)
    emits = np.empty((B, N), bool)
    for r in range(B):
        row = (typ[r], f[r], val[r], proc[r])
        span = [(min(s * seg, N), min(s * seg + seg, N)) for s in range(S)]
        ws = []
        for a, b in span:                               # the summary pass
            x = Summary(P)
            x.lo, x.up = counter_walk(row, a, b, P, x, 0, 0)
            ws.append(x)
        bs = [fold_summaries(ws[k:k + W], P) for k in range(0, S, W)]
        for s, (a, b) in enumerate(span):               # the fill pass
            blk, w = divmod(s, W)
            c, lower, upper = incoming(bs[:blk] + ws[blk * W:s], P)
            counter_walk(row, a, b, P, c, lower, upper,
                         (lows[r], vals[r], ups[r], emits[r]))
    if stats is not None:
        stats.update(plan)
    return lows, vals, ups, emits


# --------------------------------------------------------- FIFO model

def fifo_model(typ, f, val, Nmax, segment=None, tile=cuda_folds.
               FIFO_WALK_TILE, stats=None):
    """fifo_scan as the kernels compute it: per-segment counts, the
    compaction, then the run-length walk of the dequeue list."""
    B, N = typ.shape
    plan = cuda_folds.scan_plan(N, B, segment)
    seg, S = plan["segment"], plan["segments"]
    out = {k: np.empty(B, np.int64) for k in ("valid", "bad", "bad_head",
                                               "head", "tail")}
    rounds = []
    for r in range(B):
        t, fc, v = typ[r], f[r], val[r]
        enq = (t == 0) & (fc == 0)
        deq = (t == 1) & (fc == 1)
        span = [(min(s * seg, N), min(s * seg + seg, N)) for s in range(S)]
        counts = [(int(enq[a:b].sum()), int(deq[a:b].sum()))
                  for a, b in span]
        E = np.full(N, 12345, np.int64)        # never read before written
        Dj, Dv, Dt = (np.full(N, -9, np.int64) for _ in range(3))
        for s, (a, b) in enumerate(span):      # the compaction
            be = sum(c[0] for c in counts[:s])
            bd = sum(c[1] for c in counts[:s])
            for j0 in range(a, b, 32):
                j = j0 + LANES
                inn = j < b
                jj = np.where(inn, j, a)
                em, dm = enq[jj] & inn, deq[jj] & inn          # ballots
                re = be + np.cumsum(em) - em                  # popc below
                rd = bd + np.cumsum(dm) - dm
                E[re[em]] = v[jj][em]
                Dj[rd[dm]], Dv[rd[dm]], Dt[rd[dm]] = j[dm], v[jj][dm], re[dm]
                be += int(em.sum())
                bd += int(dm.sum())
        tail, m = be, bd

        def slot(hh, tl):
            return np.where(hh < Nmax - 1, E[np.minimum(hh, N - 1)],
                            E[np.maximum(tl - 1, 0)])

        h, bad_e, bad_head, succ, n_rounds = 0, -1, -1, True, 0
        for i0 in range(0, m, tile):            # the walk
            n = min(tile, m - i0)
            pos = 0
            while pos < n:
                n_rounds += 1
                e = np.arange(pos, n)
                hh = h + (e - pos) if succ else np.full(e.shape, h)
                tl, dv = Dt[i0 + e], Dv[i0 + e]
                ok = (hh < tl) & (slot(hh, tl) == dv)
                hit = e[ok != succ]                 # block-wide minimum
                first = int(hit[0]) if hit.size else n
                if succ:
                    h += first - pos
                    if first < n:
                        if bad_e < 0:
                            bad_e, bad_head = i0 + first, h
                        pos, succ = first + 1, False
                    else:
                        pos = n
                elif first < n:
                    pos, succ = first, True
                else:
                    pos = n
        rounds.append(n_rounds)
        out["valid"][r] = bad_e < 0
        out["bad"][r] = -1 if bad_e < 0 else Dj[bad_e]
        out["bad_head"][r] = bad_head
        out["head"][r] = h
        out["tail"][r] = tail
    if stats is not None:
        stats.update(plan, rounds=rounds)
    return tuple(out[k] for k in ("valid", "bad", "bad_head", "head",
                                  "tail"))


# --------------------------------------------------------- queue model

INT_MAX = 2**31 - 1
QUEUE_THREADS = 32 * cuda_folds.QUEUE_WARPS


def queue_tile(t, fc, v, j0, end, V, lo, vs):
    """One 32-line tile of a warp's walk (``queue_tile`` in folds.cu):
    per lane whether its line is a dequeue and an active line of the
    slice, its value's offset in the slice, its value group (the
    ``__match_any_sync`` mask, as a [lane, k] matrix), the group's
    inclusive prefix at the lane and whether the lane leads the group."""
    j = j0 + LANES
    inn = j < end
    jj = np.where(inn, j, 0)
    tt = np.where(inn, t[jj], -1)
    ff = np.where(inn, fc[jj], 0)
    vv = np.where(inn, v[jj], 0)
    enq = inn & (tt == 0) & (ff == 0)
    deq = inn & (tt == 1) & (ff == 1)
    c = np.clip(vv, 0, V - 1) - lo
    mine = (enq | deq) & (c >= 0) & (c < vs)
    key = np.where(mine, c, -1 - LANES)
    peers = key[None, :] == key[:, None]
    upto = peers & ~ABOVE
    pre = 2 * (upto & (mine & enq)[None, :]).sum(1) - upto.sum(1)
    leader = mine & ~(peers & ABOVE).any(1)
    return deq, mine, c, peers, pre, leader


def twins(mine, c):
    """Whether two of a tile's lines of the slice share a value (the
    kernel's lane tags: each such lane writes its lane into its value's
    tag, and one that reads back another's has a twin)."""
    tag = {}
    for lane in np.nonzero(mine)[0]:
        tag[c[lane]] = lane                  # the last writer's stays
    return any(tag[c[lane]] != lane for lane in np.nonzero(mine)[0])


def queue_summarise(t, fc, v, start, end, V, lo, vs, pair, stats_twins):
    """One warp's walk over lines [start, end) of a row into its (sum,
    low) pairs: a line at a time where the tile's values are distinct,
    by value groups (each group's inclusive prefixes, its lowest folded
    in by its highest lane) where it has twins."""
    for j0 in range(start, end, 32):
        deq, mine, c, peers, pre, leader = queue_tile(
            t, fc, v, j0, end, V, lo, vs)
        if not mine.any():
            continue
        if not twins(mine, c):
            step = np.where(deq, -1, 1)
            for lane in np.nonzero(mine)[0]:
                x, y = pair[c[lane]]
                pair[c[lane]] = (x + step[lane], min(y, x + step[lane]))
            continue
        stats_twins[0] += 1
        g_low = np.where(peers, pre[None, :], INT_MAX).min(1)
        for lane in np.nonzero(leader)[0]:
            x, y = pair[c[lane]]
            pair[c[lane]] = (x + pre[lane], min(y, x + g_low[lane]))


def queue_fold(pairs, vs, incoming=None):
    """The block's fold of consecutive parts' pairs [parts, Vs, 2] from
    the incoming prefixes (0 when None), as its QUEUE_THREADS threads
    take it: thread i folds values i, i + QUEUE_THREADS, ... in turn,
    each over the parts in order, and keeps one least part, over its
    values, at which a value's prefix reaches -1. Each part's sum
    becomes its incoming prefix. Returns the least of the threads'
    parts (``parts`` for none) and each value's count (its sum less its
    lowest prefix)."""
    parts = len(pairs)
    total = (np.zeros(vs, np.int64) if incoming is None
             else incoming[:vs].copy())
    low = np.zeros(vs, np.int64)
    first_k = np.full(QUEUE_THREADS, parts)
    for c0 in range(0, vs, QUEUE_THREADS):
        c = np.arange(c0, min(c0 + QUEUE_THREADS, vs))
        th = c - c0
        for k in range(parts):
            reach = (total[c] + pairs[k][c, 1] <= -1) & (k < first_k[th])
            first_k[th[reach]] = k
            low[c] = np.minimum(low[c], total[c] + pairs[k][c, 1])
            pairs[k][c, 0], total[c] = total[c], total[c] + pairs[k][c, 0]
    return int(first_k.min()), total - low


def queue_model(typ, f, val, V, slice_width=None, stats=None):
    """queue_scan as the kernels compute it: per (row, slice) each warp's
    chunk walk into (sum, lowest prefix) pairs, the fold over chunks
    (the counts, and w*, the first chunk that reaches -1); then the
    other seven warps summarise sub-chunks of chunk w*, the fold of those
    from its incoming prefixes gives h*, and that warp walks its
    sub-chunk again for the line; each row's minimum over its slices.
    The slices are the plan's, or ``slice_width`` values each, narrower
    than the kernel takes, so that a short test spreads a row's values
    over many slices."""
    B, N = typ.shape
    plan = cuda_folds.queue_plan(N, V, B)
    if slice_width:
        plan.update(slice_width=slice_width, slices=-(-V // slice_width))
    S, Vs, W, chunk = (plan[k] for k in ("slices", "slice_width", "warps",
                                         "chunk"))
    helpers = W - 1
    valid = np.empty(B, np.int64)
    bad = np.empty(B, np.int64)
    counts = np.empty((B, V), np.int64)
    rewalks = []
    stats_twins = [0]
    for r in range(B):
        t, fc, v = (a[r].astype(np.int64) for a in (typ, f, val))
        first_bad = []
        for s in range(S):
            lo = s * Vs
            vs = min(Vs, V - lo)
            pair = np.zeros((W, Vs, 2), np.int64)      # (sum, low)
            for w in range(W):
                start = min(w * chunk, N)
                queue_summarise(t, fc, v, start, min(start + chunk, N), V,
                                lo, vs, pair[w], stats_twins)
            ws, counts[r, lo:lo + vs] = queue_fold(list(pair), vs)
            if ws == W:
                first_bad.append(INT_MAX)
                continue
            c0 = min(ws * chunk, N)
            c1 = min(c0 + chunk, N)
            sub = -(-max(-(-(c1 - c0) // helpers), 0) // 32) * 32
            spans = [(min(c0 + h * sub, c1), min(c0 + h * sub + sub, c1))
                     for h in range(helpers)]
            hpair = [np.zeros((Vs, 2), np.int64) for _ in range(helpers)]
            for h, (a, b) in enumerate(spans):
                queue_summarise(t, fc, v, a, b, V, lo, vs, hpair[h],
                                stats_twins)
            hs, _ = queue_fold(hpair, vs, incoming=pair[ws][:, 0])
            assert hs < helpers, "a chunk that reaches -1 has a part"
            rewalks.append((r, s, ws, hs))
            run = hpair[hs][:, 0]                # the incoming prefixes
            found = INT_MAX
            a, b = spans[hs]
            for j0 in range(a, b, 32):
                deq, mine, c, peers, pre, leader = queue_tile(
                    t, fc, v, j0, b, V, lo, vs)
                before = np.where(mine, run[np.where(mine, c, 0)], 0)
                hit = deq & mine & (before + pre == -1)
                if hit.any():
                    found = j0 + int(np.argmax(hit))
                    break
                run[c[leader]] = (before + pre)[leader]
            assert found != INT_MAX, "a part that reaches -1 has a line"
            first_bad.append(found)
        b = min(first_bad)
        valid[r] = b == INT_MAX
        bad[r] = -1 if b == INT_MAX else b
    if stats is not None:
        stats.update(plan, rewalks=rewalks, twin_tiles=stats_twins[0])
    return valid, bad, counts


# ------------------------------------------------------------- inputs

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def counter_lines(seed, B, N, P, procs_few=4):
    """Seeded counter lines: every (type, f) code, small raw values with
    negatives, NONE and values at INT32_MAX, PAD tails with garbage, and
    processes in [0, P) (half of them among the first few, so that reads
    pair up within and across tiles)."""
    rng = np.random.default_rng(seed)
    typ = rng.integers(0, 4, (B, N))
    f = rng.integers(0, 3, (B, N))
    val = rng.integers(-3, 40, (B, N))
    odd = rng.random((B, N))
    val[odd < 0.05] = NONE
    val[(odd >= 0.05) & (odd < 0.08)] = 2**31 - 1
    live = rng.integers(0, N + 1, B)
    live[0] = N
    pad = np.arange(N)[None, :] >= live[:, None]
    typ[pad] = -1
    clean = pad & (rng.random((B, N)) < 0.5)
    f[clean] = 0
    val[clean] = NONE
    few = rng.integers(0, min(P, procs_few), (B, N))
    proc = np.where(rng.random((B, N)) < 0.5, few,
                    rng.integers(0, P, (B, N)))
    return [np.ascontiguousarray(a, np.int32) for a in (typ, f, val, proc)]


def fifo_lines(seed, B, N, V, noise=0.1, dup_every=0):
    """Seeded FIFO lines: enqueues of running values (mod V, so values
    repeat) and ok dequeues that follow them, ``noise`` of the dequeues
    with a random value, a wrong dequeue inserted every ``dup_every``
    dequeues (a duplicate of the last one: a failure run of one, then
    success again), other (type, f) codes, NONE and negative values, and
    PAD tails."""
    rng = np.random.default_rng(seed)
    typ = rng.choice([0, 1, 0, 1, 2, 3], (B, N))
    f = rng.integers(0, 2, (B, N))
    val = np.zeros((B, N), np.int64)
    for r in range(B):
        pending, nxt, last, k = [], 0, -1, 0
        for j in range(N):
            if typ[r, j] == 0 and f[r, j] == 0:
                val[r, j] = nxt % V
                pending.append(nxt % V)
                nxt += 1
            elif typ[r, j] == 1 and f[r, j] == 1:
                k += 1
                if dup_every and k % dup_every == 0 and last is not None:
                    val[r, j] = last
                elif pending and rng.random() >= noise:
                    last = val[r, j] = pending.pop(0)
                else:
                    val[r, j] = rng.integers(-2, V + 2)
            else:
                val[r, j] = rng.integers(-2, V + 2)
    odd = rng.random((B, N))
    val[odd < 0.01] = NONE
    live = rng.integers(0, N + 1, B)
    live[0] = N
    pad = np.arange(N)[None, :] >= live[:, None]
    typ[pad] = -1
    val[pad & (rng.random((B, N)) < 0.5)] = NONE
    return [np.ascontiguousarray(a, np.int32) for a in (typ, f, val)]


def queue_lines(seed, B, N, V, hot=0.0, noise=0.02, early=0.0):
    """Seeded unordered-queue lines: enqueues of running values (mod V,
    so values repeat) and ok dequeues of a pending value (the oldest, or
    any), ``noise`` of the dequeues with a random value, ``hot`` of the
    values drawn as value 0, ``early`` of the dequeues of a value yet to
    be enqueued; other (type, f) codes, values past V - 1, negative and
    NONE values, and PAD tails with garbage."""
    rng = np.random.default_rng(seed)
    typ = rng.choice([0, 1, 0, 1, 2, 3], (B, N))
    f = rng.integers(0, 2, (B, N))
    val = np.zeros((B, N), np.int64)
    for r in range(B):
        pending, nxt = [], 0
        for j in range(N):
            hot_v = rng.random() < hot
            if typ[r, j] == 0 and f[r, j] == 0:
                val[r, j] = 0 if hot_v else nxt % V
                pending.append(int(val[r, j]))
                nxt += 1
            elif typ[r, j] == 1 and f[r, j] == 1:
                if rng.random() < early:
                    val[r, j] = (nxt + 1) % V
                elif pending and rng.random() >= noise:
                    val[r, j] = pending.pop(
                        0 if rng.random() < 0.5
                        else int(rng.integers(len(pending))))
                else:
                    val[r, j] = rng.integers(-2, V + 2)
            else:
                val[r, j] = rng.integers(-2, V + 2)
    odd = rng.random((B, N))
    val[odd < 0.01] = NONE
    live = rng.integers(0, N + 1, B)
    live[0] = N
    pad = np.arange(N)[None, :] >= live[:, None]
    typ[pad] = -1
    val[pad & (rng.random((B, N)) < 0.5)] = NONE
    return [np.ascontiguousarray(a, np.int32) for a in (typ, f, val)]


def queue_miss_row(N, V, bad_lines=(), misses=None, cycle=None):
    """One healthy unordered-queue row of N lines (enqueue, enqueue,
    dequeue, dequeue, ... of 0, 1, 2, ... mod ``cycle``, by default
    V - 1, V >= 2) with a dequeue of V - 1, a value never enqueued, at
    each line of ``bad_lines``, and of value v at each line j of
    ``misses`` {j: v}: each a missing dequeue where v is never
    enqueued."""
    typ = np.zeros(N, np.int64)
    f = np.zeros(N, np.int64)
    val = np.zeros(N, np.int64)
    at = {j: V - 1 for j in bad_lines} | dict(misses or {})
    cycle = cycle or V - 1
    pending, enq = [], 0
    for j in range(N):
        if j in at:
            typ[j], f[j], val[j] = 1, 1, at[j]
        elif j % 4 < 2 or not pending:
            val[j] = enq % cycle
            pending.append(val[j])
            enq += 1
        else:
            typ[j], f[j] = 1, 1
            val[j] = pending.pop(0)
    return typ, f, val


def fifo_fail_row(N, bad_lines=(), bad_deqs=()):
    """One healthy FIFO row of N lines (enqueue, enqueue, dequeue,
    dequeue, ... of 0, 1, 2, ...) with a wrong dequeue (a value never
    enqueued) put at each line of ``bad_lines`` and before each ok
    dequeue of rank ``bad_deqs``: each is a failure run of one, with
    success on either side."""
    typ = np.zeros(N, np.int64)
    f = np.zeros(N, np.int64)
    val = np.zeros(N, np.int64)
    at = set(bad_lines)
    ranks = set(bad_deqs)
    enq = deq = rank = 0
    for j in range(N):
        if j in at or rank in ranks:
            typ[j], f[j], val[j] = 1, 1, -1
            ranks.discard(rank)
            rank += 1
        elif j % 4 < 2 or deq >= enq:
            typ[j], f[j], val[j] = 0, 0, enq
            enq += 1
        else:
            typ[j], f[j], val[j] = 1, 1, deq
            deq += 1
            rank += 1
    return typ, f, val


def fifo_rows(rows):
    return [np.ascontiguousarray(np.stack(a), np.int32)
            for a in zip(*rows)]


# ---------------------------------------------------------- checks

def equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64))


def check_counter(lines, P, segment=None):
    """The model against the plain version and the reference's kernel;
    returns the plan the model ran."""
    stats = {}
    got = counter_model(*lines, P, segment, stats=stats)
    equal(got, F.plain_counter_scan(*map(t, lines), P))
    equal(got, R._counter_kernel()(*lines, P))
    return stats


def check_queue(lines, V, slice_width=None):
    stats = {}
    got = queue_model(*lines, V, slice_width, stats=stats)
    equal(got, F.plain_queue_scan(*map(t, lines), V))
    equal(got, R._queue_kernel(V)(*lines))
    return stats, got


def check_fifo(lines, Nmax, segment=None, tile=cuda_folds.FIFO_WALK_TILE):
    stats = {}
    got = fifo_model(*lines, Nmax, segment, tile, stats=stats)
    equal(got, F.plain_fifo_scan(*map(t, lines), Nmax))
    equal(got, R._fifo_kernel(Nmax)(*lines))
    return stats, got


# -------------------------------------------------------- the counter

@pytest.mark.parametrize("P", [1, 2, 5, 64, 65, 128])
@pytest.mark.parametrize("segment", [1, 7, 32, 33, None, 500])
def test_counter_model_matches_plain_and_reference(P, segment):
    """Segments of one line, of a few lines inside a tile, of exactly a
    tile and one past it, the plan's, and longer than the row; P at 1,
    both sides of the shared-memory carry and 128."""
    lines = counter_lines(1000 * P + (segment or 0), 9, 300, P)
    stats = check_counter(lines, P, segment)
    if segment is not None and segment < 300:
        assert stats["segments"] >= 300 // segment > 1


def test_counter_model_rows_over_many_blocks():
    """A row cut into more blocks than one (the fill folds the row's
    earlier blocks' summaries, then its block's earlier warps')."""
    lines = counter_lines(7, 3, 2000, 16)
    stats = check_counter(lines, 16, segment=40)
    assert stats["blocks_per_row"] == 7


def test_counter_model_sparse_reads_across_segments():
    """Few reads a process, so that an ok-read's invoke-read lies many
    segments back, and ok-reads with no earlier read of their process."""
    rng = np.random.default_rng(3)
    typ, f, val, proc = counter_lines(3, 4, 900, 8)
    reads = f == 1
    thin = reads & (rng.random(f.shape) < 0.9)
    f = np.where(thin, 0, f).astype(np.int32)
    check_counter([typ, f, val, proc], 8, segment=32)


def test_counter_model_wraps_like_int32():
    """Sums past INT32_MAX wrap in uint32 as the reference's int32 does,
    across segments and tiles."""
    N = 200
    typ = np.tile(np.array([0, 1, 0, 1], np.int32), (2, N // 4))
    f = np.tile(np.array([0, 0, 1, 1], np.int32), (2, N // 4))
    val = np.full((2, N), 2**31 - 1, np.int32)
    val[1, ::3] = 5
    proc = (np.arange(N)[None, :] // 2 % 3 + np.zeros((2, 1))).astype(
        np.int32)
    for segment in (1, 3, 32, None):
        check_counter([typ, f, val, proc], 3, segment)
    got = counter_model(typ, f, val, proc, 3)
    assert (got[2] < 0).any()                 # the upper bound wrapped


def test_counter_model_single_line_and_single_row():
    lines = [np.array([[1]], np.int32), np.array([[1]], np.int32),
             np.array([[4]], np.int32), np.array([[0]], np.int32)]
    check_counter(lines, 1)
    check_counter(counter_lines(11, 1, 65, 3), 3, segment=2)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 4),
       N=st.integers(1, 120), P=st.sampled_from([1, 2, 3, 31, 33, 128]),
       segment=st.sampled_from([1, 2, 5, 31, 32, 64, None, 1000]))
def test_counter_model_drawn(seed, B, N, P, segment):
    check_counter(counter_lines(seed, B, N, P), P, segment)


# ------------------------------------------------------- the queue

@pytest.mark.parametrize("V", [1, 2, 31, 33, 1024, 1025, 16384, 65536])
def test_queue_model_matches_plain_and_reference(V):
    """Vocabularies of one and two values (one run as long as the row),
    both sides of a tile's 32 and of the widest one-slice vocabulary,
    and the full width's 16,384 and 65,536 (16 and 64 slices)."""
    B = 6 if V <= 1025 else 3
    lines = queue_lines(V * 3 + 1, B, 300, V, noise=0.05)
    stats, got = check_queue(lines, V)
    assert stats["slices"] == -(-V // 1024)
    assert set(got[0]) <= {0, 1}


@pytest.mark.parametrize("slice_width", [32, 64, None])
@pytest.mark.parametrize("hot", [0.0, 0.5, 1.0])
def test_queue_model_hot_values_and_forced_slices(hot, slice_width):
    """A hot value (half or all of the enqueues on value 0: one long run
    among short ones), with the model's slices narrowed to 32 and 64
    values (the kernel's plan takes up to 1,024) so that a
    row's values spread over many blocks."""
    V = 200
    lines = queue_lines(int(hot * 10) + (slice_width or 0), 5, 400, V,
                        hot=hot, noise=0.03)
    stats, _ = check_queue(lines, V, slice_width)
    assert stats["slices"] == -(-V // (slice_width or 224))
    assert stats["twin_tiles"] > 0 or not hot


def test_queue_model_misses_at_every_edge():
    """A missing dequeue at line 0, at the last line, each side of a
    tile edge and of a chunk edge (the chunk of 96 lines that 8 warps
    give 700 lines): each row fails where the miss was put, its walk
    again taken in the chunk that holds it; a healthy row passes."""
    N, V = 700, 40
    chunk = cuda_folds.queue_plan(N, V)["chunk"]
    assert chunk == 96
    at = [(0,), (N - 1,), (31,), (32,), (chunk - 1,), (chunk,),
          (3 * chunk + 1, 5 * chunk), (N // 2, N // 2 + 9), ()]
    lines = fifo_rows([queue_miss_row(N, V, a) for a in at])
    stats, got = check_queue(lines, V)
    valid, bad = got[0], got[1]
    assert list(valid) == [0] * 8 + [1]
    assert list(bad[:8]) == [a[0] for a in at[:8]]
    assert sorted({(r, w) for r, _, w, _ in stats["rewalks"]}) == [
        (r, a[0] // chunk) for r, a in enumerate(at[:8])]
    # Chunk w* is cut into seven sub-chunks of 32 lines (96 / 7, rounded
    # up to a tile); h* is the one that holds the miss.
    assert sorted({(r, h) for r, _, _, h in stats["rewalks"]}) == [
        (r, a[0] % chunk // 32) for r, a in enumerate(at[:8])]
    for sw in (32, 64):                 # the miss's value in one slice
        check_queue(lines, V, sw)


def test_queue_model_two_values_of_one_thread():
    """Two missing values of one slice that one thread of the fold
    takes (c and c' = c + 256, the thread folding c first), c' failing
    first: in an earlier chunk than c, in an earlier part of the same
    chunk, and after c (the row fails at c). Each row fails at its first
    miss, which the thread's least part over its values finds."""
    N, V = 700, 600
    plan = cuda_folds.queue_plan(N, V)
    chunk, helpers = plan["chunk"], plan["warps"] - 1
    assert plan["slices"] == 1 and plan["slice_width"] >= V
    c, c2 = V - 1 - QUEUE_THREADS, V - 1
    assert c % QUEUE_THREADS == c2 % QUEUE_THREADS and c >= 4
    sub = -(-(-(-chunk // helpers)) // 32) * 32
    w = 3 * chunk
    rows = [{5 * chunk + 7: c, 2 * chunk + 40: c2},
            {w + 2 * sub + 3: c, w + 5: c2},
            {w + 9: c, w + 2 * sub + 1: c2},
            {w + 20: c, w + 21: c2}]
    lines = fifo_rows([queue_miss_row(N, V, misses=m, cycle=4)
                       for m in rows])
    stats, got = check_queue(lines, V)
    assert list(got[0]) == [0] * len(rows)
    assert list(got[1]) == [min(m) for m in rows]
    assert sorted((r, w_, h) for r, _, w_, h in stats["rewalks"]) == [
        (r, min(m) // chunk, min(m) % chunk // sub)
        for r, m in enumerate(rows)]


def test_queue_model_every_dequeue_before_its_enqueue():
    """Every dequeue ahead of its enqueue (every value's walk dips below
    0, so every chunk reaches -1 and the first line fails), a row of
    dequeues and then their enqueues, and a row of enqueues alone."""
    N, V = 300, 50
    vals = np.arange(N // 2) % V
    typ = np.stack([np.repeat([[1, 0]], N // 2, 0).ravel(),
                    np.where(np.arange(N) < N // 2, 1, 0),
                    np.zeros(N)]).astype(np.int32)
    f = np.stack([np.repeat([[1, 0]], N // 2, 0).ravel(),
                  np.where(np.arange(N) < N // 2, 1, 0),
                  np.zeros(N)]).astype(np.int32)
    val = np.stack([np.repeat(vals, 2), np.arange(N) % V,
                    np.arange(N) % 70]).astype(np.int32)
    _, got = check_queue([typ, f, val], V)
    assert list(got[0]) == [0, 0, 1] and list(got[1][:2]) == [0, 0]
    assert got[2][2].sum() == N


def test_queue_model_rows_with_no_active_line():
    """An all-PAD row with garbage values, a row of failed and info
    lines only, and a row whose lines fall in one slice of many."""
    N, V = 64, 2048
    typ = np.stack([np.full(N, -1), np.tile([2, 3], N // 2),
                    np.tile([0, 1], N // 2)]).astype(np.int32)
    f = np.stack([np.zeros(N), np.tile([0, 1], N // 2),
                  np.tile([0, 1], N // 2)]).astype(np.int32)
    val = np.stack([np.full(N, NONE), np.arange(N),
                    np.full(N, 1500)]).astype(np.int32)
    _, got = check_queue([typ, f, val], V)
    assert list(got[0]) == [1, 1, 1] and list(got[1]) == [-1, -1, -1]
    assert got[2].sum() == 0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 4),
       N=st.integers(1, 300), V=st.integers(1, 100),
       slice_width=st.sampled_from([32, 64, None]),
       hot=st.sampled_from([0.0, 0.3]), early=st.sampled_from([0.0, 0.1]))
def test_queue_model_drawn(seed, B, N, V, slice_width, hot, early):
    check_queue(queue_lines(seed, B, N, V, hot=hot, early=early), V,
                slice_width)


@pytest.mark.parametrize("rows", [1, 32, 2000])
@pytest.mark.parametrize("N", [1, 31, 600, 40_002])
@pytest.mark.parametrize("V", [1, 33, 1024, 1025, 16384, 65536])
def test_queue_plan_covers_each_row(V, N, rows):
    """Slices of whole 32 values cover V exactly once, each slice's
    pairs and tags within QUEUE_SLICE_BYTES; chunks of whole tiles cover
    the row in QUEUE_WARPS warps, each the shortest whole number of
    tiles that does."""
    p = cuda_folds.queue_plan(N, V, rows)
    S, Vs, chunk = p["slices"], p["slice_width"], p["chunk"]
    assert Vs % 32 == 0 and S * Vs >= V > (S - 1) * Vs
    assert p["smem_bytes"] == 9 * p["warps"] * Vs
    assert p["smem_bytes"] <= cuda_folds.QUEUE_SLICE_BYTES
    assert p["blocks"] == rows * S
    assert p["tier"] == ("smem" if S == 1 else "sliced")
    assert chunk % 32 == 0 and chunk * p["warps"] >= N
    assert chunk == 32 or (chunk - 32) * p["warps"] < N
    assert Vs == min(1024, -(-V // 32) * 32)
    # The full-width queue batch: 16 slices of 1,024 values a row.
    assert cuda_folds.queue_plan(40_002, 16384, 32)["blocks"] == 512


# ------------------------------------------------------------ the FIFO

@pytest.mark.parametrize("N,Nmax", [(1, 1), (40, 1), (40, 8), (300, 8),
                                    (300, 512), (300, 256), (257, 512)])
@pytest.mark.parametrize("segment", [1, 33, None, 400])
def test_fifo_model_matches_plain_and_reference(N, Nmax, segment):
    """Nmax 1 (every read of the clipped slot), Nmax < N (the clipped
    slot E[tail - 1]) and pow2(N); segments of one line, past a tile, the
    plan's and longer than the row; walk tiles of 4 and 5 dequeues so
    that every run crosses tile edges."""
    lines = fifo_lines(N * 7 + Nmax + (segment or 0), 6, N, 5)
    for tile in (4, 5, cuda_folds.FIFO_WALK_TILE):
        check_fifo(lines, Nmax, segment, tile)


@pytest.mark.parametrize("V", [1, 2, 1000])
def test_fifo_model_duplicate_values_and_alternating_runs(V):
    """Repeated values (a wrong dequeue can match a later slot) and a
    duplicated dequeue every few: many success and failure runs."""
    lines = fifo_lines(20 + V, 5, 400, V, noise=0.02, dup_every=7)
    stats, got = check_fifo(lines, 512, tile=16)
    assert max(stats["rounds"]) > 10
    assert 0 in got[0]


def test_fifo_model_failure_at_every_tile_edge():
    """A wrong dequeue just before, at and after each tile edge, at line
    0 and at the last line: each row's first failure where it was put,
    its head and the final head (successes after it counted too)."""
    tile, N = 8, 200
    rows = [fifo_fail_row(N, bad_deqs=(k,)) for k in
            (tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile, 2 * tile + 1)]
    rows += [fifo_fail_row(N, bad_lines=(0,)),
             fifo_fail_row(N, bad_lines=(N - 1,)),
             fifo_fail_row(N, bad_lines=(31, 32, 33, 64)),
             fifo_fail_row(N)]
    lines = fifo_rows(rows)
    stats, got = check_fifo(lines, 256, segment=32, tile=tile)
    valid, bad = got[0], got[1]
    assert list(valid) == [0] * 9 + [1]
    assert bad[6] == 0 and bad[7] == N - 1 and bad[8] == 31
    # A healthy row takes one round a tile; a wrong dequeue inside a
    # tile two more, one at a tile's last dequeue one more.
    deqs = ((lines[0] == 1) & (lines[1] == 1)).sum(1)
    tiles = -(-deqs // tile)
    assert stats["rounds"][-1] == tiles[-1]
    assert stats["rounds"][2] == tiles[2] + 2
    assert stats["rounds"][0] == tiles[0] + 1


def test_fifo_model_empty_queue_and_no_dequeue():
    """A dequeue before any enqueue (head >= tail), rows with no ok
    dequeue, and an all-PAD row."""
    typ = np.array([[1, 0, 1, 1], [0, 0, 2, 3], [-1, -1, -1, -1]],
                   np.int32)
    f = np.array([[1, 0, 1, 1], [0, 0, 1, 1], [0, 0, 0, 0]], np.int32)
    val = np.array([[4, 4, 4, 4], [1, 2, 3, 4], [NONE] * 4], np.int32)
    for Nmax in (1, 4):
        _, got = check_fifo([typ, f, val], Nmax, segment=1, tile=1)
        assert list(got[0]) == [0, 1, 1] and got[1][0] == 0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 4),
       N=st.integers(1, 150), V=st.integers(1, 60),
       Nmax=st.sampled_from([1, 2, 8, 64, 256]),
       segment=st.sampled_from([1, 3, 32, None]),
       tile=st.sampled_from([1, 3, 32, 4096]), dup=st.sampled_from([0, 3]))
def test_fifo_model_drawn(seed, B, N, V, Nmax, segment, tile, dup):
    check_fifo(fifo_lines(seed, B, N, V, dup_every=dup), Nmax, segment,
               tile)


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("rows", [1, 4, 32, 264, 2000])
@pytest.mark.parametrize("N", [1, 31, 600, 20_000, 40_002])
def test_scan_plan_covers_each_row(N, rows):
    """Segments of whole tiles (at least SCAN_MIN_SEGMENT lines) cover a
    row in whole blocks of SCAN_WARPS, with no block wholly past the
    row, and enough of them to give the batch SCAN_TARGET_BLOCKS blocks
    where the rows are long enough."""
    p = cuda_folds.scan_plan(N, rows)
    seg, S, per_row = p["segment"], p["segments"], p["blocks_per_row"]
    assert seg % 32 == 0 and seg >= cuda_folds.SCAN_MIN_SEGMENT
    assert S == per_row * cuda_folds.SCAN_WARPS and S * seg >= N
    assert (per_row - 1) * cuda_folds.SCAN_WARPS * seg < max(N, 1)
    assert p["blocks"] == rows * per_row
    want = -(-cuda_folds.SCAN_TARGET_BLOCKS * cuda_folds.SCAN_WARPS // rows)
    if N >= cuda_folds.SCAN_MIN_SEGMENT * want:
        assert S >= want * 7 // 8       # rounding up to whole tiles
    assert cuda_folds.scan_plan(N, rows, 7)["segment"] == 7


def test_scratch_words_follow_the_plan():
    """The wrappers' scratch: the counter's summaries (and, past P 64,
    its carries), the FIFO's four line-length lists, counts and
    totals."""
    assert cuda_folds.counter_scratch_words(32, 20_000, 16) == (
        32 * (64 + 8) * (2 + 3 * 16))
    assert cuda_folds.counter_scratch_words(2, 600, 128, 33) == (
        2 * (24 + 3) * (2 + 3 * 128) + 2 * 24 * 3 * 128)
    assert cuda_folds.fifo_scratch_words(32, 40_002) == (
        32 * (4 * 40_002 + 2 * 72 + 1))
