"""The parallel forms of the fold scans K7b (``counter_scan``) and K7d
(``fifo_scan``), as ``jepsen_torch/ops/csrc/folds.cu`` computes them,
held bit for bit to the plain versions (``plain_counter_scan``,
``plain_fifo_scan``) and to the reference's ``_counter_kernel`` and
``_fifo_kernel`` (run by jax on the CPU).

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
* the FIFO: each warp counts its segment's enqueues and ok dequeues,
  the compaction gives every enqueue its rank (the value list E) and
  every ok dequeue its line, value and enqueue count, and the walk
  takes the dequeue list in tiles, in alternating success and failure
  runs, each run ended by a block-wide minimum.

The plan (segment length, warps a block) is ``cuda_folds.scan_plan``'s.
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
