"""The row kernels of the history generators (K8a ``synth_cas``, K8c
``synth_la``: one warp a history row, as
``jepsen_torch/ops/csrc/synth_device.cu`` computes them), held bit for
bit to the plain versions (``plain_cas_core``, ``plain_la_core``) and to
the reference's ``_cas_core`` and ``_la_core`` under numpy.

The CUDA kernels cannot run here, so they are modelled in numpy stage for
stage, every row a warp of 32 lanes, op 32t + l on lane l of tile t:

* the draws, lane by lane;
* the lag walk: each step a clamp-add map (a, lo, hi), composed by a
  five-step shuffle-up scan and applied to the tile's incoming lag;
* the register (cas): lanes grouped by key, roots (writes and each key's
  first op in the tile, which reads the key's register) known, and rounds
  in which every other lane applies its op to its key's previous lane;
* the counts by ballots and popcounts over running totals, per key
  masked by the key's group, and what a count needs at j_i (pending
  windows, la's ``len_inv``) by a walk over ops [j_i, i) of the warp's
  ring (its length from ``cuda_synth.synth_plan``, so that a ring too
  short would show);
* the corruption's pick, a warp max-reduce carried across tiles;
* the lines: lane m stores op m's invoke at line m + j_m and the
  completions of ops [j_{m-1}, j_m) at lines q + m, the warp the
  completions of ops [j_{n-1}, n) at lines q + n after the walk, then the
  one patch of the pick; staged in a buffer of ``synth_plan``'s length,
  no live line's slot reused, and flushed after each tile up to the
  first line not yet stored (with n even, the multiple of four below
  it); every line is stored exactly once.

The wide kernel (K8b ``synth_wide``: a warp a row, lane l writing lines
l, l + 32, ...) is modelled lane by lane too, past one and two turns of
32 lines, against ``plain_wide_core`` and the reference's ``_wide_core``.

Tolerance: none.
"""
import dataclasses

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import synth_device as R

from jepsen_torch.ops import cuda_synth
from jepsen_torch.ops import synth_device as S

torch.set_num_threads(1)

LANES = np.arange(32)
BIT = np.uint32(1) << LANES.astype(np.uint32)
LT = BIT - np.uint32(1)
LE = LT | BIT
BIG = 1 << 29
FIELDS_CAS = ("type", "process", "kind", "key", "peak_w", "key_peak_w",
              "key_present")
FIELDS_LA = ("type", "process", "fn", "key", "val", "corrupted")


# ------------------------------------------------------------ warp helpers

def ballot(x):
    """Per row, the mask of lanes where ``x`` [B, 32] holds."""
    return (np.where(x, BIT, np.uint32(0))).sum(1, dtype=np.uint64) \
        .astype(np.uint32)


def popc(m):
    return np.bitwise_count(np.asarray(m, np.uint32)).astype(np.int64)


def hibit(m):
    """31 - clz(m): the highest set lane, -1 for 0."""
    m = np.asarray(m, np.uint32)
    out = np.full(m.shape, -1, np.int64)
    for b in range(32):
        out = np.where((m >> np.uint32(b)) & np.uint32(1), b, out)
    return out


def lanes_le(x):
    """The mask of lanes <= x (x in -1..31)."""
    return ((np.uint64(2) << np.asarray(x, np.int64).astype(np.uint64))
            - np.uint64(1)).astype(np.uint32)


def shfl_up(x, o):
    y = x.copy()
    y[:, o:] = x[:, :-o]
    return y


def shfl(x, src):
    return np.take_along_axis(x, src, 1)


def match_any(k, act):
    """__match_any_sync on the key: each lane's mask of lanes with its key
    (lanes past the row's end alone)."""
    same = (k[:, :, None] == k[:, None, :]) & act[None, :, None] \
        & act[None, None, :]
    grp = np.where(same, BIT[None, None, :], np.uint32(0)).sum(
        2, dtype=np.uint64).astype(np.uint32)
    return np.where(act[None, :], grp, BIT[None, :])


def fastmod(x: int, d: int) -> int:
    """The kernel's fmod32 in Python integers: Lemire's m = 2^64 / d
    rounded up (wrapping to 0 for d = 1), x % d = high64((m * x mod
    2^64) * d)."""
    m = ((2 ** 64 - 1) // d + 1) % 2 ** 64
    return ((m * x) % 2 ** 64 * d) >> 64


# ------------------------------------------------------------ the lag walk

def compose(g1, g2):
    """g2 after g1 for clamp-add maps x -> min(max(x + a, lo), hi)."""
    a1, lo1, hi1 = g1
    a2, lo2, hi2 = g2
    return (a1 + a2, np.maximum(lo1 + a2, lo2),
            np.minimum(np.maximum(hi1 + a2, lo2), hi2))


def apply(g, x):
    a, lo, hi = g
    return np.minimum(np.maximum(x + a, lo), hi)


def lag_scan(s, i, act, P, d_in):
    """Each lane's lag from the tile's incoming ``d_in`` [B]: the
    five-step shuffle-up scan of the steps' clamp-add maps."""
    shape = s.shape
    g = (np.where(act, s, 0),
         np.broadcast_to(np.where(act, 0, -BIG), shape).copy(),
         np.broadcast_to(np.where(act, np.minimum(i, P - 1), BIG),
                         shape).copy())
    for o in (1, 2, 4, 8, 16):
        e = tuple(shfl_up(x, o) for x in g)
        c = compose(e, g)
        g = tuple(np.where(LANES >= o, cx, x) for cx, x in zip(c, g))
    return apply(g, d_in[:, None])


def walk_tiles(bits_s, n, P):
    """The whole row's lags, tile by tile (the kernel's carry)."""
    B = bits_s.shape[0]
    d_in = np.zeros(B, np.int64)
    out = np.zeros((B, n), np.int64)
    for t0 in range(0, n, 32):
        i = t0 + LANES
        act = i < n
        step = (bits_s[:, np.minimum(i, n - 1)] % 3).astype(np.int64) - 1
        d = lag_scan(step, i, act, P, d_in)
        last = min(31, n - 1 - t0)
        out[:, t0:t0 + last + 1] = d[:, :last + 1]
        d_in = d[:, last]
    return out


# ------------------------------------------------------------ the models

def draws(key, i):
    return S.fold_in(np.asarray(key, np.uint32)[:, None],
                     i.astype(np.uint32)[None, :])


class Lines:
    """The row's line grid with a count of stores to each line. Staged
    (``buffer`` slots, a power of two), a put goes to slot line & mask,
    which must hold no line not yet flushed, and ``flush(hi)`` moves each
    row's lines [done, hi), every one of them put, to the grid."""

    def __init__(self, B, n, fields, buffer=0):
        self.cols = {f: np.full((B, 2 * n), -7, np.int64) for f in fields}
        self.stores = np.zeros((B, 2 * n), np.int64)
        self.buffer = buffer
        if buffer:
            self.buf = {f: np.zeros((B, buffer), np.int64) for f in fields}
            self.occ = np.full((B, buffer), -1, np.int64)
            self.done = np.zeros(B, np.int64)

    def store(self, mask, line, **vals):
        b, l = np.nonzero(mask)
        at = np.broadcast_to(line, mask.shape)[b, l]
        vals = {f: np.broadcast_to(v, mask.shape)[b, l]
                for f, v in vals.items()}
        if not self.buffer:
            np.add.at(self.stores, (b, at), 1)
            for f, v in vals.items():
                self.cols[f][b, at] = v
            return
        s = at & (self.buffer - 1)
        assert (self.occ[b, s] == -1).all(), "a live line's slot reused"
        assert (at >= self.done[b]).all(), "a flushed line put again"
        self.occ[b, s] = at
        for f, v in vals.items():
            self.buf[f][b, s] = v

    def flush(self, hi):
        if not self.buffer:
            return
        cnt = hi - self.done
        assert (cnt >= 0).all()
        b = np.repeat(np.arange(len(hi)), cnt)
        l = self.done[b] + np.arange(cnt.sum()) - np.repeat(
            np.cumsum(cnt) - cnt, cnt)
        s = l & (self.buffer - 1)
        assert (self.occ[b, s] == l).all(), "a flushed line was not put"
        np.add.at(self.stores, (b, l), 1)
        for f, v in self.buf.items():
            self.cols[f][b, l] = v[b, s]
        self.occ[b, s] = -1
        self.done = hi.copy()


def staged_lines(plan):
    return plan["lines"] if plan["lines_in_smem"] else 0


def flush_end(line, n):
    """Where a tile's flush stops: at the first line not yet stored, or,
    with n even (four lines a lane), at the multiple of four below it."""
    return line & ~3 if n % 2 == 0 else line


def model_cas(keys, crash_lo, crash_hi, p_info_t, corrupt_t, p_crash_t, *,
              n_procs, n_ops, n_values, n_keys, with_info, with_crash,
              with_corrupt, key_meta, trace=None):
    """``cas_rows_kernel`` in numpy: ``keys`` uint32 [B] per stream.
    ``trace`` (a dict) collects the per-op lags, the pick and each tile's
    register rounds."""
    P, n, V, K = n_procs, n_ops, n_values, n_keys
    ks, kv, kf, kc = (np.asarray(keys[s], np.uint32) for s in S.STREAMS)
    clo = np.asarray(crash_lo, np.int64)[:, None]
    chi = np.asarray(crash_hi, np.int64)[:, None]
    B = ks.shape[0]
    meta = key_meta and K > 1
    plan = cuda_synth.synth_plan("cas", P, n, K)
    ring = plan["ring"]
    rmask = ring - 1
    rw = np.zeros((B, ring), np.uint32)
    regs = np.full((B, 16), -1, np.int64)
    inv_k = np.zeros((B, 16), np.int64)
    ok_k = np.zeros((B, 16), np.int64)
    peak_k = np.ones((B, 16), np.int64)
    corr_on = with_corrupt and V > 1
    fields = ("type", "process", "kind") + (("key",) if K > 1 else ())
    lines = Lines(B, n, fields, staged_lines(plan))
    rows = np.arange(B)[:, None]

    d_in = np.zeros(B, np.int64)
    j_last = np.zeros(B, np.int64)
    live_tot = np.zeros(B, np.int64)
    okw_tot = np.zeros(B, np.int64)
    peak = np.ones(B, np.int64)
    best = np.zeros(B, np.uint64)
    pick_line = np.zeros(B, np.int64)
    pick_kind = np.zeros(B, np.int64)
    d_all = np.zeros((B, n), np.int64)
    for t0 in range(0, n, 32):
        i = t0 + LANES
        act = np.broadcast_to(i < n, (B, 32))
        last = min(31, n - 1 - t0)
        bs, bv = draws(ks, i), draws(kv, i)
        f = ((bv >> 2) % 3).astype(np.int64)
        a = ((bv >> 4) % V).astype(np.int64)
        b2 = ((bv >> 12) % V).astype(np.int64)
        k = ((bv >> 20) % K).astype(np.int64) if K > 1 \
            else np.zeros((B, 32), np.int64)
        info = crash = applies = np.zeros((B, 32), bool)
        if with_info or with_crash:
            bf = draws(kf, i)
            applies = (bf & 1) == 1
            if with_info:
                info = ((bf >> 2) & 0x3FFF) < p_info_t
            if with_crash:
                crash = (i >= clo) & (i < chi) \
                    & (((bf >> 16) & 0x3FFF) < p_crash_t)
                info = info & ~crash
        ok = ~info & ~crash
        is_r, is_w, is_c = f == 0, f == 1, f == 2
        eff_w = is_w & (ok | applies)
        eff_c = is_c & (ok | applies)

        d = lag_scan((bs % 3).astype(np.int64) - 1, i, act[0], P, d_in)
        j = i - d
        j_prev = shfl_up(j, 1)
        j_prev[:, 0] = j_last
        d_in, j_last = d[:, last], j[:, last]
        d_all[:, t0:t0 + last + 1] = d[:, :last + 1]

        # The register by rounds.
        grp = match_any(k, act[0]) if K > 1 else np.where(
            act, ballot(act)[:, None], BIT[None, :])
        prev = hibit(grp & LT)
        init = np.where(act, np.take_along_axis(regs, k, 1), -1)
        root = ~act | eff_w | (prev < 0)
        v = np.where(eff_w, a, np.where(eff_c & (init == a), b2, init))
        roots = ballot(root)
        last_root = hibit(roots[:, None] & grp & LE)
        depth = popc(grp & LE & ~lanes_le(last_root))
        src = np.where(prev < 0, LANES, prev)
        rounds = depth.max(1)
        for r in range(int(rounds.max())):
            y = shfl(v, src)
            upd = ~root & (r < rounds)[:, None]
            v = np.where(upd, np.where(eff_c & (y == a), b2, y), v)
        if trace is not None:
            trace.setdefault("rounds", []).append(rounds)
        cur = np.where(prev < 0, init, shfl(v, src))
        last_of_key = act & ((grp & ~LE) == 0)
        regs[np.nonzero(last_of_key)[0], k[last_of_key]] = v[last_of_key]

        match = cur == a
        kind_inv = np.where(is_r, np.where(cur < 0, 0, 1 + cur),
                            np.where(is_w, 1 + V + a, 1 + 2 * V + a * V + b2))
        drop = (is_r & ~ok) | (is_c & ok & ~match)
        live = act & ~drop
        okc = live & ok
        pr = i % P
        word = (pr | ((drop | crash).astype(np.int64) << 15)
                | (info.astype(np.int64) << 16) | (okc.astype(np.int64) << 17)
                | (k << 20)).astype(np.uint32)
        b_at, l_at = np.nonzero(act)
        rw[b_at, i[l_at] & rmask] = word[b_at, l_at]

        # Lines: the invoke, then the completions that precede it,
        # counting the ok ones.
        stored = dict(type=np.where(drop, S.PAD, S.C_INVOKE),
                      process=np.where(drop, 0, pr),
                      kind=np.where(drop, -1, kind_inv))
        if K > 1:
            stored["key"] = np.where(drop, -1, k)
        lines.store(act, i + j, **stored)
        assert ((j - j_prev)[act] <= 2).all()
        okw = np.zeros((B, 32), np.int64)
        for off in range(2):
            q = j_prev + off
            on = act & (q < j)
            w = rw[rows, q & rmask]
            cas_completion(lines, on, w, q + i, K)
            okw += (on & ((w >> 17) & 1 == 1)).astype(np.int64)

        # Pending windows: live invokes by ballot, ok completions of ops
        # < j_i as those stored by lanes <= i (two ballots).
        live_m = ballot(live)
        ok1, ok2 = ballot(okw >= 1), ballot(okw >= 2)
        pend = live_tot[:, None] + popc(live_m[:, None] & LE) \
            - (okw_tot[:, None] + popc(ok1[:, None] & LE)
               + popc(ok2[:, None] & LE))
        peak = np.maximum(peak, np.where(live, pend, 0).max(1))
        live_tot += popc(live_m)
        okw_tot += popc(ok1) + popc(ok2)
        if meta:
            # Per key: ok ops of the key < i, less the ring's in [j_i, i).
            ok_m = ballot(okc)
            c_key = np.zeros((B, 32), np.int64)
            for off in range(int((i - j).max())):
                q = j + off
                on = live & (q < i)
                w = rw[rows, q & rmask]
                c_key += (on & ((w >> 17) & 1 == 1)
                          & (((w >> 20) & 0xF) == k)).astype(np.int64)
            kin = np.take_along_axis(inv_k, k, 1)
            kok = np.take_along_axis(ok_k, k, 1)
            pend_k = kin + popc(grp & live_m[:, None] & LE) \
                - (kok + popc(grp & ok_m[:, None] & LT) - c_key)
            for kk in range(K):
                mine = act & (k == kk)
                peak_k[:, kk] = np.maximum(peak_k[:, kk], np.where(
                    mine & live, pend_k, 0).max(1))
                inv_k[:, kk] += (mine & live).sum(1)
                ok_k[:, kk] += (mine & okc).sum(1)

        if corr_on:
            elig = act & is_r & ~drop
            m = np.where(elig, (draws(kc, i + 1) >> 1).astype(np.uint64) + 1,
                         0)
            mx = m.max(1)
            first = np.argmax(m == mx[:, None], 1)
            upd = mx > best
            best = np.where(upd, mx, best)
            pick_kind = np.where(upd, kind_inv[np.arange(B), first],
                                 pick_kind)
            pick_line = np.where(upd, (i + j)[np.arange(B), first],
                                 pick_line)

        # Every line below the next op's invoke block is stored.
        lines.flush(flush_end(t0 + last + 1 + j_last, n))
    # The completions after the last invoke, 32 lanes at a time.
    for q0 in range(int(j_last.min()), n, 32):
        q = q0 + LANES[None, :]
        on = (q >= j_last[:, None]) & (q < n)
        cas_completion(lines, on, rw[rows, q & rmask], q + n, K)
    lines.flush(np.full(B, 2 * n, np.int64))
    assert (lines.stores == 1).all(), "a line stored other than once"

    out = {f: c for f, c in lines.cols.items()}
    if corr_on:
        hb = S.fold_in(kc, np.uint32(0))
        hit = (best > 0) & ((hb >> 8) < corrupt_t)
        delta = 1 + (hb & 0xFF).astype(np.int64) % (V - 1)
        newk = 1 + (pick_kind - 1 + delta) % V
        rb = np.nonzero(hit)[0]
        out["kind"][rb, pick_line[rb]] = newk[rb]
    if trace is not None:
        trace.update(d=d_all, best=best, pick_line=pick_line)
    res = {"type": out["type"].astype(np.int8),
           "process": out["process"].astype(np.int16),
           "kind": out["kind"].astype(np.int32),
           "peak_w": peak.astype(np.int32)}
    if K > 1:
        res["key"] = out["key"].astype(np.int32)
        if meta:
            res["key_peak_w"] = peak_k[:, :K].astype(np.int32)
            res["key_present"] = inv_k[:, :K] > 0
    return res


def cas_completion(lines, on, w, line, K):
    dead = ((w >> 15) & 1) == 1
    stored = dict(type=np.where(dead, S.PAD, np.where(
                      ((w >> 16) & 1) == 1, S.C_INFO, S.C_OK)),
                  process=np.where(dead, 0, w & 0x7FFF), kind=-1)
    if K > 1:
        stored["key"] = np.where(dead, -1, (w >> 20) & 0xF)
    lines.store(on, line, **stored)


APPEND_BIT = np.uint32(0x80000000)


def model_la(keys, corrupt_t, *, n_procs, n_ops, n_keys, trace=None):
    """``la_rows_kernel`` in numpy: ``keys`` uint32 [B] per stream.
    ``trace`` collects each op's observed count, ``len_inv`` and the
    pick."""
    P, n, K = n_procs, n_ops, n_keys
    ks, kv, kc = (np.asarray(keys[s], np.uint32) for s in S.LA_STREAMS)
    B = ks.shape[0]
    plan = cuda_synth.synth_plan("la", P, n, K)
    ring = plan["ring"]
    rmask = ring - 1
    rk = np.zeros((B, ring), np.uint32)
    rv = np.zeros((B, ring), np.int64)
    cnt = np.zeros((B, K), np.int64)
    corr_on = corrupt_t > 0
    lines = Lines(B, n, ("type", "process", "fn", "key", "val"),
                  staged_lines(plan))
    rows = np.arange(B)[:, None]

    d_in = np.zeros(B, np.int64)
    j_last = np.zeros(B, np.int64)
    elem_tot = np.zeros(B, np.int64)
    best = np.zeros(B, np.uint64)
    pick = np.full(B, -1, np.int64)
    pick_len = np.zeros(B, np.int64)
    pick_line = np.zeros(B, np.int64)
    obs_all = np.zeros((B, n), np.int64)
    len_inv_all = np.zeros((B, n), np.int64)
    for t0 in range(0, n, 32):
        i = t0 + LANES
        act = np.broadcast_to(i < n, (B, 32))
        last = min(31, n - 1 - t0)
        bs, bv = draws(ks, i), draws(kv, i)
        app = (bv >> 8) < S._LA_APPEND_T
        k = ((bv >> 4) % K).astype(np.int64) if K > 1 \
            else np.zeros((B, 32), np.int64)

        d = lag_scan((bs % 3).astype(np.int64) - 1, i, act[0], P, d_in)
        j = i - d
        j_prev = shfl_up(j, 1)
        j_prev[:, 0] = j_last
        d_in, j_last = d[:, last], j[:, last]

        # Element ids and per-key counts by ballots over running totals.
        app_m = ballot(act & app)
        grp = match_any(k, act[0]) if K > 1 else np.where(
            act, ballot(act)[:, None], BIT[None, :])
        base = np.where(act, np.take_along_axis(cnt, np.where(act, k, 0), 1),
                        0)
        elem = elem_tot[:, None] + popc(app_m[:, None] & LE)
        v = np.where(app, elem, base + popc(grp & app_m[:, None] & LE))
        first_of_key = act & ((grp & LT) == 0)
        fb, fl = np.nonzero(first_of_key)
        cnt[fb, k[fb, fl]] = base[fb, fl] + popc(grp[fb, fl] & app_m[fb])
        elem_tot += popc(app_m)
        w = np.where(app, APPEND_BIT, np.uint32(0)) | k.astype(np.uint32)
        b_at, l_at = np.nonzero(act)
        rk[b_at, i[l_at] & rmask] = w[b_at, l_at]
        rv[b_at, i[l_at] & rmask] = v[b_at, l_at]
        obs_all[:, t0:t0 + last + 1] = v[:, :last + 1]

        if corr_on:
            reads = act & ~app
            len_inv = np.where(reads, v, 0)
            for off in range(int((i - j).max())):
                q = j + off
                on = reads & (q < i)
                hit = rk[rows, q & rmask] == (APPEND_BIT
                                              | k.astype(np.uint32))
                len_inv -= (on & hit).astype(np.int64)
            len_inv_all[:, t0:t0 + last + 1] = len_inv[:, :last + 1]
            m = np.where(reads & (len_inv >= 1),
                         (draws(kc, i + 1) >> 1).astype(np.uint64) + 1, 0)
            mx = m.max(1)
            first = np.argmax(m == mx[:, None], 1)
            upd = mx > best
            best = np.where(upd, mx, best)
            pick = np.where(upd, t0 + first, pick)
            pick_len = np.where(upd, len_inv[np.arange(B), first], pick_len)

        lines.store(act, i + j, type=S.C_INVOKE, process=i % P,
                    fn=np.where(app, 0, 1), key=k, val=np.where(app, elem, -1))
        assert ((j - j_prev)[act] <= 2).all()
        for off in range(2):
            q = j_prev + off
            on = act & (q < j)
            pick_line = la_completion(lines, on, rk[rows, q & rmask],
                                      rv[rows, q & rmask], q, q + i, P,
                                      pick, pick_line)
        lines.flush(flush_end(t0 + last + 1 + j_last, n))
    for q0 in range(int(j_last.min()), n, 32):
        q = q0 + LANES[None, :]
        on = (q >= j_last[:, None]) & (q < n)
        qc = np.minimum(q, n - 1)
        pick_line = la_completion(lines, on, rk[rows, qc & rmask],
                                  rv[rows, qc & rmask], qc, qc + n, P, pick,
                                  pick_line)
    lines.flush(np.full(B, 2 * n, np.int64))
    assert (lines.stores == 1).all(), "a line stored other than once"

    hit = corr_on & (best > 0) & ((S.fold_in(kc, np.uint32(0)) >> 8)
                                  < corrupt_t)
    out = lines.cols
    rb = np.nonzero(hit)[0]
    db = S.fold_in(kc, np.uint32(S._LA_DROP_CTR)).astype(np.int64)
    out["val"][rb, pick_line[rb]] = db[rb] % np.maximum(pick_len[rb], 1)
    if trace is not None:
        trace.update(obs=obs_all, len_inv=len_inv_all, best=best, pick=pick,
                     pick_line=pick_line)
    return {"type": out["type"].astype(np.int8),
            "process": out["process"].astype(np.int16),
            "fn": out["fn"].astype(np.int8),
            "key": out["key"].astype(np.int32),
            "val": out["val"].astype(np.int32), "corrupted": hit}


def la_completion(lines, on, w, v, q, line, P, pick, pick_line):
    """Store the completions ``on``; return the pick's line, updated where
    one of them is the pick's."""
    lines.store(on, line, type=S.C_OK, process=q % P,
                fn=np.where((w & APPEND_BIT) != 0, 0, 1),
                key=(w & ~APPEND_BIT).astype(np.int64), val=v)
    got = on & (q == pick[:, None])
    b, l = np.nonzero(got)
    pick_line = pick_line.copy()
    pick_line[b] = np.broadcast_to(line, got.shape)[b, l]
    return pick_line


# ------------------------------------------------------------ the cases

def cas_spec(**kw):
    base = dict(family="cas", n=12, seed=5, n_procs=5, n_ops=70,
                n_values=5, corrupt=0.5, p_info=0.1)
    return S.SynthSpec(**{**base, **kw})


def la_spec(**kw):
    base = dict(family="la", n=12, seed=4, n_procs=5, n_ops=70, n_keys=3,
                corrupt=0.6)
    return S.SynthSpec(**{**base, **kw})


# Every edge the issue names: P 1, 33, 40 and 100 (an empty window, and
# windows over several tiles); n 1, 2, 31, 32, 33, 64 and one not a
# multiple of 32; V 1 (no corruption) and 4094 (the 24-bit kind field's
# largest); K 1 and 16 with and without per-key windows; the crash window
# with timeouts; no corruption; and the north-star shape cut in rows.
CAS_CASES = {
    "north_star_rows": dict(n_procs=5, n_ops=300, corrupt=0.25, p_info=0.0),
    "procs_1": dict(n_procs=1),
    "procs_2": dict(n_procs=2),
    "procs_33": dict(n_procs=33, n_ops=200),
    "procs_40": dict(n_procs=40, n_ops=200),
    "procs_100": dict(n_procs=100, n_ops=260),
    "procs_past_ops": dict(n_procs=300, n_ops=90),
    "lines_direct": dict(n=4, n_procs=700, n_ops=800, n_keys=4),
    "ring_in_device": dict(n=3, n_procs=2100, n_ops=2200),
    "ops_1": dict(n_ops=1),
    "ops_2": dict(n_ops=2),
    "ops_31": dict(n_ops=31),
    "ops_32": dict(n_ops=32),
    "ops_33": dict(n_ops=33),
    "ops_64": dict(n_ops=64),
    "values_1": dict(n_values=1),
    "values_4094": dict(n_values=4094, n_keys=3),
    "keys_16_meta": dict(n_keys=16, n_ops=150),
    "keys_16_crash_info": dict(n_keys=16, n_ops=150, p_info=0.2,
                               crash_lo=20, crash_hi=120, p_crash=0.4),
    "keys_3_no_meta": dict(n_keys=3, key_meta=False),
    "crash_info_unkeyed": dict(p_info=0.3, crash_lo=0, crash_hi=60,
                               p_crash=0.5),
    "clean": dict(corrupt=0.0, p_info=0.0),
}

LA_CASES = {
    "la_timing_rows": dict(n_procs=5, n_ops=300, n_keys=8, corrupt=0.5),
    "procs_1": dict(n_procs=1),
    "procs_12": dict(n_procs=12, n_ops=150),
    "procs_40": dict(n_procs=40, n_ops=200),
    "procs_100": dict(n_procs=100, n_ops=260),
    "lines_direct": dict(n=4, n_procs=500, n_ops=600),
    "ring_in_device": dict(n=3, n_procs=1000, n_ops=1100),
    "counts_in_device": dict(n=6, n_keys=1100),
    "ops_1": dict(n_ops=1),
    "ops_2": dict(n_ops=2),
    "ops_33": dict(n_ops=33),
    "keys_1": dict(n_keys=1),
    "keys_16": dict(n_keys=16),
    "keys_17": dict(n_keys=17),
    "keys_33": dict(n_keys=33),
    "keys_64": dict(n_keys=64, n_ops=150),
    "corrupt_0": dict(corrupt=0.0),
    "corrupt_1": dict(corrupt=1.0),
}


def split_cas(kw):
    kw = dict(kw)
    key_meta = kw.pop("key_meta", True)
    return cas_spec(**kw), key_meta


def cas_args(spec, key_meta, rows=None, keys=None, crash_lo=None,
             crash_hi=None):
    """The generator's inputs as the model takes them (uint32 keys) and as
    the plain version does (CPU tensors), and its static flags."""
    tk, lo, hi, *thr = S.cas_inputs(spec, rows=rows, keys=keys,
                                    crash_lo=crash_lo, crash_hi=crash_hi,
                                    device="cpu")
    npk = {s: t.numpy().view(np.uint32) for s, t in tk.items()}
    return (npk, lo.numpy(), hi.numpy(), *thr), (tk, lo, hi, *thr), \
        S.cas_static(spec, key_meta)


def ref_cas(margs, st):
    """The reference's ``_cas_core`` under numpy on the model's inputs."""
    keys, lo, hi, *thr = margs
    return R._cas_core(np, keys, lo, hi, *(np.uint32(t) for t in thr), **st)


def assert_same(got, want, fields):
    assert set(got) == set(want) and set(got) <= set(fields)
    for f in want:
        w = np.asarray(want[f])
        g = np.asarray(got[f])
        assert g.shape == w.shape, f
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), f


@pytest.mark.parametrize("name", sorted(CAS_CASES))
def test_cas_model_matches_plain_and_reference(name):
    spec, key_meta = split_cas(CAS_CASES[name])
    margs, targs, st = cas_args(spec, key_meta)
    got = model_cas(*margs, **st)
    plain = {f: v.numpy() for f, v in S.plain_cas_core(*targs, **st).items()}
    assert_same(got, plain, FIELDS_CAS)
    assert_same(got, ref_cas(margs, st), FIELDS_CAS)


@pytest.mark.parametrize("name", sorted(LA_CASES))
def test_la_model_matches_plain_and_reference(name):
    spec = la_spec(**LA_CASES[name])
    tk, thr = S.la_inputs(spec, device="cpu")
    npk = {s: t.numpy().view(np.uint32) for s, t in tk.items()}
    st = S.la_static(spec)
    got = model_la(npk, thr, **st)
    plain = {f: v.numpy() for f, v in S.plain_la_core(tk, thr, **st).items()}
    assert_same(got, plain, FIELDS_LA)
    ref = R.synth_la_device(R.SynthSpec(**dataclasses.asdict(spec)),
                            backend="numpy")
    assert_same(got, {f: getattr(ref, f) for f in FIELDS_LA}, FIELDS_LA)
    if spec.corrupt > 0 and spec.n_ops > 4:
        assert got["corrupted"].any(), "no row hit: the pick is untested"


def test_row_slices_and_explicit_keys():
    """Rows [lo, hi) of a batch equal the full batch's; explicit stream
    keys and per-row crash windows (the fuzz loop's neighbourhoods) equal
    the plain version and the reference, in both families."""
    spec, _ = split_cas(dict(n=30, n_keys=4, crash_lo=10, crash_hi=50,
                             p_crash=0.3))
    full = model_cas(*cas_args(spec, True)[0], **S.cas_static(spec))
    part = model_cas(*cas_args(spec, True, rows=(7, 23))[0],
                     **S.cas_static(spec))
    for f in part:
        assert np.array_equal(part[f], full[f][7:23]), f
    rows = np.array([5, 5, 17, 29, 2], np.uint32)
    keys = S.history_keys_for(spec.seed, rows)
    keys["sched"][1] = S.fold_in(keys["sched"][1], np.uint32(0xF00D))
    lo = np.array([0, 4, 10, 2, 16], np.int32)     # row 2: the spec's
    hi = np.array([70, 9, 50, 3, 40], np.int32)
    margs, targs, st = cas_args(spec, True, keys=keys, crash_lo=lo,
                                crash_hi=hi)
    got = model_cas(*margs, **st)
    plain = {f: v.numpy() for f, v in S.plain_cas_core(*targs, **st).items()}
    assert_same(got, plain, FIELDS_CAS)
    assert_same(got, ref_cas(margs, st), FIELDS_CAS)
    assert np.array_equal(got["kind"][2], full["kind"][17])

    la = la_spec(n=30)
    st = S.la_static(la)

    def la_model(**kw):
        tk, thr = S.la_inputs(la, device="cpu", **kw)
        return model_la({s: t.numpy().view(np.uint32) for s, t in tk.items()},
                        thr, **st), (tk, thr)
    lfull, _ = la_model()
    lpart, _ = la_model(rows=(7, 23))
    for f in lpart:
        assert np.array_equal(lpart[f], lfull[f][7:23]), f
    lkeys = S.history_keys_for(la.seed, rows)
    lkeys["vals"][0] = S.fold_in(lkeys["vals"][0], np.uint32(0xF00D))
    lgot, (tk, thr) = la_model(keys=lkeys)
    plain = {f: v.numpy() for f, v in S.plain_la_core(tk, thr, **st).items()}
    assert_same(lgot, plain, FIELDS_LA)
    ref = R.synth_la_device(R.SynthSpec(**dataclasses.asdict(la)),
                            keys=lkeys, backend="numpy")
    assert_same(lgot, {f: getattr(ref, f) for f in FIELDS_LA}, FIELDS_LA)


# ------------------------------------------------------------ the stages

def test_clamp_composition_is_the_maps_composed():
    """Random clamp-add maps, the constant case lo >= hi among them: the
    composed map equals applying one, then the other, at every x."""
    rng = np.random.default_rng(0)
    g1 = (rng.integers(-40, 40, 4000), rng.integers(-50, 50, 4000),
          rng.integers(-50, 50, 4000))
    g2 = (rng.integers(-40, 40, 4000), rng.integers(-50, 50, 4000),
          rng.integers(-50, 50, 4000))
    assert (g1[1] >= g1[2]).sum() > 1000    # constant maps are covered
    for x in range(-60, 61, 7):
        assert np.array_equal(apply(compose(g1, g2), x),
                              apply(g2, apply(g1, x)))


@pytest.mark.parametrize("P", [1, 2, 5, 32, 33, 40, 100, 5000])
def test_lag_scan_is_the_walk(P):
    """The tile scan, carried across tiles, gives the plain walk's lags at
    every op, rows of 1 to 200 ops (whole tiles and ragged ones)."""
    for n in (1, 2, 31, 32, 33, 64, 200):
        keys = S.history_keys_for(P, np.arange(6, dtype=np.uint32))
        bits_s = draws(keys["sched"], np.arange(n))
        got = walk_tiles(bits_s, n, P)
        want = S.plain_walk(torch.from_numpy(
            (bits_s % 3).astype(np.int64) - 1), P).numpy()
        assert np.array_equal(got, want), n


def test_line_placement_is_the_line_decode():
    """Every line is stored once (the models assert it), and the op a
    line holds is the plain schedule's: the process column of a P = n
    row names each op, through the closed-form ``_line_decode``."""
    for P, n in ((40, 40), (100, 100), (33, 33), (7, 7)):
        spec = la_spec(n=6, n_procs=P, n_ops=n, corrupt=0.0)
        tk, thr = S.la_inputs(spec, device="cpu")
        st = S.la_static(spec)
        trace = {}
        got = model_la({s: t.numpy().view(np.uint32)
                        for s, t in tk.items()}, thr, trace=trace, **st)
        bits_s = draws(tk["sched"].numpy().view(np.uint32), np.arange(n))
        d = S.plain_walk(torch.from_numpy((bits_s % 3).astype(np.int64) - 1),
                         P)
        comp, _ = S._op_positions(d, n, P)
        op, is_comp = S._line_decode(comp, n, P)
        assert np.array_equal(got["process"], op.numpy())
        assert np.array_equal(got["type"] == S.C_OK, is_comp.numpy())


def test_register_rounds_are_few():
    """The rounds a tile needs are its longest run of non-roots: 4 to 9 on
    average on the north-star shape (one key), fewer with keys."""
    means = {}
    for K in (1, 8):
        spec, meta = split_cas(dict(n=16, n_ops=320, n_keys=K,
                                    p_info=0.0))
        trace = {}
        model_cas(*cas_args(spec, meta)[0], trace=trace,
                  **S.cas_static(spec, meta))
        rounds = np.concatenate(trace["rounds"])
        assert rounds.max() <= 31
        means[K] = rounds.mean()
    assert 4 <= means[1] <= 9 and means[8] < means[1]


def test_tile_counts_and_len_inv():
    """The la model's per-op counts, by ballots over running totals, are
    the per-key prefix counts; its len_inv, by the ring walk over
    [j_i, i), is the count at op j_i - 1, for P whose window stays in a
    tile and P whose window spans several."""
    for P in (5, 40, 100):
        spec = la_spec(n=8, n_procs=P, n_ops=260, n_keys=5, corrupt=1.0)
        tk, thr = S.la_inputs(spec, device="cpu")
        keys = {s: t.numpy().view(np.uint32) for s, t in tk.items()}
        trace = {}
        model_la(keys, thr, trace=trace, **S.la_static(spec))
        n = spec.n_ops
        bits_v = draws(keys["vals"], np.arange(n))
        bits_s = draws(keys["sched"], np.arange(n))
        app = (bits_v >> 8) < S._LA_APPEND_T
        key = ((bits_v >> 4) % spec.n_keys).astype(np.int64)
        d = walk_tiles(bits_s, n, P)
        j = np.arange(n) - d
        for b in range(spec.n):
            for i in range(n):
                mine = (key[b, :i + 1] == key[b, i]) & app[b, :i + 1]
                want = mine.sum() if not app[b, i] else None
                if want is not None:
                    assert trace["obs"][b, i] == want
                    assert trace["len_inv"][b, i] == mine[:j[b, i]].sum()


def test_pick_across_tiles_is_the_first_largest():
    """The carried warp max-reduce picks the first op of the row's largest
    score: the plain argmax, on rows long enough that picks land in every
    tile."""
    spec = la_spec(n=24, n_ops=200, corrupt=1.0)
    tk, thr = S.la_inputs(spec, device="cpu")
    keys = {s: t.numpy().view(np.uint32) for s, t in tk.items()}
    trace = {}
    model_la(keys, thr, trace=trace, **S.la_static(spec))
    n = spec.n_ops
    sc = draws(keys["corr"], np.arange(n) + 1)
    bits_v = draws(keys["vals"], np.arange(n))
    eligible = ~((bits_v >> 8) < S._LA_APPEND_T) & (trace["len_inv"] >= 1)
    m = np.where(eligible, (sc >> 1).astype(np.uint64) + 1, 0)
    assert np.array_equal(trace["pick"], np.where(m.max(1) > 0,
                                                  m.argmax(1), -1))
    assert len(set((trace["pick"] // 32).tolist())) >= 4


def test_peak_windows_from_tile_counts():
    """peak_w and the per-key windows come from the tile ballots less the
    ring's ok ops in [j_i, i): equal to the plain cumsum form with P past
    one tile and a crash window (the models' full cases hold every
    field; this one pins the windows alone on wide rows)."""
    spec, _ = split_cas(dict(n=10, n_procs=40, n_ops=300, n_keys=6,
                             p_info=0.2, crash_lo=30, crash_hi=250,
                             p_crash=0.3))
    margs, targs, st = cas_args(spec, True)
    got = model_cas(*margs, **st)
    plain = S.plain_cas_core(*targs, **st)
    for f in ("peak_w", "key_peak_w", "key_present"):
        assert np.array_equal(got[f], plain[f].numpy()), f
    assert (got["peak_w"] > 5).all()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 12, 33, 4094, 32767, 65535,
                               (1 << 31) - 1, (1 << 32) - 1])
def test_fastmod_is_the_remainder(d):
    """The kernel's Lemire remainder at every divisor it takes (P, V, K)
    on the draws' edges."""
    rng = np.random.default_rng(d)
    xs = [0, 1, d - 1, d, d + 1, 2 * d - 1, (1 << 32) - 1, (1 << 31),
          (1 << 28) - 1, (1 << 12) - 1] + rng.integers(
              0, 1 << 32, 200, dtype=np.uint64).tolist()
    for x in xs:
        x = int(x) % (1 << 32)
        assert fastmod(x, d) == x % d, (x, d)


def test_synth_plan_places_rings_counts_and_lines():
    """The ring holds min(P, n) + 32 ops at least and the line buffer
    min(P, n) + 67 lines, powers of two; each goes to the device (or, for
    lines, straight to the outputs) past a warp's 12 KB, the ring first;
    la counts past 1,024 keys go to the device scratch; the block's
    shared memory stays within 48 KB."""
    plan = cuda_synth.synth_plan
    ns = plan("cas", 5, 1000)
    assert (ns["ring"], ns["lines"]) == (64, 128)
    assert ns["ring_in_smem"] and ns["lines_in_smem"]
    assert ns["smem_bytes"] == 4 * (256 + 4 * 64 + 7 * 128)
    assert plan("cas", 100, 1000, 3)["lines"] == 256
    assert plan("cas", 300, 90)["ring"] == 128
    assert plan("cas", 1, 1)["ring"] == 64
    assert plan("cas", 2016, 5000)["ring_in_smem"]
    assert not plan("cas", 2017, 5000)["ring_in_smem"]
    assert plan("cas", 400, 5000, 4)["lines_in_smem"]
    assert not plan("cas", 500, 5000, 4)["lines_in_smem"]
    assert plan("la", 992, 5000, 8)["ring_in_smem"]
    assert not plan("la", 993, 5000, 8)["ring_in_smem"]
    assert plan("la", 400, 5000, 8)["lines_in_smem"]
    assert not plan("la", 500, 5000, 8)["lines_in_smem"]
    assert plan("la", 5, 100, 1024)["counts_in_smem"]
    assert not plan("la", 5, 100, 1025)["counts_in_smem"]
    for fam, P, n, K in (("cas", 2016, 9000, 16), ("cas", 400, 9000, 16),
                         ("la", 992, 9000, 1024), ("la", 400, 9000, 1024),
                         ("la", 5000, 9000, 1024), ("la", 5, 9000, 1025)):
        p = plan(fam, P, n, K)
        assert p["ring"] >= min(P, n) + 32 and p["lines"] >= min(P, n) + 67
        assert p["smem_bytes"] <= 48 * 1024


# ------------------------------------------------------- the wide kernel

def model_wide(vals_key, *, width, n_values, invalid):
    """K8b as ``wide_kernel`` computes it: a warp a row, lane l writing
    lines l, l + 32, ... of its row, each write line's value its own draw
    fold_in(key, t) % V by the kernel's Lemire remainder, peak_w by lane
    0."""
    B, N, w1 = len(vals_key), width + 1, width - 1
    read_kind = 1 + 2 * n_values + n_values * n_values if invalid else 0
    out = {"type": np.full((B, N), 99, np.int8),
           "process": np.full((B, N), -9, np.int16),
           "kind": np.full((B, N), -9, np.int32),
           "peak_w": np.full(B, -9, np.int32)}
    stores = np.zeros((B, N), np.int64)
    for b in range(B):
        for turn in range(0, N, 32):
            for lane in range(32):
                t = turn + lane
                if t >= N:
                    continue
                stores[b, t] += 1
                out["type"][b, t] = 1 if t == N - 1 else 0
                out["process"][b, t] = min(t, w1)
                if t < w1:
                    draw = int(S.fold_in(vals_key[b], np.uint32(t)))
                    out["kind"][b, t] = 1 + n_values + fastmod(draw,
                                                               n_values)
                else:
                    out["kind"][b, t] = read_kind if t == w1 else -1
        out["peak_w"][b] = width
    assert (stores == 1).all()
    return out


@pytest.mark.parametrize("width", [1, 2, 9, 17, 18, 33, 40, 70])
@pytest.mark.parametrize("invalid", [False, True])
def test_wide_model_matches_plain_and_reference(width, invalid):
    """The lanes-over-lines layout, past one and two turns of 32 lines,
    against ``plain_wide_core`` and the reference's ``_wide_core`` under
    numpy, bit for bit."""
    spec = S.SynthSpec(family="wide", n=6, seed=2 + width, width=width,
                       n_values=2 + width % 5, invalid=invalid)
    vk = S.wide_inputs(spec, device="cpu")
    st = dict(width=width, n_values=spec.n_values, invalid=invalid)
    got = model_wide(vk.numpy().view(np.uint32), **st)
    assert_same(got, {k: v.numpy() for k, v in
                      S.plain_wide_core(vk, **st).items()},
                ("type", "process", "kind", "peak_w"))
    assert_same(got, R._wide_core(np, vk.numpy().view(np.uint32), **st),
                ("type", "process", "kind", "peak_w"))
