"""A numpy model of ``shard_close`` in ``jepsen_torch/ops/csrc/wgl_shard.cu``
on the kernel's own layout, for the CPU tests.

It runs what the kernel runs, row by row: the slice split by its top
``clog`` local mask bits over 2^clog CTAs of ``threads`` threads (the
wrapper's ``close_plan``, or forced); the load, a warp taking its
batches of 32-mask groups with lanes over masks, building NZ and the
dirty bitmap DT as ballots; the fresh slots found by scanning back over
the row's event types a warp's 32 events at a time; the sweep, skipped
when nothing merged and (no slot is fresh or the slice is empty), by
layers of masks (a mask's local and rank bits counted), CTA r taking its
local layer k - popcount(r) from ``cuda_shard.close_order`` a thread a
mask, each pulling from the final sources of the slots it holds (across
CTAs for a rank bit); "kept" read from NZ. A layer's masks read only the
layer before and write only themselves, so the model takes a CTA's part
of a layer at once, in the order of the threads' strides, after
checking that the strides cover each mask exactly once.
"""
import numpy as np

from jepsen_torch.ops import cuda_shard
from jepsen_torch.ops.encode import EV_CLOSE, EV_FUSED, EV_OK

LIVE = (EV_OK, EV_FUSED, EV_CLOSE)
FULL = np.uint32(0xFFFFFFFF)
LANES = np.arange(32, dtype=np.uint32)


def np_(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def ballot(flags):
    """[..., 32] bools -> [...] uint32 lane words."""
    return (flags.astype(np.uint64) << LANES.astype(np.uint64)).sum(
        -1).astype(np.uint32)


def unpack(words):
    """[...] uint32 -> [..., 32] bools."""
    return ((np.asarray(words, np.uint32)[..., None] >> LANES) & 1) == 1


def strided(n, nwarps):
    """Indices 0..n-1 in the order the warps of a CTA visit them (warp w:
    w, w + nwarps, ...); each exactly once."""
    out = np.concatenate([np.arange(w, n, nwarps)
                          for w in range(min(nwarps, n))]) \
        if n else np.zeros(0, np.int64)
    assert np.array_equal(np.sort(out), np.arange(n))
    return out.astype(np.int64)


def batched(n, nwarps, batch=8):
    """Groups 0..n-1 in the order a CTA's warps load them: warp w takes
    ``batch`` consecutive groups from w * batch, then steps by nwarps *
    batch (kLoadBatch); each exactly once."""
    out = [g0 + u for w in range(nwarps)
           for g0 in range(w * batch, n, nwarps * batch)
           for u in range(batch) if g0 + u < n]
    out = np.array(out, np.int64)
    assert np.array_equal(np.sort(out), np.arange(n))
    return out


def kind(ev_slots, K1, row, e, slot):
    k = int(ev_slots[row, e, slot])
    k = k + K1 if k < 0 else k
    return min(max(k, 0), K1 - 1)


def fresh_slots(typ, slot, ev_slots, K1, row, e, WL, W):
    """The kernel's fresh_slots: warp 0 scans back 32 events at a time
    for the row's previous live event p (lane l reads event base - l)."""
    p = -1
    base = e - 1
    while base >= 0 and p < 0:
        j = base - np.arange(32)
        live = np.array([jj >= 0 and int(typ[row, jj]) in LIVE for jj in j])
        if live.any():
            p = base - int(np.argmax(live))
        base -= 32
    if p < 0:
        return (1 << WL) - 1
    q = -1
    if int(typ[row, p]) in (EV_OK, EV_FUSED):
        q = min(max(int(slot[row, p]), 0), W - 1)
    f = 0
    for lane in range(WL):
        if lane == q or kind(ev_slots, K1, row, e, lane) != \
                kind(ev_slots, K1, row, p, lane):
            f |= 1 << lane
    return f


def stage(target, K1, V, NW, row, kinds):
    """The staged nibble tables: [WL, ceil(V/4), 16, NW] words, entry
    (i, q, n) the image under slot i of the states 4q + b for the set
    bits b of n, and the live mask (bit i: slot i's row reaches a
    state)."""
    t = target if target.ndim == 2 else target[row]
    NQ = (V + 3) // 4
    tab = np.zeros((len(kinds), NQ, 16, NW), np.uint32)
    live = 0
    for i, k in enumerate(kinds):
        to = t[k].astype(np.int64)
        if (to >= 0).any():
            live |= 1 << i
        for q in range(NQ):
            for n in range(16):
                for b in range(4):
                    st = 4 * q + b
                    if (n >> b) & 1 and st < V and to[st] >= 0:
                        tab[i, q, n, to[st] >> 5] |= np.uint32(
                            1 << (int(to[st]) & 31))
    return tab, live


def image(x, tab):
    """nibble_image on words x [NW, ...]: a lookup a nibble of the state
    set, ORed."""
    NW, NQ = x.shape[0], tab.shape[0]
    img = np.zeros_like(x)
    for q in range(NQ):
        n = (x[q >> 3] >> np.uint32(4 * (q & 7))) & np.uint32(15)
        for w in range(NW):
            img[w] |= tab[q, n, w]
    return img


class Row:
    """One row's CTAs: slices Fl[r] [NW, Ml], bitmaps NZ and DT [Gl]."""

    def __init__(self, F, clog, threads):
        NW, M = F.shape
        self.C, self.clog = 1 << clog, clog
        self.Ml = M >> clog
        self.Wl = self.Ml.bit_length() - 1
        self.Gl = max(1, self.Ml >> 5)
        self.lanes = FULL if self.Ml >= 32 else np.uint32((1 << self.Ml) - 1)
        self.threads = threads
        self.nwarps = threads // 32
        self.Fl = [F[:, r * self.Ml:(r + 1) * self.Ml].copy()
                   for r in range(self.C)]
        self.NZ = [np.zeros(self.Gl, np.uint32) for _ in range(self.C)]
        self.DT = [np.zeros(self.Gl, np.uint32) for _ in range(self.C)]

    def words(self, r, m):
        """Words [NW, ...] of CTA r's masks m (masks past Ml read as
        empty)."""
        ok = m < self.Ml
        out = self.Fl[r][:, np.where(ok, m, 0)]
        return np.where(ok[None], out, np.uint32(0))


def load(row, Fg, recvs):
    """The load loop: each CTA's groups in warp order, the received
    images ORed in; returns whether the merge changed a mask."""
    added = False
    for r in range(row.C):
        g = batched(row.Gl, row.nwarps)
        m = g[:, None] * 32 + np.arange(32)[None, :]
        act = unpack(np.full(len(g), row.lanes))
        at = r * row.Ml + np.where(act, m, 0)
        v = np.where(act[None], Fg[:, at], np.uint32(0))
        x = v.copy()
        for R in recvs:
            x |= np.where(act[None], R[:, at], np.uint32(0))
        for w in range(v.shape[0]):
            row.Fl[r][w, m[act]] = x[w][act]
        gain = (x != v).any(0)
        row.NZ[r][g] = ballot((x != 0).any(0))
        row.DT[r][g] = ballot(gain)
        added |= bool(gain.any())
    return added


def order(bits):
    """``cuda_shard.close_order`` on the CPU: a CTA's local masks by bit
    count, then value."""
    return cuda_shard.close_order(bits, "cpu").numpy().astype(np.int64)


def bit_of(words, m):
    return ((words[m >> 5] >> (m & 31).astype(np.uint32)) & 1) == 1


def pull_layer(row, r, m, tab, live, fresh, full):
    """CTA r's destination masks ``m`` of one layer, a thread each: for
    each live slot a mask holds, T_i of the source's words (the mask
    without bit i, or the same mask in the rank-bit-clear partner CTA):
    from every source in the full mode, else where the source is dirty,
    or non-empty and i is fresh; a mask that gains is written and marked
    dirty and non-empty."""
    Wl, WL = row.Wl, tab.shape[0]
    held = (m | (r << Wl)) & live
    acc = np.zeros((row.Fl[r].shape[0], len(m)), np.uint32)
    for i in range(WL):
        on = ((held >> i) & 1) == 1
        if not on.any():
            continue
        if i < Wl:
            sr, sm = r, m ^ (1 << i)
        else:
            sr, sm = r ^ (1 << (i - Wl)), m
        act = on if full else on & (
            bit_of(row.DT[sr], sm)
            | (bool((fresh >> i) & 1) & bit_of(row.NZ[sr], sm)))
        y = np.where(act[None], row.Fl[sr][:, sm], np.uint32(0))
        acc |= np.where(act[None], image(y, tab[i]), np.uint32(0))
    x = row.Fl[r][:, m]
    gain = ((acc & ~x) != 0).any(0)
    row.Fl[r][:, m] = x | acc
    g = m[gain]
    b = np.left_shift(np.uint32(1), (g & 31).astype(np.uint32))
    np.bitwise_or.at(row.DT[r], g >> 5, b)
    np.bitwise_or.at(row.NZ[r], g >> 5, b)
    return bool(gain.any())


def sweep(row, tab, live, fresh):
    """The sweep by layers of masks: global layer k (masks of k bits) is
    local layer k - popcount(rank) on each CTA, ``order``'s entries in
    thread-stride order; every CTA's part of a layer before the next
    (the kernel's barrier)."""
    gained = False
    go = order(row.Wl)
    first = [0] * row.C
    count = [1] * row.C
    # The full mode, a CTA's: every slot fresh, or half its masks dirty.
    full = [fresh == live or 2 * int(np.unpackbits(
        row.DT[r].view(np.uint8)).sum()) >= row.Ml for r in range(row.C)]
    for k in range(tab.shape[0] + 1):
        for r in range(row.C):
            j = k - bin(r).count("1")
            if 0 <= j <= row.Wl:
                idx = first[r] + strided(count[r], row.threads)
                gained |= pull_layer(row, r, go[idx], tab, live, fresh,
                                     full[r])
                first[r] += count[r]
                count[r] = count[r] * (row.Wl - j) // (j + 1)
    return gained


def kept_from_nz(row, q, WL, d):
    """``kept`` from the non-empty flags, as the kernel reads them: each
    CTA's masks in thread-stride order, those with bit q (a local slot),
    or all of them on a CTA whose rank bit, or a shard whose top bit, q
    names."""
    Wl = WL - row.clog
    k = False
    for r in range(row.C):
        every = q >= Wl and bool((r >> (q - Wl)) & 1 if q < WL
                                 else (d >> (q - WL)) & 1)
        if q >= Wl and not every:
            continue
        m = strided(row.Ml, row.threads)
        nz = bit_of(row.NZ[r], m)
        k |= bool((nz & (every | (((m >> q) & 1) == 1))).any())
    return k


def model_close(F, recv, ev_type, ev_slot, ev_slots, target, valid, *, e,
                d, WL, W, V, first_round, clog=None, stats=None):
    """shard_close on the kernel's layout, with its signature; ``clog``
    forces a split over 2^clog CTAs (else ``close_plan``'s), ``stats``
    (a dict) gets whether each row swept. Returns (changed, kept) int32
    and updates F in place."""
    import torch
    F8 = np_(F).view(np.uint32)
    rows, NW, M = F8.shape
    typ, slot = np_(ev_type), np_(ev_slot)
    slots, tgt, vl = np_(ev_slots), np_(target), np_(valid)
    K1 = tgt.shape[-2]
    plan = cuda_shard.close_plan(WL, NW, rows)
    if clog is None:
        clog, threads = plan["clog"], plan["threads"]
    else:
        threads = 32 * min(cuda_shard.CLOSE_MAX_THREADS // 32,
                           max(1, (M >> clog) >> 5))
    recvs = [np_(r).view(np.uint32) for r in recv if r is not None]
    changed = np.zeros(rows, np.int32)
    kept = np.zeros(rows, np.int32)
    for b in range(rows):
        t = int(typ[b, e])
        if not vl[b] or t not in LIVE:
            continue
        kinds = [kind(slots, K1, b, e, i) for i in range(WL)]
        fresh = fresh_slots(typ, slot, slots, K1, b, e, WL, W) \
            if first_round else 0
        tab, live = stage(tgt, K1, V, NW, b, kinds)
        row = Row(F8[b], clog, threads)
        added = load(row, F8[b], [R[b] for R in recvs])
        nonempty = any(z.any() for z in row.NZ)
        fr = fresh & live
        grew = added
        swept = bool((fr and nonempty) or added)
        if swept:
            grew |= sweep(row, tab, live, fr)
        if stats is not None:
            stats.setdefault("swept", {})[b] = swept
        k = False
        if t != EV_CLOSE:
            q = min(max(int(slot[b, e]), 0), W - 1)
            k = kept_from_nz(row, q, WL, d)
        changed[b], kept[b] = int(added), int(k)
        if grew:
            for c in range(row.C):
                F8[b][:, c * row.Ml:(c + 1) * row.Ml] = row.Fl[c]
    return torch.from_numpy(changed), torch.from_numpy(kept)
