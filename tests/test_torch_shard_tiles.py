"""K3's ``shard_close`` (``jepsen_torch/ops/csrc/wgl_shard.cu``) on its own
layout, held bit for bit to its plain version ``plain_shard_close``, and
its launch plan ``cuda_shard.close_plan`` at the tiers' edges.

The CUDA kernel cannot run here, so ``tests/_shard_model.py`` models it
step for step: the slice over 1, 2, 4 or 8 CTAs (forced at local windows
1-10, so that slots on the CTA-rank bits run), the load a warp a 32-mask
group, the non-empty and dirty flags, the fresh slots found by scanning
back, the sweep by layers of masks in the threads' strides with pulls
across CTAs (flag-tested, or from every source in the full mode), and
"kept" from the flags.

* One shard's walk: seeded random slices and tables (one and two state
  words, shared and per-row tables, padding, invalid and empty rows),
  each event's first round, a later round with random received images,
  and the completion, the model against the plain version at every step.
* The three rows a broken form fails: a configuration that only a
  CTA-rank slot bit can reach, a mask that gains only after every other
  link of a chain (the last layer of the sweep), and a slot that is fresh
  only because an OK freed it.
* The fresh-slot rule against brute-force closures: from a slice as the
  previous live event's closure and completion leave it, closing from the
  fresh slots (and every slot from a mask that gains) gives the slice
  that closing under every live slot gives.
* The model through the port's walk (``frontier_sharded_kernel`` with
  ``ops=``) at forced clusters, against the single-device plain route.
* The plan at its edges: block, cluster and device tiers, bytes a CTA,
  CTAs a row, and enough CTAs to fill the card on the timing batch.

Tolerance: none.
"""
import numpy as np
import pytest
import torch

from _shard_model import fresh_slots, kind, model_close

from jepsen_torch.ops import cuda_shard as CS
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.encode import EV_CLOSE, EV_FUSED, EV_OK
from jepsen_torch.parallel import checker_mesh, frontier_sharded_kernel

torch.set_num_threads(1)

LIVE = (EV_OK, EV_FUSED, EV_CLOSE)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_case(seed, B, N, V, W, K1, shared):
    """Seeded tables and a first slice: event types with padding, slots
    in [-1, W - 1], kinds from a small vocabulary (so that kinds repeat
    between events), half the targets unreachable; row 0 all padding,
    row 1 invalid, row 2 an empty slice."""
    rng = np.random.default_rng(seed)
    ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
    ev_slot = rng.integers(-1, W, (B, N)).astype(np.int8)
    ev_slots = rng.integers(-1, K1 + 1, (B, N, W)).astype(np.int8)
    shape = (K1, V) if shared else (B, K1, V)
    target = rng.integers(-1, V, shape).astype(np.int32)
    target[rng.random(shape) < 0.5] = -1
    ev_type[0] = 0
    return ev_type, ev_slot, ev_slots, target, rng


def first_slice(rng, B, NW, M, V, density):
    F = np.zeros((B, NW, M), np.uint32)
    hit = rng.random((B, M)) < density
    for w in range(NW):
        bits = rng.integers(0, 1 << min(32, V - 32 * w), (B, M),
                            dtype=np.int64).astype(np.uint32)
        F[:, w] = np.where(hit, bits, 0)
    F[:, 0, 0] |= 1
    F[2] = 0
    return F


def assert_same(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------- one shard's walk

WALK_CASES = [  # (WL, clog, NW, shared target, top bits)
    (1, 0, 1, True, 1), (1, 1, 2, False, 1), (2, 2, 1, False, 2),
    (3, 3, 1, True, 1), (4, 1, 2, True, 2), (5, 0, 1, False, 1),
    (5, 2, 1, True, 1), (6, 1, 1, False, 2), (6, 3, 2, True, 1),
    (7, 2, 2, False, 1), (8, 0, 2, True, 1), (8, 3, 1, False, 2),
    (9, 1, 1, True, 1), (10, 2, 1, False, 1), (10, 3, 2, True, 2),
    (10, 0, 1, True, 1)]


@pytest.mark.parametrize("WL,clog,NW,shared,k", WALK_CASES)
def test_close_model_matches_plain_on_a_walk(WL, clog, NW, shared, k):
    """Each event of a random one-shard walk: the first round, a later
    round with random images received for every top bit, and the plain
    completion; the model (slice over 2^clog CTAs) and the plain
    version from the same slice, every output bit for bit."""
    W, V, K1, B, N = WL + k, (12 if NW == 1 else 36), 4, 5, 7
    for d in (0, (1 << k) - 1):
        ev_type, ev_slot, ev_slots, target, rng = random_case(
            1000 * WL + 10 * clog + d, B, N, V, W, K1, shared)
        F = first_slice(rng, B, NW, 1 << WL, V, 0.04)
        valid = np.ones(B, bool)
        valid[1] = False
        bad = np.full(B, 2 ** 31 - 1, np.int32)
        ev = (t(ev_type), t(ev_slot), t(ev_slots), t(target))
        Ft, vt, bt = t(F.view(np.int32)), t(valid), t(bad)
        for e in range(N):
            geo = dict(e=e, d=d, WL=WL, W=W, V=V)
            for rnd in range(2):
                recv = [None] * k
                if rnd:
                    recv = [t(first_slice(rng, B, NW, 1 << WL, V, 0.02)
                              .view(np.int32)) for _ in range(k)]
                Fm = Ft.clone()
                want = CS.plain_shard_close(Ft, recv, *ev, vt,
                                            first_round=rnd == 0, **geo)
                got = model_close(Fm, recv, *ev, vt, first_round=rnd == 0,
                                  clog=clog, **geo)
                assert_same(got, want)
                assert torch.equal(Fm, Ft), (e, rnd)
            nonempty = want[1] | t(np.arange(B, dtype=np.int32) % 2)
            CS.plain_shard_commit(Ft, torch.zeros_like(Ft), [None] * k,
                                  *ev, vt, bt, nonempty, idx=e, **geo)


def test_close_model_plan_tiers_on_random_slices():
    """The model at the plan's own tiers (no forced split) on random
    first-event slices, WL 14-16 at one word."""
    for WL in (14, 15, 16):
        V, K1, B, N, W = 6, 3, 3, 1, WL
        ev_type, ev_slot, ev_slots, target, rng = random_case(
            WL, B, N, V, W, K1, True)
        ev_type[:] = EV_OK
        F = first_slice(rng, B, 1, 1 << WL, V, 0.002)
        ev = (t(ev_type), t(ev_slot), t(ev_slots), t(target))
        Ft = t(F.view(np.int32))
        Fm = Ft.clone()
        geo = dict(e=0, d=0, WL=WL, W=W, V=V, first_round=True)
        want = CS.plain_shard_close(Ft, [], *ev, t(np.ones(B, bool)), **geo)
        got = model_close(Fm, [], *ev, t(np.ones(B, bool)), **geo)
        assert_same(got, want)
        assert torch.equal(Fm, Ft)


# ------------------------------------------- the rows a broken form fails

def one_row(N, W, K1, V):
    ev_type = np.full((1, N), EV_OK, np.int8)
    ev_slot = np.zeros((1, N), np.int8)
    ev_slots = np.full((1, N, W), K1 - 1, np.int8)   # kind K1-1: no moves
    target = np.full((K1, V), -1, np.int32)
    return ev_type, ev_slot, ev_slots, target


def run_both(F, ev, e, WL, W, V, clog, first_round=True):
    Ft = t(F.view(np.int32))
    Fm = Ft.clone()
    vt = t(np.ones(F.shape[0], bool))
    geo = dict(e=e, d=0, WL=WL, W=W, V=V, first_round=first_round)
    evt = tuple(t(a) for a in ev)
    want = CS.plain_shard_close(Ft, [], *evt, vt, **geo)
    stats = {}
    got = model_close(Fm, [], *evt, vt, clog=clog, stats=stats, **geo)
    assert_same(got, want)
    assert torch.equal(Fm, Ft)
    return Ft.numpy().view(np.uint32), stats


@pytest.mark.parametrize("WL,clog", [(1, 1), (6, 1), (6, 2), (6, 3),
                                     (9, 3)])
def test_row_crossing_only_a_rank_bit(WL, clog):
    """Only slot WL - 1, the CTA split's top rank bit, moves a config:
    the closure lands in the partner CTA's slice and nowhere else."""
    V, K1 = 4, 3
    ev_type, ev_slot, ev_slots, target = one_row(1, WL, K1, V)
    ev_slots[0, 0, WL - 1] = 0
    target[0, 0] = 1
    ev_slot[0, 0] = WL - 1
    F = np.zeros((1, 1, 1 << WL), np.uint32)
    F[0, 0, 0] = 1
    out, _ = run_both(F, (ev_type, ev_slot, ev_slots, target), 0, WL, WL,
                      V, clog)
    want = np.zeros(1 << WL, np.uint32)
    want[0], want[1 << (WL - 1)] = 1, 2
    np.testing.assert_array_equal(out[0, 0], want)


@pytest.mark.parametrize("WL,clog", [(4, 0), (6, 2), (8, 3), (10, 1)])
def test_row_gaining_only_late(WL, clog):
    """A chain down the slots: slot j takes state WL-1-j to WL-j, so the
    full mask gains only after every other link: in pass WL of an
    in-order slot sweep, in the last layer of the kernel's sweep by
    layers. A form that stops early, or takes the layers out of order,
    misses it."""
    V, K1 = WL + 2, WL + 1
    ev_type, ev_slot, ev_slots, target = one_row(1, WL, K1, V)
    for j in range(WL):
        ev_slots[0, 0, j] = j
        target[j, WL - 1 - j] = WL - j
    ev_type[0, 0] = EV_CLOSE
    F = np.zeros((1, 1, 1 << WL), np.uint32)
    F[0, 0, 0] = 1
    out, stats = run_both(F, (ev_type, ev_slot, ev_slots, target), 0, WL,
                          WL, V, clog)
    want = np.zeros(1 << WL, np.uint32)
    chain = 0
    want[0] = 1
    for j in range(WL):
        chain |= 1 << (WL - 1 - j)
        want[chain] = 1 << (j + 1)
    np.testing.assert_array_equal(out[0, 0], want)
    assert stats["swept"][0]


@pytest.mark.parametrize("WL,clog", [(3, 0), (6, 1), (7, 3)])
def test_row_fresh_only_by_a_freed_slot(WL, clog):
    """Event 0 closes under slot 1 (state 0 -> 1 -> 2) and completes on
    it; event 1 has the same kinds, so slot 1 is fresh only because the
    OK freed it. The closure must take (0, s1) to (2, s2); a form that
    missed the freed slot would keep the frontier as it was."""
    V, K1, q = 4, 2, 1
    ev_type, ev_slot, ev_slots, target = one_row(2, WL, K1, V)
    ev_slots[0, :, q] = 0
    target[0, 0], target[0, 1] = 1, 2
    ev_slot[0, :] = q
    ev = (ev_type, ev_slot, ev_slots, target)
    F = np.zeros((1, 1, 1 << WL), np.uint32)
    F[0, 0, 0] = 1
    out, _ = run_both(F, ev, 0, WL, WL, V, clog)
    Ft = t(out.view(np.int32).copy())
    evt = tuple(t(a) for a in ev)
    vt, bt = t(np.ones(1, bool)), t(np.zeros(1, np.int32))
    CS.plain_shard_commit(Ft, torch.zeros_like(Ft), [], *evt, vt, bt,
                          t(np.ones(1, np.int32)), e=0, idx=0, d=0, WL=WL,
                          W=WL, V=V)
    before = Ft.numpy().view(np.uint32).copy()
    assert before[0, 0, 0] == 2 and not before[0, 0, 1:].any()
    assert fresh_slots(ev_type, ev_slot, ev_slots, K1, 0, 1, WL, WL) \
        == 1 << q
    out, _ = run_both(before.copy(), ev, 1, WL, WL, V, clog)
    assert out[0, 0, 1 << q] == 4
    assert not np.array_equal(out, before)


# ------------------------------------ the fresh rule against brute force

def onehot(target, V, NW, row, kinds):
    """Each slot's [V, NW] packed one-hot target rows, and the live mask
    (slots whose row reaches a state)."""
    t = target if target.ndim == 2 else target[row]
    tabs, live = [], 0
    for i, k in enumerate(kinds):
        tab = np.zeros((V, NW), np.uint32)
        for s, to in enumerate(t[k]):
            if to >= 0:
                tab[s, to >> 5] = np.uint32(1 << (int(to) & 31))
                live |= 1 << i
        tabs.append(tab)
    return tabs, live


def brute(F, tabs, slots, from_all):
    """A closure of one row's slice F [NW, M] (a copy): slot i pushes
    T_i(F[m]) into F[m | 2^i] from every mask when i is in ``from_all``,
    else only from masks that gained; rounds until nothing changes."""
    F = F.copy()
    NW, M = F.shape
    gained = np.zeros(M, bool)
    while True:
        before = F.copy()
        for i in range(len(tabs)):
            if not (slots >> i) & 1:
                continue
            tab = tabs[i]
            for m in range(M):
                if m >> i & 1 or not F[:, m].any():
                    continue
                if not ((from_all >> i) & 1 or gained[m]):
                    continue
                img = np.zeros(NW, np.uint32)
                for s in range(tab.shape[0]):
                    if F[s // 32, m] >> np.uint32(s % 32) & 1:
                        img |= tab[s]
                new = F[:, m | 1 << i] | img
                if (new != F[:, m | 1 << i]).any():
                    gained[m | 1 << i] = True
                    F[:, m | 1 << i] = new
        if np.array_equal(before, F):
            return F


@pytest.mark.parametrize("seed", range(6))
def test_fresh_rule_matches_full_closure(seed):
    """On a walk over one unsharded window (plain closes and
    completions), at each live event but a row's first: the brute-force
    closure from the fresh slots equals the one from every live slot."""
    WL, V, K1, B, N = 3 + seed % 3, 6 + 30 * (seed % 2), 3, 4, 9
    NW = (V + 31) // 32
    ev_type, ev_slot, ev_slots, target, rng = random_case(
        77 + seed, B, N, V, WL, K1, seed % 2 == 0)
    F = t(first_slice(rng, B, NW, 1 << WL, V, 0.2).view(np.int32))
    ev = (t(ev_type), t(ev_slot), t(ev_slots), t(target))
    valid = t(np.ones(B, bool))
    bad = t(np.zeros(B, np.int32))
    checked = 0
    for e in range(N):
        geo = dict(e=e, d=0, WL=WL, W=WL, V=V)
        for b in range(B):
            if not bool(valid[b]) or int(ev_type[b, e]) not in LIVE:
                continue
            fresh = fresh_slots(ev_type, ev_slot, ev_slots, K1, b, e, WL,
                                WL)
            if fresh == (1 << WL) - 1:
                continue
            tabs, live = onehot(target, V, NW, b, [
                kind(ev_slots, K1, b, e, i) for i in range(WL)])
            Fb = F[b].numpy().view(np.uint32)
            np.testing.assert_array_equal(
                brute(Fb, tabs, live, fresh & live),
                brute(Fb, tabs, live, live))
            checked += 1
        kept = CS.plain_shard_close(F, [], *ev, valid, first_round=True,
                                    **geo)[1]
        CS.plain_shard_commit(F, torch.zeros_like(F), [], *ev, valid, bad,
                              kept | 1, idx=e, **geo)
    assert checked > 0


# --------------------------------------------- the model through the walk

@pytest.mark.parametrize("D,WL,clog,NW", [(2, 4, 2, 1), (4, 6, 3, 2),
                                          (2, 8, 1, 1), (8, 5, 2, 1)])
def test_walk_through_model_at_forced_clusters(D, WL, clog, NW):
    """The port's walk with the model as its close (split over 2^clog
    CTAs) against the single-device plain route, on seeded tables."""
    W = WL + D.bit_length() - 1
    V, K1, B, N = (8 if NW == 1 else 40), 4, 4, 10
    ev_type, ev_slot, ev_slots, target, _ = random_case(
        31 * D + WL, B, N, V, W, K1, False)
    args = (ev_type, ev_slot, ev_slots, target)

    def close(*a, **kw):
        return model_close(*a, clog=clog, **kw)
    ops = {"shard_close": close, "shard_image": CS.plain_shard_image,
           "shard_commit": CS.plain_shard_commit}
    mesh = checker_mesh(1, D, devices=[torch.device("cpu")] * 8)
    got = frontier_sharded_kernel(V, W, mesh)(*args, ops=ops)
    want = L.get_kernel(V, W)(*(t(a) for a in args))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("WL,NW,rows,tier,ctas", [
    (13, 1, 64, "block", 1), (13, 2, 64, "block", 1),
    (14, 1, 1, "cluster", 2), (14, 2, 64, "cluster", 2),
    (14, 1, 528, "block", 1), (15, 1, 8, "cluster", 4),
    (15, 1, 528, "block", 1), (15, 2, 1, "cluster", 4),
    (15, 2, 528, "cluster", 2), (16, 1, 64, "cluster", 8),
    (16, 1, 132, "cluster", 4), (16, 2, 64, "cluster", 8),
    (16, 2, 264, "cluster", 4), (17, 1, 1, "cluster", 8),
    (17, 2, 64, "cluster", 8), (18, 1, 8, "cluster", 8),
    (18, 2, 64, "device", 1), (1, 1, 1, "block", 1),
    (5, 2, 8, "block", 1)])
def test_close_plan_at_its_edges(WL, NW, rows, tier, ctas):
    p = CS.close_plan(WL, NW, rows)
    assert (p["tier"], p["ctas"]) == (tier, ctas)
    assert p["smem_bytes"] <= CS.SMEM_LIMIT_BYTES < 227 * 1024
    assert p["ctas"] <= 8 and p["ctas_launched"] == rows * ctas
    assert 32 <= p["threads"] <= CS.CLOSE_MAX_THREADS
    assert p["smem_bytes"] == 4 * CS.close_smem_words(
        WL, p["clog"], NW, 32 * NW, tier != "device")
    if tier != "device":
        assert p["masks_per_cta"] * p["ctas"] == 1 << WL
        # The fewest CTAs that hold the slice, or more to fill the card.
        fit = min(c for c in range(min(WL, 3) + 1)
                  if 4 * CS.close_smem_words(
            WL, c, NW, 32 * NW, True) <= CS.SMEM_LIMIT_BYTES)
        assert p["clog"] == fit or (
            rows << (p["clog"] - 1) < CS.CLOSE_FILL_CTAS
            and p["masks_per_cta"] >= CS.CLOSE_SPLIT_MASKS)
    else:
        assert 4 * CS.close_smem_words(WL, 3, NW, 32 * NW, True) \
            > CS.SMEM_LIMIT_BYTES


def test_close_plan_fills_the_card_on_the_timing_batch():
    """The wide W 17 specs' launches: 64 rows of a 2^16-mask slice at one
    word take at least as many CTAs as the card has SMs."""
    p = CS.close_plan(16, 1, 64)
    assert p["ctas_launched"] >= CS.CARD_SMS == 132
    for NW in (1, 2):
        for WL in range(1, CS.MAX_W_LOCAL + 1):
            for rows in (1, 2, 8, 64, 256):
                q = CS.close_plan(WL, NW, rows)
                assert q["smem_bytes"] <= CS.SMEM_LIMIT_BYTES
                assert q["ctas"] in (1, 2, 4, 8)
