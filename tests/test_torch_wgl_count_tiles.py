"""K2 instrument's counting bodies (``wgl_count_walk`` and
``wgl_count_block_kernel`` in ``jepsen_torch/ops/csrc/wgl_frontier.cu``),
modelled in numpy on the kernel's own layout and held bit for bit to the
plain version ``plain_wgl(iters=)`` and to the reference's
``make_kernel(instrument=True)`` (jax on the CPU): valid, bad, the
frontier and each row's closure passes.

The CUDA kernel cannot run here, so its two tiers are modelled step for
step:

* the warp tier (W <= 8): a row on 32 lanes, lane l holding masks
  l + 32j (j < 2^W / 32, at least one) as registers; slots 0..4 step by
  an xor-partner shuffle, slots 5..7 by a register move j ^ 2^(i-5);
  events in 32-event tiles, the tile's pads whose slots reach no state
  counted by a ballot, the rest walked in order;
* the block tier (W > 8): a row on T = min(2^W, 1024) threads, thread
  t holding masks t + T j; a slot bit below 5 names a lane of the same
  warp, a bit below log2(T) a thread of another warp, a bit above it
  another mask j of the same thread.

A closure steps the live slots in order, in place, and counts passes up
to the first that changes nothing. A slot is stepped only while it is
dirty: its kind differs from the one the frontier was last closed under
(or it was freed by a completion), or another slot's step changed the
frontier since its own last step. A clean slot's step changes nothing,
so the frontiers and the count are the reference's.

Hand-built rows (``chip_smoke.count_edge_rows``, loaded by its path)
tell the reference's count from the counts a broken body would give:
one that steps every slot at once from the pass's first frontier, one
that skips pads, and one that stops counting at a row's failure.

Tolerance: none.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import linearize as ref

from jepsen_torch.ops import cuda_wgl
from jepsen_torch.ops import linearize as L

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
INT32_MAX = 2**31 - 1
EV_OK, EV_CLOSE, EV_FUSED = 2, 3, 4


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the table

class Table:
    """One row's transition table as the kernel stages it: nibble images
    (V <= 8 at one state word), int8 targets, or the int32 table read in
    place, with a reach flag per kind (None when read in place: every
    slot counts live)."""

    def __init__(self, tg, V, form):
        self.V, self.NW, self.form = V, (V + 31) // 32, form
        K1 = tg.shape[0]
        packed = np.where((tg >= 0) & (tg < 32 * self.NW), tg, -1)
        self.targets = packed if form != "device" else np.where(
            tg < 32 * self.NW, tg, -1)
        self.reach = None if form == "device" else (packed >= 0).any(1)
        if form == "nibble":
            nib = np.zeros((K1, 32), np.uint64)
            for x in range(32):
                n, v = x >> 4, x & 15
                for b in range(4):
                    s = 4 * n + b
                    if s < V and (v >> b) & 1:
                        to = packed[:, s]
                        nib[:, x] |= np.where(
                            to >= 0, np.uint64(1) << np.maximum(
                                to, 0).astype(np.uint64), np.uint64(0))
            self.nib = nib
        self.vmask = np.uint64((1 << V) - 1) if V < 64 else np.uint64(
            2**64 - 1)

    def live(self, k):
        return True if self.reach is None else bool(self.reach[k])

    def image(self, k, x):
        """T_k of each configuration word of x (uint64, states < V)."""
        y = x & self.vmask
        if self.form == "nibble":
            return (self.nib[k][(y & np.uint64(15)).astype(np.int64)]
                    | self.nib[k][16 + (y >> np.uint64(4)).astype(
                        np.int64)])
        acc = np.zeros_like(y)
        for s in range(self.V):
            to = int(self.targets[k, s])
            if to >= 0:
                acc |= ((y >> np.uint64(s)) & np.uint64(1)) << np.uint64(to)
        return acc


# ------------------------------------------------------------ the models

class Broken:
    """Flags for the broken bodies the hand-built rows must catch, and
    ``dense``, a body that is not broken but steps every live slot in
    every pass (no clean skip)."""

    def __init__(self, at_once=False, skip_pads=False, stop_at_fail=False,
                 dense=False):
        self.at_once, self.skip_pads = at_once, skip_pads
        self.stop_at_fail, self.dense = stop_at_fail, dense


FINE = Broken()


class WarpFrontier:
    """The warp tier's registers: x[lane, j] holds mask lane + 32 j."""

    def __init__(self, F, W):
        self.W, M = W, 1 << W
        self.mpl = max(1, M // 32)
        m = np.arange(32)[:, None] + 32 * np.arange(self.mpl)[None, :]
        self.x = np.where(m < M, F[np.minimum(m, M - 1)], np.uint64(0))

    def masks(self):
        return np.arange(32)[:, None] + 32 * np.arange(self.mpl)[None, :]

    def step(self, t, k, i, src):
        """Slot i's step, its sources read from ``src`` (the frontier
        itself when stepping in place); returns "something changed"."""
        x = self.x
        if i < 5:
            bit = 1 << i
            lanes = np.arange(32)
            up = (lanes & bit) != 0
            partner = src[lanes ^ bit]                      # the shuffle
            n = t.image(k, np.where(up[:, None], partner, np.uint64(0)))
        else:
            jb = 1 << (i - 5)
            j = np.arange(self.mpl)
            up = (j & jb) != 0
            partner = src[:, j ^ jb]                        # a register move
            n = np.where(up[None, :], t.image(k, partner), np.uint64(0))
        add = n & ~x
        x |= add
        return bool(add.any())

    def copy(self):
        c = WarpFrontier.__new__(WarpFrontier)
        c.W, c.mpl, c.x = self.W, self.mpl, self.x.copy()
        return c

    def any_with(self, q):
        return bool(((self.masks() >> q) & 1).astype(bool)[
            self.x != 0].any())

    def complete(self, q):
        if q < 5:
            bit = 1 << q
            lanes = np.arange(32)
            up = (lanes & bit) != 0
            moved = self.x[lanes ^ bit]
            self.x = np.where(up[:, None], np.uint64(0), moved)
        else:
            jb = 1 << (q - 5)
            j = np.arange(self.mpl)
            up = (j & jb) != 0
            self.x = np.where(up[None, :], np.uint64(0), self.x[:, j ^ jb])

    def dense(self, M):
        out = np.zeros(M, np.uint64)
        m = self.masks()
        out[m[m < M]] = self.x[m < M]
        return out

    def clear(self):
        self.x[:] = 0


class BlockFrontier:
    """The block tier's masks: x[t, j] holds mask t + T j of T threads."""

    def __init__(self, F, W):
        self.W, M = W, 1 << W
        self.T = min(M, 1024)
        self.J = M // self.T
        self.x = F.reshape(self.J, self.T).T.copy()

    def step(self, t, k, i, src):
        bit = 1 << i
        T, J = self.T, self.J
        tid = np.arange(T)[:, None]
        j = np.arange(J)[None, :]
        if bit < 32:            # another lane of the warp
            partner = src[(tid ^ bit).ravel()]
            up = np.broadcast_to((tid & bit) != 0, (T, J))
        elif bit < T:           # a thread of another warp
            assert ((tid ^ bit) >> 5 != tid >> 5).all()
            partner = src[(tid ^ bit).ravel()]
            up = np.broadcast_to((tid & bit) != 0, (T, J))
        else:                   # another mask of the same thread
            jb = bit // T
            partner = src[:, (j ^ jb).ravel()]
            up = np.broadcast_to((j & jb) != 0, (T, J))
        n = np.where(up, t.image(k, partner), np.uint64(0))
        add = n & ~self.x
        self.x |= add
        return bool(add.any())

    def copy(self):
        c = BlockFrontier.__new__(BlockFrontier)
        c.W, c.T, c.J, c.x = self.W, self.T, self.J, self.x.copy()
        return c

    def masks(self):
        return np.arange(self.T)[:, None] + self.T * np.arange(
            self.J)[None, :]

    def any_with(self, q):
        return bool(((self.masks() >> q) & 1).astype(bool)[
            self.x != 0].any())

    def complete(self, q):
        d = self.dense(1 << self.W)
        m = np.arange(1 << self.W)
        qb = 1 << q
        d = np.where(m & qb, np.uint64(0), d[m | qb])
        self.x = d.reshape(self.J, self.T).T.copy()

    def dense(self, M):
        return self.x.T.reshape(M).copy()

    def clear(self):
        self.x[:] = 0


def closure(fr, t, kinds, live, dirty, broken):
    """One counted closure of frontier fr in place: slots stepped in
    order while dirty, passes up to the first that changes nothing."""
    passes = 0
    skip = not (broken.at_once or broken.dense)
    while True:
        start = fr.x.copy() if broken.at_once else None
        ch_pass = False
        for i in range(len(kinds)):
            if not (live >> i) & 1 or (skip and not (dirty >> i) & 1):
                continue
            ch = fr.step(t, kinds[i], i, start if broken.at_once else fr.x)
            dirty &= ~(1 << i)
            if ch:
                dirty |= live & ~(1 << i)
            ch_pass |= ch
        passes += 1
        if not ch_pass:
            return passes


def walk_row(ev_type, ev_slot, ev_slots, t, F, Fb, valid, bad, idx0, W, WL,
             K1, tiles, broken=FINE):
    """One row's walk by a counting body: ``tiles`` models the warp tier
    (32-event tiles, quiet pads counted per tile), else the block tier.
    Returns (valid, bad, F, Fb, passes)."""
    N, M = len(ev_type), 1 << W
    fr = (WarpFrontier if W <= cuda_wgl.W_WARP else BlockFrontier)(F, W)
    Fb = Fb.copy()
    ok, first_bad, passes = bool(valid), int(bad), 0
    closed = [-1] * WL         # the kind each slot's closure holds under
    kinds_all = ev_slots[:, :WL].astype(np.int64)
    kinds_all = np.clip(np.where(kinds_all < 0, kinds_all + K1, kinds_all),
                        0, K1 - 1)
    step = 32 if tiles else 1
    for e0 in range(0, N, step):
        ev = range(e0, min(e0 + step, N))
        live_ev = [int(ev_type[e]) in (EV_OK, EV_CLOSE, EV_FUSED) for e in ev]
        live_sl = [sum(1 << i for i in range(WL) if t.live(kinds_all[e, i]))
                   for e in ev]
        quiet = [not a and not b for a, b in zip(live_ev, live_sl)]
        if not broken.skip_pads:
            passes += sum(quiet)
        for j, e in enumerate(ev):
            if quiet[j]:
                continue
            if not live_ev[j] and broken.skip_pads:
                continue
            kinds = list(kinds_all[e])
            live = live_sl[j]
            dirty = sum(1 << i for i in range(WL) if kinds[i] != closed[i])
            x = fr.copy()
            passes += closure(x, t, kinds, live, dirty, broken)
            if not live_ev[j]:
                continue                      # a pad's closure is dropped
            fr, closed = x, kinds
            if int(ev_type[e]) == EV_CLOSE:
                continue
            q = min(max(int(np.int8(ev_slot[e])), 0), WL - 1)
            if fr.any_with(q):
                fr.complete(q)
                closed = closed[:q] + [-1] + closed[q + 1:]
                continue
            if ok:
                Fb = fr.dense(M)
            fr.clear()
            ok, first_bad = False, min(first_bad, idx0 + e)
            if not broken.stop_at_fail:
                passes += N - 1 - e - (sum(quiet[j + 1:])
                                       if not broken.skip_pads else 0)
            return ok, first_bad, fr.dense(M), Fb, passes
    return ok, first_bad, fr.dense(M), Fb, passes


def model(ev_type, ev_slot, ev_slots, target, V, W, w_live=None, form=None,
          broken=FINE):
    """The counting bodies over a batch from a fresh carry, the tier and
    table form as the instrumented plan picks them (``form`` forces the
    table form). Returns (valid, bad, frontier, passes) as
    make_kernel(instrument=True) does."""
    B, N = ev_type.shape
    NW, M = (V + 31) // 32, 1 << W
    WL = W if w_live is None else max(1, min(w_live, W))
    shared = target.ndim == 2
    K1 = target.shape[-2]
    plan = cuda_wgl.smem_plan(V, W, WL, K1=K1, shared_target=shared,
                              instrument=True)
    form = plan["table_form"] if form is None else form
    valid = np.zeros(B, bool)
    bad = np.zeros(B, np.int32)
    front = np.zeros((B, NW, M), np.uint32)
    passes = np.zeros(B, np.int32)
    for r in range(B):
        t = Table(target if shared else target[r], V, form)
        F = np.zeros(M, np.uint64)
        F[0] = 1
        ok, bd, Fr, Fb, n = walk_row(
            ev_type[r], ev_slot[r], ev_slots[r], t, F, np.zeros(M, np.uint64),
            True, INT32_MAX, 0, W, WL, K1, W <= cuda_wgl.W_WARP, broken)
        out = Fr if ok else Fb
        for w in range(NW):
            front[r, w] = ((out >> np.uint64(32 * w))
                           & np.uint64(0xffffffff)).astype(np.uint32)
        valid[r], bad[r], passes[r] = ok, bd, n
    return valid, bad, front, passes


# ------------------------------------------------------------ the yardsticks

def reference(args, V, W, w_live=None):
    kern = ref.make_kernel(V, W, w_live=w_live, instrument=True)
    shared = args[3].ndim == 2
    out = jax.jit(jax.vmap(kern, in_axes=(0, 0, 0, None if shared else 0)))(
        *args)
    return tuple(np.asarray(o) for o in out)


def plain(args, V, W, w_live=None):
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    v, b, f, it = L.get_kernel(V, W, w_live=w_live, instrument=True)(*ts)
    return v.numpy(), b.numpy(), f.numpy().view(np.uint32), it.numpy()


def assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def random_rows(seed, B, N, V, W, w_live, K1, shared):
    """Seeded random tables: every event code, slot and kind indices past
    both ends (they clamp and wrap), pads carrying live kinds, half the
    table's entries inconsistent so that rows both fail and survive; row
    0 all pads, row 1 one live event at the end of the first tile, the
    last row failing at its first event (it completes a slot whose kind
    reaches no state)."""
    rng = np.random.default_rng(seed)
    ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
    ev_type[0] = 0
    if B > 1 and N > 31:
        ev_type[1] = 0
        ev_type[1, 31] = EV_OK
    ev_slot = rng.integers(-1, W + 1, (B, N)).astype(np.int8)
    ev_slots = rng.integers(-1, K1 + 1, (B, N, W))
    q = np.clip(ev_slot, 0, (w_live or W) - 1).astype(np.int64)
    ev_slots[np.arange(B)[:, None], np.arange(N)[None], q] = rng.integers(
        0, K1 - 1, (B, N))
    ev_slots = ev_slots.astype(np.int8 if K1 < 127 else np.int32)
    shape = (K1, V) if shared else (B, K1, V)
    target = rng.integers(-1, V, shape).astype(np.int32)
    target[rng.random(shape) < 0.5] = -1
    target[..., K1 - 1, :] = -1
    ev_type[-1, 0], ev_slot[-1, 0], ev_slots[-1, 0] = EV_OK, 0, K1 - 1
    return ev_type, ev_slot, ev_slots, target


# (V, W, w_live, K1, shared target, rows, events): the warp tier at one to
# eight masks a lane, the block tier at one to several masks a thread,
# one and two state words (V 1, 8, 33, 64), w_live < W, int8 and int32
# slot tables (K1 >= 127), shared and per-row targets.
CASES = {
    "w1_v1": (1, 1, None, 3, True, 6, 40),
    "w3_v8_rows": (8, 3, None, 5, False, 8, 40),
    "w5_v8_mpl1": (8, 5, None, 7, True, 8, 70),
    "w5_v64_wl3_int32": (64, 5, 3, 200, False, 6, 40),
    "w6_v8_mpl2": (8, 6, 4, 7, False, 6, 40),
    "w6_v33_mpl2": (33, 6, None, 9, True, 6, 40),
    "w7_v8_mpl4": (8, 7, None, 9, True, 6, 40),
    "w7_v64_mpl4": (64, 7, 6, 9, False, 4, 40),
    "w8_v8_mpl8": (8, 8, None, 12, False, 6, 40),
    "w8_v40_mpl8_int32": (40, 8, 6, 130, True, 4, 40),
    "w9_v8_block": (8, 9, 6, 12, False, 3, 40),
    "w10_v33_block": (33, 10, None, 9, True, 3, 36),
    "w11_v8_block": (8, 11, 5, 9, False, 2, 36),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_plain_and_reference(case):
    V, W, wl, K1, shared, B, N = CASES[case]
    args = random_rows(sum(map(ord, case)), B, N, V, W, wl, K1, shared)
    got = model(*args, V, W, wl)
    want = plain(args, V, W, wl)
    assert_same(got, want)
    assert_same(got, reference(args, V, W, wl))
    assert (~got[0]).any() and got[0][0]      # a row fails; the pad row not


@pytest.mark.parametrize("form", ["nibble", "int8", "device"])
def test_model_table_forms(form):
    """Every staged form of the table gives the same count: nibble
    images, int8 targets, the table in device memory (every slot live)."""
    args = random_rows(5, 6, 40, 8, 6, None, 9, True)
    assert_same(model(*args, 8, 6, form=form), plain(args, 8, 6))
    args = random_rows(6, 2, 36, 8, 10, None, 9, False)
    assert_same(model(*args, 8, 10, form=form), plain(args, 8, 10))


def test_block_layout_classes():
    """The block tier's slot bits: 0..4 a lane of the warp, 5 ..
    log2(T) - 1 another warp, the rest another mask of the thread."""
    for W in (9, 10, 12, 14, 16):
        T = min(1 << W, 1024)
        tid = np.arange(T)
        for i in range(W):
            bit = 1 << i
            if bit < 32:
                assert ((tid ^ bit) >> 5 == tid >> 5).all()
            elif bit < T:
                assert ((tid ^ bit) >> 5 != tid >> 5).all()
            else:
                assert bit % T == 0


# ------------------------------------------------------------ hand rows

BROKEN = {"at_once": Broken(at_once=True),
          "skip_pads": Broken(skip_pads=True),
          "stop_at_fail": Broken(stop_at_fail=True)}


@pytest.mark.parametrize("W", [5, 8, 9, 12])
def test_hand_rows_tell_the_schedule(W):
    """The hand-built rows: the model and the plain version give the
    reference's count and the expected one, and each broken body misses
    it on some row."""
    cs = chip_smoke()
    rows = cs.count_edge_rows(W)
    args = tuple(np.asarray(a) for a in rows["args"])
    V = rows["V"]
    want = reference(args, V, W)
    assert_same(plain(args, V, W), want)
    got = model(*args, V, W)
    assert_same(got, want)
    np.testing.assert_array_equal(got[3], rows["passes"])
    for name, broken in BROKEN.items():
        wrong = model(*args, V, W, broken=broken)
        assert (wrong[3] != want[3]).any(), name


def test_clean_slots_are_skipped_exactly():
    """Stepping every live slot every pass (no clean skip) counts the
    same passes: a clean slot's step changes nothing."""
    args = random_rows(9, 6, 40, 8, 7, None, 9, False)
    got = model(*args, 8, 7, broken=Broken(dense=True))
    assert_same(got, model(*args, 8, 7))
    assert_same(got, plain(args, 8, 7))
