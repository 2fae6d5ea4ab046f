"""The port's WGL step (jepsen_torch.ops.linearize) against the reference.

The same inputs — buckets from the reference encoder over seeded
corpora, and seeded random event tables — go through
``jax.vmap(jepsen_tpu.ops.linearize.make_kernel(V, W))`` and through the
port's plain PyTorch version on the CPU (the CUDA kernel's yardstick;
the kernel itself is held against it on the card by chip_smoke.py).
Tolerance: none — valid, bad and the packed frontier viewed as uint32
must be bit-identical.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.linearizable import prepare_history
from jepsen_tpu.models.core import cas_register
from jepsen_tpu.ops import linearize as ref
from jepsen_tpu.ops import pallas_wgl
from jepsen_tpu.ops.encode import bucket_encode
from jepsen_tpu.workloads.synth import synth_cas_batch, synth_rw_history

from jepsen_torch.convert import batch_from_arrays
from jepsen_torch.ops import cuda_wgl
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.schedule import BucketScheduler

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def ref_kernel(V, W, shared, w_live=None, resume=False):
    kern = ref.make_kernel(V, W, w_live=w_live, resume=resume)
    t_ax = None if shared else 0
    if resume:
        return jax.jit(jax.vmap(kern, in_axes=(0, 0, 0, t_ax,
                                               None, 0, 0, 0, 0)))
    return jax.jit(jax.vmap(kern, in_axes=(0, 0, 0, t_ax)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_check(ev_type, ev_slot, ev_slots, target, V, W, w_live=None):
    v, b, f = L.get_kernel(V, W, w_live=w_live)(
        t(ev_type), t(ev_slot), t(ev_slots), t(target))
    return v.numpy(), b.numpy(), f.numpy().view(np.uint32)


def assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def ref_buckets(n, seed0, **kw):
    hists = synth_cas_batch(n, seed0=seed0, **kw)
    return [b for b in bucket_encode(cas_register(),
                                     [prepare_history(h) for h in hists],
                                     max_states=64, max_slots=16)
            if b.batch]


CORPORA = {
    # test_linearize_tpu.py::test_random_parity_sweep's corpus
    "sweep": dict(n=60, seed0=7, n_procs=4, n_ops=18, n_values=3,
                  corrupt=0.2, p_info=0.12),
    # two state words: V = 40 (not a multiple of 32)
    "two_words": dict(n=4, seed0=5, n_procs=4, n_ops=200, n_values=48,
                      corrupt=0.25),
    # info-heavy: wider pending windows, pinned slots
    "info": dict(n=12, seed0=31, n_procs=6, n_ops=24, n_values=4,
                 corrupt=0.3, p_info=0.3),
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_plain_matches_make_kernel_on_encoded_buckets(corpus):
    buckets = ref_buckets(**CORPORA[corpus])
    invalid = 0
    for b in buckets:
        want = ref_kernel(b.V, b.W, False)(b.ev_type, b.ev_slot,
                                          b.ev_slots, b.target)
        got = port_check(b.ev_type, b.ev_slot, b.ev_slots, b.target,
                         b.V, b.W)
        assert_same(got, want)
        invalid += int((~got[0]).sum())
    assert invalid >= 1, "corpus must exercise the failure latch"
    if corpus == "two_words":
        assert any(b.V > 32 for b in buckets)


# A seed per process count whose history's vocabulary takes one state
# word (11 processes) or two (12, 13).
DC_SEEDS = {11: 77, 12: 84, 13: 93}


@pytest.mark.parametrize("n_procs", sorted(DC_SEEDS))
def test_plain_matches_make_kernel_on_dc_rw_buckets(n_procs):
    """The dc headline's shape (chip_smoke.py's dc path): an unkeyed
    read/write history of 80 ops over 11-13 processes, stale reads
    seeded, encoded as the reference encodes it (88 events, W =
    n_procs; one state word at 11 processes, two at 12 and 13)."""
    hist = synth_rw_history(DC_SEEDS[n_procs], n_procs=n_procs, n_ops=80,
                            stale=0.3)
    buckets = [b for b in bucket_encode(cas_register(),
                                        [prepare_history(hist)],
                                        max_states=64, max_slots=16)
               if b.batch]
    assert [(b.W, b.V > 32, b.n_events) for b in buckets] == [
        (n_procs, n_procs > 11, 88)]
    for b in buckets:
        want = ref_kernel(b.V, b.W, False)(b.ev_type, b.ev_slot,
                                          b.ev_slots, b.target)
        got = port_check(b.ev_type, b.ev_slot, b.ev_slots, b.target,
                         b.V, b.W)
        assert_same(got, want)


def random_inputs(seed, *, B, N, V, W, K1, shared, n_pad=0, wild=False):
    """Seeded random event tables: every event type (pad, ok, close,
    fused), random slot tables over the whole kind vocabulary (the
    sentinel row included), random transition tables, and a ragged
    tail of ``n_pad`` pad events. ``wild`` draws slot and kind indices
    one past each end (the reference clamps slots like ``lax.switch``
    and wraps, then clamps, kinds like a JAX gather), with a real kind
    in each completing slot so that rows both fail and survive."""
    rng = np.random.default_rng(seed)
    ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
    ev_type[:, N - n_pad:] = 0
    lo = -1 if wild else 0
    ev_slot = rng.integers(lo, W + (1 if wild else 0), (B, N)).astype(
        np.int8)
    ev_slots = rng.integers(lo, K1 + (1 if wild else 0), (B, N, W))
    if wild:
        q = np.clip(ev_slot, 0, W - 1).astype(np.int64)
        ev_slots[np.arange(B)[:, None], np.arange(N)[None], q] = \
            rng.integers(0, K1 - 1, (B, N))
    ev_slots = ev_slots.astype(np.int8)
    shape = (K1, V) if shared else (B, K1, V)
    target = rng.integers(-1, V, shape, dtype=np.int32)
    # sparse tables keep frontiers from saturating
    target[rng.random(shape) < 0.6] = -1
    target[..., K1 - 1, :] = -1
    return ev_type, ev_slot, ev_slots, target


RANDOM_CASES = {
    "shared_target": dict(B=6, N=24, V=8, W=5, K1=7, shared=True),
    "per_row_target": dict(B=6, N=24, V=8, W=5, K1=7, shared=False),
    "w_live_below_W": dict(B=5, N=20, V=8, W=6, K1=6, shared=True,
                           w_live=4),
    "ragged_events": dict(B=4, N=21, V=8, W=4, K1=5, shared=False,
                          n_pad=6),
    "two_words_bit31": dict(B=4, N=16, V=48, W=4, K1=9, shared=True),
    "one_full_word": dict(B=4, N=16, V=32, W=3, K1=6, shared=False),
    "indices_out_of_range": dict(B=8, N=24, V=8, W=5, K1=7, shared=False,
                                 wild=True),
}


@pytest.mark.parametrize("case", sorted(RANDOM_CASES))
def test_plain_matches_make_kernel_on_random_inputs(case):
    kw = dict(RANDOM_CASES[case])
    w_live = kw.pop("w_live", None)
    V, W, shared = kw["V"], kw["W"], kw["shared"]
    args = random_inputs(11, **kw)
    want = ref_kernel(V, W, shared, w_live=w_live)(*args)
    got = port_check(*args, V, W, w_live=w_live)
    assert_same(got, want)
    # the random tables must reach both outcomes
    assert got[0].any() or (~got[0]).any()
    assert np.asarray(got[2]).any()


def test_resume_form_matches_make_kernel_resume():
    """Carry (F, Fb, valid, bad) through three event chunks in both
    packages; every intermediate carry agrees."""
    V, W, K1, B = 8, 5, 6, 5
    ev_type, ev_slot, ev_slots, target = random_inputs(
        3, B=B, N=30, V=V, W=W, K1=K1, shared=True)
    rk = ref_kernel(V, W, True, resume=True)
    pk = L.get_kernel(V, W, resume=True)
    F, Fb, valid, bad = L.initial_carry(B, V, W, CPU)
    rcarry = (valid.numpy(), bad.numpy(), F.numpy().view(np.uint32),
              Fb.numpy().view(np.uint32))
    pcarry = (valid, bad, F, Fb)
    for lo in (0, 10, 20):
        sl = slice(lo, lo + 10)
        rv, rb, rF, rFb = rk(ev_type[:, sl], ev_slot[:, sl],
                             ev_slots[:, sl], target, np.int32(lo),
                             rcarry[2], rcarry[3], rcarry[0], rcarry[1])
        rcarry = tuple(np.asarray(a) for a in (rv, rb, rF, rFb))
        v, b, F, Fb = pk(t(ev_type[:, sl]), t(ev_slot[:, sl]),
                         t(ev_slots[:, sl]), t(target), lo, pcarry[2],
                         pcarry[3], pcarry[0], pcarry[1])
        pcarry = (v, b, F, Fb)
        assert_same((v.numpy(), b.numpy(), F.numpy().view(np.uint32),
                     Fb.numpy().view(np.uint32)), rcarry)
    assert not rcarry[0].all(), "chunks must cross a failure latch"


@pytest.mark.parametrize("chunk", [8, 13])
def test_event_chunked_matches_one_shot(chunk):
    for b in ref_buckets(**CORPORA["sweep"]):
        pb = batch_from_arrays(b)
        one = L.run_encoded_batch(pb, True, device="cpu")
        chunked = L.run_event_chunked(pb, chunk, True, device="cpu")
        assert_same(chunked, one)
        want = ref_kernel(b.V, b.W, False)(b.ev_type, b.ev_slot,
                                          b.ev_slots, b.target)
        assert_same(one, want)


def test_plain_matches_pallas_interpret_mode():
    """One small case against the Pallas kernel itself, in interpret
    mode as tests/test_pallas.py runs it (a ragged event axis)."""
    args = pallas_wgl.make_probe_batch(V=4, W=4, rows=4, events=70)
    pk = pallas_wgl.make_pallas_kernel(4, 4, shared_target=True,
                                       interpret=True)
    want = pk(*args)
    ev_type, ev_slot, ev_slots, target = args
    got = port_check(ev_type, ev_slot, ev_slots, target, 4, 4)
    assert_same(got, want)


@pytest.mark.parametrize("V,W,tier,ctas", [
    (8, 15, "block", 1), (8, 16, "cluster", 2), (8, 18, "cluster", 8),
    (48, 14, "block", 1), (48, 15, "cluster", 2), (64, 4, "warp", 1),
    (8, 1, "warp", 1), (8, cuda_wgl.W_WARP, "warp", 1),
    (8, cuda_wgl.W_WARP + 1, "block", 1), (64, cuda_wgl.W_WARP, "warp", 1),
    (64, 14, "block", 1), (32, 16, "cluster", 2), (33, 15, "cluster", 2),
    (8, 17, "cluster", 4), (40, 16, "cluster", 4), (64, 17, "cluster", 8),
    (40, 18, "device", 1)])
def test_smem_plan_places_the_frontier(V, W, tier, ctas):
    """Where a row's frontier lives: in the warp's registers, one block's
    shared memory, a cluster's (split by its top mask bits, as few CTAs
    as hold it), or, for two state words at W 18, device memory."""
    plan = cuda_wgl.smem_plan(V, W)
    assert (plan["tier"], plan["cluster_ctas"]) == (tier, ctas)
    assert plan["frontier_in_smem"] is (tier != "device")
    assert plan["smem_bytes"] <= plan["limit_bytes"]
    assert plan["frontier_bytes"] == L.n_state_words(V) * 4 << W
    assert 32 <= plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    if tier in ("block", "cluster"):
        assert plan["cta_frontier_bytes"] * ctas == plan["frontier_bytes"]


def count_tier_plan(V, W, K1):
    """The instrumented entry's plan past W_WARP, written out: a block of
    min(2^W, 1024) threads a row, the frontier and its pad copy in shared
    memory beside the event tile (32 events of 18 slot offsets, a live
    slot mask and an event word each) and the table staged as the warp
    tier stages it (nibble images to V 8, else int8 targets); without
    the table when all three do not fit; past that both frontiers in
    device memory (the "device" tier), the table staged when it fits."""
    NW, M = L.n_state_words(V), 1 << W
    form = "nibble" if V <= 8 else "int8"
    table = ((K1 * 128 if form == "nibble" else K1 * V) + K1 + 15) & ~15
    frontier, fixed = 2 * NW * M * 4, 4 * (32 * 18 + 32 + 32)
    for tier, resident in (("block", frontier), ("device", 0)):
        for f, rows in ((form, table), ("device", 0)):
            if resident + fixed + rows <= 232448:
                return {"tier": tier, "rows_per_block": 1, "table_form": f,
                        "cluster_ctas": 1, "rows_bytes": rows,
                        "frontier_bytes": frontier,
                        "frontier_in_smem": tier == "block",
                        "smem_bytes": resident + fixed + rows,
                        "threads": min(M, 1024), "limit_bytes": 232448}


def warp_count_plan(V, W, K1, shared):
    """The instrumented entry's plan to W_WARP, written out: the warp
    tier's, a warp a row and R rows a block, R the largest of 8, 4, 2, 1
    whose R event tiles (1 KB each) and staged tables (one for a shared
    target, else one a row; nibble images to V 8, else int8 targets) fit
    48 KB; a table that fits no block stays in device memory, R 8. The
    frontier and its pad copy sit in the warp's registers."""
    NW, M = L.n_state_words(V), 1 << W
    form = "nibble" if V <= 8 else "int8"
    table = ((K1 * 128 if form == "nibble" else K1 * V) + K1 + 15) & ~15
    plan = {"tier": "warp", "rows_per_block": 8, "table_form": "device",
            "cluster_ctas": 1, "rows_bytes": 0,
            "frontier_bytes": 2 * NW * M * 4, "frontier_in_smem": True,
            "smem_bytes": 8 * 1024, "threads": 8 * 32,
            "limit_bytes": 232448}
    for R in (8, 4, 2, 1):
        tables = table if shared else R * table
        if R * 1024 + tables <= 48 * 1024:
            plan.update(rows_per_block=R, table_form=form, rows_bytes=tables,
                        smem_bytes=R * 1024 + tables, threads=R * 32)
            break
    return plan


def instrument_plan(V, W, w_live=None, K1=1, shared=True):
    """The instrumented entry's plan: to W_WARP the warp tier's
    (warp_count_plan; w_live changes nothing), past it the count
    tier's."""
    if W > cuda_wgl.W_WARP:
        return count_tier_plan(V, W, K1)
    return warp_count_plan(V, W, K1, shared)


def wide_plan(V, W, K1):
    """The wide tiers' plan, written out: the fewest CTAs (1, 2, 4, 8)
    whose shared memory holds the split frontier, three bitmap words a
    32-mask group, the event tile (32 events of a kind per slot up to 18
    slots, a type and a slot), four flags and two counters, with the int8
    table staged when it fits too; else the device-memory tier."""
    NW, M = L.n_state_words(V), 1 << W
    table = (K1 * V + K1 + 15) & ~15
    for ctas in (1, 2, 4, 8):
        groups = M // ctas // 32
        base = NW * M // ctas * 4 + 4 * (3 * groups + 32 * 18 + 64 + 6)
        for form, extra in (("int8", table), ("device", 0)):
            if base + extra <= 232448:
                return ("block" if ctas == 1 else "cluster", ctas, form,
                        base + extra, groups)
    groups = M // 32
    base = 4 * (3 * groups + 32 * 18 + 64 + 6)
    form = "int8" if base + table <= 232448 else "device"
    return ("device", 1, form, base + (table if form == "int8" else 0),
            groups)


@pytest.mark.parametrize("V", [1, 8, 31, 32, 33, 48, 64])
def test_smem_plan_tiers_and_limits(V):
    """Every window W 1..18 at every table size: the tier by W, each CTA
    within the shared memory a block may use (and the warp tier within
    its budget), threads a whole number of warps, the wide tiers as
    wide_plan writes them out (w_live and a shared target change
    nothing there), and the instrumented entry on the warp tier's plan
    to W_WARP and on the count tier's past it (instrument_plan)."""
    for W in range(1, cuda_wgl.MAX_W + 1):
        for w_live in (None, 1, 3):
            for K1 in (1, 37, 200, 800, 5000):
                for shared in (True, False):
                    plan = cuda_wgl.smem_plan(V, W, w_live, K1=K1,
                                              shared_target=shared)
                    assert plan["smem_bytes"] <= plan["limit_bytes"]
                    assert plan["threads"] % 32 == 0
                    inst = cuda_wgl.smem_plan(V, W, w_live, K1=K1,
                                              shared_target=shared,
                                              instrument=True)
                    assert inst == instrument_plan(V, W, w_live, K1,
                                                   shared)
                    assert inst["smem_bytes"] <= inst["limit_bytes"]
                    if W > cuda_wgl.W_WARP:
                        tier, ctas, form, smem, groups = wide_plan(V, W, K1)
                        assert (plan["tier"], plan["cluster_ctas"],
                                plan["table_form"], plan["smem_bytes"]) == (
                            tier, ctas, form, smem)
                        assert plan["rows_per_block"] == 1
                        assert plan["threads"] == 32 * min(
                            32, max(4, groups // 8))
                        continue
                    R = plan["rows_per_block"]
                    assert plan["tier"] == "warp" and plan["frontier_in_smem"]
                    assert plan["cluster_ctas"] == 1
                    assert plan["threads"] == 32 * R
                    assert plan["smem_bytes"] <= cuda_wgl.WARP_SMEM_BYTES
                    form = "nibble" if V <= 8 else "int8"
                    tables = cuda_wgl.table_bytes(K1, V, form) * (
                        1 if shared else R)
                    tiles = R * cuda_wgl.TILE_BYTES
                    if plan["table_form"] != "device":
                        assert plan["table_form"] == form
                        assert plan["smem_bytes"] == tiles + tables
                    else:
                        assert plan["table_form"] == "device"
                        assert R == cuda_wgl.WARP_ROWS
                        assert plan["smem_bytes"] == tiles
                        # not even one row's block holds the table
                        assert (cuda_wgl.TILE_BYTES
                                + cuda_wgl.table_bytes(K1, V, form)
                                > cuda_wgl.WARP_SMEM_BYTES)


@pytest.mark.parametrize("V", range(1, 65))
def test_smem_plan_every_width_and_vocabulary(V):
    """Every W 1..18 at this V: the tier by W and word count (warp to
    W_WARP; then the block tier while one block holds the frontier, W
    <= 15 at one state word and <= 14 at two; a cluster of 2, 4 or 8
    CTAs to 18 at one word and 17 at two; device memory at 18 and two
    words), each CTA's bytes within 227 KB and whole 32-mask groups,
    threads a whole number of warps up to 1024, the group entry taking
    exactly the warp and block tiers, and the instrumented plan on the
    warp tier to W_WARP and on the count tier past it."""
    NW = L.n_state_words(V)
    for W in range(1, cuda_wgl.MAX_W + 1):
        plan = cuda_wgl.smem_plan(V, W, K1=40)
        ctas = plan["cluster_ctas"]
        if W <= cuda_wgl.W_WARP:
            want = ("warp", 1)
        elif W <= 16 - NW:
            want = ("block", 1)
        elif W <= 19 - NW:
            want = ("cluster", 1 << (W - 16 + NW))
        else:
            want = ("device", 1)
        assert (plan["tier"], ctas) == want, (V, W)
        assert plan["smem_bytes"] <= cuda_wgl.SMEM_LIMIT_BYTES
        assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
        if W > cuda_wgl.W_WARP:
            assert ((1 << W) // ctas) % 32 == 0
            assert plan["table_form"] == "int8"
        batch = SimpleNamespace(V=V, W=W, eff_w_live=W)
        assert BucketScheduler._groupable(batch) is (
            plan["tier"] in ("warp", "block"))
        inst = cuda_wgl.smem_plan(V, W, K1=40, instrument=True)
        assert inst["tier"] == ("warp" if W <= cuda_wgl.W_WARP
                                else "block" if W <= 15 - NW
                                else "device")
        assert inst == instrument_plan(V, W, K1=40)


@pytest.mark.parametrize("V,W,K1,shared,R,form", [
    (8, 5, 40, True, 8, "nibble"),     # the north-star bucket
    (8, 4, 40, True, 8, "nibble"),
    (8, 5, 40, False, 4, "nibble"),    # nibble images per row
    (9, 5, 40, True, 8, "int8"),       # past V = 8: int8 targets
    (64, 5, 200, False, 2, "int8"),    # per-row tables: fewer rows
    (64, 8, 300, False, 2, "int8"),
    (64, 8, 700, False, 1, "int8"),
    (64, 3, 350, False, 2, "int8"),
    (64, 6, 800, True, 8, "device"),   # past the budget: device memory
    (64, 8, 760, False, 8, "device"),
    (64, 2, 800, True, 8, "device")])
def test_smem_plan_warp_rows_and_table(V, W, K1, shared, R, form):
    plan = cuda_wgl.smem_plan(V, W, K1=K1, shared_target=shared)
    assert plan["tier"] == "warp"
    assert (plan["rows_per_block"], plan["table_form"]) == (R, form)


def test_table_bytes_rounds_to_16():
    assert cuda_wgl.table_bytes(1, 1, "int8") == 16
    assert cuda_wgl.table_bytes(40, 8, "int8") == 368
    assert cuda_wgl.table_bytes(40, 8) == 40 * 129 + 8    # nibble images
    assert cuda_wgl.table_bytes(40, 9) == 400
    assert all(cuda_wgl.table_bytes(k, v, f) % 16 == 0
               and cuda_wgl.table_bytes(k, v, f) >= k * (v + 1)
               for k in (1, 7, 130) for v in (1, 8, 64)
               for f in ("int8", "nibble"))


def test_cuda_wrapper_refuses_cpu_tensors():
    args = [t(a) for a in random_inputs(1, B=2, N=8, V=8, W=4, K1=4,
                                        shared=True)]
    carry = L.initial_carry(2, 8, 4, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wgl.wgl_frontier(*args, 0, *carry, V=8, W=4)
    with pytest.raises(ValueError, match="states"):
        cuda_wgl.wgl_frontier(*args, 0, *carry, V=72, W=4)
    with pytest.raises(ValueError, match="host engine"):
        L.get_kernel(72, 4)
    with pytest.raises(ValueError, match="W=19"):
        cuda_wgl.wgl_frontier(*args, 0, *carry, V=8, W=19)


def test_group_and_prepared_launches_refuse_cpu_tensors():
    """No fallback: the group entry and the prepared launches take CUDA
    tensors or raise, as the single-bucket wrapper does."""
    args = [t(a) for a in random_inputs(1, B=2, N=8, V=8, W=4, K1=4,
                                        shared=True)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wgl.wgl_frontier_group([(8, 4, None, True)], args)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wgl.prepare_group([(8, 4, None, True)], args)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wgl.prepare_frontier(*args, 0, *L.initial_carry(2, 8, 4, CPU),
                                  V=8, W=4)


def test_plain_counts_the_operations_the_step_needs():
    """The op count behind the kernel's bound, by hand: V = 2, W = 1;
    kind 0 sends state 0 to state 1, kind 1 (the sentinel) reaches no
    state. Events: close, pad, ok, ok on the sentinel (fails)."""
    target = t(np.array([[1, -1], [-1, -1]], np.int32))
    ev_type = t(np.array([[3, 0, 2, 2]], np.int8))
    ev_slot = t(np.zeros((1, 4), np.int8))
    ev_slots = t(np.array([[[0], [0], [0], [1]]], np.int8))
    iters = torch.zeros(1, dtype=torch.int64)
    ops = torch.zeros(1, dtype=torch.int64)
    valid, bad, _, _ = L.plain_wgl(ev_type, ev_slot, ev_slots, target, 0,
                                   *L.initial_carry(1, 2, 1, CPU), V=2, W=1,
                                   iters=iters, ops=ops)
    assert not valid[0] and int(bad[0]) == 3
    # close: expand (0, {}) once; pad: nothing; ok: the same expansion
    # plus one kept-mask test; ok on the sentinel: the test alone.
    assert int(ops[0]) == 1 + 0 + 2 + 1
    # close takes two sweeps (one to converge, one to see it); the pad's
    # closure (counted, then dropped) and each ok take one
    assert int(iters[0]) == 2 + 1 + 1 + 1


# ------------------------------------------- K2 instrument: closure passes

def ref_instrumented(V, W, shared, w_live=None):
    kern = ref.make_kernel(V, W, w_live=w_live, instrument=True)
    return jax.jit(jax.vmap(kern, in_axes=(0, 0, 0, None if shared else 0)))


def port_instrumented(ev_type, ev_slot, ev_slots, target, V, W,
                      w_live=None):
    v, b, f, it = L.get_kernel(V, W, w_live=w_live, instrument=True)(
        t(ev_type), t(ev_slot), t(ev_slots), t(target))
    return v.numpy(), b.numpy(), f.numpy().view(np.uint32), it.numpy()


INSTRUMENT_CASES = {
    # pads carry live slot kinds: their closures count and are dropped
    "pads_with_live_kinds": dict(B=6, N=24, V=8, W=4, K1=6, shared=True,
                                 n_pad=8),
    "per_row_target": dict(B=6, N=20, V=8, W=5, K1=7, shared=False),
    "w_live_below_W": dict(B=5, N=20, V=8, W=6, K1=6, shared=True,
                           w_live=3),
    # slot and kind indices past both ends: rows fail early, and every
    # event after the first failure counts one pass
    "early_failures": dict(B=8, N=24, V=8, W=4, K1=7, shared=False,
                           wild=True),
    "two_words": dict(B=4, N=16, V=40, W=3, K1=9, shared=True),
    "one_slot": dict(B=5, N=18, V=3, W=1, K1=3, shared=False, n_pad=5),
}


@pytest.mark.parametrize("case", sorted(INSTRUMENT_CASES))
def test_instrumented_matches_make_kernel_instrument(case):
    """get_kernel(instrument=True) — plain_wgl(iters=) on the CPU — gives
    the reference's four outputs bit for bit, the pass count included."""
    kw = dict(INSTRUMENT_CASES[case])
    w_live = kw.pop("w_live", None)
    args = random_inputs(11, **kw)
    want = ref_instrumented(kw["V"], kw["W"], kw["shared"], w_live)(*args)
    got = port_instrumented(*args, kw["V"], kw["W"], w_live)
    assert_same(got, want)
    if case == "early_failures":
        assert (~got[0]).sum() >= 1
    # the three check outputs are the uninstrumented kernel's
    assert_same(got[:3], port_check(*args, kw["V"], kw["W"], w_live))


@pytest.mark.parametrize("corpus", ["sweep", "info"])
def test_instrumented_matches_make_kernel_on_encoded_buckets(corpus):
    for b in ref_buckets(**CORPORA[corpus]):
        want = ref_instrumented(b.V, b.W, False, b.eff_w_live)(
            b.ev_type, b.ev_slot, b.ev_slots, b.target)
        got = port_instrumented(b.ev_type, b.ev_slot, b.ev_slots, b.target,
                                b.V, b.W, b.eff_w_live)
        assert_same(got, want)


def test_instrumented_counts_a_pad_row():
    """A row of four pad events (V 2, W 1): the first three carry a kind
    that sends state 0 to 1, so each closure of the initial frontier
    takes two passes, and none advances the frontier; the fourth's kind
    reaches no state: one pass. The reference counts 7."""
    target = np.array([[1, -1], [-1, -1]], np.int32)
    args = (np.zeros((1, 4), np.int8), np.zeros((1, 4), np.int8),
            np.array([[[0], [0], [0], [1]]], np.int8), target)
    want = ref_instrumented(2, 1, True)(*args)
    got = port_instrumented(*args, 2, 1)
    assert_same(got, want)
    assert int(got[3][0]) == 7
    assert got[2][0, 0].tolist() == [1, 0]   # the frontier never moved


def test_measure_closure_iters_matches_the_reference_bench_loop():
    """measure_closure_iters is bench.py's instrumented pass: the same
    total passes and vpu_op_model lane-ops over the same buckets."""
    buckets = ref_buckets(**CORPORA["sweep"])
    want_iters, want_ops = 0, 0.0
    for b in buckets:
        out = ref.get_kernel(b.V, b.W, shared_target=False,
                             w_live=b.eff_w_live, instrument=True)(
            b.ev_type, b.ev_slot, b.ev_slots, b.target)
        it = int(np.asarray(out[3]).sum())
        m = ref.vpu_op_model(b.V, b.W, b.eff_w_live)
        want_ops += (it * m["per_iteration"]
                     + b.batch * b.ev_opidx.shape[-1] * m["per_event"])
        want_iters += it
    got = L.measure_closure_iters(
        [batch_from_arrays(b) for b in buckets], device="cpu")
    assert got["iters"] == want_iters and got["lane_ops"] == want_ops
    assert got["buckets"] == len(buckets)


def test_instrumented_has_the_check_form_only():
    with pytest.raises(ValueError, match="check form"):
        L.get_kernel(8, 4, instrument=True, resume=True)


def test_instrument_plan_runs_the_block_body_at_every_width():
    """The instrumented entry runs the warp tier to W_WARP and a block a
    row past it, with a pad copy beside the frontier: both in shared
    memory while they fit (W 14 at one state word, 13 at two), in device
    memory past that; a table too large for shared memory stays in
    device memory in every tier."""
    for W in range(1, 19):
        for V in (8, 40):
            plan = cuda_wgl.smem_plan(V, W, instrument=True)
            words = cuda_wgl.n_state_words(V)
            assert plan["frontier_bytes"] == 2 * words * (4 << W)
            if W <= cuda_wgl.W_WARP:
                assert plan["tier"] == "warp"
                continue
            assert plan["tier"] in ("block", "device")
            assert plan["frontier_in_smem"] == (plan["tier"] == "block")
            assert plan["frontier_in_smem"] == (
                plan["frontier_bytes"] + 4 * cuda_wgl.count_fixed_words()
                <= cuda_wgl.SMEM_LIMIT_BYTES)
            assert plan["threads"] == min(1 << W, 1024)
    assert cuda_wgl.smem_plan(8, 14, instrument=True)["tier"] == "block"
    assert cuda_wgl.smem_plan(8, 15, instrument=True)["tier"] == "device"
    assert cuda_wgl.smem_plan(40, 13, instrument=True)["tier"] == "block"
    assert cuda_wgl.smem_plan(40, 14, instrument=True)["tier"] == "device"
    assert cuda_wgl.smem_plan(8, 15)["tier"] == "block"
    for W, K1, want in ((6, 800, ("warp", "device")),
                        (12, 3000, ("block", "device")),
                        (16, 4000, ("device", "device")),
                        (16, 9, ("device", "int8"))):
        plan = cuda_wgl.smem_plan(64, W, K1=K1, instrument=True)
        assert (plan["tier"], plan["table_form"]) == want


def test_instrumented_wrapper_refuses_cpu_tensors():
    args = [t(a) for a in random_inputs(1, B=2, N=8, V=8, W=4, K1=4,
                                        shared=True)]
    carry = L.initial_carry(2, 8, 4, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wgl.wgl_frontier(*args, 0, *carry, V=8, W=4,
                              iters=torch.zeros(2, dtype=torch.int32))
