"""The peel loop's kernel (K4 ``dc_peel``, as
``jepsen_torch/ops/csrc/dc_peel.cu`` computes it), held bit for bit to
the reference's ``get_dc_kernel`` (jax on the CPU), to its numpy twin
``dc_host_decide`` and to the plain version ``plain_dc_peel``, in both
decided and rounds.

The CUDA kernel cannot run here, so its tiers are modelled in numpy step
for step. Neither keeps the reference's per-cluster minima (m_resp):
an event belongs to one cluster, so the two smallest cluster minima are
g1, the least alive event, and g2, the least alive event outside g1's
cluster a1. Both models keep m_inv across rounds, start it as garbage
and reset only the alive ops' clusters each round, so that a slot read
before its reset would show.

* The warp tier (E <= 256): a row on 32 lanes, lane l holding events
  l + 32k (k below E/32 rounded up to a power of two) as registers and
  an alive bit mask; g1 as a min-reduce over each lane's lowest alive
  slot, a1 from g1's lane, g2 as a min-reduce over the alive events
  outside a1, the reset and scatter-max of m_inv, the peel test, two
  votes.
* The block tiers (E > 256): a row on 256 threads, thread t holding
  events t + 256j; each thread folds its alive events into (least event,
  its cluster, least event of another cluster), the folds merge by a
  five-step xor butterfly in each warp and then over the eight warps'
  partials in order; the same reset, scatter-max and test.

Tolerance: none.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import dc_monitor as R

from jepsen_torch.checkers.linearizable import prepare_history
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import cuda_dc
from jepsen_torch.ops import dc_monitor as D
from jepsen_torch.ops.encode import bucket_encode
from jepsen_torch.workloads import synth as S

torch.set_num_threads(1)

BIG = 1 << 30
THREADS = 256


def slots(E):
    """Events a lane holds in the warp tier: E/32 rounded up to a power
    of two (the kernel's template K, 1 to 8)."""
    k = 1
    while 32 * k < E:
        k *= 2
    return k


def registers(E, K):
    """A row's [32, K] lane registers: event l + 32k on lane l, slot k."""
    e = np.arange(32)[:, None] + 32 * np.arange(K)[None, :]
    valid = e < E
    ec = np.minimum(e, E - 1)
    return e, valid, ec


def warp_row(inv, cluster, active, cap, garbage):
    """One row of the warp tier: (decided, rounds)."""
    E = inv.shape[0]
    K = slots(E)
    e, valid, ec = registers(E, K)
    r_inv = np.where(valid, inv[ec], 0)
    r_cl = np.where(valid, cluster[ec], 0)
    alive = valid & active[ec]
    m_inv = garbage[:32 * K].copy()
    rounds = 0
    left = bool(alive.any())
    running = left
    while running:
        # Each lane's lowest alive slot is its least alive event.
        has = alive.any(1)
        k = np.argmax(alive, 1)
        mine = np.where(has, e[np.arange(32), k], BIG)
        mine_cl = np.where(has, r_cl[np.arange(32), k], 0)
        g1 = int(mine.min())
        a1 = int(mine_cl[g1 & 31])
        other = np.where(alive & (r_cl != a1), e, BIG).min(1)
        g2 = int(other.min())
        m_inv[r_cl[alive]] = -1
        np.maximum.at(m_inv, r_cl[alive], r_inv[alive])
        t = np.where(r_cl == a1, g2, g1)
        dead = alive & (m_inv[r_cl] <= t)
        alive = alive & ~dead
        rounds += 1
        left = bool(alive.any())
        running = bool(dead.any()) and left and rounds < cap
    return not left, rounds


def merge(a, b):
    """The kernel's merge of two folds (v1, c1, v2), elementwise."""
    av1, ac1, av2 = a
    bv1, bc1, bv2 = b
    take_b = bv1 < av1
    v1 = np.where(take_b, bv1, av1)
    c1 = np.where(take_b, bc1, ac1)
    v2 = np.where(take_b,
                  np.minimum(bv2, np.where(ac1 != bc1, av1, av2)),
                  np.minimum(av2, np.where(bc1 != ac1, bv1, bv2)))
    return v1, c1, v2


def block_minima(alive, cluster):
    """g1, a1, g2 as the block tier reduces them: each thread's fold of
    its strided events, the xor butterfly in each warp, the partials in
    warp order."""
    E = alive.shape[0]
    m = (np.full(THREADS, BIG), np.full(THREADS, -1), np.full(THREADS, BIG))
    for j in range(0, E, THREADS):
        ev = np.arange(j, j + THREADS)
        ok = ev < E
        evc = np.minimum(ev, E - 1)
        live = ok & alive[evc]
        one = (np.where(live, ev, BIG), np.where(live, cluster[evc], -1),
               np.full(THREADS, BIG))
        m = merge(m, one)
    lane = np.arange(THREADS)
    for d in (16, 8, 4, 2, 1):
        m = merge(m, tuple(x[lane ^ d] for x in m))
    parts = [tuple(int(x[w * 32]) for x in m) for w in range(THREADS // 32)]
    acc = tuple(np.array(v) for v in parts[0])
    for p in parts[1:]:
        acc = merge(acc, tuple(np.array(v) for v in p))
    return int(acc[0]), int(acc[1]), int(acc[2])


def block_row(inv, cluster, active, cap, garbage):
    """One row of the smem and global tiers: (decided, rounds)."""
    E = inv.shape[0]
    alive = active.astype(bool).copy()
    m_inv = garbage[:E].copy()
    rounds = 0
    left = bool(alive.any())
    running = left
    while running:
        g1, a1, g2 = block_minima(alive, cluster)
        m_inv[cluster[alive]] = -1
        np.maximum.at(m_inv, cluster[alive], inv[alive])
        t = np.where(cluster == a1, g2, g1)
        dead = alive & (m_inv[cluster] <= t)
        alive = alive & ~dead
        rounds += 1
        left = bool(alive.any())
        running = bool(dead.any()) and left and rounds < cap
    return not left, rounds


def model(inv, cluster, active, max_rounds=0, seed=0):
    """The kernel's tier at width E over every row: (decided, rounds)."""
    B, E = inv.shape
    cap = max_rounds or E + 1
    garbage = np.random.default_rng(seed).integers(
        -(1 << 31), 1 << 31, max(E, 32 * slots(E)), dtype=np.int64)
    row = warp_row if cuda_dc.tier(E) == "warp" else block_row
    out = [row(inv[b], cluster[b], active[b], cap, garbage)
           for b in range(B)]
    return (np.array([d for d, _ in out], bool),
            np.array([r for _, r in out], np.int32))


def random_plan(rng, B, E, kind):
    """Plans the tests peel: W-overlapped write+read ``pairs``, arbitrary
    clusters (``random``), ``one`` cluster a row (a random one), and
    pairs whose clusters are shifted so that the least alive event's
    cluster is not 0 (``shifted``, the first events inactive)."""
    e = np.arange(E)
    if kind in ("pairs", "shifted"):
        w = rng.integers(1, 9, (B, 1))
        inv = np.maximum(0, e[None] - w)
        cluster = np.broadcast_to(e // 2 * 2, (B, E)).copy()
        if kind == "shifted":
            cluster = (cluster + rng.integers(1, E + 1, (B, 1))) % E
    elif kind == "one":
        inv = rng.integers(0, E, (B, E))
        cluster = np.broadcast_to(rng.integers(0, E, (B, 1)), (B, E))
    else:
        inv = rng.integers(0, E, (B, E))
        cluster = rng.integers(0, E, (B, E))
    active = rng.random((B, E)) < 0.85
    if kind == "shifted":
        active[:, :min(3, E - 1)] = False
    return (inv.astype(np.int32), np.ascontiguousarray(cluster, np.int32),
            active)


def assert_all_agree(plan, max_rounds):
    """The model, the plain version, the reference's kernel and its host
    twin on one plan: decided and rounds bit for bit."""
    inv, cluster, active = plan
    E = inv.shape[1]
    got_d, got_r = model(inv, cluster, active, max_rounds)
    want_d, want_r = (np.asarray(a)
                      for a in R.get_dc_kernel(E, max_rounds)(*plan))
    plain_d, plain_r = D.plain_dc_peel(
        *(torch.from_numpy(a) for a in plan), max_rounds)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(plain_d.numpy(), got_d)
    np.testing.assert_array_equal(plain_r.numpy(), got_r)
    np.testing.assert_array_equal(
        R.dc_host_decide(*plan, max_rounds=max_rounds), got_d)
    return got_r


# --------------------------------------------------------------- the tiers

def test_tiers_at_their_edges():
    """Warp to 256 events, then a block a row in shared memory while
    13 bytes an event fit, then device memory; the kernel's constants."""
    assert cuda_dc.SMEM_BYTES_PER_EVENT == 13
    assert [cuda_dc.tier(E) for E in (1, 32, 33, 255, 256)] == ["warp"] * 5
    edge = cuda_dc.SMEM_LIMIT_BYTES // cuda_dc.SMEM_BYTES_PER_EVENT
    assert [cuda_dc.tier(E) for E in (257, 1024, 16384, edge)] == \
        ["smem"] * 4
    assert cuda_dc.tier(edge + 1) == "global"
    assert [slots(E) for E in (1, 32, 33, 64, 65, 128, 129, 256)] == \
        [1, 1, 2, 2, 4, 4, 8, 8]


@pytest.mark.parametrize("E", [1, 2, 31, 32, 33, 64, 100, 128, 255, 256,
                               257, 300, 512, 1024])
def test_model_matches_reference(E):
    """Both tiers' models at every width edge, on pair-structured,
    arbitrary, one-cluster and shifted-cluster plans (two rows each)."""
    rng = np.random.default_rng(E)
    for kind in ("pairs", "random", "one", "shifted"):
        assert_all_agree(random_plan(rng, 2, E, kind), 0)


@pytest.mark.parametrize("E", [64, 257])
@pytest.mark.parametrize("max_rounds", [1, 3])
def test_model_stops_at_the_cap(E, max_rounds):
    """A round cap ends the loop with the last round counted; long pair
    chains reach it."""
    rng = np.random.default_rng(10 * E + max_rounds)
    rounds = np.concatenate([
        assert_all_agree(random_plan(rng, 3, E, kind), max_rounds)
        for kind in ("pairs", "shifted")])
    assert rounds.max() == max_rounds


@pytest.mark.parametrize("E", [32, 300])
def test_model_edge_rows(E):
    """All-inactive rows run no round and are decided; a row with one
    active op peels in one round (g2 is BIG); a row whose ops share one
    cluster peels whole."""
    inv = np.zeros((3, E), np.int32)
    cluster = np.full((3, E), E - 1, np.int32)
    active = np.zeros((3, E), bool)
    active[1, E // 2] = True
    active[2] = True
    inv[2] = np.arange(E)
    rounds = assert_all_agree((inv, cluster, active), 0)
    assert rounds.tolist() == [0, 1, 1]


def test_least2_merge_is_the_two_minima():
    """The block tier's fold: merged over any split and in any order, it
    is the least event, its cluster and the least event of another
    cluster (BIG where none)."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        ev = rng.permutation(1000)[:n]
        cl = rng.integers(0, int(rng.integers(1, 5)), n)
        order = rng.permutation(n)
        folds = [(np.array(ev[i]), np.array(cl[i]), np.array(BIG))
                 for i in order]
        while len(folds) > 1:
            i = int(rng.integers(0, len(folds) - 1))
            folds[i:i + 2] = [merge(folds[i], folds[i + 1])]
        v1, c1, v2 = (int(x) for x in folds[0])
        g1 = int(ev.min())
        a1 = int(cl[ev.argmin()])
        outside = ev[cl != a1]
        assert (v1, c1, v2) == (g1, a1, int(outside.min()) if len(outside)
                                else BIG)


def test_model_on_the_dc_paths_plans():
    """The plans the dc path makes of unkeyed read/write histories (W
    11-16, healthy and stale), padded as dc_decide pads them: every one
    in the warp tier, the model equal to the reference."""
    hists = [S.synth_rw_history(s, n_procs=11 + s % 6, n_ops=40,
                                stale=0.3 if s % 3 == 0 else 0.0)
             for s in range(12)]
    batches = bucket_encode(cas_register(), [prepare_history(h)
                                             for h in hists],
                            max_states=64, max_slots=32, fuse=True)
    rows = 0
    for b in batches:
        plan = D.dc_plan(b)
        if plan is None:
            continue
        padded = D.pad_plan(plan.inv, plan.cluster, plan.active)
        assert cuda_dc.tier(padded[0].shape[1]) == "warp"
        assert_all_agree(padded, 0)
        rows += plan.inv.shape[0]
    assert rows >= 6


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises: a CPU plan is
    refused, never peeled by the plain version."""
    z = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_dc.dc_peel(z, z, z.bool(), 9)
