"""The tiled tiers of the closure kernel (K5 ``graph_closure``, K6
``txn_closure``: blocked Warshall on 32 x 32 bit tiles, as
``jepsen_torch/ops/csrc/graph_closure.cu`` computes it), held bit for
bit to the plain versions (``plain_graph_closure``, ``plain_txn_closure``)
and to the reference's ``graph_kernel`` and ``txn_kernel`` (run by jax
on the CPU).

The CUDA kernel cannot run here, so it is modelled in numpy stage for
stage, on the kernel's own word layout (``tile_word``: tile (I, J) is 32
consecutive words, row r at word (r + J) mod 32 of them):

* the load (the SI plane's prologue for the txn entry: N | RW·N with
  RW = G2 & ~N, word by word);
* per round K: the diagonal tile's closure by 32 broadcast steps; row
  block K as A | D*·A and column block K as A | A·D*; every other tile
  as C | A(I,K)·A(K,J) by eight 16-entry nibble tables of A(K,J)'s
  rows, a lane with a zero A(I,K) word skipped;
* the probe: the first vertex whose diagonal bit is set.

Each phase runs over all its tiles at once (within a phase no tile is
read after another writes it); the work items that spread phase 3 over
a block's warps are checked to cover each tile once. Tolerance: none.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import graph as R
from jepsen_tpu.ops import txn_graph as RT

from jepsen_torch.ops import cuda_graph
from jepsen_torch.ops import graph as G
from jepsen_torch.ops import txn_graph as TG
from jepsen_torch.ops.faults import INT32_MAX

from _graph_planes import pack_dense, random_planes

torch.set_num_threads(1)

LANES = np.arange(32)
BITS = np.arange(32, dtype=np.uint32)


def tile_word(I, J, r, T):
    """The kernel's word index of row r of tile (I, J) (``tile_word``)."""
    return ((I * T + J) << 5) | ((r + J) & 31)


def load_plane(rows, V, C=1):
    """Packed rows uint32 [V, T] into the kernel's layout over C CTAs: a
    flat word array each, CTA c holding row blocks [c·Tc, c·Tc + Tc)
    (Tc = T / C) at ``tile_word(I - c·Tc, J, r, T)``."""
    T = V // 32
    Tc = T // C
    mems = []
    for c in range(C):
        i, J = np.meshgrid(np.arange(c * Tc * 32, (c + 1) * Tc * 32),
                           np.arange(T), indexing="ij")
        mem = np.zeros(V * T // C, np.uint32)
        mem[tile_word((i >> 5) - c * Tc, J, i & 31, T)] = rows[i, J]
        mems.append(mem)
    return mems


def si_rows(n, g2, V):
    """The txn entry's SI prologue: row i is N[i] | OR over the bits k of
    RW[i] = G2[i] & ~N[i] of N[k], word by word."""
    rw = g2 & ~n
    out = n.copy()
    for i in range(V):
        for u in range(n.shape[1]):
            w = int(rw[i, u])
            while w:
                c = (w & -w).bit_length() - 1
                w &= w - 1
                out[i] |= n[u * 32 + c]
    return out


def or_rows_under(bits, rows):
    """Per lane, the OR of ``rows[k]`` over the bits k of ``bits[lane]``
    (the shuffle loops of phases 1 and 2)."""
    take = ((bits[:, None] >> BITS[None, :]) & 1).astype(bool)
    return np.bitwise_or.reduce(np.where(take, rows[None, :], 0), axis=1)


def nibble_tables(brow):
    """The eight 16-entry tables of a tile B (``table[16n + m]`` = OR of
    B's rows 4n + b over the bits b of m), as a warp's lanes build them:
    entry e = lane + 32x, four shuffles each."""
    table = np.zeros(128, np.uint32)
    for x in range(4):
        e = LANES + 32 * x
        base, m = (e >> 4) << 2, e & 15
        for bit in range(4):
            table[e] |= np.where((m >> bit) & 1, brow[base + bit], 0
                                 ).astype(np.uint32)
    return table


def tiled_closure(mems, V):
    """Blocked Warshall on a plane's words held by C = len(mems) CTAs,
    round by round, phase by phase; each CTA updates only its own tiles
    and reads round K's diagonal tile and row block from the CTA that
    owns block K. Returns the closed words."""
    C = len(mems)
    T = V // 32
    Tc = T // C
    mems = [m.copy() for m in mems]

    def tile(I, J):
        return tile_word(I, J, LANES, T)

    for K in range(T):
        o, Ko = K // Tc, K % Tc
        own = mems[o]
        # 1. The owner closes the diagonal tile: step k ORs row k into
        #    the rows with bit k.
        d = own[tile(Ko, K)]
        for k in range(32):
            dk = d[k]
            d = np.where((d >> np.uint32(k)) & 1, d | dk, d)
        own[tile(Ko, K)] = d
        # 2. The owner's row block K: A | D*·A; each CTA's own tiles of
        #    column block K: A | A·D*, D* read from the owner.
        dstar = mems[o][tile(Ko, K)]
        for J in range(T):
            if J != K:
                a = own[tile(Ko, J)]
                own[tile(Ko, J)] = a | or_rows_under(dstar, a)
        for c, mem in enumerate(mems):
            for i in range(Tc):
                if (c, i) != (o, Ko):
                    a = mem[tile(i, K)]
                    mem[tile(i, K)] = a | or_rows_under(a, dstar)
        # 3. Each CTA's other tiles: C | A(I,K)·A(K,J), by nibble tables
        #    of the owner's A(K,J).
        js = np.array([J for J in range(T) if J != K])
        if not js.size:
            continue
        tables = np.stack([nibble_tables(own[tile(Ko, J)]) for J in js])
        for c, mem in enumerate(mems):
            rows = np.array([i for i in range(Tc) if (c, i) != (o, Ko)])
            if not rows.size:
                continue
            a = mem[tile_word(rows[:, None], K, LANES, T)]    # [i, lane]
            nib = (a[:, :, None] >> (4 * np.arange(8, dtype=np.uint32))) & 15
            got = np.bitwise_or.reduce(                       # [J, i, lane]
                tables[:, (np.arange(8) << 4) + nib], axis=-1)
            at = tile_word(rows[None, :, None], js[:, None, None], LANES, T)
            mem[at] = np.where(a[None] != 0, mem[at] | got, mem[at])
    return mems


def probe(mems, V):
    """Each CTA's first own row with its diagonal bit set; the minimum
    over the CTAs (rank 0's read of the others')."""
    T = V // 32
    Tc = T // len(mems)
    firsts = []
    for c, mem in enumerate(mems):
        i = np.arange(Tc * 32)
        diag = (mem[tile_word(i >> 5, (i >> 5) + c * Tc, i & 31, T)]
                >> (i & 31)) & 1
        on = np.nonzero(diag)[0]
        firsts.append(c * Tc * 32 + int(on[0]) if on.size else INT32_MAX)
    f = min(firsts)
    return f != INT32_MAX, f


def model(adj, V, entry, planes=None):
    """(cyc, node) [B, L] of packed int32 planes [B, l_in, V, V/32] by the
    tiled tiers, each plane over the CTAs that the plan gives a batch of
    ``planes`` planes (the batch's own when None)."""
    adj = adj.view(np.uint32)
    l_in, l_out = cuda_graph.ENTRIES[entry]
    C = cuda_graph.tile_plan(V, planes or adj.shape[0] * l_out)["cluster"]
    cyc = np.zeros((adj.shape[0], l_out), bool)
    node = np.zeros((adj.shape[0], l_out), np.int32)
    for b in range(adj.shape[0]):
        for p in range(l_out):
            rows = (si_rows(adj[b, 1], adj[b, 3], V) if p == 4
                    else adj[b, p])
            cyc[b, p], node[b, p] = probe(
                tiled_closure(load_plane(rows, V, C), V), V)
    return cyc, node


def special_planes(V, L):
    """Empty, self-loop on the last vertex, one edge, the V-long cycle,
    and a cycle closed only through the last tile's vertices."""
    dense = np.zeros((5, L, V, V), np.uint8)
    dense[1, :, V - 1, V - 1] = 1
    dense[2, :, 0, 1] = 1
    dense[3, :, np.arange(V), (np.arange(V) + 1) % V] = 1
    dense[4, :, 5, V - 2] = 1
    dense[4, :, V - 2, V - 33] = 1
    dense[4, :, V - 33, 5] = 1
    return pack_dense(dense)


def check(adj, V, entry, reference=True, batches=(None,)):
    """The model, over the CTAs a plane that the plan gives a batch of
    each of ``batches`` planes (None: the batch's own), against the
    plain version and the reference's kernel."""
    t = torch.from_numpy(np.ascontiguousarray(adj).view(np.int32))
    plain = (G.plain_graph_closure if entry == "graph"
             else TG.plain_txn_closure)(t, V)
    ref = None
    if reference:
        ref = (R.graph_kernel(V) if entry == "graph"
               else RT.txn_kernel(V))(adj.view(np.int32))
    for planes in batches:
        got = model(adj, V, entry, planes)
        for g, w in zip(got, plain):
            np.testing.assert_array_equal(g, w.numpy())
        if ref is not None:
            for g, w in zip(got, ref):
                np.testing.assert_array_equal(g, np.asarray(w))
    return got


# Batches of planes for which the plan spreads each plane over 8, 4, 2
# and 1 CTAs, where V/32 allows it.
PLANES_FOR = {8: 1, 4: 33, 2: 66, 1: 133}


def cluster_batches(V):
    """Batch sizes (in planes) that lead the plan to every cluster size
    a plane of V vertices can take in shared memory."""
    return tuple(PLANES_FOR[c] for c in (1, 2, 4, 8) if c <= V // 32)


@pytest.mark.parametrize("V", [64, 128, 256, 512])
def test_graph_tiles_match_plain_and_reference(V):
    """Random planes at three densities (cumulative across the three
    planes as extraction makes them) and the special planes, each plane
    in one CTA and spread over every cluster it can take."""
    rng = np.random.default_rng(V)
    B = 2 if V <= 256 else 1
    adj = np.concatenate([random_planes(rng, B, 3, V, d)
                          for d in (0.002, 0.02, 0.3)]
                         + [special_planes(V, 3)])
    adj = np.bitwise_or.accumulate(adj, axis=1)
    cyc, node = check(adj, V, "graph", batches=(None,) + cluster_batches(V))
    assert cyc.any() and not cyc.all()
    assert (node[-5] == INT32_MAX).all() and (node[-4] == V - 1).all()
    assert (node[-2] == 0).all() and (node[-1] == 5).all()


def test_graph_tiles_at_v1024_and_v2048():
    """The shared-memory tier's widest bucket (32 x 32 tiles, over the
    plan's cluster of 8 and over one CTA) and the first global-memory
    one (64 x 64, one CTA), against the plain version (and at V 1024 the
    reference): sparse planes, with a cycle closed across tiles added to
    the last, and at V 1024 the special planes' long cycles."""
    for V in (1024, 2048):
        rng = np.random.default_rng(V)
        adj = random_planes(rng, 1, 3, V, 0.001)
        adj[0, 2] |= special_planes(V, 1)[4, 0]
        if V == 1024:
            adj = np.concatenate([adj, special_planes(V, 3)[[3, 4]]])
            assert cuda_graph.tile_plan(V, 9)["cluster"] == 8
        cyc, node = check(adj, V, "graph", reference=V == 1024,
                          batches=(None, PLANES_FOR[1]) if V == 1024
                          else (None,))
        assert node[0, 2] <= 5 and cyc[-1].all()


@pytest.mark.parametrize("V", [64, 256])
def test_txn_tiles_match_plain_and_reference(V):
    """The txn entry's five planes, the SI plane derived by the
    prologue (each CTA its own rows): random ladders (G2 a superset of
    G1c) and one whose only cycle is an anti-dependency closed by a G1c
    edge, in one CTA and over a cluster of 2."""
    rng = np.random.default_rng(100 + V)
    adj = random_planes(rng, 3, 4, V, 0.02)
    adj[:, 3] |= adj[:, 1]
    dense = np.zeros((1, 4, V, V), np.uint8)
    dense[0, 1:, V - 1, 0] = 1
    dense[0, 3, 0, V - 1] = 1
    adj = np.concatenate([adj, pack_dense(dense)])
    cyc, node = check(adj, V, "txn",
                      batches=(PLANES_FOR[1], PLANES_FOR[2]))
    assert cyc[-1].tolist() == [False, False, False, True, True]
    assert node[-1, 3:].tolist() == [0, 0]


@pytest.mark.parametrize("V", [64, 128, 256, 1024, 2048, 32768])
def test_tile_layout_is_a_bank_free_bijection(V):
    """``tile_word`` maps each (row, word) of a plane to its own word; a
    warp reading a tile touches 32 banks, and (from 32 tiles a side) a
    warp writing one row's 32 words does too."""
    T = V // 32
    if V <= 2048:
        i, J = np.meshgrid(np.arange(V), np.arange(T), indexing="ij")
        w = tile_word(i >> 5, J, i & 31, T).ravel()
        assert np.array_equal(np.sort(w), np.arange(V * T))
    for I, J in ((0, 0), (T - 1, 1), (T // 2, T - 1)):
        assert len({tile_word(I, J, r, T) % 32 for r in range(32)}) == 32
    if T >= 32:
        assert len({tile_word(3, J, 7, T) % 32 for J in range(32)}) == 32


def kernel_items(V, C):
    """The tiles each CTA's warps write in each phase of a round, as the
    kernel's loops assign them: {(phase, K): [(cta, I, J), ...]}."""
    p = cuda_graph.tile_plan(V, PLANES_FOR[C])
    assert p["cluster"] == C
    T, nwarps = p["tiles"], p["threads"] // 32
    Tc = T // C
    nseg = nwarps // T if nwarps > T else 1
    seg_len = Tc // nseg
    out = {}
    for K in sorted({0, T // 2, T - 1}):
        o, Ko = K // Tc, K % Tc
        for rank in range(C):
            owner = rank == o
            nrow, ncol = (T - 1 if owner else 0), Tc - owner
            for warp in range(nwarps):
                for q in range(warp, nrow + ncol, nwarps):
                    if q < nrow:
                        I, J = K, q if q < K else q + 1
                    else:
                        i = q - nrow
                        I, J = rank * Tc + (i + 1 if owner and i >= Ko
                                            else i), K
                    out.setdefault((2, K), []).append((rank, I, J))
                for q in range(warp, T * nseg, nwarps):
                    J = q & (T - 1)
                    if J == K:
                        continue
                    i0 = (q >> (T.bit_length() - 1)) * seg_len
                    for i in range(i0, i0 + seg_len):
                        if not (owner and i == Ko):
                            out.setdefault((3, K), []).append(
                                (rank, rank * Tc + i, J))
    return T, Tc, out


@pytest.mark.parametrize("V,C", [(64, 1), (64, 2), (128, 4), (256, 1),
                                 (256, 8), (512, 2), (1024, 1), (1024, 2),
                                 (1024, 8), (2048, 1), (4096, 1)])
def test_phase_items_cover_each_tile_once(V, C):
    """Phases 2 and 3 of a round write each tile of row and column
    block K, and each other tile, exactly once, every one by the CTA
    that holds it; the block is a warp a tile of its share up to 1,024
    threads."""
    T, Tc, items = kernel_items(V, C)
    p = cuda_graph.tile_plan(V, PLANES_FOR[C])
    assert p["threads"] == min(1024, 32 * Tc * T)
    for (phase, K), got in items.items():
        want = ({(K, J) for J in range(T) if J != K}
                | {(I, K) for I in range(T) if I != K}) if phase == 2 \
            else {(I, J) for I in range(T) for J in range(T)
                  if I != K and J != K}
        assert sorted((I, J) for _, I, J in got) == sorted(want)
        assert all(I // Tc == rank for rank, I, _ in got)


def test_tier_and_plan_edges():
    """The tiers: warp to V 32, tiles in shared memory to V 1024 (with
    the warps' tables), in device memory from V 2048; in shared memory
    the widest cluster (to 8, and to V/32) that keeps the batch's CTAs
    within 132: the graph path's 16 graphs (48 planes) at V 1024 take 2
    CTAs a plane, 32 graphs (96 planes) one."""
    assert [cuda_graph.tier(V) for V in (8, 32, 64, 1024, 2048)] == [
        "warp", "warp", "smem", "smem", "global"]
    assert cuda_graph.tile_plan(1024, 96)["smem_bytes"] == (
        1024 * 32 * 4 + 32 * 128 * 4)
    assert [cuda_graph.tile_plan(1024, n)["cluster"]
            for n in (96, 48, 30, 16, 1)] == [1, 2, 4, 8, 8]
    assert cuda_graph.tile_plan(1024, 48)["smem_bytes"] == (
        1024 * 32 * 4 // 2 + 32 * 128 * 4)
    assert cuda_graph.tile_plan(64, 1)["cluster"] == 2
    assert cuda_graph.tile_plan(256, 640)["cluster"] == 1
    assert cuda_graph.tile_plan(2048, 1) == {
        "tiles": 64, "cluster": 1, "threads": 1024, "tier": "global",
        "smem_bytes": 32 * 128 * 4, "blocks": 1}
    assert [cuda_graph.tile_plan(256, n)["cluster"]
            for n in (66, 67)] == [2, 1]
