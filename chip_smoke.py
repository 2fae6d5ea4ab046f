"""Smoke run of the jepsen_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the six CUDA libraries from the checkout's sources (one nvcc
each, in parallel; the native host engines with g++ beside them) and
holds each kernel bit for bit against its plain
PyTorch version on the card (the list-append generator with its own
phases, below): the WGL frontier kernel in each of its tiers (warp;
block, cluster and device memory, the wide tiers, at every W 9-18 at one
and two state words) with cases at every tier edge, tables staged on
chip and left in device memory, padding rows, mostly-padding rows and
tile-edge rows, and the event-chunked resume entry against the one-shot
launch; its
group entry (several bucket chunks of mixed shapes and tiers in one
launch, padding rows skipped, against ``plain_fused_wgl`` and against
single-bucket launches); and the history generators (CAS/register cases over
processes, to windows over several of the row kernel's 32-op tiles,
values to the 24-bit kind field's largest, op counts on each side of a
tile, keys, faults, lines stored straight to the outputs, a ring in
device scratch, row slices and explicit stream keys; the wide family at
widths over one, two and three of its warp's 32-line turns). It times the warp tier against the block tier on the same rows at each
window it could take (``tier_cut``). Then it drives the port's
paths, each with the launch counts set to 0 just before and read just
after:

  * the Op-list path, ``check_batch(scheduler=False)`` on seeded
    CAS-register histories of 1,000 invocations each (125 of them: cut
    in count, never in length, to keep the run short), with the host
    oracle on sampled rows;
  * the columnar exact path, ``check_synth(scheduler=False)`` on the
    north-star spec: 10,000 histories of 1,000 ops generated on the
    card, encoded by the columnar walk and checked by the frontier
    kernel, with its layer split, the host oracle on sampled rows,
    ``details=True`` against ``check_batch`` on a 256-row slice, and two
    wide W = 17 specs; the same spec also through the default
    ``check_synth`` (the scheduler), timed and held against it;
  * the scheduler main path, the default ``check_synth`` on the bench's
    keyed headline spec (10,000 histories of 1,000 ops over 8 keys):
    per-key partition, fused and renumbered encode groups, the bucket
    scheduler and its group launches, held against the exact path on
    every history, the host oracle on sampled sub-histories and
    ``details=True`` on a 256-row slice; then the scheduler over the
    wide specs and over 125 Op-list histories against
    ``scheduler=False``;
  * the native host engines (``jepsen_torch/native``, built with g++ at
    first use) and the legacy host stream (``native_path``): on the
    north-star spec and the keyed headline (after its partition), the
    encode with the C++ walk against the numpy walk, exact (and on the
    headline fused and renumbered), bit for bit and each timed; then
    ``check_synth(synth="host")`` on both specs (the headline's cut to
    5,000 rows for the script's time) with ``scheduler=False`` and
    ``True`` (K1 and K2f on the card): equal verdicts and bad ops,
    sampled rows
    against the host oracle, and the rows that failed inside a fused
    run, which the C++ batch engine re-derives, held to ``wgl_check``
    and timed through both engines;
  * the dependency-graph closure kernel's two entries (``graph_closure``,
    ``txn_closure``) against their plain versions at every vertex bucket
    from 8 to 2048, in each tier (``graph_kernel_parity``: a warp a
    plane to V 32, blocked Warshall on 32 x 32 bit tiles in shared
    memory to V 1024, over batches that the plan spreads over 1, 2, 4
    and 8 CTAs a plane, and in device memory from V 2048), then the cycle
    checker,
    ``check_graphs_batch``, on the reference bench's list-append batch
    and on a full-width one of 1,000-op histories (``graph_path``), and
    the isolation certifier, ``certify_batch``, on the bench's
    transactional mix and a wide one (``isolation_path``), each held
    against its host oracle (run on a pool of worker processes) and the
    kernel against its plain version and its library route (bfloat16
    matmul squarings) on the batch;
  * the fold kernels' four entries (``fold_counts`` in each of its four
    families, ``counter_scan``, ``queue_scan``, ``fifo_scan``) against
    their plain versions on seeded random lines at every width edge and
    in both tiers, and ``queue_scan`` on rows of 40,002 lines at V 1,
    16,384 and 65,536 with misses at line 0, the last line and each
    side of a tile and a warp's chunk edge, and of two values that one
    thread of the fold takes (``fold_kernel_parity``), then each of the seven fold
    checkers' ``check_*_batch`` on the reference bench's total-queue
    batch and on a full-width batch per family, 8 histories of 10,000
    elements with seeded violations, every history held against its host
    oracle in ``checkers.simple`` and the kernel against its plain
    version on the batch (``fold_path``);
  * the peel loop (K4, ``cuda_dc.dc_peel``) against its plain version on
    the probe plan, pair, random, one-cluster and shifted-cluster plans at
    every edge of its three tiers (warp to E 256, shared memory, device
    memory), all-inactive rows and round caps 1 and 3
    (``dc_kernel_parity``); then the
    peel prefilter at full width (``dc_path``): the rate probe
    (``fleet.probe_and_persist``), and two batches of 1,024 unkeyed
    read/write histories of 80 ops at W 11-16, one healthy and one with
    every eighth row stale, each through ``check_batch_columnar`` with
    ``wgl_backend`` "dc", "xla" (the frontier search alone) and "auto"
    (on the probed rates), verdicts and bad ops equal across the three,
    the certified rows equal to the host twin, a sample against
    ``wgl_check``, K4 measured on the plans the path gave it (every one
    in its warp tier; beside it the empty kernel on its grids and the
    whole peel as PyTorch calls, its library route), and each
    dc run's frontier launches replayed alone, once a batch also one by
    one with their plans and the bound from the operations their data
    needs (``k1_launches_measure``); then
    ``fleet.route_check`` on a mixed corpus (cas, rw, list-append and
    transactional histories at the bench's shapes), every row held to
    its host oracle (``route_check``);
  * the list-append generator (K8c, ``cuda_synth.synth_la``) against its
    plain version bit for bit over processes, keys (past the counts'
    shared-memory share), op counts, corruption rates, lines stored
    straight to the outputs, a ring in device scratch, a row slice and
    explicit stream keys (``la_synth_parity``); then the la path on the
    card, ``synthesize`` -> ``decode_la`` -> ``check_graphs_batch(family=
    "list-append")``, on a full-width batch (4 histories of 1,000 ops
    over 8 keys, half corrupted: V 1,024) and the reference bench's
    shape (2,000 of 30 ops), every corrupted row invalid with a G2
    cycle and every clean one valid, sampled rows against the host
    oracle on the worker pool, and K8c timed alone on 10,000 histories
    of 1,000 ops (``la_path``).

Then the fault ladder's phases, after every kernel is built:

  * the instrumented entry of the frontier kernel (K2 instrument, each
    row's closure passes) against the plain version's pass count bit for
    bit and against the frontier kernel's valid, bad and frontier, on
    random tables at every edge of its plan (the warp tier at one to
    eight masks a lane, the block and device-memory tiers past it, each
    with its table staged and in device memory), on hand-built rows
    whose counts tell its slot schedule from broken ones
    (``count_edge_rows``, against their known counts too) and on the
    north-star bucket and the keyed headline's dispatched buckets, which
    its path (``measure_closure_iters``) measures (``instrument_parity``);
  * the keyed headline's shape at 1,000 histories under each single-fault
    schedule of the checker nemesis, fault-free, with
    ``scheduler=False``, launched on a side stream, under a sticky
    corruption that quarantines every row to the host oracle, and killed
    at a decode chunk then resumed from a chunk journal with no decided
    row dispatched again (``wgl_faults``);
  * the graph and isolation bench batches under each single-fault
    schedule, and killed and resumed (``graph_faults``);
  * the failure classifier on the card's real failures: an allocation
    far past its memory and a refused launch (``real_oom``);
  * the seed campaign, ``runtime.run_synth_seeds``, over three seeds of
    a faulted keyed cas spec, then killed mid seed 1 by the checker
    nemesis and resumed from its checkpoint and journals: the same
    summaries, no completed seed run again, only undecided rows
    dispatched (``campaign``);
  * the fuzz loop, ``fuzz.fuzz_campaign``, two rounds over the same spec
    with every eighth neighbour re-checked by the host engine: no
    disagreement and at least one invalid neighbourhood (``fuzz``);
  * the online checker, ``online.OnlineDaemon``, over a live store of 16
    tenants (14 CAS runs of the north-star shape, 2,000 ops by 5
    processes, one over 40 values whose state space crosses 32 states,
    one wide run whose mask axis lies in K1's wide tiers), each WAL
    written by ``HistoryWAL`` in flushes of 64 ops with the daemon
    ticking between flushes and dropped for a new one half way: the
    delta path's launches of the frontier kernel's resume entry counted
    and replayed alone (by shape, beside the empty kernel on their
    grids), every launch held to the plain version from the same carry,
    every fourth delta verdict of each tenant held to
    ``check_batch_columnar`` of its prefix, every final verdict to the
    post-mortem recheck, no frontier invalidated but where a new kind
    renumbered the state space, the new daemon restoring each tenant's
    frontier checkpoint and dispatching only the suffix, five of the
    tenants rerun with ``JT_ONLINE_DC=1`` to the same verdicts, and a
    carry widened from one state word to two in place; with the host
    split of a tick read from the span tracer (``online_path``).

Then the multi-device routes, on a mesh of the card named 8 times
(``provision.provisioned``; until then nothing is provisioned, the
one-card host has no production mesh, and no sharded dispatch may run):

  * the frontier-sharded step (K3, ``csrc/wgl_shard.cu``) on explicit
    meshes 4 x 2, 2 x 4 and 1 x 8 at local windows 1, 8, 9, 13, 14, 15
    and 16 (``shard_close``'s block tier at its widest, its cluster tier
    at 2, 4 and 8 CTAs), one and two state words, shared and per-row tables,
    padding rows, rows that fail on and survive a top-slot completion, and
    the rows a broken close fails (a chain that gains in a late pass, a
    config only the cluster's top rank bit reaches, a slot fresh only
    because an OK freed it): each of its three kernels against its plain
    version on every input the walk gives it, and the walk's valid, bad
    and frontier against K1 on the same rows, with the close's launches
    per tier (``mesh_kernel_parity``);
  * the production routes: wide Op-list rows at W 17, 18 and 19 and a
    columnar W 18 batch on the frontier route, the wide W 17
    ``check_synth`` specs on it against their one-card ``data1wide`` run,
    and the dryrun's 256 CAS histories of 256 ops on the batch-sharded
    route against ``data1`` and ``wgl_check`` (``mesh_path``). Every K3
    walk of these routes is replayed through the plain versions (the
    outputs must be equal) and with each kernel held against its plain
    version on every input; K3 is timed on the wide specs beside K1's
    data1wide time on them, with K1's bound on those rows shared out
    over its three kernels.

``python3 chip_smoke.py --headline TREE [TREE ...]`` instead times the
default ``check_synth`` on the keyed headline spec in each checkout
given, in that order (for example parent, change, change, parent).
``python3 chip_smoke.py --kernels TREE [TREE ...]`` times the frontier
kernel (K1) over every launch of the dc batches' dc runs, the count
fold (K7a) on each family's full-width batch, the counter, queue and
FIFO scans (K7b, K7c, K7d) on theirs, and the closure's two entries
(K5 on 32 and on 16 full-width list-append graphs, V 1024; K6 on 128
wide transactional graphs, V 256) and the generators (K8a on the
north-star batch, K8c on 10,000 la histories of 1,000 ops, and each on
the first 528 and 2,112 rows of its batch, also through its wrapper and
split into its kernels by the profiler), the peel loop (K4) over every
plan of the dc batches' dc runs, and the wide generator (K8b) on the
wide path's 256 rows of width 17, and the instrumented entry (K2
instrument) with K1 on the north-star bucket and on the keyed
headline's dispatched buckets, each W apart, each beside the empty
kernel (``csrc/launch_floor.cu``) on its grids, the launch floor; the same
inputs in each checkout given, with the bound, each K1 launch's plan and
time, and the folds', closures' and K4's library routes measured once in
this checkout, and the frontier-sharded step (K3) over the wide W 17
``check_synth`` specs' walks on a mesh of the card named 8 times (each
kernel's device time by the profiler, the walk by the host clock).
``--kernels --only dc,wide TREE ...`` times only the named groups
(``k1``, ``folds``, ``closures``, ``synth``, ``dc``, ``wide``,
``instrument``, ``mesh``).

Kernel times are of the kernel alone (``time_launches``: carries reset
and outputs allocated outside the window, CUDA events around each
launch), with the wrapper-inclusive time beside them as ``wrapper_ms``.
Each phase prints one JSON line; a failed check raises and the script
exits non-zero. The last three lines are the kernels line, the card's
name and power limit as nvidia-smi reports them, and the result line.

Exits 2 without a result when no CUDA device is available.
"""
from __future__ import annotations

import collections
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The card's published peaks (H100 SXM data sheet, full 700 W power
# limit): device memory rate, and the int32 lane-op rate — half the
# 67 TFLOP/s float32 FMA rate's lanes (64 INT32 lanes per SM against 128
# FP32 lanes), one op per lane per clock: 67e12 / 2 / 2.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# The north-star batch: 10,000 CAS-register histories of 1,000 ops.
NS_SPEC = dict(family="cas", n=10_000, seed=0, n_procs=5, n_ops=1_000,
               n_values=5, corrupt=0.25)
# The reference bench's keyed headline batch (bench.py:271-273): the
# scheduler main path.
HEADLINE_SPEC = dict(family="cas", n=10_000, seed=1, n_procs=5,
                     n_ops=1_000, n_values=5, corrupt=0.1, p_info=0.01,
                     n_keys=8)
# The Op-list path's count, cut from 2,000 (to 1,000, then to 500 when
# the la phases joined the script, to 250 when the mesh phases did, and
# to 125 when native_path did); its length is uncut. Host-oracle rows of the WGL paths: 32 (64 until
# the mesh phases joined the script).
OPLIST_HISTORIES = 125
SCHED_OPLIST_HISTORIES = 125
ORACLE_ROWS = 32
DETAIL_ROWS = 256
WIDE_ROWS = 256
# K8b's parity widths: one, two and three of its warp's 32-line turns
# (lines = width + 1), the wide path's 17 and K1's wide tiers' edges.
WIDE_PARITY_WIDTHS = (2, 6, 9, 17, 18, 33, 40)

# Integer operations of one splitmix32 draw (fold_in): the counter add,
# the stride multiply and key add, then mix's three shift-xor-multiply
# rounds (the last without the multiply).
FOLD_IN_OPS = 11


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase line also gets the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def on(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(dev)


def bucket_args(b, dev):
    tgt = b.target[0] if b.shared_target else b.target
    return (on(b.ev_type, dev), on(b.ev_slot, dev), on(b.ev_slots, dev),
            on(tgt, dev))


def kernel_vs_plain(args, V, W, w_live, dev, L, idx0=0):
    """Run one batch through the CUDA kernel and the plain version on
    the card from a fresh carry; return (equal, max_abs_err, rows
    invalid)."""
    carry = L.initial_carry(args[0].shape[0], V, W, dev)
    kv, kb, kf, kfb = L.get_kernel(V, W, w_live=w_live,
                                   resume=True)(*args, idx0, *carry)
    pv, pb, pf, pfb = L.plain_wgl(*args, idx0, *carry, V=V, W=W,
                                  w_live=w_live)
    torch.cuda.synchronize()
    equal = (torch.equal(kv, pv) and torch.equal(kb, pb)
             and torch.equal(kf, pf) and torch.equal(kfb, pfb))
    err = 0
    for x, y in ((kb, pb), (kf, pf), (kfb, pfb)):
        d = (x.to(torch.int64) & 0xFFFFFFFF) - (y.to(torch.int64)
                                                & 0xFFFFFFFF)
        err = max(err, int(d.abs().max()) if d.numel() else 0)
    err = max(err, int((kv != pv).sum()))
    return equal, err, int((~kv).sum())


# Seeded random tables (V, W, w_live, K1, shared target) at every tier
# edge of the kernel: W = 1, 2, 4, 5, W_WARP and W_WARP + 1 (warp tier,
# then block tier), 15 (the widest block-tier window at one word) and 16
# (device-memory tier). They cover every event code, slot and kind
# indices past both ends (they clamp and wrap as in the reference), int8
# and int32 slot tables (K1 >= 127), V = 8, 40, 48 and 64 (two state words
# with bit 31), shared and per-row targets, w_live < W, warp-tier tables
# as nibble images (V <= 8), as int8 targets, in a block of fewer rows,
# and left in device memory (K1 = 800 at V = 64).
def random_cases(w_warp: int) -> tuple:
    return ((8, 1, None, 5, True), (8, 2, None, 7, False),
            (40, 4, None, 9, True), (64, 4, None, 9, False),
            (8, 5, None, 7, True), (64, 5, 3, 200, False),
            (48, 6, None, 200, True), (64, 6, None, 800, True),
            (64, 3, None, 800, False),
            (8, w_warp, None, 12, False), (40, w_warp, 6, 130, True),
            (8, w_warp + 1, 6, 12, False), (8, 15, 5, 9, True),
            (8, 16, 3, 6, True))


# Events per random row: three 32-event tiles of the warp tier.
RANDOM_EVENTS = 96

# The wide tiers' random cases (V, W, w_live, K1, shared target): every W
# from W_WARP + 1 to 18 at one state word (V 8) and two (V 40), shared
# and per-row targets, w_live < W on even W; so the block tier, clusters
# of 2, 4 and 8 CTAs and the device-memory tier (V 40 at W 18); then a
# table past shared memory beside the frontier (read from device
# memory), and two words at V 48 and 64. Rows 4-7 are mostly padding.
def wide_cases(w_warp: int) -> tuple:
    out = []
    for W in range(w_warp + 1, 19):
        for V in (8, 40):
            shared = (W + V) % 2 == 0
            out.append((V, W, W - 2 if W % 2 == 0 else None,
                        9 if shared else 130, shared))
    return tuple(out) + ((64, 13, None, 3000, True), (64, 18, 5, 6, True),
                         (48, 17, None, 12, False))


# Rows of a wide case: fewer where the plain version's frontier is large.
def wide_rows(W: int) -> int:
    return 8 if W <= 15 else 4


def pad_heavy(rng, args, rows=range(4, 8)):
    """Make most events of ``rows`` padding (EV_PAD), in place."""
    ev_type = args[0]
    for r in rows:
        if r < ev_type.shape[0]:
            keep = torch.from_numpy(rng.random(ev_type.shape[1]) < 0.15)
            ev_type[r] = torch.where(keep.to(ev_type.device), ev_type[r],
                                     torch.zeros_like(ev_type[r]))
    return args


def chunked_vs_one_shot(L, args, V, W, wl, dev, cut=40) -> bool:
    """The resume entry over events [0, cut) then [cut, N) against one
    launch over all N, from a fresh carry: all four outputs equal."""
    kern = L.get_kernel(V, W, w_live=wl, resume=True)
    carry = L.initial_carry(args[0].shape[0], V, W, dev)
    one = kern(*args, 0, *carry)
    head = [a[:, :cut] for a in args[:3]]
    tail = [a[:, cut:].contiguous() for a in args[:3]]
    mid = kern(*[h.contiguous() for h in head], args[3], 0, *carry)
    # kern returns (valid, bad, F, Fb); the carry order is (F, Fb, valid,
    # bad)
    two = kern(*tail, args[3], cut, mid[2], mid[3], mid[0], mid[1])
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(one, two))


def random_tables(rng, B, N, V, W, w_live, K1, shared, dev):
    """Seeded random tables for B rows of N events. The first rows are
    edge rows (when N >= 64): row 0 is all EV_PAD, rows 1 and 2 end their
    live events at the last event of the first and second 32-event tile,
    row 3 has one live event, the first of the second tile."""
    ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
    if B >= 4 and N >= 64:
        ev_type[0] = 0
        ev_type[1, 32:] = 0
        ev_type[1, 31] = 2
        ev_type[2, 64:] = 0
        ev_type[2, 63] = 3
        ev_type[3] = 0
        ev_type[3, 32] = 2
    ev_slot = rng.integers(-1, W + 1, (B, N)).astype(np.int8)
    ev_slots = rng.integers(-1, K1 + 1, (B, N, W))
    # the completing slot holds a real op kind, as in an encoded history
    q = np.clip(ev_slot, 0, (w_live or W) - 1).astype(np.int64)
    ev_slots[np.arange(B)[:, None], np.arange(N)[None], q] = \
        rng.integers(0, K1 - 1, (B, N))
    ev_slots = ev_slots.astype(np.int8 if K1 < 127 else np.int32)
    shape = (K1, V) if shared else (B, K1, V)
    target = rng.integers(-1, V, shape).astype(np.int32)
    target[rng.random(shape) < 0.5] = -1     # rows both fail and survive
    target[..., K1 - 1, :] = -1
    return tuple(on(a, dev) for a in (ev_type, ev_slot, ev_slots, target))


def tier_of(L, V, W, w_live, K1, shared) -> dict:
    """The kernel's plan for a bucket, as the wrappers pick it."""
    plan = L.cuda_wgl.smem_plan(V, W, w_live, K1=K1, shared_target=shared)
    return {"tier": plan["tier"], "rows_per_block": plan["rows_per_block"],
            "table_form": plan["table_form"],
            "cluster_ctas": plan["cluster_ctas"]}


def phase_kernel_parity(dev, L, synth, cas, prep, bucket_encode):
    out = {"phase": "kernel_vs_plain", "buckets": []}
    max_err = 0
    # (a) W = 6..18: shared-memory and device-memory frontiers.
    ha = synth(256, seed0=1, n_procs=5, n_ops=200, n_values=5,
               corrupt=0.25, p_info=0.05)
    ba = bucket_encode(cas(), [prep(h) for h in ha], max_states=64,
                       max_slots=18)
    # (b) two state words: V = 40 and 48.
    hb = synth(16, seed0=5, n_procs=4, n_ops=300, n_values=48,
               corrupt=0.25)
    bb = bucket_encode(cas(), [prep(h) for h in hb], max_states=64,
                       max_slots=18)
    Ws, Vs = set(), set()
    for tag, bs in (("a", ba), ("b", bb)):
        for b in bs:
            if not b.batch:
                continue
            eq, err, inv = kernel_vs_plain(bucket_args(b, dev), b.V, b.W,
                                           b.eff_w_live, dev, L)
            out["buckets"].append({
                "corpus": tag, "V": b.V, "W": b.W, "rows": b.batch,
                "events": b.n_events, "invalid": inv, "equal": eq,
                **tier_of(L, b.V, b.W, b.eff_w_live, b.target.shape[-2],
                          b.shared_target)})
            require(eq, f"kernel != plain at corpus {tag} V={b.V} "
                        f"W={b.W}")
            max_err = max(max_err, err)
            Ws.add(b.W)
            Vs.add(b.V)
    require(set(range(6, 19)) <= Ws, f"corpus (a) missed a W: {sorted(Ws)}")
    require(any(v > 32 for v in Vs), "no two-word corpus")
    # Seeded random tables, resumed at a nonzero event index.
    rng = np.random.default_rng(2024)
    tiers = set()
    for V, W, wl, K1, shared in random_cases(L.cuda_wgl.W_WARP):
        args = random_tables(rng, 64, RANDOM_EVENTS, V, W, wl, K1, shared,
                             dev)
        eq, err, inv = kernel_vs_plain(args, V, W, wl, dev, L, idx0=1000)
        tier = tier_of(L, V, W, wl, K1, shared)
        tiers.add((tier["tier"], tier["table_form"],
                   tier["rows_per_block"] < L.cuda_wgl.WARP_ROWS
                   and tier["tier"] == "warp"))
        out["buckets"].append({
            "corpus": "random", "V": V, "W": W, "w_live": wl, "K1": K1,
            "shared_target": shared, "rows": 64, "events": RANDOM_EVENTS,
            "invalid": inv, "equal": eq, **tier})
        require(eq, f"kernel != plain on random tables V={V} W={W}")
        max_err = max(max_err, err)
    require({("warp", "nibble", False), ("warp", "int8", False),
             ("warp", "int8", True), ("warp", "device", False),
             ("block", "int8", False), ("cluster", "int8", False)}
            <= tiers, f"the random cases missed a tier: {sorted(tiers)}")
    # The wide tiers at every W, both word counts, with mostly-padding
    # rows, rows that fail (the latch) and rows that stay valid; and the
    # event-chunked resume against the one-shot launch at each plan.
    wide, seen, resumed_wide = [], set(), 0
    for V, W, wl, K1, shared in wide_cases(L.cuda_wgl.W_WARP):
        B = wide_rows(W)
        args = pad_heavy(rng, random_tables(rng, B, RANDOM_EVENTS, V, W, wl,
                                            K1, shared, dev))
        eq, err, inv = kernel_vs_plain(args, V, W, wl, dev, L, idx0=1000)
        plan = L.cuda_wgl.smem_plan(V, W, wl, K1=K1, shared_target=shared)
        chunked = chunked_vs_one_shot(L, args, V, W, wl, dev)
        resumed_wide += 1
        wide.append({"V": V, "W": W, "w_live": wl, "K1": K1,
                     "shared_target": shared, "rows": B,
                     "events": RANDOM_EVENTS, "invalid": inv, "equal": eq,
                     "chunked_equal": chunked, "tier": plan["tier"],
                     "cluster_ctas": plan["cluster_ctas"],
                     "table_form": plan["table_form"]})
        require(eq, f"kernel != plain on wide tables V={V} W={W}")
        require(chunked, f"chunked != one-shot on wide tables V={V} W={W}")
        max_err = max(max_err, err)
        seen.add((plan["tier"], plan["cluster_ctas"], plan["table_form"]))
    out["wide"] = wide
    require({("block", 1, "int8"), ("block", 1, "device"),
             ("cluster", 2, "int8"), ("cluster", 4, "int8"),
             ("cluster", 8, "int8"), ("device", 1, "int8")} <= seen,
            f"the wide cases missed a plan: {sorted(seen)}")
    require({(c["W"], c["V"] > 32) for c in wide}
            >= {(W, two) for W in range(L.cuda_wgl.W_WARP + 1, 19)
                for two in (False, True)}, "a wide W or word count missed")
    require(0 < sum(c["invalid"] for c in wide)
            < sum(c["rows"] for c in wide), "no failing or no valid row")
    # (c) the resume entry: event-chunked equals one-shot.
    resumed = 0
    for b in [x for x in ba if x.batch and x.W <= 12] + bb:
        one = L.run_encoded_batch(b, True, device=dev)
        chunked = L.run_event_chunked(b, 24, True, device=dev)
        for x, y in zip(one, chunked):
            require(np.array_equal(x, y),
                    f"chunked != one-shot at V={b.V} W={b.W}")
        resumed += 1
    out["resume_buckets"] = resumed + resumed_wide
    out["max_abs_err"] = max_err
    emit(out)
    return max_err


TIER_CUT_ROWS = 4096


# The variants tier_cut compares: (name, warp tier taken, nibble images).
TIER_VARIANTS = (("warp", True, True), ("warp_int8", True, False),
                 ("block", False, True))


def phase_tier_cut(dev, L, S, cas):
    """The warp tier against the block tier on the same rows, W = 5 to
    the widest window the warp tier is built for: the first 4,096
    north-star rows (V 8, W 5, 792 events), widened as the scheduler
    widens a bucket to its W class; and the warp tier's nibble images
    against its int8 table. Kernel alone, the variants in turns and back
    (warp, warp_int8, block, block, warp_int8, warp), their outputs held
    equal: the basis of W_WARP and NIBBLE_MAX_V."""
    from jepsen_torch.ops.encode import (encode_columnar, take_rows,
                                         widen_batch)
    from jepsen_torch.ops.statespace import enumerate_statespace
    cw = L.cuda_wgl
    spec = S.SynthSpec(**{**NS_SPEC, "n": TIER_CUT_ROWS})
    cols, _ = S.synth_cas_device(spec, key_meta=False, device=dev)
    space = enumerate_statespace(cas(), cols.kinds, 64)
    buckets, _ = encode_columnar(space, cols, max_slots=18)
    b = max(buckets, key=lambda x: x.batch)
    out = {"phase": "tier_cut", "rows": b.batch, "V": b.V,
           "events": b.n_events, "w_live": b.eff_w_live,
           "w_warp": cw.W_WARP, "by_W": []}
    saved = cw.W_WARP, cw.NIBBLE_MAX_V
    try:
        for W in range(b.W, cw.WARP_MAX_W + 1):
            wb = widen_batch(b, W)
            args = bucket_args(wb, dev)
            carry = L.initial_carry(wb.batch, wb.V, W, dev)
            times = {name: [] for name, _, _ in TIER_VARIANTS}
            results = {}
            for name, warp, nibble in TIER_VARIANTS + TIER_VARIANTS[::-1]:
                cw.W_WARP = W if warp else W - 1
                cw.NIBBLE_MAX_V = saved[1] if nibble else 0
                times[name].append(time_launches([prepared_single(
                    L, *args, 0, *carry, V=wb.V, W=W,
                    w_live=wb.eff_w_live)], reps=3))
                results[name] = L.get_kernel(wb.V, W,
                                             w_live=wb.eff_w_live)(*args)
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y) for r in results.values()
                        for x, y in zip(r, results["block"]))
            require(equal, f"the tiers disagree at W={W}")
            out["by_W"].append({"W": W, **{f"{n}_ms": t for n, t in
                                           times.items()},
                                "equal": equal})
    finally:
        cw.W_WARP, cw.NIBBLE_MAX_V = saved
    # The warp tier at the bucket's own W on fewer rows: how its time
    # scales with the warps an SM holds.
    out["rows_scaling"] = []
    for rows in (1024, 2048, TIER_CUT_ROWS):
        sub = take_rows(b, range(rows))
        args = bucket_args(sub, dev)
        carry = L.initial_carry(rows, sub.V, sub.W, dev)
        out["rows_scaling"].append({"rows": rows, "warp_ms": time_launches(
            [prepared_single(L, *args, 0, *carry, V=sub.V, W=sub.W,
                             w_live=sub.eff_w_live)], reps=3)})
    emit(out)


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# GPU cycles the card sleeps before each timed launch, so that the host
# enqueues the launch and its closing event while the card is still busy
# and the window holds the kernel alone (about 200 us at 1.98 GHz: an
# entry of several kernels, enqueued while the host oracles' workers
# load the CPU, took more than 50 us).
SLEEP_CYCLES = 400_000


def time_launches(launches, reps: int) -> float:
    """Mean milliseconds per rep of a sequence of prepared launches, the
    kernel alone: each ``(reset, launch)`` pair restores its carry before
    the window, and CUDA events bracket the launch only."""
    for reset, launch in launches:
        reset()
        launch()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        for reset, launch in launches:
            reset()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            stop.record()
            windows.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in windows) / reps


def kernel_split(fn, reps: int) -> dict:
    """Milliseconds per call of each CUDA kernel that fn() launches, by
    torch.profiler's device times (the kernel's name without its
    namespace and arguments): the passes of a multi-kernel entry apart."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0))
        if us:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1]
            name = name.split("::")[-1]
            split[name] = split.get(name, 0.0) + us / 1e3 / reps
    return split


def synth_times(cuda_synth, family, args, st, reps: int) -> dict:
    """A generator kernel of ``family`` ("cas": K8a, "la": K8c) on the
    given inputs: alone (its prepared launch, outputs allocated outside
    the window; a tree without ``prepare_cas`` times the wrapper in the
    same sleep-bracketed window and says so in ``timed``), through its
    wrapper, and each of its kernels apart by the profiler."""
    wrap = cuda_synth.synth_cas if family == "cas" else cuda_synth.synth_la
    prepare = getattr(cuda_synth, f"prepare_{family}", None)

    def wrapper():
        wrap(*args, **st)
    launch, timed = ((wrapper, "wrapper") if prepare is None
                     else (prepare(*args, **st)[0], "prepared"))
    return {"ms": time_launches([(lambda: None, launch)], reps=reps),
            "timed": timed,
            "wrapper_ms": time_launches([(lambda: None, wrapper)],
                                        reps=reps),
            "split_ms": kernel_split(launch, reps)}


def wide_grid(B: int) -> tuple:
    """K8b's launch grid on B rows: blocks of eight rows, a warp each
    (kWideWarps in the source)."""
    return -(-B // 8), 256


def wide_launch(cuda_synth, vk, st):
    """K8b's launch alone on ``vk``: its prepared launch, or, in a tree
    without ``prepare_wide``, its library entry on outputs allocated
    here; with which of the two it is ("prepared", "library entry")."""
    prepare = getattr(cuda_synth, "prepare_wide", None)
    if prepare is not None:
        return prepare(vk, **st)[0], "prepared"
    B, N = vk.shape[0], st["width"] + 1
    out = [torch.empty((B, N), dtype=d, device=vk.device)
           for d in (torch.int8, torch.int16, torch.int32)]
    out.append(torch.empty(B, dtype=torch.int32, device=vk.device))
    lib = cuda_synth._library()

    def launch(_alive=(vk, out)):
        err = lib.synth_wide_launch(
            vk.data_ptr(), B, st["width"], st["n_values"],
            int(st["invalid"]), *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"synth_wide_launch failed: {err}")
    return launch, "library entry"


def wide_times(cuda_synth, vk, st, reps: int, floor_path=None) -> dict:
    """K8b on ``vk``: alone (``time_launches``), through its wrapper
    (``time_cuda``, back to back) and the empty kernel on its grid
    (``floor_ms``)."""
    launch, timed = wide_launch(cuda_synth, vk, st)
    return {"ms": time_launches([(lambda: None, launch)], reps=reps),
            "timed": timed,
            "wrapper_ms": time_cuda(lambda: cuda_synth.synth_wide(vk, **st),
                                    reps=reps),
            "floor_ms": time_launches(floor_launches(
                [wide_grid(vk.shape[0])], floor_path), reps=reps)}


def prepared_single(L, ev_type, ev_slot, ev_slots, target, idx0, F, Fb,
                    valid, bad, **kw):
    """A single-bucket launch on copies of the given carry, with the
    reset that restores them: ``(reset, launch)``."""
    init = (F, Fb, valid, bad)
    carry = [t.clone() for t in init]
    launch = L.cuda_wgl.prepare_frontier(ev_type, ev_slot, ev_slots, target,
                                         idx0, *carry, **kw)

    def reset():
        for c, t in zip(carry, init):
            c.copy_(t)
    return reset, launch


def prepared_group(L, members, flat, rows):
    """A group launch with its outputs allocated, and the reset that
    restores their initial carry: ``(reset, launch)``."""
    launch, outs = L.cuda_wgl.prepare_group(members, flat, rows)
    init = [o.clone() for o in outs]

    def reset():
        for o, t in zip(outs, init):
            o.copy_(t)
    return reset, launch


def outputs_err(a: dict, b: dict) -> int:
    """Largest absolute difference over every output of two result
    dicts (integer and bool tensors of equal shapes)."""
    return max((int((a[n].to(torch.int64) - b[n].to(torch.int64))
                    .abs().max()) if a[n].numel() else 0) for n in b)


def synth_case(S, cuda_synth, spec, dev, rows=None, key_meta=True,
               keys=None):
    """The generator kernel of ``spec``'s family and its plain version on
    the same inputs on the card: (kernel outputs, plain outputs)."""
    if spec.family == "la":
        args = S.la_inputs(spec, rows=rows, keys=keys, device=dev)
        st = S.la_static(spec)
        return cuda_synth.synth_la(*args, **st), S.plain_la_core(*args, **st)
    if spec.family == "wide":
        vk = S.wide_inputs(spec, rows=rows, device=dev)
        st = dict(width=spec.width, n_values=spec.n_values,
                  invalid=spec.invalid)
        return cuda_synth.synth_wide(vk, **st), S.plain_wide_core(vk, **st)
    args = S.cas_inputs(spec, rows=rows, device=dev)
    st = S.cas_static(spec, key_meta)
    return (cuda_synth.synth_cas(*args, **st),
            S.plain_cas_core(*args, **st))


def phase_synth_parity(dev, S, cuda_synth):
    import dataclasses
    spec = S.SynthSpec
    ns = spec(**NS_SPEC)
    cases = [("north_star_rows_0_256", ns, (0, 256)),
             ("keyed_all_faults",
              spec(n=64, seed=3, n_procs=4, n_ops=18, n_values=3, n_keys=3,
                   p_info=0.1, crash_lo=4, crash_hi=12, p_crash=0.5,
                   corrupt=0.4), None)]
    cases += [(f"n_procs_{p}", spec(n=128, seed=5, n_procs=p, n_ops=300,
                                    n_values=5, corrupt=0.5, p_info=0.1),
               None) for p in (1, 2, 5, 12)]
    cases += [(f"n_values_{v}", spec(n=128, seed=6, n_procs=5, n_ops=300,
                                     n_values=v, n_keys=2, corrupt=0.5),
               None) for v in (1, 2, 48)]
    cases += [(f"n_ops_{n}", spec(n=64, seed=7, n_procs=5, n_ops=n,
                                  n_values=3, corrupt=0.5, p_info=0.2,
                                  crash_lo=0, crash_hi=500, p_crash=0.2),
               None) for n in (1, 2, 31, 32, 33, 64, 1000)]
    # Windows over several of the row kernel's 32-op tiles, the largest
    # value count the 24-bit kind field takes, every key with crashes and
    # timeouts, a line buffer past the warp's shared memory (P 700: lines
    # stored straight to the outputs) and a ring past it (P 3,000: the
    # device-scratch ring).
    cases += [(f"n_procs_{p}", spec(n=128, seed=8, n_procs=p, n_ops=600,
                                    n_values=5, n_keys=3, corrupt=0.5,
                                    p_info=0.1), None)
              for p in (33, 40, 100)]
    cases += [("n_values_4094", spec(n=128, seed=10, n_procs=5, n_ops=300,
                                     n_values=4094, n_keys=2, corrupt=0.5),
               None),
              ("n_keys_16_crash_info",
               spec(n=128, seed=11, n_procs=6, n_ops=400, n_values=4,
                    n_keys=16, p_info=0.15, crash_lo=50, crash_hi=350,
                    p_crash=0.3, corrupt=0.5), None),
              ("lines_direct",
               spec(n=64, seed=13, n_procs=700, n_ops=1500, n_values=5,
                    n_keys=4, p_info=0.1, corrupt=0.5), None),
              ("ring_in_device",
               spec(n=32, seed=12, n_procs=3000, n_ops=4000, n_values=5,
                    n_keys=4, p_info=0.1, corrupt=0.5), None)]
    cases += [(f"wide_{w}_{'invalid' if inv else 'valid'}",
               spec(family="wide", n=WIDE_ROWS, seed=2, width=w,
                    n_values=2, invalid=inv), None)
              for w in WIDE_PARITY_WIDTHS for inv in (False, True)]
    out = {"phase": "synth_vs_plain", "cases": []}
    err = 0
    for label, sp, rows in cases:
        k, p = synth_case(S, cuda_synth, sp, dev, rows)
        torch.cuda.synchronize()
        require(set(k) == set(p), f"{label}: outputs {sorted(k)} != "
                                  f"{sorted(p)}")
        equal = all(torch.equal(k[n], p[n]) for n in p)
        err = max(err, outputs_err(k, p))
        case = {"case": label, "outputs": sorted(p),
                "rows": int(p["type"].shape[0]),
                "lines": int(p["type"].shape[1]), "equal": equal}
        if sp.family == "cas":
            case["plan"] = cuda_synth.synth_plan("cas", sp.n_procs,
                                                 sp.n_ops, sp.n_keys)
        out["cases"].append(case)
        require(equal, f"synth kernel != plain on {label}")
    # A rows=(lo, hi) slice equals the same rows of the full batch.
    sp = spec(n=300, seed=9, n_procs=5, n_ops=100, n_values=3, n_keys=4,
              corrupt=0.5, p_info=0.1)
    full, _ = synth_case(S, cuda_synth, sp, dev)
    part, plain = synth_case(S, cuda_synth, sp, dev, rows=(100, 250))
    torch.cuda.synchronize()
    sliced = all(torch.equal(full[n][100:250], part[n])
                 and torch.equal(part[n], plain[n]) for n in plain)
    require(sliced, "a row slice differs from the full batch")
    # Explicit stream keys and per-row crash windows, as the fuzz loop's
    # neighbourhoods pass them.
    rows = np.array([5, 5, 17, 40, 2, 255], np.uint32)
    keys = S.history_keys_for(sp.seed, rows)
    keys["sched"][1] = S.fold_in(keys["sched"][1], np.uint32(0xF00D))
    lo = np.array([0, 4, 8, 2, 16, 60], np.int32)
    hi = np.array([100, 9, 12, 3, 40, 99], np.int32)
    sp = dataclasses.replace(sp, p_crash=0.4)
    args = S.cas_inputs(sp, keys=keys, crash_lo=lo, crash_hi=hi, device=dev)
    st = S.cas_static(sp)
    k, p = cuda_synth.synth_cas(*args, **st), S.plain_cas_core(*args, **st)
    torch.cuda.synchronize()
    keyed = all(torch.equal(k[n], p[n]) for n in p)
    require(keyed, "synth kernel with explicit keys != plain")
    err = max(err, outputs_err(k, p))
    out.update(row_slice_equal=sliced, explicit_keys_equal=keyed,
               max_abs_err=err)
    emit(out)
    return err


def frontier_bytes(L, ev_type, ev_slots, target, V, W, w_live,
                   parts=False):
    """Bytes a frontier launch must move for its rows: per live event
    (padding events are skipped before their slots are read, so they
    count nothing) its type, its slot and its ``w_live`` slot kinds; the
    transition table (shared, or one per row) read once; and valid
    (bool), bad (int32) and the frontier (int32 [words, 2^W]) written
    once per row. ``parts``: (bytes read, bytes written) apart."""
    from jepsen_torch.ops.encode import EV_PAD
    model = L.vpu_op_model(V, W, w_live)
    live = int((ev_type != EV_PAD).sum())
    read = (live * (2 + model["w_live"] * ev_slots.element_size())
            + target.numel() * target.element_size())
    written = ev_type.shape[0] * (1 + 4 + 4 * model["words"]
                                  * model["masks"])
    return (read, written) if parts else read + written


def wgl_measure(dev, L, buckets):
    """The frontier kernel over a path's buckets: upload, kernel time
    alone (``time_launches``, 5 runs after a warm-up) and through the
    wrapper (CUDA events around the check calls, fresh carry included),
    the plain version's time, and the bound from the operations this
    batch's data needs and the bytes it must move (``frontier_bytes``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    argsets = [(b, bucket_args(b, dev)) for b in buckets]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    kerns = [L.get_kernel(b.V, b.W, w_live=b.eff_w_live) for b in buckets]

    def run_kernel():
        for k, (_, a) in zip(kerns, argsets):
            k(*a)

    wrapper_ms = time_cuda(run_kernel, reps=5)
    kernel_ms = time_launches(
        [prepared_single(L, *a, 0, *L.initial_carry(b.batch, b.V, b.W, dev),
                         V=b.V, W=b.W, w_live=b.eff_w_live)
         for b, a in argsets], reps=5)

    def run_plain(**counters):
        for j, (b, a) in enumerate(argsets):
            L.plain_wgl(*a, 0, *L.initial_carry(b.batch, b.V, b.W, dev),
                        V=b.V, W=b.W, w_live=b.eff_w_live,
                        **{k: v[j] for k, v in counters.items()})

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # Once more, untimed, counting per row the integer operations this
    # batch's data needs (each closure configuration expanded once per
    # reaching slot, one word test per kept mask): the op-count bound's
    # input.
    needed = [torch.zeros(b.batch, dtype=torch.int64, device=dev)
              for b, _ in argsets]
    run_plain(ops=needed)
    ops = sum(int(nd.sum()) for nd in needed)
    nbytes = sum(frontier_bytes(L, a[0], a[2], a[3], b.V, b.W,
                                b.eff_w_live) for b, a in argsets)
    # The closure passes of every event, from the instrumented entry, and
    # the reference's dense formulation over them (vpu_op_model: every
    # state bit of every mask tested on every pass, per_event over every
    # event), for comparison only.
    passes = L.measure_closure_iters(buckets, device=dev)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"upload_ms": upload_ms, "kernel_ms": kernel_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "tiers": [tier_of(L, b.V, b.W, b.eff_w_live, a[3].shape[-2],
                              b.shared_target) for b, a in argsets],
            "closure_sweeps": passes["iters"],
            "needed_ops": ops, "dense_model_lane_ops": passes["lane_ops"],
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def synth_bound(spec) -> dict:
    """Least time of the CAS generator on ``spec``'s whole batch: the
    bytes it must move (per-row keys and crash window read once; type,
    process, kind, the key column when keyed, and peak_w written once)
    and the integer operations of its random draws alone (every other
    operation of the kernel comes on top), whichever is larger."""
    B, n = spec.n, spec.n_ops
    nbytes = B * (4 * 4 + 2 * 4) + B * 4 \
        + B * 2 * n * (1 + 2 + 4 + (4 if spec.n_keys > 1 else 0))
    corrupt = spec.corrupt > 0 and spec.n_values > 1
    draws = B * n * (2 + int(spec.p_info > 0 or spec.p_crash > 0)
                     + int(corrupt)) + B * int(corrupt)
    ops = draws * FOLD_IN_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "draw_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def wide_bound(spec) -> dict:
    """As ``synth_bound``, for the wide generator: keys read once; type,
    process, kind and peak_w written once; one draw per write."""
    B, N = spec.n, spec.width + 1
    nbytes = B * 4 + B * N * (1 + 2 + 4) + B * 4
    ops = B * (spec.width - 1) * FOLD_IN_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "draw_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_oplist_path(dev, L, synth, cas, prep, bucket_encode, wgl_check):
    """check_batch(scheduler=False) on Op lists: the first slice's path,
    at OPLIST_HISTORIES rows."""
    from jepsen_torch.ops.encode import take_rows
    t0 = time.perf_counter()
    hists = synth(OPLIST_HISTORIES, seed0=0, n_procs=5,
                  n_ops=NS_SPEC["n_ops"], n_values=5, corrupt=0.25,
                  p_info=0.0)
    synth_s = time.perf_counter() - t0

    L.cuda_wgl.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = L.check_batch(cas(), hists, scheduler=False)
    e2e_s = time.perf_counter() - t0
    launches = L.cuda_wgl.LAUNCHES
    require(launches > 0, "check_batch did not launch the kernel")
    require(len(results) == OPLIST_HISTORIES, "missing verdicts")
    require(not any("fallback" in r for r in results),
            "Op-list rows fell back to the host")

    # Field parity with the host oracle on sampled rows, invalid ones
    # included.
    invalid = [i for i, r in enumerate(results) if r["valid"] is False]
    valid = [i for i, r in enumerate(results) if r["valid"] is True]
    sample = invalid[:ORACLE_ROWS // 2] + valid[:ORACLE_ROWS // 2]
    require(len(sample) >= ORACLE_ROWS and invalid, "sample too small")
    for i in sample:
        want = wgl_check(cas(), hists[i])
        got = results[i]
        require(got["valid"] == want["valid"], f"verdict differs at {i}")
        if want["valid"] is False:
            require(got["op"]["index"] == want["op"]["index"],
                    f"bad op differs at {i}")
        require(got.get("configs") == want.get("configs"),
                f"configs differ at {i}")

    # The same batch again, layer by layer: host prepare, host encode,
    # host-to-device copy and the kernel.
    t0 = time.perf_counter()
    prepared = [prep(h) for h in hists]
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = [b for b in bucket_encode(cas(), prepared, max_states=64,
                                        max_slots=18) if b.batch]
    encode_s = time.perf_counter() - t0
    big = max(buckets, key=lambda b: b.batch)
    head = take_rows(big, range(min(256, big.batch)))
    eq, err, _ = kernel_vs_plain(bucket_args(head, dev), head.V, head.W,
                                 head.eff_w_live, dev, L)
    require(eq, "kernel != plain on an Op-list slice")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    argsets = [bucket_args(b, dev) for b in buckets]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    kerns = [L.get_kernel(b.V, b.W, w_live=b.eff_w_live) for b in buckets]
    kernel_ms = time_cuda(lambda: [k(*a) for k, a in zip(kerns, argsets)],
                          reps=5)
    emit({"phase": "oplist_path", "histories": OPLIST_HISTORIES,
          "ops_per_history": NS_SPEC["n_ops"], "synth_s": synth_s,
          "check_batch_s": e2e_s,
          "histories_per_s": OPLIST_HISTORIES / e2e_s,
          "invalid": len(invalid), "oracle_rows": len(sample),
          "prepare_s": prepare_s, "encode_s": encode_s,
          "upload_ms": upload_ms, "kernel_ms": kernel_ms,
          "rest_s": e2e_s - prepare_s - encode_s
          - (upload_ms + kernel_ms) / 1e3,
          "buckets": [{"V": b.V, "W": b.W, "rows": b.batch,
                       "events": b.n_events} for b in buckets],
          "wgl_launches": launches})
    return {"launches": launches, "max_abs_err": err}


def phase_columnar_path(dev, L, S, cuda_synth, cas, wgl_check):
    """check_synth(scheduler=False) on the north-star spec, the default
    check_synth on the same spec, then the exact path's layers one by
    one."""
    from jepsen_torch.history.columnar import ColumnarOps, columnar_to_ops
    from jepsen_torch.ops.encode import encode_columnar, take_rows
    from jepsen_torch.ops.statespace import enumerate_statespace
    from jepsen_torch.workloads.synth import cas_kind_vocabulary
    spec = S.SynthSpec(**NS_SPEC)
    B = spec.n

    cuda_synth.LAUNCHES = 0
    L.cuda_wgl.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split: dict = {}
    valid, bad = L.check_synth(cas(), spec, timings=split, scheduler=False)
    e2e_s = time.perf_counter() - t0
    launches = {"synth_device": cuda_synth.LAUNCHES,
                "wgl_frontier": L.cuda_wgl.LAUNCHES}
    require(all(v > 0 for v in launches.values()),
            f"check_synth missed a kernel: {launches}")
    require(valid.shape == (B,) and bad.shape == (B,), "verdict shapes")

    # The same spec through the default check_synth (scheduler, fused
    # and renumbered encode groups; the batch is unkeyed, so no
    # partition), held against the exact path's verdicts.
    cuda_synth.LAUNCHES = 0
    L.cuda_wgl.LAUNCHES = 0
    L.cuda_wgl.GROUP_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsplit, dstats = {}, {}
    dv, db = L.check_synth(cas(), spec, timings=dsplit, stats_out=dstats)
    default = {"check_synth_s": time.perf_counter() - t0,
               "launches": {"synth_device": cuda_synth.LAUNCHES,
                            "wgl_frontier": L.cuda_wgl.LAUNCHES,
                            "wgl_frontier_group":
                                L.cuda_wgl.GROUP_LAUNCHES},
               "split_s": dsplit,
               "stats": {k: dstats[k] for k in (
                   "classes", "chunks", "dispatches", "fused_groups",
                   "fusion_ratio", "t_first_verdict_s")}}
    default["histories_per_s"] = B / default["check_synth_s"]
    require(np.array_equal(dv, valid) and np.array_equal(db, bad),
            "default check_synth != exact path on the north-star spec")

    # The same batch again, layer by layer.
    t0 = time.perf_counter()
    args = S.cas_inputs(spec, device=dev)
    keys_s = time.perf_counter() - t0
    st = S.cas_static(spec, key_meta=False)
    launch, out = cuda_synth.prepare_cas(*args, **st)
    synth_ms = time_launches([(lambda: None, launch)], reps=5)
    synth_wrapper_ms = time_cuda(lambda: cuda_synth.synth_cas(*args, **st),
                                 reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in out.items()}
    copy_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = S.plain_cas_core(*args, **st)
    torch.cuda.synchronize()
    synth_plain_ms = (time.perf_counter() - t0) * 1e3
    require(all(torch.equal(out[n], plain[n]) for n in plain),
            "synth kernel != plain on the north-star batch")
    synth_err = outputs_err(out, plain)
    del plain
    cols = ColumnarOps(type=host["type"], process=host["process"],
                       kind=host["kind"],
                       kinds=cas_kind_vocabulary(spec.n_values))
    t0 = time.perf_counter()
    space = enumerate_statespace(cas(), cols.kinds, 64)
    buckets, failures = encode_columnar(space, cols, max_slots=18)
    encode_s = time.perf_counter() - t0
    big = max(buckets, key=lambda b: b.batch)
    head = take_rows(big, range(min(256, big.batch)))
    eq, wgl_err, _ = kernel_vs_plain(bucket_args(head, dev), head.V, head.W,
                                     head.eff_w_live, dev, L)
    require(eq, "kernel != plain on the north-star slice")
    wgl = wgl_measure(dev, L, buckets)
    require(len(buckets) == 1 and wgl["tiers"][0]["tier"] == "warp",
            f"the north-star buckets {[(b.V, b.W) for b in buckets]} do "
            f"not run on the warp tier: {wgl['tiers']}")
    reasons: dict = {}
    for _, why in failures:
        reasons[why] = reasons.get(why, 0) + 1

    # Verdicts and bad ops against the host oracle on sampled rows, half
    # of them invalid.
    invalid = np.flatnonzero(~valid)
    sample = (invalid[:ORACLE_ROWS // 2].tolist()
              + np.flatnonzero(valid)[:ORACLE_ROWS // 2].tolist())
    require(len(sample) >= ORACLE_ROWS and len(invalid) >= ORACLE_ROWS // 2,
            "oracle sample too small")
    t0 = time.perf_counter()
    for i in sample:
        want = wgl_check(cas(), columnar_to_ops(cols, i))
        require(bool(valid[i]) == (want["valid"] is True),
                f"verdict differs at {i}")
        if want["valid"] is False:
            require(int(bad[i]) == want["op"]["index"],
                    f"bad op differs at {i}")
    oracle_s = time.perf_counter() - t0

    # details=True on a slice against check_batch on the same rows.
    sub, _ = S.synth_cas_device(spec, rows=(0, DETAIL_ROWS), key_meta=False)
    got = L.check_columnar(cas(), sub, details=True, scheduler=False)
    want = L.check_batch(cas(), [columnar_to_ops(sub, r)
                                 for r in range(DETAIL_ROWS)],
                         scheduler=False)
    for r, (g, w) in enumerate(zip(got, want)):
        require(g["valid"] == w["valid"] and g["valid"] == bool(valid[r]),
                f"details verdict differs at {r}")
        require(g.get("op", {}).get("index") == w.get("op", {}).get("index"),
                f"details bad op differs at {r}")
        require(g.get("configs") == w.get("configs"),
                f"details configs differ at {r}")

    # Two wide specs at W = 17: a cluster tier; their K1 launches
    # replayed alone.
    wide = []
    for inv in (False, True):
        ws = S.SynthSpec(family="wide", n=WIDE_ROWS, width=17, n_values=2,
                         invalid=inv)
        cuda_synth.WIDE_LAUNCHES = 0
        L.cuda_wgl.LAUNCHES = L.cuda_wgl.WIDE_LAUNCHES = 0
        with LaunchRecorder(L.cuda_wgl) as k1:
            t0 = time.perf_counter()
            wv, _ = L.check_synth(cas(), ws, scheduler=False)
            wide_s = time.perf_counter() - t0
        counts = {"synth_wide": cuda_synth.WIDE_LAUNCHES,
                  "wgl_frontier": L.cuda_wgl.LAUNCHES,
                  "wgl_frontier_wide": L.cuda_wgl.WIDE_LAUNCHES}
        require(all(v > 0 for v in counts.values()),
                f"a wide check_synth missed a kernel: {counts}")
        require(bool((wv == (not inv)).all()),
                f"wide W=17 invalid={inv}: rows not as built")
        wide.append({"invalid": inv, "rows": WIDE_ROWS, "s": wide_s,
                     "valid_rows": int(wv.sum()), "launches": counts,
                     "route": L.DISPATCH_LOG[-1][0],
                     "k1_ms": time_launches([prepared_single(L, *a, **kw)
                                             for a, kw in k1.singles],
                                            reps=3),
                     "k1_plans": [tier_of(L, kw["V"], kw["W"], kw["w_live"],
                                          a[3].shape[-2], a[3].dim() == 2)
                                  for a, kw in k1.singles]})
        del k1
    # The wide generator at that shape: alone, through its wrapper, and
    # the empty kernel on its grid.
    vk = S.wide_inputs(ws, device=dev)
    st = dict(width=ws.width, n_values=ws.n_values, invalid=ws.invalid)
    wide_gen = wide_times(cuda_synth, vk, st, reps=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S.plain_wide_core(vk, **st)
    torch.cuda.synchronize()
    wide_gen.update(plain_ms=(time.perf_counter() - t0) * 1e3,
                    **wide_bound(ws))

    emit({"phase": "columnar_main_path", "spec": NS_SPEC,
          "check_synth_s": e2e_s, "histories_per_s": B / e2e_s,
          "default_check_synth": default,
          "invalid": int((~valid).sum()), "launches": launches,
          # host clock, inside the check_synth run
          "split_s": split,
          "rest_s": e2e_s - sum(split.values()),
          # the same layers again, one by one
          "keys_s": keys_s, "synth_kernel_ms": synth_ms,
          "synth_wrapper_ms": synth_wrapper_ms,
          "copy_back_ms": copy_ms, "synth_plain_ms": synth_plain_ms,
          "encode_columnar_s": encode_s,
          "wgl_upload_ms": wgl["upload_ms"],
          "wgl_kernel_ms": wgl["kernel_ms"],
          "wgl_wrapper_ms": wgl["wrapper_ms"],
          "decode_s": split["device_s"]
          - (wgl["upload_ms"] + wgl["wrapper_ms"]) / 1e3,
          "buckets": [{"V": b.V, "W": b.W, "rows": b.batch,
                       "events": b.n_events} for b in buckets],
          "host_rows": reasons, "oracle_rows": len(sample),
          "oracle_s": oracle_s, "details_rows": DETAIL_ROWS,
          "wide": wide, "wide_generator": wide_gen, "wgl": wgl,
          "synth_bound": synth_bound(spec)})
    sb = synth_bound(spec)
    return {
        "buckets": buckets, "wide": wide, "wide_generator": wide_gen,
        "wgl_frontier": {"launches": launches["wgl_frontier"],
                         "max_abs_err": wgl_err, "ms": wgl["kernel_ms"],
                         "wrapper_ms": wgl["wrapper_ms"],
                         "tier": wgl["tiers"][0]["tier"],
                         "plain_ms": wgl["plain_ms"],
                         "bound_ms": wgl["bound_ms"],
                         "bound_by": wgl["bound_by"],
                         "bytes": wgl["bytes"],
                         "needed_ops": wgl["needed_ops"]},
        "synth_device": {"launches": launches["synth_device"],
                         "max_abs_err": synth_err, "ms": synth_ms,
                         "wrapper_ms": synth_wrapper_ms,
                         "plain_ms": synth_plain_ms,
                         "bound_ms": sb["bound_ms"],
                         "bound_by": sb["bound_by"]}}


# Group-launch cases, one tuple per member: (V, W, w_live, K1, shared
# target[, real rows]). V 8/40/48/64, W 1..15, shared and per-row
# targets, int8 and int32 slot tables (K1 >= 127), 1, 2, 4 and 8 members,
# warp-tier and block-tier members side by side, a warp-tier member whose
# table fits only 2 rows per block, one whose table stays in device
# memory, and members with fewer real rows than a warp-tier block holds.
# Every member's frontier fits in shared memory (W <= 15 at one word,
# <= 14 at two), as in the scheduler's groups.
GROUP_CASES = (
    ((8, 15, None, 12, True),),
    ((40, 14, 5, 9, False), (8, 4, None, 7, True)),
    ((8, 6, None, 7, True), (48, 9, 6, 200, False), (40, 5, None, 9, True),
     (8, 12, 4, 130, False)),
    ((8, 4, None, 5, True), (8, 7, None, 9, False), (40, 10, 3, 140, True),
     (48, 8, None, 11, False), (8, 13, 6, 7, True), (48, 14, 4, 9, True),
     (8, 15, None, 6, False), (40, 4, None, 300, False)),
    ((8, 5, None, 7, True, 3), (8, 9, None, 9, False, 5),
     (64, 7, 4, 300, False, 3), (8, 1, None, 4, False, 1),
     (64, 6, None, 800, True, 11), (8, 8, 5, 12, True, 17)),
)


def tensors_err(a, b) -> int:
    """Largest absolute difference of two integer or bool tensors, int32
    words compared as uint32 bit patterns; a bool pair counts its
    mismatches."""
    if a.dtype == torch.bool:
        return int((a != b).sum())
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max()) if d.numel() else 0


def padded_member(rng, V, W, w_live, K1, shared, pad, dev, B=None):
    """One member's random tables with ``pad`` padding rows (all EV_PAD,
    empty slots, unreachable per-row targets) after its ``B`` real rows
    (drawn when not given)."""
    B = int(rng.integers(1, 40)) if B is None else B
    N = int(rng.integers(8, 100))
    args = random_tables(rng, B, N, V, W, w_live, K1, shared, dev)
    ev_type, ev_slot, ev_slots, target = args
    z = lambda t: torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=dev)
    flat = [torch.cat([ev_type, z(ev_type)]), torch.cat([ev_slot, z(ev_slot)]),
            torch.cat([ev_slots, z(ev_slots).fill_(K1 - 1)]),
            target if shared else torch.cat([target, z(target).fill_(-1)])]
    return flat, B


def group_vs_plain(members, flat, rows, dev, L):
    """One group launch against plain_fused_wgl and against single-bucket
    launches member by member, on the same inputs: (equal, max_abs_err,
    invalid rows)."""
    got = L.get_fused_kernel(members)(*flat, rows=rows)
    want = L.plain_fused_wgl(members, flat)
    single = []
    for i, (V, W, wl, _) in enumerate(members):
        single += L.get_kernel(V, W, w_live=wl)(*flat[4 * i:4 * i + 4])
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) and torch.equal(g, x)
                for g, w, x in zip(got, want, single))
    err = max(max(tensors_err(g, w), tensors_err(g, x))
              for g, w, x in zip(got, want, single))
    invalid = sum(int((~got[3 * i]).sum()) for i in range(len(members)))
    return equal, err, invalid


def encoder_members(dev, S, cas):
    """Real encoder chunks for group launches: a batch whose rows
    renumber into sub-spaces, encoded fused in two streamed groups with
    one registry (as the scheduler's source does). Returns the first
    group's renumbered buckets and a bucket merged across both groups."""
    from jepsen_torch.ops.encode import merge_batches
    from jepsen_torch.ops.schedule import iter_columnar_groups
    from jepsen_torch.ops.statespace import enumerate_statespace
    spec = S.SynthSpec(family="cas", n=512, seed=13, n_procs=2, n_ops=60,
                       n_values=40, corrupt=0.3, p_info=0.05)
    cols, _ = S.synth_cas_device(spec, key_meta=False, device=dev)
    space = enumerate_statespace(cas(), cols.kinds, 64)
    first, second = [[b for b in g if b.batch] for g in iter_columnar_groups(
        space, cols, max_slots=16, encode_rows=256, fuse=True,
        renumber=True)]
    # Rows renumber into sub-spaces of their own alphabets: a pair of
    # different widths.
    by_v = {}
    for b in first:
        if b.V < len(space.states):
            by_v.setdefault(b.V, b)
    renumbered = list(by_v.values())
    require(len(renumbered) >= 2, "no renumbered pair")
    both = sorted({b.V for b in first} & {b.V for b in second})
    require(both, "no V in both encode groups")
    V = both[0]
    pend = [b for b in first + second if b.V == V]
    return renumbered[:2], merge_batches(pend, max(b.W for b in pend))


def phase_group_parity(dev, L, S, cas):
    from jepsen_torch.ops.encode import EV_FUSED
    from jepsen_torch.ops.schedule import (EVENT_QUANTUM, BucketScheduler,
                                           _round_up)
    out = {"phase": "group_vs_plain", "groups": []}
    max_err = 0
    rng = np.random.default_rng(77)
    for case in GROUP_CASES:
        members, flat, rows = [], [], []
        for V, W, wl, K1, shared, *nb in case:
            f, nb = padded_member(rng, V, W, wl, K1, shared,
                                  int(rng.integers(0, 9)), dev, *nb)
            members.append((V, W, wl, shared))
            flat += f
            rows.append(nb)
        eq, err, inv = group_vs_plain(members, flat, rows, dev, L)
        out["groups"].append({"source": "random", "members": [
            {"V": V, "W": W, "w_live": wl, "K1": K1, "shared_target": sh,
             "rows": nb, "padded_rows": int(flat[4 * i].shape[0]),
             "slots": str(flat[4 * i + 2].dtype),
             **tier_of(L, V, W, wl, K1, sh)}
            for i, ((V, W, wl, K1, sh, *_), nb) in enumerate(
                zip(case, rows))],
            "invalid": inv, "equal": eq})
        require(eq, f"group launch != plain on {len(case)} random members")
        max_err = max(max_err, err)
    # Real encoder chunks, padded as the scheduler pads them.
    sch = BucketScheduler(device=dev)
    pair, merged = encoder_members(dev, S, cas)
    for label, bs in (("renumbered_pair", pair),
                      ("merged_across_groups", [merged] + pair)):
        members, flat, rows = [], [], []
        for b in bs:
            Bp, _ = sch._chunk_plan(b)
            nb = min(b.batch, Bp)
            flat += sch._pad_chunk(b, 0, nb, Bp,
                                   _round_up(b.n_events, EVENT_QUANTUM))
            members.append(sch._member_spec(b))
            rows.append(nb)
        eq, err, inv = group_vs_plain(members, flat, rows, dev, L)
        out["groups"].append({"source": label, "members": [
            {"V": b.V, "W": b.W, "rows": nb, "shared_target": b.shared_target,
             "fused_events": int((b.ev_type == EV_FUSED).sum()),
             **tier_of(L, b.V, b.W, b.eff_w_live, b.target.shape[-2],
                       b.shared_target)}
            for b, nb in zip(bs, rows)], "invalid": inv, "equal": eq})
        require(eq, f"group launch != plain on the {label}")
        max_err = max(max_err, err)
    out["max_abs_err"] = max_err
    emit(out)
    return max_err


class LaunchRecorder:
    """Keeps the inputs of every kernel launch made while it is active
    (the wrappers still launch and count as always), so a path's launches
    can be replayed, timed and held against the plain version on the
    same inputs afterwards."""

    def __init__(self, cuda_wgl):
        self.mod = cuda_wgl
        self.singles, self.groups = [], []

    def __enter__(self):
        single, group = self.mod.wgl_frontier, self.mod.wgl_frontier_group

        def rec_single(ev_type, ev_slot, ev_slots, target, idx0, F, Fb,
                       valid, bad, **kw):
            self.singles.append(((ev_type, ev_slot, ev_slots, target, idx0,
                                  F.clone(), Fb.clone(), valid.clone(),
                                  bad.clone()), kw))
            return single(ev_type, ev_slot, ev_slots, target, idx0, F, Fb,
                          valid, bad, **kw)

        def rec_group(members, flat, rows=None):
            self.groups.append((members, tuple(flat), rows))
            return group(members, flat, rows)

        self._orig = single, group
        self.mod.wgl_frontier, self.mod.wgl_frontier_group = \
            rec_single, rec_group
        return self

    def __exit__(self, *exc):
        self.mod.wgl_frontier, self.mod.wgl_frontier_group = self._orig
        return False


class BucketRecorder:
    """Keeps every bucket the bucket scheduler yields while active: the
    consolidated buckets a path dispatched."""

    def __init__(self):
        from jepsen_torch.ops import schedule
        self.cls = schedule.BucketScheduler
        self.buckets = []

    def __enter__(self):
        run, buckets = self.cls.run, self.buckets

        def rec_run(sch, source):
            for batch, out in run(sch, source):
                if not isinstance(out, Exception):
                    buckets.append(batch)
                yield batch, out

        self._orig = run
        self.cls.run = rec_run
        return self

    def __exit__(self, *exc):
        self.cls.run = self._orig
        return False


def real_rows(members, flat, rows):
    """A recorded group's inputs cut to each member's real rows."""
    out = []
    for i, ((_, _, _, shared), nb) in enumerate(zip(members, rows)):
        out += [t[:nb] for t in flat[4 * i:4 * i + 3]]
        out.append(flat[4 * i + 3] if shared else flat[4 * i + 3][:nb])
    return out


def launch_bound(nbytes: int, ops: int) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"needed_ops": ops, "bytes": nbytes, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# Group launches of a path whose members the plain version runs on (the
# first ones recorded): the plain version over all of the keyed
# headline's 20 group launches took 56-91 s of the script's time on the
# card; the bound counts every group's operations from the kernel's own
# closures (``closure_ops``), held equal to the plain version's count on
# these groups.
PLAIN_GROUPS = 4


def group_measure(dev, L, groups):
    """The recorded group launches of a path: their kernel time alone
    (``time_launches``, 3 runs after a warm-up) and through the wrapper
    (CUDA events around the wrapper calls, output allocation included),
    each member's tier, parity and time of the plain version on the same
    inputs (the first PLAIN_GROUPS groups), and the bound from the bytes
    the groups must move (``frontier_bytes`` over each member's real
    rows) and the operations their data needs (``closure_ops`` on every
    member, equal to the plain version's count where it ran)."""
    def replay():
        return [L.cuda_wgl.wgl_frontier_group(m, f, r) for m, f, r in groups]

    wrapper_ms = time_cuda(replay, reps=3)
    ms = time_launches([prepared_group(L, m, f, r) for m, f, r in groups],
                       reps=3)
    got = replay()
    torch.cuda.synchronize()
    held = groups[:PLAIN_GROUPS]
    # The plain version, member by member as plain_fused_wgl runs it, each
    # counting the operations its data needs in the same run.
    needed = [[torch.zeros(nb, dtype=torch.int64, device=dev) for nb in r]
              for _, _, r in held]
    t0 = time.perf_counter()
    want = []
    for (m, f, r), nd in zip(held, needed):
        flat = real_rows(m, f, r)
        out = []
        for i, ((V, W, wl, _), nb) in enumerate(zip(m, r)):
            valid, bad, F, Fb = L.plain_wgl(
                *flat[4 * i:4 * i + 4], 0, *L.initial_carry(nb, V, W, dev),
                V=V, W=W, w_live=wl, ops=nd[i])
            out += [valid, bad, torch.where(valid[:, None, None], F, Fb)]
        want.append(out)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, equal = 0, True
    for (m, _, r), g, w in zip(held, got, want):
        for j in range(3 * len(m)):
            gj = g[j][:r[j // 3]]
            equal = equal and torch.equal(gj, w[j])
            err = max(err, tensors_err(gj, w[j]))
    del got, want
    ops = 0
    nbytes = 0
    tiers: dict = {}
    for gi, (m, f, r) in enumerate(groups):
        flat = real_rows(m, f, r)
        for i, ((V, W, wl, shared), nb) in enumerate(zip(m, r)):
            ev = flat[4 * i:4 * i + 4]
            counted = closure_ops(L, (*ev, 0, *L.initial_carry(nb, V, W,
                                                               dev)),
                                  {"V": V, "W": W,
                                   "w_live": L._w_live(W, wl)})
            if gi < PLAIN_GROUPS:
                equal = equal and torch.equal(counted, needed[gi][i])
            ops += int(counted.sum())
            nbytes += frontier_bytes(L, ev[0], ev[2], ev[3], V, W, wl)
            t = tier_of(L, V, W, wl, ev[3].shape[-2], shared)["tier"]
            require(t == "warp" or W > L.cuda_wgl.W_WARP,
                    f"a W={W} member runs on the {t} tier")
            key = f"{t}_W{W}"
            tiers[key] = tiers.get(key, 0) + 1
    return {"groups": len(groups),
            "members": sum(len(m) for m, _, _ in groups),
            "rows": sum(sum(r) for _, _, r in groups),
            "members_by_tier_and_W": dict(sorted(tiers.items())),
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "plain_groups": len(held),
            "plain_members": sum(len(m) for m, _, _ in held),
            "equal": equal, "max_abs_err": err, **launch_bound(nbytes, ops)}


def singles_measure(dev, L, singles):
    """The recorded single-bucket launches of a path: kernel time alone
    and through the wrapper (CUDA events), parity with the plain version
    on the same inputs, and the bound from the bytes they must move and
    the operations their data needs (as ``group_measure``)."""
    def replay():
        return [L.cuda_wgl.wgl_frontier(*a[:5], *(t.clone() for t in a[5:]),
                                        **kw) for a, kw in singles]

    wrapper_ms = time_cuda(replay, reps=3)
    ms = time_launches([prepared_single(L, *a, **kw) for a, kw in singles],
                       reps=3)
    got = replay()
    needed = [torch.zeros(a[0].shape[0], dtype=torch.int64, device=dev)
              for a, _ in singles]
    t0 = time.perf_counter()
    want = [L.plain_wgl(*a, **kw, ops=nd) for (a, kw), nd in
            zip(singles, needed)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((tensors_err(x, y) for g, w in zip(got, want)
               for x, y in zip(g, w)), default=0)
    ops = sum(int(nd.sum()) for nd in needed)
    nbytes = 0
    tiers = []
    for a, kw in singles:
        nbytes += frontier_bytes(L, a[0], a[2], a[3], kw["V"], kw["W"],
                                 kw["w_live"])
        tiers.append({"V": kw["V"], "W": kw["W"], "rows": a[0].shape[0],
                      **tier_of(L, kw["V"], kw["W"], kw["w_live"],
                                a[3].shape[-2], a[3].dim() == 2)})
    return {"launches": len(singles), "tiers": tiers, "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "equal": err == 0, "max_abs_err": err,
            **launch_bound(nbytes, ops)}


def hist_json(h: dict) -> dict:
    return {str(k): int(v) for k, v in sorted(h.items())}


def phase_scheduler_path(dev, L, S, cuda_synth, cas, wgl_check):
    """The default check_synth (partition, fused and renumbered encode
    groups, the bucket scheduler and its group launches) on the bench's
    keyed headline spec, held against the exact path."""
    from jepsen_torch.history.columnar import columnar_to_ops
    from jepsen_torch.ops.partition import partition_columnar, pending_w_hist
    spec = S.SynthSpec(**HEADLINE_SPEC)
    B = spec.n

    split, stats = {}, {}
    with LaunchRecorder(L.cuda_wgl) as rec, BucketRecorder() as disp:
        cuda_synth.LAUNCHES = 0
        L.cuda_wgl.LAUNCHES = 0
        L.cuda_wgl.GROUP_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        valid, bad = L.check_synth(cas(), spec, timings=split,
                                   stats_out=stats)
        e2e_s = time.perf_counter() - t0
        launches = {"synth_device": cuda_synth.LAUNCHES,
                    "wgl_frontier": L.cuda_wgl.LAUNCHES,
                    "wgl_frontier_group": L.cuda_wgl.GROUP_LAUNCHES}
    require(all(v > 0 for v in launches.values()),
            f"the scheduler path missed a kernel: {launches}")
    require(launches["wgl_frontier_group"] == len(rec.groups)
            and launches["wgl_frontier"] == len(rec.singles),
            "recorded launches differ from the counts")
    require(valid.shape == (B,) and bad.shape == (B,), "verdict shapes")

    # The same batch: the partition's effect, then the exact path.
    cols, _ = S.synthesize(spec, key_meta=False, device=dev)
    t0 = time.perf_counter()
    pb = partition_columnar(cols)
    partition_s = time.perf_counter() - t0
    w_pre, w_post = pending_w_hist(cols), pending_w_hist(pb.cols)
    exact_split: dict = {}
    t0 = time.perf_counter()
    ev, eb = L.check_columnar(cas(), cols, scheduler=False,
                              timings=exact_split)
    exact_s = time.perf_counter() - t0
    require(np.array_equal(valid, ev), "scheduler verdicts != exact path")
    require(np.array_equal(bad, eb), "scheduler bad ops != exact path")

    # The host oracle on ORACLE_ROWS sub-histories: the witness subs of
    # half as many invalid histories and as many subs of valid ones.
    invalid = np.flatnonzero(~valid)
    require(len(invalid) >= ORACLE_ROWS // 2, "too few invalid rows")
    sub_of = {(int(h), k): s for s, (h, k) in
              enumerate(zip(pb.sub_history.tolist(), pb.sub_key))}
    t0 = time.perf_counter()
    for i in invalid[:ORACLE_ROWS // 2].tolist():
        key = int(cols.key[i, int(bad[i])])
        want = wgl_check(cas(), columnar_to_ops(pb.cols, sub_of[(i, key)]))
        require(want["valid"] is False and want["op"]["index"] == int(bad[i]),
                f"oracle disagrees on history {i} key {key}")
    valid_subs = [s for s, h in enumerate(pb.sub_history.tolist())
                  if valid[h]][:ORACLE_ROWS // 2]
    for s in valid_subs:
        require(wgl_check(cas(), columnar_to_ops(pb.cols, s))["valid"]
                is True, f"oracle finds sub {s} invalid")
    oracle_s = time.perf_counter() - t0

    # details=True on a slice against the exact path.
    sub, _ = S.synth_cas_device(spec, rows=(0, DETAIL_ROWS), key_meta=False)
    got = L.check_columnar(cas(), sub, details=True)
    want = L.check_columnar(cas(), sub, details=True, scheduler=False)
    for r, (g, w) in enumerate(zip(got, want)):
        require(g["valid"] == w["valid"] and g["valid"] == bool(valid[r]),
                f"details verdict differs at {r}")
        for f in ("op", "configs", "independent_key"):
            gv, wv = g.get(f), w.get(f)
            if f == "op":
                gv, wv = (gv or {}).get("index"), (wv or {}).get("index")
            require(gv == wv, f"details {f} differs at {r}")

    single = singles_measure(dev, L, rec.singles)
    require(single["equal"], "a single launch != plain on the main path")
    group = group_measure(dev, L, rec.groups)
    require(group["equal"], "a group launch != plain on the main path")
    del rec
    emit({"phase": "scheduler_main_path", "spec": HEADLINE_SPEC,
          "check_synth_s": e2e_s, "histories_per_s": B / e2e_s,
          "invalid": int((~valid).sum()), "launches": launches,
          # host clock, inside the check_synth run: synth, partition,
          # encode groups, device and decode, host fallback
          "split_s": split, "rest_s": e2e_s - sum(split.values()),
          "stats": stats,
          "subs": {"before": B, "after": pb.n_subs,
                   "partition_s": partition_s,
                   "w_hist_before": hist_json(w_pre),
                   "w_hist_after": hist_json(w_post)},
          "exact_check_columnar_s": exact_s, "exact_split_s": exact_split,
          "oracle_subs": ORACLE_ROWS, "oracle_s": oracle_s,
          "details_rows": DETAIL_ROWS,
          "single_launches": single, "group_launches": group})
    return {"launches": launches, "single": single, "group": group,
            "buckets": disp.buckets}


def phase_scheduler_sides(dev, L, S, cuda_synth, synth, cas):
    """The scheduler over the wide specs (W = 17: the wide route) and
    over Op-list histories, against scheduler=False."""
    out = {"phase": "scheduler_sides", "wide": []}
    for inv in (False, True):
        ws = S.SynthSpec(family="wide", n=WIDE_ROWS, width=17, n_values=2,
                         invalid=inv)
        cuda_synth.WIDE_LAUNCHES = 0
        L.cuda_wgl.LAUNCHES = 0
        t0 = time.perf_counter()
        sv, sb = L.check_synth(cas(), ws)
        s = time.perf_counter() - t0
        counts = {"synth_wide": cuda_synth.WIDE_LAUNCHES,
                  "wgl_frontier": L.cuda_wgl.LAUNCHES}
        route = L.DISPATCH_LOG[-1][0]
        xv, xb = L.check_synth(cas(), ws, scheduler=False)
        require(np.array_equal(sv, xv) and np.array_equal(sb, xb),
                f"wide invalid={inv}: scheduler != exact")
        require(all(v > 0 for v in counts.values()) and route == "data1wide",
                f"wide invalid={inv}: {counts}, route {route}")
        out["wide"].append({"invalid": inv, "rows": WIDE_ROWS, "s": s,
                            "valid_rows": int(sv.sum()), "launches": counts,
                            "route": route})
    # No info ops, as in the Op-list phase: an info op pins its slot to
    # the end, and a wide invalid row whose first failure lies inside a
    # fused run is re-derived by the exponential host engine.
    hists = synth(SCHED_OPLIST_HISTORIES, seed0=11, n_procs=5,
                  n_ops=NS_SPEC["n_ops"], n_values=5, corrupt=0.25,
                  p_info=0.0)
    L.cuda_wgl.LAUNCHES = 0
    L.cuda_wgl.GROUP_LAUNCHES = 0
    t0 = time.perf_counter()
    got = L.check_batch(cas(), hists)
    sched_s = time.perf_counter() - t0
    counts = {"wgl_frontier": L.cuda_wgl.LAUNCHES,
              "wgl_frontier_group": L.cuda_wgl.GROUP_LAUNCHES}
    require(counts["wgl_frontier"] + counts["wgl_frontier_group"] > 0,
            "check_batch(scheduler=True) launched nothing")
    t0 = time.perf_counter()
    want = L.check_batch(cas(), hists, scheduler=False)
    exact_s = time.perf_counter() - t0
    prov: dict = {}
    for i, (g, w) in enumerate(zip(got, want)):
        g = dict(g)
        p = g.pop("provenance")
        prov[p] = prov.get(p, 0) + 1
        require(g == w, f"Op-list history {i}: scheduler != exact")
    out["oplist"] = {"histories": SCHED_OPLIST_HISTORIES,
                     "check_batch_s": sched_s, "exact_s": exact_s,
                     "invalid": sum(r["valid"] is False for r in got),
                     "provenance": prov, "launches": counts}
    emit(out)
    return dict(counts, synth_wide=sum(w["launches"]["synth_wide"]
                                       for w in out["wide"]))


# ---------------------------------------------- dependency-graph phases

# The closure kernel's parity buckets: every vertex bucket from 8 to 2048
# (V = 1024 is the last whose rows fit in shared memory; 2048 runs the
# global-memory tier), and forward-edge densities from sparse to dense.
GRAPH_VS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
GRAPH_DENSITIES = (0.002, 0.05, 0.5)

# The graph path's batches: the reference bench's (bench.py:849-852) and
# a full-width one, Elle-style list-append histories of 1,000 ops over
# 8 keys (V 1024). The full-width count is cut from 128 to 8 (32 until
# the la path's batch of the same width joined the script, 16 until the
# mesh phases did): the
# checker's host refinement of each cyclic graph's witness (a BFS per
# vertex over about 500,000 realtime edges, seconds each) and the host
# oracle, not the card, set its time. Host-oracle rows: every row of the
# bench batch, GRAPH_ORACLE_ROWS evenly spaced rows of the wide one.
GRAPH_BENCH_HISTORIES = 2_000
GRAPH_WIDE = dict(n=8, n_ops=1_000, n_keys=8)
GRAPH_WIDE_CUT_FROM = 128
GRAPH_ORACLE_ROWS = 16
# The isolation path's batches: the bench's (bench.py:899, V 16) and a
# wide one (V 256), its count cut from 256 to 32 (128 until the la
# phases joined the script, 64 until the mesh phases did) for the same
# reason (the host refinement and the oracle, about 0.2 s a history).
ISO_BENCH = dict(n=512, seed=7, anomaly="mix")
ISO_WIDE = dict(n=32, seed=7, anomaly="mix", n_txns=250)
ISO_WIDE_CUT_FROM = 256


# The native_path phase: the EncodedBatch fields two encodes must share,
# and the fused-run rows (at most) held to wgl_check and timed through
# both engines.
ENCODE_FIELDS = ("ev_type", "ev_slot", "ev_slots", "ev_opidx", "target",
                 "orig_n_events")
REFINE_ORACLE_ROWS = 256


def encodes_equal(a, b) -> bool:
    """Two encode_columnar results, bucket for bucket, array for array."""
    (ba, fa), (bb, fb) = a, b
    if fa != fb or len(ba) != len(bb):
        return False
    for x, y in zip(ba, bb):
        if (x.V, x.W, x.w_live, list(x.indices)) != \
                (y.V, y.W, y.w_live, list(y.indices)):
            return False
        for f in ENCODE_FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            if (u is None) != (v is None) or (
                    u is not None and (u.dtype != v.dtype
                                       or not np.array_equal(u, v))):
                return False
    return True


def encode_pair(label, space, cols, **kw) -> dict:
    """encode_columnar with the native walk and with the numpy walk on
    one batch, each timed by the host clock, and held bit for bit; the
    native walk alone (native.encode_walk) timed beside them."""
    from jepsen_torch import native
    from jepsen_torch.ops.encode import _round_up, encode_columnar
    out, res = {}, {}
    for walk in ("native", "numpy"):
        t0 = time.perf_counter()
        res[walk] = encode_columnar(space, cols, max_slots=18,
                                    native=walk == "native", **kw)
        out[f"{walk}_s"] = time.perf_counter() - t0
    require(encodes_equal(res["native"], res["numpy"]),
            f"native_path {label}: native encode != numpy encode")
    t0 = time.perf_counter()
    native.encode_walk(cols.type, cols.process, cols.kind,
                       _round_up(cols.n_lines // 2 + 1, 8), 18,
                       space.n_kinds)
    out["native_walk_s"] = time.perf_counter() - t0
    out["speedup"] = out["numpy_s"] / out["native_s"]
    out["buckets"] = len(res["native"][0])
    return out


class NativeRecorder:
    """Keeps the histories given to the C++ batch engine
    (native.check_batch_native) while active, with the engine's host time
    and calls."""

    def __init__(self):
        from jepsen_torch import native
        self.mod = native
        self.hists, self.s, self.calls = [], 0.0, 0

    def __enter__(self):
        real = self.mod.check_batch_native

        def rec(model, hs, **kw):
            t0 = time.perf_counter()
            rs = real(model, hs, **kw)
            self.s += time.perf_counter() - t0
            self.calls += 1
            self.hists.extend(hs)
            return rs
        self._orig = real
        self.mod.check_batch_native = rec
        return self

    def __exit__(self, *exc):
        self.mod.check_batch_native = self._orig
        return False


def host_stream_oracle(cas, wgl_check, cols, valid, bad, label):
    """The legacy stream's verdicts against wgl_check on ORACLE_ROWS rows,
    half of them invalid (keyed batches: the invalid rows' witness
    sub-histories and as many valid sub-histories)."""
    from jepsen_torch.history.columnar import columnar_to_ops
    from jepsen_torch.ops.partition import partition_columnar
    invalid = np.flatnonzero(~valid)[:ORACLE_ROWS // 2].tolist()
    require(len(invalid) == ORACLE_ROWS // 2,
            f"native_path {label}: too few invalid rows")
    if cols.key is None:
        for i in invalid + np.flatnonzero(valid)[:ORACLE_ROWS // 2].tolist():
            want = wgl_check(cas(), columnar_to_ops(cols, i))
            require(bool(valid[i]) == (want["valid"] is True)
                    and (valid[i] or int(bad[i]) == want["op"]["index"]),
                    f"native_path {label}: row {i} != wgl_check")
        return
    pb = partition_columnar(cols)
    sub_of = {(int(h), k): s for s, (h, k) in
              enumerate(zip(pb.sub_history.tolist(), pb.sub_key))}
    for i in invalid:
        key = int(cols.key[i, int(bad[i])])
        want = wgl_check(cas(), columnar_to_ops(pb.cols, sub_of[(i, key)]))
        require(want["valid"] is False
                and want["op"]["index"] == int(bad[i]),
                f"native_path {label}: history {i} != wgl_check")
    subs = [s for s, h in enumerate(pb.sub_history.tolist())
            if valid[h]][:ORACLE_ROWS // 2]
    for s in subs:
        require(wgl_check(cas(), columnar_to_ops(pb.cols, s))["valid"]
                is True, f"native_path {label}: sub {s} != wgl_check")


def refine_compare(cas, wgl_check, hists, label) -> dict:
    """The fused-run rows' re-derivation, the C++ batch engine against
    the Python engine on the same rows (at most REFINE_ORACLE_ROWS), each
    timed by the host clock: equal verdicts and bad ops."""
    from jepsen_torch import native
    rows = hists[:REFINE_ORACLE_ROWS]
    if not rows:
        return {"rows": 0}
    t0 = time.perf_counter()
    nat = native.check_batch_native(cas(), rows)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [wgl_check(cas(), h) for h in rows]
    python_s = time.perf_counter() - t0
    require([verdict(r) for r in nat] == [verdict(r) for r in py],
            f"native_path {label}: check_batch_native != wgl_check on "
            "the fused-run rows")
    return {"rows": len(rows), "of": len(hists), "native_s": native_s,
            "python_s": python_s, "speedup": python_s / native_s}


# The keyed headline's host-stream pair runs its spec at n 5,000 rather
# than 10,000 (the full pair took about 39 s), a count cut for the
# script's time when online_path joined it.
NATIVE_HEADLINE_N = 5_000


def phase_native_path(dev, L, S, cas, wgl_check):
    """The native host engines on the card's host, and the legacy host
    stream through the card: on the north-star spec and the keyed
    headline (after its partition), the encode with the native walk
    against the numpy walk, exact, and on the headline also fused and
    renumbered as the scheduler encodes, bit for bit and timed in turn
    (the north-star's fused encode was cut for the script's time); then,
    on both specs (the headline's at NATIVE_HEADLINE_N rows),
    check_synth(synth="host") with scheduler=False and True (K1 and K2f
    on the card), verdicts and bad ops equal, sampled rows equal to
    wgl_check, and the rows that failed inside a fused run, which the
    C++ batch engine re-derives, held to wgl_check and timed through
    both engines."""
    from jepsen_torch.ops.partition import partition_columnar
    from jepsen_torch.ops.statespace import enumerate_statespace
    out = {"phase": "native_path", "encode": {}, "host_stream": {}}
    for label, fields in (("north_star", NS_SPEC),
                          ("headline", HEADLINE_SPEC)):
        spec = S.SynthSpec(**fields)
        keyed = spec.n_keys > 1
        cols, _ = S.synthesize(spec, key_meta=False, device=dev)
        if keyed:
            t0 = time.perf_counter()
            cols = partition_columnar(cols).cols
            out["encode"][f"{label}_partition_s"] = time.perf_counter() - t0
        space = enumerate_statespace(cas(), cols.kinds, 64)
        enc = out["encode"][label] = {
            "rows": cols.batch, "lines": cols.n_lines,
            "exact": encode_pair(f"{label} exact", space, cols)}
        if keyed:
            # The scheduler's encode (fused, renumbered) on the batch the
            # scheduler path checks: the keyed headline's sub-batch.
            enc["scheduler"] = encode_pair(f"{label} scheduler", space,
                                           cols, fuse=True, renumber=True)
            spec = S.SynthSpec(**dict(fields, n=NATIVE_HEADLINE_N))

        runs, verdicts, batches = {}, {}, []
        synthesize = S.synthesize

        def kept(*a, **kw):
            # The batch check_synth generates, kept for the oracle below.
            out = synthesize(*a, **kw)
            batches.append(out[0])
            return out
        for scheduler in (False, True):
            split, stats = {}, {}
            zero_counts(L)
            torch.cuda.synchronize()
            S.synthesize = kept
            try:
                with NativeRecorder() as nat:
                    t0 = time.perf_counter()
                    v, b = L.check_synth(cas(), spec, synth="host",
                                         device=dev, scheduler=scheduler,
                                         timings=split, stats_out=stats)
                    e2e_s = time.perf_counter() - t0
            finally:
                S.synthesize = synthesize
            launches = counts(L)
            require(launches["wgl_frontier"]
                    + launches["wgl_frontier_group"] > 0,
                    f"native_path {label}: no frontier launch")
            mode = "scheduler" if scheduler else "exact"
            verdicts[mode] = (v, b)
            runs[mode] = {"check_synth_s": e2e_s,
                          "histories_per_s": spec.n / e2e_s,
                          "invalid": int((~v).sum()),
                          "launches": launches, "split_s": split,
                          "rest_s": e2e_s - sum(split.values()),
                          "native_calls": nat.calls,
                          "native_rows": len(nat.hists),
                          "native_s": nat.s}
            if scheduler:
                require(nat.calls > 0 and nat.hists,
                        f"native_path {label}: no fused-run row reached "
                        "the C++ batch engine")
                runs[mode]["stats"] = {k: stats.get(k) for k in (
                    "classes", "chunks", "dispatches", "fused_groups",
                    "fusion_ratio")}
                runs[mode]["refine"] = refine_compare(cas, wgl_check,
                                                      nat.hists, label)
            del nat
        (ev, eb), (sv, sb) = verdicts["exact"], verdicts["scheduler"]
        require(np.array_equal(ev, sv) and np.array_equal(eb, sb),
                f"native_path {label}: scheduler verdicts != exact")
        require(len(batches) == 2 and all(
            np.array_equal(batches[0].type, x.type) for x in batches),
            f"native_path {label}: the host stream differs between runs")
        t0 = time.perf_counter()
        host_stream_oracle(cas, wgl_check, batches[0], ev, eb, label)
        runs["oracle_rows"] = ORACLE_ROWS
        runs["oracle_s"] = time.perf_counter() - t0
        runs["rows"] = spec.n
        out["host_stream"][label] = runs
    emit(out)
    return out


def graph_planes(rng, V, l_in, rows):
    """Packed int32 planes [B, l_in, V, words(V)] for the kernel parity:
    ``rows`` seeded random rows per density (forward edges at the
    density, back edges, which close cycles, at a fiftieth of it; the
    first two densities cumulative across planes as extraction makes
    them, the last independent; for V >= 32 column 31 set on half the
    rows), then the special rows: empty, a self-loop on the last vertex,
    one edge, and the V-long cycle (Warshall's longest chain)."""
    i, j = np.meshgrid(np.arange(V), np.arange(V), indexing="ij")
    parts = []
    for n, d in enumerate(GRAPH_DENSITIES):
        p = np.where(j > i, d, d / 50).astype(np.float32)
        dense = rng.random((rows, l_in, V, V), dtype=np.float32) < p
        if n < 2:
            dense = np.logical_or.accumulate(dense, axis=1)
        if V >= 32:
            dense[:, :, : V // 2, 31] = True
        parts.append(dense)
    special = np.zeros((4, l_in, V, V), bool)
    special[1, :, V - 1, V - 1] = True
    special[2, :, 0, 1] = True
    special[3, :, np.arange(V), (np.arange(V) + 1) % V] = True
    dense = np.concatenate(parts + [special]).astype(np.uint8)
    if V < 32:
        dense = np.concatenate(
            [dense, np.zeros(dense.shape[:-1] + (32 - V,), np.uint8)], -1)
    return np.packbits(dense, axis=-1, bitorder="little").view(np.int32)


def closure_fns(entry):
    """(kernel wrapper, plain version) of a closure entry."""
    from jepsen_torch.ops import cuda_graph
    from jepsen_torch.ops.graph import plain_graph_closure
    from jepsen_torch.ops.txn_graph import plain_txn_closure
    return (getattr(cuda_graph, f"{entry}_closure"),
            plain_graph_closure if entry == "graph" else plain_txn_closure)


def graph_cluster_batches(V, B, l_out):
    """Graphs of a B-graph batch to run at V: all of them, and in the
    shared-memory tier the most that lead the plan to spread a plane
    over each wider cluster of CTAs that V/32 allows."""
    from jepsen_torch.ops import cuda_graph
    batches = [B]
    if cuda_graph.tier(V) == "smem":
        for c in (8, 4, 2):
            n = min(B, cuda_graph.TARGET_CTAS // (c * l_out))
            if c <= V // 32 and n not in batches:
                batches.append(n)
    return batches


def phase_graph_kernel_parity(dev):
    """Both closure entries against their plain versions on the card, bit
    for bit, at every vertex bucket from 8 to 2048; in the shared-memory
    tier also on evenly spaced subsets of the batch small enough that
    the plan spreads each plane over every cluster of CTAs it can take
    (``graph_cluster_batches``)."""
    from jepsen_torch.ops import cuda_graph
    rng = np.random.default_rng(31)
    out = {"phase": "graph_kernel_parity", "cases": []}
    err = 0
    tiers, spread = set(), set()
    for entry, (l_in, l_out) in cuda_graph.ENTRIES.items():
        kern, plain = closure_fns(entry)
        for V in GRAPH_VS:
            rows = 8 if V <= 256 else max(1, 2048 // V)
            adj = on(graph_planes(rng, V, l_in, rows), dev)
            pc, pn = plain(adj, V)
            tier = cuda_graph.tier(V)
            tiers.add(tier)
            B = adj.shape[0]
            for n in graph_cluster_batches(V, B, l_out):
                idx = torch.from_numpy(np.unique(np.linspace(
                    0, B - 1, n).round()).astype(np.int64)).to(adj.device)
                kc, kn = kern(adj[idx].contiguous(), V)
                torch.cuda.synchronize()
                wc, wn = pc[idx], pn[idx]
                equal = torch.equal(kc, wc) and torch.equal(kn, wn)
                err = max(err, tensors_err(kc, wc), tensors_err(kn, wn))
                ctas = (cuda_graph.tile_plan(V, n * l_out)["cluster"]
                        if tier != "warp" else 0)
                spread.add(ctas)
                out["cases"].append({
                    "entry": entry, "V": V, "tier": tier,
                    "ctas_a_plane": ctas, "graphs": n,
                    "planes": int(wc.numel()),
                    "cyclic_planes": int(wc.sum()), "equal": equal})
                require(equal, f"{entry}_closure != plain at V={V}, "
                               f"{n} graphs")
            require(0 < int(pc.sum()) < pc.numel(),
                    f"{entry} V={V}: the cases must give both verdicts")
    require(tiers == {"warp", "smem", "global"}, f"tiers seen: {tiers}")
    require({1, 2, 4, 8} <= spread, f"CTAs a plane seen: {spread}")
    out["max_abs_err"] = err
    emit(out)
    return err


def closure_library(adj, V, entry):
    """A closure entry by the library route on the card: the reference's
    own algorithm, the packed planes unpacked to bfloat16 0/1 matrices
    (the txn entry's SI plane derived as min(N + RW·N, 1)), then
    bitlen(V - 1) squarings min(A + A·A, 1) by torch.matmul, which sums
    in float32 on the card: exact, since a sum of non-negative terms is
    positive exactly when one of them is. Returns (cyc, node) as the
    kernel does."""
    from jepsen_torch.ops.graph import closure_iters
    col = torch.arange(V, device=adj.device)
    a = ((adj[..., col // 32] >> (col % 32).to(torch.int32)) & 1
         ).to(torch.bfloat16)
    if entry == "txn":
        n = a[:, 1]
        rw = torch.clamp_min(a[:, 3] - n, 0)
        si = torch.clamp_max(n + torch.matmul(rw, n), 1)
        a = torch.cat([a, si[:, None]], dim=1)
    for _ in range(closure_iters(V)):
        a = torch.clamp_max(a + torch.matmul(a, a), 1)
    diag = torch.diagonal(a, dim1=-2, dim2=-1) > 0
    cyc = diag.any(dim=-1)
    first = torch.argmax(diag.to(torch.int32), dim=-1).to(torch.int32)
    return cyc, torch.where(cyc, first, torch.full_like(first, 2**31 - 1))


def closure_measure(dev, entry, buckets):
    """A closure entry over a path's buckets: kernel time alone
    (``time_launches``, 5 runs after a warm-up) and through the wrapper
    (output allocation included), the plain version's time, parity with
    it on every row, the library route's time (``closure_library``, held
    equal to the plain version), and the bound: the packed planes read
    once and cyc/node written once over the memory rate, against
    L·V²·words(V) word ORs a graph (plus V²·words(V) for the txn entry's
    SI plane) over the int32 rate."""
    from jepsen_torch.ops import cuda_graph
    kern, plain = closure_fns(entry)
    l_out = cuda_graph.ENTRIES[entry][1]
    adjs = [(b.V, on(b.adj, dev)) for b in buckets]
    ms = time_launches([(lambda: None, cuda_graph.prepare(a, V, entry)[0])
                        for V, a in adjs], reps=5)
    wrapper_ms = time_cuda(lambda: [kern(a, V) for V, a in adjs], reps=5)
    plain_ms = time_cuda(lambda: [plain(a, V) for V, a in adjs], reps=2)
    library_ms = time_cuda(
        lambda: [closure_library(a, V, entry) for V, a in adjs], reps=3)
    got = [kern(a, V) for V, a in adjs]
    want = [plain(a, V) for V, a in adjs]
    lib = [closure_library(a, V, entry) for V, a in adjs]
    torch.cuda.synchronize()
    err = max(max(tensors_err(g[0], w[0]), tensors_err(g[1], w[1]))
              for g, w in zip(got, want))
    require(all(torch.equal(x[0], w[0]) and torch.equal(x[1], w[1])
                for x, w in zip(lib, want)),
            f"{entry}: the library route != plain")
    nbytes = ops = 0
    for V, a in adjs:
        wd = cuda_graph.words(V)
        nbytes += a.numel() * 4 + a.shape[0] * l_out * (1 + 4)
        ops += a.shape[0] * V * V * wd * (l_out + (entry == "txn"))
    return {"buckets": [{"V": V, "graphs": a.shape[0],
                         "tier": cuda_graph.tier(V),
                         "ctas_a_plane": cuda_graph.tile_plan(
                             V, a.shape[0] * l_out)["cluster"]
                         if V > cuda_graph.WARP_MAX_V else 0}
                        for V, a in adjs],
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "bfloat16 torch.matmul squarings, float32 "
                            "sums",
            "equal": err == 0, "max_abs_err": err,
            **launch_bound(nbytes, ops)}


def host_oracle(pool, fn, items):
    """fn over items on the worker pool (the pure-Python host oracles)."""
    return pool.map(fn, items, chunksize=max(1, len(items) // 64))


def graph_batch(dev, pool, label, hists, oracle_rows, extra):
    """check_graphs_batch on one batch, its histories extracted first
    (as bench.py times it): launch count, layer split, parity with the
    host oracle on ``oracle_rows`` and the kernel's measurement on the
    batch's buckets."""
    from jepsen_torch.checkers.cycle import check_graphs_batch
    from jepsen_torch.ops import cuda_graph
    from jepsen_torch.ops.graph import (bucket_v, check_graph_host,
                                        encode_graphs, extract_graph)
    t0 = time.perf_counter()
    graphs = [extract_graph(h, "list-append") for h in hists]
    extract_s = time.perf_counter() - t0
    timings, stats = {}, {}
    cuda_graph.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = check_graphs_batch(graphs, stats_out=stats, timings=timings)
    batch_s = time.perf_counter() - t0
    launches = cuda_graph.LAUNCHES
    require(launches > 0, f"{label}: graph_closure was not launched")
    require(len(res) == len(hists), f"{label}: result count")
    t0 = time.perf_counter()
    want = host_oracle(pool, check_graph_host, [graphs[i]
                                                for i in oracle_rows])
    oracle_s = time.perf_counter() - t0
    for i, w in zip(oracle_rows, want):
        require({**res[i], "provenance": "host"} == w,
                f"{label}: row {i} differs from check_graph_host")
    # Uncorrupted histories are serializable; a corrupted one (a stale
    # read, when the history has a read to corrupt) is an
    # anti-dependency cycle, never a write-order violation.
    for s, r in enumerate(res):
        require(r["valid"] is True or (s % 7 == 0 and r["anomaly"] == "G2"),
                f"{label}: row {s}: {r['valid']}, {r['anomaly']}")
    measure = closure_measure(dev, "graph", encode_graphs(graphs))
    require(measure["equal"], f"{label}: kernel != plain on the batch")
    vb: dict = {}
    for g in graphs:
        vb[bucket_v(g.n)] = vb.get(bucket_v(g.n), 0) + 1
    return {"batch": label, **extra, "graphs": len(hists),
            "vertex_buckets": hist_json(vb), "extract_s": extract_s,
            "check_graphs_batch_s": batch_s,
            "graphs_per_s": len(hists) / batch_s,
            "e2e_graphs_per_s": len(hists) / (extract_s + batch_s),
            "anomalies": sum(r["valid"] is not True for r in res),
            "launches": launches, "split_s": timings,
            "rest_s": batch_s - sum(timings.values()),
            "stats": stats, "oracle_rows": len(oracle_rows),
            "oracle_s": oracle_s, "kernel": measure}


def phase_graph_path(dev, pool):
    """check_graphs_batch on the card: the reference bench's batch (2,000
    list-append histories of 30 ops, every seventh corrupted: V 32) and
    the full-width one (1,000 ops over 8 keys: V 1024)."""
    from jepsen_torch.workloads.synth import synth_la_history
    bench = [synth_la_history(s, n_ops=30,
                              corrupt=1.0 if s % 7 == 0 else 0.0)
             for s in range(GRAPH_BENCH_HISTORIES)]
    a = graph_batch(dev, pool, "bench", bench, list(range(len(bench))),
                    {"n_ops": 30, "source": "bench.py:849-852"})
    w = GRAPH_WIDE
    wide = [synth_la_history(s, n_ops=w["n_ops"], n_keys=w["n_keys"],
                             corrupt=1.0 if s % 7 == 0 else 0.0)
            for s in range(w["n"])]
    rows = np.linspace(0, w["n"] - 1, GRAPH_ORACLE_ROWS).astype(int)
    b = graph_batch(dev, pool, "wide", wide, sorted(set(rows.tolist())),
                    {"n_ops": w["n_ops"], "n_keys": w["n_keys"],
                     "count_cut_from": GRAPH_WIDE_CUT_FROM})
    emit({"phase": "graph_path", "batches": [a, b]})
    return a, b


def iso_batch(dev, pool, label, kw, extra):
    """certify_batch on one TxnSpec batch, extracted first (as bench.py
    times it): launch count, layer split,
    parity with certify_host on every row and with the injected labels,
    and the kernel's measurement on the batch's buckets."""
    from jepsen_torch.isolation import certify_batch
    from jepsen_torch.ops import cuda_graph
    from jepsen_torch.ops.synth_txn import (EXPECTED_CAP, TxnSpec,
                                            synth_txn_batch)
    from jepsen_torch.ops.txn_graph import (check_txn_host,
                                            encode_txn_graphs,
                                            extract_txn_graph)
    pairs = synth_txn_batch(TxnSpec(**kw))
    t0 = time.perf_counter()
    graphs = [extract_txn_graph(h) for h, _ in pairs]
    extract_s = time.perf_counter() - t0
    timings, stats = {}, {}
    cuda_graph.TXN_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = certify_batch(graphs, stats_out=stats, timings=timings)
    batch_s = time.perf_counter() - t0
    launches = cuda_graph.TXN_LAUNCHES
    require(launches > 0, f"{label}: txn_closure was not launched")
    t0 = time.perf_counter()
    want = host_oracle(pool, check_txn_host, graphs)
    oracle_s = time.perf_counter() - t0
    levels, mix = {}, {}
    for i, ((_, anom), r, w) in enumerate(zip(pairs, res, want)):
        require({**r, "provenance": "host"} == w,
                f"{label}: history {i} differs from certify_host")
        require(r["level"] == EXPECTED_CAP[anom],
                f"{label}: history {i} ({anom}) certified at {r['level']}")
        levels[r["level"]] = levels.get(r["level"], 0) + 1
        mix[anom or "clean"] = mix.get(anom or "clean", 0) + 1
    measure = closure_measure(dev, "txn", encode_txn_graphs(graphs))
    require(measure["equal"], f"{label}: kernel != plain on the batch")
    return {"batch": label, "spec": kw, **extra, "histories": len(pairs),
            "extract_s": extract_s, "certify_batch_s": batch_s,
            "hist_per_s": len(pairs) / batch_s,
            "e2e_hist_per_s": len(pairs) / (extract_s + batch_s),
            "launches": launches, "split_s": timings,
            "rest_s": batch_s - sum(timings.values()), "stats": stats,
            "levels": dict(sorted(levels.items())),
            "anomaly_mix": dict(sorted(mix.items())),
            "oracle_s": oracle_s, "kernel": measure}


def phase_isolation_path(dev, pool):
    """certify_batch on the card: the bench's batch (512 histories of 12
    transactions, V 16) and a wide one (250 transactions, V 256)."""
    a = iso_batch(dev, pool, "bench", ISO_BENCH,
                  {"source": "bench.py:899"})
    b = iso_batch(dev, pool, "wide", ISO_WIDE,
                  {"count_cut_from": ISO_WIDE_CUT_FROM})
    emit({"phase": "isolation_path", "batches": [a, b]})
    return a, b


# ------------------------------------------------ invariant fold phases

# The fold kernels' parity cases: vocabulary widths at every edge (V 1,
# 2, 31, 32, 33, 4096, the full-width 16384, and 65536, past shared
# memory for every family's histograms: crdb leaves it at 16384 already),
# process counts from 1 to 64 (the counter's shared-memory carry) and
# 128 (its device-memory carry), queue multisets and FIFO rings at the
# shared-memory edges and past them. The scans' full length (N 40,000)
# is held against the plain version in fold_path, on the full-width
# batches.
FOLD_VS = (1, 2, 31, 32, 33, 4096, 16384, 65536)
FOLD_PS = (1, 2, 5, 16, 64, 128)
FOLD_QUEUE_VS = (1, 2, 31, 33, 4096, 16384, 65536)
FOLD_FIFO_CASES = ((1, 1), (5, 8), (33, 64), (600, 1024), (600, 8),
                   (4000, 4096), (10_000, 16384), (4000, 65536))
# The segmented scans' edges, (B, N, P or Nmax, segment; None for the
# plan's): rows of 40,002 lines (many segments and tiles; P 128 with its
# device-memory carry; FIFO rings staged, in device memory, and clipped
# at Nmax < N), one-line segments, segments just past a tile and longer
# than the row, one row alone.
FOLD_COUNTER_EDGES = ((4, 40_002, 16, None), (3, 40_002, 128, None),
                      (1, 3_000, 5, 1), (40, 600, 64, 33),
                      (40, 600, 65, 33), (7, 600, 3, 1_000))
FOLD_FIFO_EDGES = ((40_002, 65_536, None), (40_002, 16_384, None),
                   (40_002, 1_024, None), (600, 1_024, 1), (600, 8, 33),
                   (600, 1_024, 5_000))
# queue_scan's edges, (N, V): rows of 40,002 lines at V 1 (one run as
# long as the row), 16,384 and 65,536 (16 and 64 slices a row) with
# misses at line 0, the last line, each side of a tile and a chunk edge,
# and of two values that one thread of the fold takes; one slice of 224
# values and two slices, the second of one value.
FOLD_QUEUE_EDGES = ((40_002, 1), (40_002, 16_384), (40_002, 65_536),
                    (600, 200), (600, 1_025))
FOLD_COUNT_FAMILIES = ("set", "crdb", "tq", "ids")
FOLD_COUNT_CASES = tuple((V, 24 if V <= 4096 else 6, 3000)
                         for V in FOLD_VS) + ((16384, 64, 40_000),
                                              (1024, 24, 3000),
                                              (1025, 24, 3000))


def count_edge_cases(family: str) -> tuple:
    """fold_counts' slice edges for a family at a batch whose rows alone
    fill the card (one slice a row while it fits): the widest one-slice
    vocabulary and one value past it. (1024, 1025 at 24 rows in
    FOLD_COUNT_CASES are the other edge: where rows too few to fill the
    card start to take more slices.)"""
    from jepsen_torch.ops import cuda_folds as K
    C = K.FAMILIES[family][1]
    widest = K.COUNT_SLICE_BYTES // (4 * C) // 32 * 32
    rows = K.COUNT_TARGET_BLOCKS
    return ((widest, rows, 600), (widest + 1, rows, 600))

# The fold path's batches: the reference bench's total-queue batch
# (bench.py:805-826: 2,000 histories of 100 elements) and, per family, a
# full-width batch of 8 histories (cut from 64 when the la phases
# joined the script, from 32 when the mesh phases did and from 16 when
# online_path did) of 10,000
# elements over 10 processes, what a Jepsen set, queue, unique-id or
# counter run records over its time limit. Seeded violations by seed % 8
# (see fold_history). ``--kernels`` times the folds on 32 such histories
# (FOLD_KERNELS_WIDE), the batch its earlier timings used.
FOLD_BENCH_HISTORIES = 2_000
FOLD_BENCH_ELEMENTS = 100
FOLD_WIDE = dict(n=8, elements=10_000, procs=10)
FOLD_KERNELS_WIDE = dict(FOLD_WIDE, n=32)
FOLD_CHECKS = {"set": "check_sets_batch", "crdb": "check_crdb_sets_batch",
               "tq": "check_total_queues_batch",
               "queue": "check_queues_batch",
               "fifo": "check_fifo_queues_batch",
               "ids": "check_unique_ids_batch",
               "counter": "check_counters_batch"}
# int32 operations a line and a plane element (the bound's operation
# count): the count pass compares type, f and value and clips and adds
# (6 a line), the epilogue a few a plane element (3); the scans compare
# type and f, index their carry and write their outputs (counter 12,
# queue 8, FIFO 10 a line).
FOLD_OPS = {"fold_counts": (6, 3), "counter_scan": (12, 0),
            "queue_scan": (8, 0), "fifo_scan": (10, 0)}


def fold_lines(rng, B, N, V, P=None, queue=False):
    """Seeded random line tensors [B, N] with the encoder's edges: a PAD
    tail of random length per row (half its lines with garbage f and
    val), every (type, f) code, values past V - 1, negative values and
    NONE_SENTINEL; for the counter (P given) small raw values and
    processes in [0, P); for the queue scans (``queue``) enqueues of
    running values and dequeues that mostly follow them, so that rows of
    both verdicts and both FIFO errors occur."""
    from jepsen_torch.ops.folds import NONE_SENTINEL
    none = int(NONE_SENTINEL)
    typ = rng.choice(np.array([0, 1, 2, 3], np.int32), (B, N),
                     p=[0.45, 0.4, 0.1, 0.05])
    f = rng.integers(0, 2 if queue else 3, (B, N),
                     dtype=np.int32)
    if P is not None:
        val = rng.integers(-3, 50, (B, N), dtype=np.int32)
        proc = rng.integers(0, P, (B, N), dtype=np.int32)
    elif queue:
        enq = (typ == 0) & (f == 0)
        deq = (typ == 1) & (f == 1)
        val = np.where(enq, np.cumsum(enq, 1) - 1,
                       np.cumsum(deq, 1) - 1).astype(np.int32) % max(V, 1)
        corrupt = rng.random((B, N)) < rng.choice([0, 0.0005, 0.05],
                                                  (B, 1))
        val = np.where(corrupt, rng.integers(0, V + 2, (B, N)), val)
        proc = None
    else:
        val = rng.integers(0, V + 3, (B, N), dtype=np.int32)
        proc = None
    val = val.astype(np.int32)
    odd = rng.random((B, N))
    val[odd < 0.01] = none
    val[(odd >= 0.01) & (odd < 0.02)] = -5
    live = rng.integers(0, N + 1, B)
    live[0] = N
    pad = np.arange(N)[None, :] >= live[:, None]
    typ[pad] = -1
    clean = pad & (rng.random((B, N)) < 0.5)
    f[clean] = 0
    val[clean] = none
    out = [typ, f, val] + ([proc] if proc is not None else [])
    return [np.ascontiguousarray(a, np.int32) for a in out]


def fifo_edge_row(N, bad_lines=(), bad_deqs=(), every=0, V=None):
    """One FIFO row of N lines (enqueue, enqueue, dequeue, dequeue, ... of
    0, 1, 2, ..., mod V where given, so that values repeat) with a wrong
    ok dequeue (a value never enqueued, or with V the value one past the
    head's) at each line of ``bad_lines``, at each dequeue rank of
    ``bad_deqs`` and, with ``every``, at every ``every``-th rank: each a
    failure run of one between success runs."""
    typ = np.zeros(N, np.int32)
    f = np.zeros(N, np.int32)
    val = np.zeros(N, np.int32)
    at, ranks = set(bad_lines), set(bad_deqs)
    enq = deq = rank = 0
    for j in range(N):
        if (j in at or rank in ranks
                or (every and rank % every == every - 1)):
            typ[j], f[j] = 1, 1
            val[j] = -1 if V is None else (deq + 1) % V
            rank += 1
        elif j % 4 < 2 or deq >= enq:
            val[j] = enq if V is None else enq % V
            enq += 1
        else:
            typ[j], f[j] = 1, 1
            val[j] = deq if V is None else deq % V
            deq += 1
            rank += 1
    return typ, f, val


def fifo_edge_lines(N, seg):
    """Rows of N lines whose first failure sits at every edge the walk
    and the compaction have: line 0, the last line, each side of a
    segment edge, each side of the walk's tile edges (dequeue ranks),
    a wrong dequeue every 37 (alternating runs), repeated values with a
    wrong one among them, and a healthy row."""
    from jepsen_torch.ops import cuda_folds as K
    tile = K.FIFO_WALK_TILE
    rows = [fifo_edge_row(N, bad_lines=(0,)),
            fifo_edge_row(N, bad_lines=(N - 1,)),
            fifo_edge_row(N, bad_lines=(seg - 1, 3 * seg + 1)),
            fifo_edge_row(N, bad_lines=(seg,)),
            fifo_edge_row(N, bad_deqs=(tile - 1,)),
            fifo_edge_row(N, bad_deqs=(tile, 2 * tile + 1)),
            fifo_edge_row(N, bad_deqs=(2 * tile - 1,)),
            fifo_edge_row(N, every=37),
            fifo_edge_row(N, bad_lines=(N // 2,), V=7),
            fifo_edge_row(N)]
    return [np.ascontiguousarray(np.stack(a), np.int32) for a in zip(*rows)]


def queue_edge_row(N, V, bad_lines=(), hot=False, misses=None, cycle=None):
    """One unordered-queue row of N lines (enqueue, enqueue, dequeue,
    dequeue, ... of 0, 1, 2, ... mod ``cycle``, by default V - 1, or all
    of value 0 when ``hot``) with a dequeue of V - 1, never enqueued, at
    each line of ``bad_lines`` (V >= 2), and of value v at each line j
    of ``misses`` {j: v}: each a missing dequeue where v is never
    enqueued."""
    typ = np.zeros(N, np.int32)
    f = np.zeros(N, np.int32)
    val = np.zeros(N, np.int32)
    at = {j: V - 1 for j in bad_lines} | dict(misses or {})
    cycle = cycle or V - 1
    pending, enq = collections.deque(), 0
    for j in range(N):
        if j in at:
            typ[j], f[j], val[j] = 1, 1, at[j]
        elif j % 4 < 2 or not pending:
            val[j] = 0 if hot else enq % cycle
            pending.append(val[j])
            enq += 1
        else:
            typ[j], f[j] = 1, 1
            val[j] = pending.popleft()
    return typ, f, val


def queue_edge_lines(N, V, plan):
    """Rows of N lines whose first miss sits at every edge of the walk
    (``plan`` queue_plan's): line 0, the last line, each side of a tile
    edge and of a warp's chunk edge, two misses in later chunks; where
    the last slice holds V - 257 and V - 1, which one thread of the
    fold takes in that order, misses of both with V - 1 failing first
    (in an earlier chunk, in an earlier seventh of one chunk) and after;
    then a hot value with a miss, and a healthy row. Returns the lines
    and each failing row's first miss."""
    chunk = plan["chunk"]
    bad = [(0,), (N - 1,), (31,), (32,), (chunk - 1,), (chunk,),
           (3 * chunk + 1, 5 * chunk)]
    rows = [queue_edge_row(N, V, b) for b in bad]
    firsts = [b[0] for b in bad]
    c, c2 = V - 257, V - 1
    if c >= 4 and c // plan["slice_width"] == c2 // plan["slice_width"]:
        sub = -(-(-(-chunk // (plan["warps"] - 1))) // 32) * 32
        w = 3 * chunk
        for m in ({5 * chunk + 7: c, 2 * chunk + 40: c2},
                  {w + 2 * sub + 3: c, w + 5: c2},
                  {w + 9: c, w + 2 * sub + 1: c2}):
            rows.append(queue_edge_row(N, V, misses=m, cycle=4))
            firsts.append(min(m))
    rows += [queue_edge_row(N, V, (N // 2,), hot=True), queue_edge_row(N, V)]
    return ([np.ascontiguousarray(np.stack(a), np.int32)
             for a in zip(*rows)], firsts)


def fold_outputs_equal(a, b) -> tuple:
    """(all equal, largest absolute difference) of two output tuples,
    kernel on the card and plain on the CPU (None where a family has no
    such output)."""
    eq, err = True, 0
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        x = x.cpu()
        eq &= torch.equal(x, y)
        err = max(err, tensors_err(x, y))
    return eq, err


def phase_fold_kernel_parity(dev):
    """Each of the four fold entries, and each fold_counts family, against
    its plain version (on the CPU) bit for bit, on seeded random lines at
    every width edge and in both tiers."""
    from jepsen_torch.ops import cuda_folds as K
    from jepsen_torch.ops import folds as F
    rng = np.random.default_rng(77)
    out = {"phase": "fold_kernel_parity", "cases": []}
    err = 0
    tiers = set()

    def case(entry, args_np, width, run_k, run_p, **info):
        nonlocal err
        cpu = [torch.from_numpy(a) for a in args_np]
        got = run_k([t.to(dev) for t in cpu])
        torch.cuda.synchronize()
        want = run_p(cpu)
        equal, e = fold_outputs_equal(got, want)
        err = max(err, e)
        B, N = args_np[0].shape
        tier = K.tier(entry, width, info.get("family"), rows=B)
        tiers.add((entry, info.get("family"), tier))
        out["cases"].append({"entry": entry, **info, "width": width,
                             "B": B, "N": N, "tier": tier, "equal": equal})
        require(equal, f"{entry} {info} width {width}: kernel != plain")
        return want

    for fam in FOLD_COUNT_FAMILIES:
        for V, B, N in FOLD_COUNT_CASES + count_edge_cases(fam):
            lines = fold_lines(rng, B, N, V)
            final = ((rng.random((B, V)) < 0.5).astype(np.uint8)
                     if fam in ("set", "crdb") else None)
            args = lines + ([final] if final is not None else [])

            def run_k(ts, fam=fam, V=V):
                final_t = ts[3] if len(ts) > 3 else None
                return K.fold_counts(fam, *ts[:3], final_t, V)

            def run_p(ts, fam=fam, V=V):
                final_t = ts[3] if len(ts) > 3 else None
                return F.plain_fold_counts(fam, *ts[:3], final_t, V)
            want = case("fold_counts", args, V, run_k, run_p, family=fam)
            planes = want[0]
            require(fam == "ids" or V == 1 or 0 < int((planes != 0).sum())
                    < planes.numel(), f"{fam} V={V}: degenerate planes")
    for P in FOLD_PS:
        args = fold_lines(rng, 40, 600, None, P=P)
        want = case("counter_scan", args, P,
                    lambda ts, P=P: K.counter_scan(*ts, P),
                    lambda ts, P=P: F.plain_counter_scan(*ts, P))
        require(0 < int(want[3].sum()), f"counter P={P}: no read emitted")
    verdicts = set()
    for V in FOLD_QUEUE_VS:
        B = 40 if V <= 4096 else 8
        args = fold_lines(rng, B, 600, V, queue=True)
        want = case("queue_scan", args, V,
                    lambda ts, V=V: K.queue_scan(*ts, V),
                    lambda ts, V=V: F.plain_queue_scan(*ts, V))
        verdicts |= set(want[0].tolist())
    for N, V in FOLD_QUEUE_EDGES:
        args = fold_lines(rng, 6 if N > 600 else 40, N, V, queue=True)
        firsts = []
        if V >= 2 and N > 600:
            edge, firsts = queue_edge_lines(N, V, K.queue_plan(N, V))
            args = [np.concatenate([e, a]) for e, a in zip(edge, args)]
        want = case("queue_scan", args, V,
                    lambda ts, V=V: K.queue_scan(*ts, V),
                    lambda ts, V=V: F.plain_queue_scan(*ts, V),
                    slices=K.queue_plan(N, V)["slices"])
        verdicts |= set(want[0].tolist())
        # Each edge row's first miss is where it was put.
        require(want[1][:len(firsts)].tolist() == firsts,
                f"queue edge rows fail at {want[1].tolist()}")
    require(verdicts == {0, 1}, f"queue verdicts seen: {verdicts}")
    verdicts = set()
    for N, Nmax in FOLD_FIFO_CASES:
        B = 40 if N <= 600 else 8
        args = fold_lines(rng, B, N, max(N, 2), queue=True)
        want = case("fifo_scan", args, Nmax,
                    lambda ts, Nmax=Nmax: K.fifo_scan(*ts, Nmax),
                    lambda ts, Nmax=Nmax: F.plain_fifo_scan(*ts, Nmax))
        verdicts |= set(want[0].tolist())
    require(verdicts == {0, 1}, f"FIFO verdicts seen: {verdicts}")
    for B, N, P, seg in FOLD_COUNTER_EDGES:
        args = fold_lines(rng, B, N, None, P=P)
        args[2][:, 3::17] = 2**31 - 1          # sums past INT32_MAX wrap
        want = case("counter_scan", args, P,
                    lambda ts, P=P, seg=seg: K.counter_scan(*ts, P, seg),
                    lambda ts, P=P: F.plain_counter_scan(*ts, P),
                    segment=K.scan_plan(N, B, seg)["segment"])
        require(0 < int(want[3].sum()), f"counter P={P}: no read emitted")
    verdicts = set()
    for N, Nmax, seg in FOLD_FIFO_EDGES:
        seg_n = K.scan_plan(N, 10)["segment"]
        args = (fifo_edge_lines(N, seg_n) if N > 600
                else fold_lines(rng, 40, N, 97, queue=True))
        want = case("fifo_scan", args, Nmax,
                    lambda ts, Nmax=Nmax, seg=seg: K.fifo_scan(*ts, Nmax,
                                                               seg),
                    lambda ts, Nmax=Nmax: F.plain_fifo_scan(*ts, Nmax),
                    segment=K.scan_plan(N, args[0].shape[0], seg)[
                        "segment"])
        verdicts |= set(want[0].tolist())
        # Unclipped, each edge row's first failure is where it was put.
        require(N <= 600 or Nmax < N or want[1][:4].tolist() == [
            0, N - 1, seg_n - 1, seg_n],
            f"FIFO edge rows fail at {want[1].tolist()}")
    require(verdicts == {0, 1}, f"FIFO verdicts seen: {verdicts}")
    seen = {(e, t) for e, _, t in tiers}
    require(seen == {(e, t) for e in K.ENTRIES
                     for t in (("smem", "sliced")
                               if e in ("fold_counts", "queue_scan")
                               else ("smem", "global"))},
            f"tiers seen: {sorted(seen)}")
    for fam in FOLD_COUNT_FAMILIES:
        require({("fold_counts", fam, t) for t in ("smem", "sliced")}
                <= tiers, f"fold_counts {fam}: a plan was not run")
    out["max_abs_err"] = err
    emit(out)
    return err


# ---- the full-width histories (port Op types), one per (family, seed)

def _windows(rng, n, procs):
    """Element indices in windows of ``procs`` concurrent operations:
    yields (invokes, completions), each a list of (process, element),
    the completions in a shuffled order."""
    for w in range(0, n, procs):
        inv = [(p, w + p) for p in range(min(procs, n - w))]
        done = list(inv)
        rng.shuffle(done)
        yield inv, done


def fold_set_history(seed, n, procs):
    """Adds of 0..n-1 by ``procs`` processes, 85% ok, 7.5% fail, 7.5%
    info (half of those in the read), then one final read. seed % 8: 1
    loses an acknowledged add, 2 reads an element never added, 3 reads
    one twice, 4 revives a failed add."""
    import random

    from jepsen_torch.history.core import index
    from jepsen_torch.history.ops import fail_op, info_op, invoke_op, ok_op
    rng = random.Random(seed)
    h, ok, failed, final = [], [], [], []
    for inv, done in _windows(rng, n, procs):
        h += [invoke_op(p, "add", v) for p, v in inv]
        for p, v in done:
            r = rng.random()
            if r < 0.85:
                h.append(ok_op(p, "add", v))
                ok.append(v)
                final.append(v)
            elif r < 0.925:
                h.append(fail_op(p, "add", v))
                failed.append(v)
            else:
                h.append(info_op(p, "add", v))
                if rng.random() < 0.5:
                    final.append(v)
    kind = seed % 8
    if kind == 1:
        final.remove(rng.choice(ok))
    elif kind == 2:
        final.append(n + seed)
    elif kind == 3:
        final.append(rng.choice(final))
    elif kind == 4 and failed:
        final.append(rng.choice(failed))
    h += [invoke_op(procs, "read", None), ok_op(procs, "read",
                                                sorted(final))]
    return index(h)


def fold_queue_history(seed, n, procs, fifo=False):
    """Enqueues of 0..n-1 (90% ok, 5% fail, 5% info), then dequeues: for
    ``fifo`` the first n - k elements in enqueue order, else the ok
    enqueues and half the info ones, shuffled. seed % 8: 1 loses an
    element, 2 dequeues one twice, 3 dequeues one never enqueued, 4
    swaps two dequeues (out of order)."""
    import random

    from jepsen_torch.history.core import index
    from jepsen_torch.history.ops import fail_op, info_op, invoke_op, ok_op
    rng = random.Random(seed)
    h, deqs = [], []
    for inv, done in _windows(rng, n, procs):
        h += [invoke_op(p, "enqueue", v) for p, v in inv]
        for p, v in done:
            r = rng.random()
            if r < 0.9:
                h.append(ok_op(p, "enqueue", v))
                deqs.append(v)
            elif r < 0.95:
                h.append(fail_op(p, "enqueue", v))
            else:
                h.append(info_op(p, "enqueue", v))
                if rng.random() < 0.5:
                    deqs.append(v)
    if fifo:
        deqs = list(range(n - rng.randrange(0, 20)))
    else:
        rng.shuffle(deqs)
    kind = seed % 8
    if kind == 1:
        deqs.pop(rng.randrange(len(deqs)))
    elif kind == 2:
        deqs.insert(rng.randrange(len(deqs)), rng.choice(deqs))
    elif kind == 3:
        deqs.insert(rng.randrange(len(deqs)), n + seed)
    elif kind == 4:
        i = rng.randrange(len(deqs) - 1)
        deqs[i], deqs[i + 1] = deqs[i + 1], deqs[i]
    it = iter(deqs)
    for inv, done in _windows(rng, len(deqs), procs):
        h += [invoke_op(p, "dequeue", None) for p, _ in inv]
        h += [ok_op(p, "dequeue", next(it)) for p, _ in done]
    return index(h)


def fold_ids_history(seed, n, procs):
    """n generates (90% ok with the next id, 5% fail, 5% info). seed %
    8: 1 acknowledges one id twice, 2 three ids twice each."""
    import random

    from jepsen_torch.history.core import index
    from jepsen_torch.history.ops import fail_op, info_op, invoke_op, ok_op
    rng = random.Random(seed)
    h, issued = [], []
    kind = seed % 8
    dup_at = set(rng.sample(range(n // 2, n), {1: 1, 2: 3}.get(kind, 0)))
    for inv, done in _windows(rng, n, procs):
        h += [invoke_op(p, "generate", None) for p, _ in inv]
        for p, i in done:
            r = rng.random()
            if i in dup_at or r < 0.9:
                v = rng.choice(issued) if i in dup_at else len(issued)
                issued.append(v)
                h.append(ok_op(p, "generate", v))
            elif r < 0.95:
                h.append(fail_op(p, "generate", None))
            else:
                h.append(info_op(p, "generate", None))
    return index(h)


def fold_counter_history(seed, n, procs):
    """n adds (1..5, 90% ok, 10% info) and reads by ``procs`` processes,
    half each, each read's value within its bounds. seed % 8: 1 reads
    past the upper bound, 2 adds 3,000,000,000 (past int32: the row
    detours to the host checker)."""
    import random

    from jepsen_torch.history.core import index
    from jepsen_torch.history.ops import info_op, invoke_op, ok_op
    rng = random.Random(seed)
    h = []
    lower = upper = 0
    kind = seed % 8
    for inv, done in _windows(rng, n, procs):
        ops = {}
        for p, i in inv:
            if rng.random() < 0.5:
                v = 3_000_000_000 if kind == 2 and i == n // 2 \
                    else rng.randrange(1, 6)
                h.append(invoke_op(p, "add", v))
                upper += v
                ops[p] = ("add", v)
            else:
                h.append(invoke_op(p, "read", None))
                ops[p] = ("read", None)
        lo, hi = lower, upper
        for p, i in done:
            f, v = ops[p]
            if f == "add":
                if rng.random() < 0.9:
                    h.append(ok_op(p, "add", v))
                    lower += v
                else:
                    h.append(info_op(p, "add", v))
            else:
                r = hi + 1 + rng.randrange(5) if kind == 1 and i == n // 2 \
                    else rng.randint(lo, hi)
                h.append(ok_op(p, "read", r))
    return index(h)


def fold_bench_history(seed, n=FOLD_BENCH_ELEMENTS):
    """The reference bench's total-queue history (bench.py:805-818)."""
    import random

    from jepsen_torch.history.ops import invoke_op, ok_op
    rng = random.Random(seed)
    h = []
    for i in range(n):
        h.append(invoke_op(0, "enqueue", i))
        h.append(ok_op(0, "enqueue", i))
    order = list(range(n))
    rng.shuffle(order)
    if rng.random() < 0.3:
        order.pop()                      # lost element
    for v in order:
        h.append(invoke_op(1, "dequeue", None))
        h.append(ok_op(1, "dequeue", v))
    return h


def fold_history(family, seed, elements, procs):
    """A full-width history of ``family`` (set and crdb share theirs,
    and tq and queue theirs)."""
    if family in ("set", "crdb"):
        return fold_set_history(seed, elements, procs)
    if family in ("tq", "queue", "fifo"):
        return fold_queue_history(seed, elements, procs, family == "fifo")
    if family == "ids":
        return fold_ids_history(seed, elements, procs)
    return fold_counter_history(seed, elements, procs)


def fold_oracle(job):
    """The host checker of ``jepsen_torch.checkers.simple`` on one
    history, regenerated from its seed in the worker: ``job`` is
    (family, seed, elements, procs); elements None is the bench's
    history."""
    from jepsen_torch.checkers import simple
    from jepsen_torch.models.core import fifo_queue, unordered_queue
    family, seed, elements, procs = job
    h = (fold_bench_history(seed) if elements is None
         else fold_history(family, seed, elements, procs))
    checker, model = {
        "set": (simple.SetChecker(), None),
        "tq": (simple.TotalQueueChecker(), None),
        "ids": (simple.UniqueIdsChecker(), None),
        "counter": (simple.CounterChecker(), None),
        "queue": (simple.QueueChecker(), unordered_queue()),
        "fifo": (simple.QueueChecker(), fifo_queue())}[family]
    r = checker.check(None, model, h)
    if family == "queue" and r["valid"] is True:
        # The batch fold reports the multiset left as a dict.
        r = {**r, "final-queue": dict(r["final-queue"].pending)}
    return r


def fold_measure(dev, lw, ts):
    """A batch's kernel on the inputs the batch function gave it (its
    lowered batch ``lw`` and device tensors ``ts``): the kernel alone
    (``time_launches``, 5 runs after a warm-up) and through its wrapper,
    the plain version's time on CPU copies (host clock, one run) and
    parity with it, the whole function by the library route on the card
    where there is one (``library_ms``: fold_counts with one
    ``scatter_add_`` of its histograms beside it, ``counter_scan``), and
    the bound: inputs read once and outputs written once over the memory
    rate, against FOLD_OPS over the int32 rate."""
    from jepsen_torch.ops import cuda_folds as K
    from jepsen_torch.ops import folds as F
    cpu = [None if t is None else t.cpu() for t in ts]
    if lw.entry == "fold_counts":
        launch = K.prepare_counts(lw.family, *ts, lw.width)[0]
    else:
        launch = getattr(K, "prepare_" + lw.entry.split("_")[0])(
            *ts, lw.width)[0]
    ms = time_launches([(lambda: None, launch)], reps=5)
    wrapper_ms = time_cuda(lambda: F.run_kernel(lw, ts), reps=5)
    got = F.run_kernel(lw, ts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = F.run_kernel(lw, cpu)
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal, err = fold_outputs_equal(got, want)
    B, N = lw.arrays[0].shape
    in_bytes = sum(a.nbytes for a in lw.arrays if a is not None)
    out_bytes = sum(w.numel() * w.element_size() for w in want
                    if w is not None)
    per_line, per_elem = FOLD_OPS[lw.entry]
    ops = per_line * B * N + per_elem * sum(w.numel() for w in want
                                            if w is not None)
    library_ms = library_hist_ms = None
    extra = {}
    if lw.entry in ("counter_scan", "fifo_scan"):
        plan = K.scan_plan(N, B)
        extra = {"segment": plan["segment"], "blocks": plan["blocks"]}
    if lw.entry == "counter_scan":
        library_ms = time_cuda(lambda: counter_scan_library(ts, lw.width),
                               reps=5)
        lib = counter_scan_library(ts, lw.width)
        require(fold_outputs_equal(lib, want)[0],
                "counter: the library route != plain")
        extra["library_call"] = ("cumsum of the two bounds, a per-process "
                                 "cummax of read lines, gathers")
    elif lw.entry == "fifo_scan":
        extra["library_call"] = ("none: the final head after a first "
                                 "failure is a dependent walk")
    elif lw.entry == "queue_scan":
        library_ms = time_cuda(lambda: queue_scan_library(ts, lw.width),
                               reps=5)
        lib = queue_scan_library(ts, lw.width)
        require(fold_outputs_equal(lib, want)[0],
                "queue: the library route != plain")
        plan = K.queue_plan(N, lw.width, B)
        extra = {"slices": plan["slices"],
                 "slice_width": plan["slice_width"],
                 "chunk": plan["chunk"], "blocks": plan["blocks"],
                 "library_call": "a stable sort of each row by value, "
                                 "cumsum and scatter_reduce_"}
    elif lw.entry == "fold_counts":
        C = K.FAMILIES[lw.family][1]
        V = lw.width
        code = torch.full((B, N), -1, dtype=torch.int64, device=dev)
        for c, (t, fc) in enumerate(FOLD_CODES[lw.family]):
            code[(ts[0] == t) & (ts[1] == fc)] = c
        mask = (code >= 0) & (ts[2] >= 0)
        idx = torch.where(mask, code * V + ts[2].clamp(0, V - 1).long(),
                          torch.zeros_like(code))
        ones = mask.to(torch.int32)
        hist = torch.zeros((B, C * V), dtype=torch.int32, device=dev)
        library_hist_ms = time_cuda(
            lambda: hist.zero_().scatter_add_(1, idx, ones), reps=5)
        # The whole function by the library route, lines to planes.
        library_ms = time_cuda(lambda: fold_counts_library(
            lw.family, ts, V), reps=5)
        lib = fold_counts_library(lw.family, ts, V)
        require(fold_outputs_equal(lib, want)[0],
                f"{lw.family}: the library route != plain")
        plan = K.count_plan(lw.family, V, B)
        extra = {"library_hist_ms": library_hist_ms,
                 "library_call": "scatter_add_ of the histograms and the "
                                 "family's plane ops in torch",
                 "slices": plan["slices"],
                 "slice_width": plan["slice_width"]}
    return {"entry": lw.entry, "family": lw.family, "width": lw.width,
            "B": B, "N": N, "tier": K.tier(lw.entry, lw.width, lw.family,
                                           rows=B),
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "plain_on": "cpu", "library_ms": library_ms, **extra,
            "equal": equal, "max_abs_err": err,
            **launch_bound(in_bytes + out_bytes, ops)}


def counter_scan_library(ts, P):
    """counter_scan by the library route on the card: the two bounds by
    cumsum, and each line's nearest earlier invoke-read and read of its
    process by a cummax of line indices over a [B, P, N] one-hot, with
    gathers. Returns (lows, vals, ups, emits) as the kernel does."""
    from jepsen_torch.ops.folds import NONE_SENTINEL
    typ, f, val, proc = ts
    B, N = typ.shape
    none = int(NONE_SENTINEL)
    add = torch.where(val == none, 0, val).long()
    up = torch.where((typ == 0) & (f == 0), add, 0)
    lo = torch.where((typ == 1) & (f == 0), add, 0)
    ups = torch.cumsum(up, 1) - up
    lowp = torch.cumsum(lo, 1) - lo
    inv = (typ == 0) & (f == 1)
    read = inv | ((typ == 1) & (f == 1))
    p = proc.long().clamp(0, P - 1)
    mine = p[:, None, :] == torch.arange(P, device=typ.device)[None, :, None]
    j = torch.arange(N, device=typ.device)

    def last_before(mask):
        last = torch.where(mine & mask[:, None, :], j, -1).cummax(2).values
        last = torch.nn.functional.pad(last, (1, 0), value=-1)[:, :, :N]
        return last.gather(1, p[:, None, :]).squeeze(1)
    ki, kr = last_before(inv), last_before(read)
    has = ki >= 0
    kic = ki.clamp_min(0)
    lows = torch.where(has, lowp.gather(1, kic), 0).to(torch.int32)
    vals = torch.where(has, val.gather(1, kic), none).to(torch.int32)
    emits = ((typ == 1) & (f == 1) & (kr >= 0)
             & inv.gather(1, kr.clamp_min(0)))
    return lows, vals, ups.to(torch.int32), emits.to(torch.uint8)


def queue_scan_library(ts, V):
    """queue_scan by the library route on the card: each row's active
    lines sorted stably by clipped value (so each value's lines keep
    their order), the steps' prefix sums within each value's run by a
    cumsum less its value at the run's start, each value's sum and
    lowest prefix by scatter_add_ and scatter_reduce_, and the first
    dequeue whose prefix is -1. Returns (valid, bad, counts) as the
    kernel does."""
    typ, f, val = ts
    B, N = typ.shape
    dev = typ.device
    enq = (typ == 0) & (f == 0)
    deq = (typ == 1) & (f == 1)
    key = torch.where(enq | deq, val.clamp(0, V - 1).long(), V)
    sk, order = torch.sort(key, dim=1, stable=True)
    step = (enq.long() - deq.long()).gather(1, order)
    cs = step.cumsum(1)
    j = torch.arange(N, device=dev).expand(B, N)
    starts = torch.ones_like(sk, dtype=torch.bool)
    starts[:, 1:] = sk[:, 1:] != sk[:, :-1]
    first = torch.where(starts, j, 0).cummax(1).values
    pre = cs - (cs - step).gather(1, first)
    total = torch.zeros((B, V + 1), dtype=torch.long, device=dev
                        ).scatter_add_(1, sk, step)
    low = torch.zeros((B, V + 1), dtype=torch.long, device=dev
                      ).scatter_reduce_(1, sk, pre, "amin")
    counts = (total - low)[:, :V].to(torch.int32)
    miss = deq.gather(1, order) & (pre == -1)
    bad = torch.where(miss, order, N).amin(1)
    valid = bad == N
    return (valid.to(torch.uint8),
            torch.where(valid, -1, bad).to(torch.int32), counts)


def fold_counts_library(family, ts, V):
    """fold_counts by the library route on the card: each line's
    histogram index from its (type, f) code, one scatter_add_ of every
    histogram, then the family's planes by torch ops (the formulas of
    ``plain_fold_counts``). Returns (planes, attempted)."""
    typ, f, val = ts[:3]
    B = typ.shape[0]
    C = len(FOLD_CODES[family])
    code = torch.full(typ.shape, -1, dtype=torch.int64, device=typ.device)
    for c, (t, fc) in enumerate(FOLD_CODES[family]):
        code[(typ == t) & (f == fc)] = c
    mask = (code >= 0) & (val >= 0)
    idx = torch.where(mask, code * V + val.clamp(0, V - 1).long(),
                      torch.zeros_like(code))
    h = torch.zeros((B, C * V), dtype=torch.int32, device=typ.device
                    ).scatter_add_(1, idx, mask.to(torch.int32))
    h = h.view(B, C, V)
    attempted = None
    if family in ("set", "crdb"):
        fr = ts[3].to(torch.bool)
        att, add = h[:, 0] > 0, h[:, 1] > 0
        if family == "set":
            ok = fr & att
            planes = (att, ok, fr & ~att, add & ~fr, ok & ~add)
        else:
            failed, unsure = h[:, 2] > 0, h[:, 3] > 0
            planes = (att, failed, fr & add, fr & ~att, fr & failed,
                      add & ~fr, fr & unsure)
        out = torch.stack(planes, 1).to(torch.uint8)
    elif family == "tq":
        att, enq, deq = h[:, 0], h[:, 1], h[:, 2]
        zero = torch.zeros_like(att)
        ok = torch.minimum(deq, att)
        out = torch.stack((
            att, ok, torch.where(att == 0, deq, zero),
            torch.where(att > 0, torch.clamp_min(deq - att, 0), zero),
            torch.clamp_min(enq - deq, 0), torch.clamp_min(ok - enq, 0)), 1)
    else:
        out = h[:, :1].clone()
        attempted = ((typ == 0) & (f == 0)).sum(1, dtype=torch.int32)
    return out, attempted


# (type, f) of each fold_counts histogram, in the kernel's order.
FOLD_CODES = {"set": ((0, 0), (1, 0)),
              "crdb": ((0, 0), (1, 0), (2, 0), (3, 0)),
              "tq": ((0, 0), (1, 0), (1, 1)), "ids": ((1, 0),)}


def fold_batch(dev, pool, family, label, hists, jobs):
    """One check_*_batch on the card: launch counts (set to 0 just
    before, read just after), the host clock's split, every history
    held against its host oracle (crdb: against the port's CPU path),
    and the kernel's measurement on the batch's inputs."""
    from jepsen_torch.ops import cuda_folds as K
    from jepsen_torch.ops import folds as F
    fn = getattr(F, FOLD_CHECKS[family])
    kw = {"stats_out": {}} if family == "counter" else {}
    timings = {}
    # Keep the kernel's inputs as the batch function hands them over, to
    # time and hold the kernel on them afterwards.
    seen = []
    run_kernel = F.run_kernel

    def recording(lw, ts):
        seen.append((lw, ts))
        return run_kernel(lw, ts)
    F.run_kernel = recording
    for e in K.LAUNCHES:
        K.LAUNCHES[e] = 0
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        res = fn(hists, timings=timings, **kw)
        batch_s = time.perf_counter() - t0
    finally:
        F.run_kernel = run_kernel
    launches = dict(K.LAUNCHES)
    require(len(seen) == 1, f"{label} {family}: {len(seen)} kernel calls")
    entry = seen[0][0].entry
    require(launches == {e: int(e == entry) for e in K.ENTRIES},
            f"{label} {family}: launches {launches}")
    t0 = time.perf_counter()
    if family == "crdb":
        want = F.check_crdb_sets_batch(hists, device="cpu")
    else:
        want = host_oracle(pool, fold_oracle, jobs)
    oracle_s = time.perf_counter() - t0
    for i, (r, w) in enumerate(zip(res, want)):
        require(r == w, f"{label} {family}: history {i} differs from its "
                        f"oracle")
    measure = fold_measure(dev, *seen[0])
    require(measure["equal"], f"{label} {family}: kernel != plain")
    kernel_s = measure["ms"] / 1e3
    return {"family": family, "check": FOLD_CHECKS[family],
            "histories": len(hists),
            "lines": int(sum(len(h) for h in hists)),
            "batch_s": batch_s, "hist_per_s": len(hists) / batch_s,
            "split_s": timings, "rest_s": batch_s - sum(timings.values()),
            "host_share": 1 - kernel_s / batch_s,
            "invalid": sum(r["valid"] is not True for r in res),
            "launches": launches[entry], "oracle_s": oracle_s,
            **kw, "kernel": measure}


def phase_fold_path(dev, pool):
    """Each of the seven check_*_batch on the card: the reference bench's
    total-queue batch (its fold_total_queue_rate is the batch's rate on
    a warm call, as bench.py times it) and a full-width batch per
    family."""
    from jepsen_torch.ops import folds as F
    t0 = time.perf_counter()
    bench = [fold_bench_history(s) for s in range(FOLD_BENCH_HISTORIES)]
    F.check_total_queues_batch(bench)          # warm, as bench.py does
    b = fold_batch(dev, pool, "tq", "bench", bench,
                   [("tq", s, None, None)
                    for s in range(FOLD_BENCH_HISTORIES)])
    out = {"phase": "fold_path", "fold_total_queue_rate": b["hist_per_s"],
           "bench": b, "wide": dict(FOLD_WIDE), "families": []}
    w = FOLD_WIDE
    shared = {}
    for family in FOLD_CHECKS:
        key = {"crdb": "set", "queue": "tq"}.get(family, family)
        t1 = time.perf_counter()
        if key not in shared:
            shared.clear()
            shared[key] = [fold_history(family, s, w["elements"], w["procs"])
                           for s in range(w["n"])]
        gen_s = time.perf_counter() - t1
        jobs = [(family, s, w["elements"], w["procs"])
                for s in range(w["n"])]
        b = fold_batch(dev, pool, family, "wide", shared[key], jobs)
        out["families"].append({**b, "generate_s": gen_s})
    out["fold_s"] = time.perf_counter() - t0
    emit(out)
    return out


# ------------------------------------------------- the peel loop (K4)

# The dc path's batches: unkeyed wide-window read/write histories, W 11
# to 16 cycling by row. 80 ops keep the batch's shared vocabulary (the
# register's values, one a write) at most 56 states over seeds 0-1023,
# under the columnar path's 64; 96 ops reach 68 and would leave it.
DC_ROWS = 1_024
DC_OPS = 80
DC_W0, DC_WS = 11, 6
DC_STALE = 0.3
# Rows of a dc batch (and of route_check's rw rows) held to wgl_check on
# the worker pool, 20-40 s each: cut from 16 to 8 for the script's time
# when the mesh phases joined it (the window still cycles W 11-16).
DC_ORACLE_ROWS = 8
# int32 operations the peel's function needs in one round (the bound's
# count; dc_work replays each row to count what its data needs): an op
# alive at the round's start takes part in the scatter-min and the
# scatter-max, then reads its cluster's peel bit and is kept or killed,
# 4; a live cluster takes the two-minimum merge (a compare, two selects)
# and the peel test (the outside bound's compare and select, the
# invocation compare), 6. Loads, stores and loop control are not counted.
DC_OP_OPS = 4
DC_CLUSTER_OPS = 6
# K4's parity widths: each side of the warp tier's slot counts (32, 64,
# 128 events a row) and of its edge (256), the smem tier, and past 13
# bytes an event of shared memory (32768) the device-memory tier.
DC_PARITY_EVENTS = (1, 2, 32, 33, 64, 255, 256, 257, 1024, 4096, 16384,
                    32768)
# Round caps of the cap cases, and their widths (one a tier).
DC_PARITY_CAPS = (1, 3)
DC_CAP_EVENTS = (64, 257, 32768)
# route_check's mixed corpus: the bench shapes of each family, each
# count halved for the script's time (from 256, 512, 512 and 128).
ROUTE_CAS = dict(n=128, n_procs=5, n_ops=1_000, n_values=5, corrupt=0.25)
ROUTE_RW = 256
ROUTE_LA = dict(n=256, n_ops=30)
ROUTE_TXN = dict(n=64, seed=7, anomaly="mix")


# The faulty dc batch's stale rows.
DC_STALE_ROWS = frozenset(range(0, DC_ROWS, 8))


def dc_oracle_jobs() -> list:
    """Both dc batches' oracle rows, as jobs: main starts them on the pool
    before the dc phases (a W 16 row takes 20-60 s, longer than the
    rest of a round), and the batches read them when they get there."""
    return ([rw_job(s, 0.0) for s in dc_sample()]
            + [rw_job(s, DC_STALE if s in DC_STALE_ROWS else 0.0)
               for s in dc_sample(DC_STALE_ROWS)])


def dc_sample(stale_rows=frozenset()) -> list:
    """A dc batch's oracle rows: spread over the batch, the window
    cycling through W 11-16; with ``stale_rows`` (the faulty batch) half
    of them stale rows."""
    step = DC_ROWS // DC_ORACLE_ROWS
    sample = [step * i + (i - step * i) % DC_WS
              for i in range(DC_ORACLE_ROWS)]
    if stale_rows:
        half = DC_ORACLE_ROWS // 2
        st = sorted(stale_rows)
        sample = (st[::len(st) // half][:half]
                  + [s for s in sample if s not in stale_rows][:half])
    return sample


def rw_job(seed: int, stale: float) -> tuple:
    return (seed, DC_W0 + seed % DC_WS, DC_OPS, stale)


def rw_history(job):
    from jepsen_torch.workloads.synth import synth_rw_history
    seed, n_procs, n_ops, stale = job
    return synth_rw_history(seed, n_procs=n_procs, n_ops=n_ops, stale=stale)


def rw_oracle(job):
    """``wgl_check`` on one rw history, regenerated from its job in the
    worker: (valid, bad op index or None)."""
    from jepsen_torch.checkers.linearizable import wgl_check
    from jepsen_torch.models.core import cas_register
    r = wgl_check(cas_register(), rw_history(job))
    return r["valid"], (r.get("op") or {}).get("index")


class RwOracle:
    """The host oracle of rw histories on the worker pool, remembered
    per job: a history the dc path's batches and route_check share is
    checked once."""

    def __init__(self, pool):
        self.pool, self.seen, self.s = pool, {}, 0.0
        self.pending = None

    def prefetch(self, jobs) -> None:
        """Start the oracle on ``jobs`` in the pool's workers and return:
        the next call collects them (``s`` counts only the wait)."""
        new = sorted({j for j in jobs if j not in self.seen})
        self.pending = (new, self.pool.map_async(rw_oracle, new,
                                                 chunksize=1))

    def __call__(self, jobs):
        t0 = time.perf_counter()
        if self.pending is not None:
            new, res = self.pending
            self.pending = None
            for j, r in zip(new, res.get()):
                self.seen[j] = r
        new = sorted({j for j in jobs if j not in self.seen})
        for j, r in zip(new, host_oracle(self.pool, rw_oracle, new)):
            self.seen[j] = r
        self.s += time.perf_counter() - t0
        return [self.seen[j] for j in jobs]


def verdict(r: dict) -> tuple:
    return r["valid"], (r.get("op") or {}).get("index")


def dc_plan_rows(rng, B, E, kind):
    """Plan rows of one ``kind``: W-overlapped write+read ``pairs``,
    arbitrary clusters (``random``), a row's ops all in ``one`` cluster,
    and ``shifted`` pairs, whose clusters are moved and whose first
    events are inactive, so that the least alive event's cluster is not
    0; a tenth of the ops inactive."""
    e = np.arange(E)
    if kind in ("pairs", "shifted"):
        inv = np.maximum(0, e[None] - rng.integers(1, 17, (B, 1)))
        cl = np.broadcast_to(e // 2 * 2, (B, E))
        if kind == "shifted":
            cl = (cl + rng.integers(1, E + 1, (B, 1))) % E
    else:
        inv = rng.integers(0, E, (B, E))
        cl = (np.broadcast_to(rng.integers(0, E, (B, 1)), (B, E))
              if kind == "one" else rng.integers(0, E, (B, E)))
    act = rng.random((B, E)) < 0.9
    if kind == "shifted":
        act[:, :min(3, E - 1)] = False
    return (inv.astype(np.int32), np.ascontiguousarray(cl, np.int32), act)


def dc_cases(rng):
    """The parity cases of K4: (label, inv, cluster, active, round cap
    or 0), padded as dc_decide pads or at the widths given."""
    from jepsen_torch.ops import dc_monitor as D
    out = [(f"probe_w{w}", *D.pad_plan(*D.make_probe_plan(64, 128, w)), 0)
           for w in (6, 12)]
    for E in DC_PARITY_EVENTS:
        # The widest rows peel a pair a round, E / 2 rounds of the plain
        # version over all of them: fewer rows there, and no shifted
        # rows (the narrower widths hold that case in every tier).
        B = 64 if E <= 4096 else 8 if E <= 16384 else 4
        kinds = ("pairs", "random", "one") + (("shifted",) if E <= 4096
                                              else ())
        for kind in kinds:
            out.append((f"{kind}_E{E}", *dc_plan_rows(rng, B, E, kind), 0))
    for E in DC_CAP_EVENTS:
        for cap in DC_PARITY_CAPS:
            for kind in ("pairs", "shifted"):
                out.append((f"{kind}_E{E}_cap{cap}",
                            *dc_plan_rows(rng, 8, E, kind), cap))
    z = np.zeros((4, 64), np.int32)
    out.append(("inactive", z, z, np.zeros((4, 64), bool), 0))
    return out


def dc_pair(plans, dev, cap=0):
    """K4 on the card and its plain version on CPU copies over plans:
    (rounds of every row, largest difference in decided or rounds)."""
    from jepsen_torch.ops import cuda_dc
    from jepsen_torch.ops import dc_monitor as D
    err, rounds = 0, []
    for inv, cl, act in plans:
        cpu = [torch.from_numpy(a) for a in (inv, cl, act)]
        kd, kr = cuda_dc.dc_peel(*(t.to(dev) for t in cpu),
                                 cap or inv.shape[1] + 1)
        pd, pr = D.plain_dc_peel(*cpu, cap)
        err = max(err, tensors_err(kd.cpu(), pd), tensors_err(kr.cpu(), pr))
        rounds += pr.tolist()
    return rounds, err


def dc_work(inv, cluster, active):
    """Replays the peel loop over plan rows on the host, as
    ``dc_host_decide`` does, and counts the work each round's data needs:
    (rounds [B], op-rounds, cluster-rounds), a round counting the ops
    alive at its start and the clusters they hold."""
    B, E = active.shape
    resp = np.arange(E)
    rounds = np.zeros(B, np.int64)
    ops = clusters = 0
    for b in range(B):
        alive = active[b].astype(bool)
        while alive.any() and rounds[b] < E + 1:
            rounds[b] += 1
            cl = cluster[b]
            m_resp = np.full(E, 1 << 30)
            np.minimum.at(m_resp, cl[alive], resp[alive])
            m_inv = np.full(E, -1)
            np.maximum.at(m_inv, cl[alive], inv[b][alive])
            has = m_resp < 1 << 30
            ops += int(alive.sum())
            clusters += int(has.sum())
            a1 = int(np.argmin(m_resp))
            m2 = m_resp.copy()
            m2[a1] = 1 << 30
            t_out = np.where(resp == a1, m2.min(), m_resp[a1])
            new_alive = alive & ~(has & (m_inv <= t_out))[cl]
            if (new_alive == alive).all():
                break
            alive = new_alive
    return rounds, ops, clusters


def phase_dc_kernel_parity(dev):
    """K4 (``cuda_dc.dc_peel``) against ``plain_dc_peel`` on CPU copies,
    decided and rounds bit for bit: the probe plan at W 6 and 12; pair,
    random, one-cluster and shifted-cluster plans at every tier edge (the
    warp tier to E 256, the smem tier to 16384, the device-memory tier at
    32768); round caps 1 and 3 in each tier; all-inactive rows; and
    JT_DC_MAX_ROUNDS=1 through dc_decide."""
    from jepsen_torch.ops import cuda_dc
    from jepsen_torch.ops import dc_monitor as D
    rng = np.random.default_rng(8)
    cases, err = [], 0
    for label, inv, cl, act, cap in dc_cases(rng):
        rounds, e = dc_pair([(inv, cl, act)], dev, cap)
        require(e == 0, f"dc_peel != plain_dc_peel on {label}")
        err = max(err, e)
        cases.append({"case": label, "B": inv.shape[0], "E": inv.shape[1],
                      "tier": cuda_dc.tier(inv.shape[1]), "cap": cap,
                      "rounds_max": max(rounds), "equal": True})
        require(not cap or max(rounds) == cap,
                f"{label}: no row reached the round cap")
    os.environ["JT_DC_MAX_ROUNDS"] = "1"
    try:
        plan = D.make_probe_plan(64, 128, 12)
        got_r, want_r = [], []
        got = D.dc_decide(*plan, device=dev, rounds_out=got_r)
        want = D.dc_decide(*plan, device="cpu", rounds_out=want_r)
    finally:
        del os.environ["JT_DC_MAX_ROUNDS"]
    require(np.array_equal(got, want) and got_r == want_r,
            "dc_decide differs from its plain version under a round cap")
    require(set(got_r) == {1} and not got.any(), "the round cap is ignored")
    cases.append({"case": "JT_DC_MAX_ROUNDS=1", "B": 64, "E": 128,
                  "tier": cuda_dc.tier(128), "rounds_max": 1,
                  "equal": True})
    tiers = {c["tier"] for c in cases}
    require(tiers == {"warp", "smem", "global"},
            f"the parity cases missed a tier: {sorted(tiers)}")
    emit({"phase": "dc_kernel_parity", "cases": cases, "max_abs_err": err})
    return err


class DcRecorder:
    """Times the peel plan and the pre-filter on the host clock and keeps
    the plan of every K4 launch and every chunk's certified rows while it
    is active (the wrappers still launch and count as always). After the
    timed run, ``padded_plans`` pads the plans as dc_decide does and
    ``check_host`` holds the certified rows to ``dc_host_decide &
    capable``, outside the run's clock."""

    def __init__(self):
        self.raw, self.chunks = [], []
        self.plan_s = self.peel_s = 0.0
        self.certified = 0

    def padded_plans(self):
        """[(padded plan, real rows)] of every K4 launch."""
        return [(self.D.pad_plan(*p), p[0].shape[0]) for p in self.raw]

    def certified_at(self) -> list:
        """Positions in the caller's history list of every row the peel
        loop certified."""
        return sorted(batch.indices[lo + i] for batch, lo, _, out
                      in self.chunks for i in np.flatnonzero(out))

    def check_host(self) -> int:
        """Holds each chunk's certified rows to the host twin; returns
        the rows checked."""
        D, n = self.D, 0
        for batch, lo, hi, out in self.chunks:
            p = D.dc_plan_for(batch)
            host = D.dc_host_decide(p.inv[lo:hi], p.cluster[lo:hi],
                                    p.active[lo:hi]) & p.capable[lo:hi]
            require(np.array_equal(out, host),
                    "certified rows != dc_host_decide & capable")
            n += hi - lo
        return n

    def __enter__(self):
        from jepsen_torch.ops import dc_monitor as D
        self.D = D
        self._orig = D.dc_plan, D.dc_decide, D.dc_prefilter_chunk
        plan, decide, prefilter = self._orig

        def rec_plan(batch):
            t0 = time.perf_counter()
            out = plan(batch)
            self.plan_s += time.perf_counter() - t0
            return out

        def rec_decide(inv, cluster, active, **kw):
            self.raw.append((inv, cluster, active))
            t0 = time.perf_counter()
            out = decide(inv, cluster, active, **kw)
            self.peel_s += time.perf_counter() - t0
            return out

        def rec_prefilter(batch, lo, hi, **kw):
            out = prefilter(batch, lo, hi, **kw)
            if out is not None:
                self.certified += int(out.sum())
                self.chunks.append((batch, lo, hi, out.copy()))
            return out

        D.dc_plan, D.dc_decide, D.dc_prefilter_chunk = \
            rec_plan, rec_decide, rec_prefilter
        return self

    def __exit__(self, *exc):
        self.D.dc_plan, self.D.dc_decide, self.D.dc_prefilter_chunk = \
            self._orig
        return False


def counts(L):
    from jepsen_torch.ops import cuda_dc
    return {"dc_peel": cuda_dc.LAUNCHES, "wgl_frontier": L.cuda_wgl.LAUNCHES,
            "wgl_frontier_wide": L.cuda_wgl.WIDE_LAUNCHES,
            "wgl_frontier_group": L.cuda_wgl.GROUP_LAUNCHES}


def zero_counts(L):
    from jepsen_torch.ops import cuda_dc
    cuda_dc.LAUNCHES = L.cuda_wgl.LAUNCHES = L.cuda_wgl.GROUP_LAUNCHES = 0
    L.cuda_wgl.WIDE_LAUNCHES = 0


def closure_ops(L, args, kw, top=None):
    """What ``plain_wgl(ops=)`` counts for one recorded launch, per row
    (int64 [B]), from the closures of the kernel under test: each live
    event is run twice from the previous event's carry, once as EV_CLOSE
    (its closure Fc, the count's input) and once as itself. Per live
    event of a row still valid: NW ORs for each configuration of Fc
    under each slot whose kind reaches a state and whose bit its mask
    lacks, and on an OK one word test per kept mask. With ``top`` (a
    slot), the three parts apart: (ORs under the slots below ``top``,
    ORs under the slots from ``top`` up, word tests)."""
    from jepsen_torch.ops.encode import EV_CLOSE, EV_FUSED, EV_OK
    ev_type, ev_slot, ev_slots, target, idx0 = args[:5]
    V, W, WL = kw["V"], kw["W"], kw["w_live"]
    B, N = ev_type.shape
    NW, M, K1 = L.n_state_words(V), 1 << W, target.shape[-2]
    dev = ev_type.device
    kern = L.get_kernel(V, W, w_live=WL, resume=True)
    kinds = ev_slots[:, :, :WL].long()
    kinds = torch.where(kinds < 0, kinds + K1, kinds).clamp(0, K1 - 1)
    reach_k = ((target >= 0) & (target < 32 * NW)).any(-1)
    reach = (reach_k[kinds] if target.dim() == 2 else torch.gather(
        reach_k, 1, kinds.reshape(B, -1)).reshape(B, N, WL)).long()
    masks = torch.arange(M, device=dev)
    lacks = [((masks >> i) & 1 == 0).long() for i in range(WL)]
    octet = torch.tensor([bin(v).count("1") for v in range(256)],
                         dtype=torch.int64, device=dev)
    split, top = top is not None, WL if top is None else min(top, WL)
    parts = torch.zeros(3, B, dtype=torch.int64, device=dev)
    F, Fb, valid, bad = (t.clone() for t in args[5:9])
    for e in range(N):
        typ = ev_type[:, e]
        live = (typ == EV_OK) | (typ == EV_FUSED) | (typ == EV_CLOSE)
        if not bool(live.any()):
            continue
        ev = [t[:, e:e + 1].contiguous() for t in (ev_slot, ev_slots)]
        close = torch.where(live, EV_CLOSE, 0).to(torch.int8)[:, None]
        Fc = kern(close, *ev, target, idx0 + e, F, Fb, valid, bad)[2]
        pc = octet[Fc.contiguous().view(torch.uint8).long()].view(
            B, NW, M, 4).sum((1, 3))
        weights = [sum((reach[:, e, i, None] * lacks[i] for i in slots),
                       torch.zeros_like(pc))
                   for slots in (range(top), range(top, WL))]
        ok = ((typ == EV_OK) | (typ == EV_FUSED)).long()
        need = torch.stack([NW * (pc * w).sum(1) for w in weights]
                           + [ok * (NW * (M >> 1))])
        parts += torch.where(live & valid, need, torch.zeros_like(need))
        valid, bad, F, Fb = kern(ev_type[:, e:e + 1].contiguous(), *ev,
                                 target, idx0 + e, F, Fb, valid, bad)
    return tuple(parts) if split else parts.sum(0)


# Rows of each recorded launch the plain version runs on to hold
# closure_ops to plain_wgl(ops=) (the plain version over a whole dc
# batch takes minutes on the card), on every PLAIN_SAMPLE_EVERY-th
# launch (every one until the mesh phases joined the script: the
# plain version's event walk, 13-21 s a batch, does not shrink with
# the rows).
PLAIN_SAMPLE_ROWS = 2
PLAIN_SAMPLE_EVERY = 2


def k1_launches_measure(L, singles) -> dict:
    """A run's recorded single-bucket launches, once per batch: each
    launch's plan (tier, CTAs per row, table form),
    W, V, rows, events and time alone (``time_launches``, 3 runs), and
    the bound of the whole run from the operations its data needs
    (``closure_ops``) and the bytes the launches must move
    (``frontier_bytes``). The plain version runs on the first
    PLAIN_SAMPLE_ROWS rows of every PLAIN_SAMPLE_EVERY-th launch (its
    time there is ``plain_ms``), which must give the same verdicts,
    frontiers and operation counts as the kernel and closure_ops
    there."""
    detail, nbytes, ops, plain_ms, sampled = [], 0, 0, 0.0, 0
    for li, (a, kw) in enumerate(singles):
        V, W, wl = kw["V"], kw["W"], kw["w_live"]
        plan = L.cuda_wgl.smem_plan(V, W, wl, K1=a[3].shape[-2],
                                    shared_target=a[3].dim() == 2)
        nbytes += frontier_bytes(L, a[0], a[2], a[3], V, W, wl)
        counted = closure_ops(L, a, kw)
        ops += int(counted.sum())
        detail.append({"V": V, "W": W, "w_live": wl,
                       "rows": int(a[0].shape[0]),
                       "events": int(a[0].shape[1]), "tier": plan["tier"],
                       "cluster_ctas": plan["cluster_ctas"],
                       "table_form": plan["table_form"],
                       "threads": plan["threads"],
                       "needed_ops": int(counted.sum()),
                       "ms": time_launches([prepared_single(L, *a, **kw)],
                                           reps=3)})
        if li % PLAIN_SAMPLE_EVERY:
            continue
        n = min(PLAIN_SAMPLE_ROWS, a[0].shape[0])
        part = [t[:n] for t in a[:3]] + [a[3] if a[3].dim() == 2
                                         else a[3][:n]]
        carry = [t[:n] for t in a[5:9]]
        got = L.cuda_wgl.wgl_frontier(*part, a[4], *carry, **kw)
        nd = torch.zeros(n, dtype=torch.int64, device=a[0].device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = L.plain_wgl(*part, a[4], *carry, **kw, ops=nd)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        sampled += n
        require(all(torch.equal(x, y) for x, y in zip(got, want))
                and torch.equal(nd, counted[:n]),
                f"W={W} V={V}: kernel or closure_ops != plain on the "
                "sampled rows")
    return {"launches": detail, "plain_ms": plain_ms, "plain_on": "cuda",
            "plain_rows": sampled,
            "plain_rows_of": sum(d["rows"] for d in detail),
            **launch_bound(nbytes, ops)}


class DecodeClock:
    """Sums the host time spent in ops.linearize._decode_result (one
    invalid row's result dict from its latched frontier) while active."""

    def __init__(self, L):
        self.L = L
        self.s, self.calls = 0.0, 0

    def __enter__(self):
        real = self.L._decode_result

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.s += time.perf_counter() - t0
                self.calls += 1
        self._orig = real
        self.L._decode_result = timed
        return self

    def __exit__(self, *exc):
        self.L._decode_result = self._orig
        return False


def dc_run(L, cas, hists, backend, measure=False):
    """check_batch_columnar(details="invalid") of an unkeyed batch under
    one backend, as its two steps (the columnar conversion, then
    check_columnar) so that the host clock splits them: launch counts
    set to 0 just before and read just after, the scheduler's stats, the
    peel plan's and pre-filter's host time, the host time of the invalid
    rows' result dicts (``decode_result_s``, the rest of the residue
    search's host time beside it as ``k1_rest_s``), and the frontier
    launches (K1, K2f) of the run replayed alone by CUDA events
    (``k1_ms``); with
    ``measure``, also each launch's plan and time and the run's K1 bound
    (``k1``, ``k1_launches_measure``). After the clock stops, every
    chunk's certified rows are held to the host twin."""
    from jepsen_torch.history.columnar import ops_to_columnar
    from jepsen_torch.ops.statespace import enumerate_statespace
    split, stats = {}, {}
    with DcRecorder() as rec, LaunchRecorder(L.cuda_wgl) as k1, \
            DecodeClock(L) as dec:
        zero_counts(L)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols = ops_to_columnar(cas(), hists, max_states=64)
        split["convert_s"] = time.perf_counter() - t0
        res = L.check_columnar(cas(), cols, details="invalid", timings=split,
                               stats_out=stats,
                               scheduler_opts={"wgl_backend": backend})
        e2e_s = time.perf_counter() - t0
        launches = counts(L)
    require(launches["wgl_frontier"] == len(k1.singles)
            and launches["wgl_frontier_group"] == len(k1.groups),
            "recorded launches differ from the counts")
    # K1 and K2f alone, every launch of the run replayed (5 runs).
    k1_ms = time_launches(
        [prepared_single(L, *a, **kw) for a, kw in k1.singles]
        + [prepared_group(L, m, f, r) for m, f, r in k1.groups], reps=5)
    k1_detail = None
    if measure:
        require(not k1.groups, "a measured dc run made group launches")
        k1_detail = k1_launches_measure(L, k1.singles)
    del k1
    host_checked, plans = rec.check_host(), rec.padded_plans()
    split["dc_plan_s"], split["dc_prefilter_s"] = rec.plan_s, rec.peel_s
    # device_s holds the plan, the pre-filter, K1 and the decode; the
    # decode of the invalid rows' result dicts (_decode_result) is split
    # out of the rest (launches, waits, copies and the verdict scatter).
    split["k1_and_decode_s"] = (split["device_s"] - rec.plan_s
                                - rec.peel_s)
    split["decode_result_s"] = dec.s
    split["decode_results"] = dec.calls
    split["k1_rest_s"] = split["k1_and_decode_s"] - dec.s
    run = {"backend": backend, "check_s": e2e_s,
           "histories_per_s": len(hists) / e2e_s,
           "states": enumerate_statespace(cas(), cols.kinds, 64).n_states,
           "launches": launches,
           "k1_launches": launches["wgl_frontier"]
           + launches["wgl_frontier_group"], "k1_ms": k1_ms,
           **({"k1": k1_detail} if measure else {}),
           "split_s": split, "certified_rows": rec.certified,
           "host_checked_rows": host_checked,
           "stats": {k: stats.get(k) for k in (
               "chunks", "dispatches", "fused_groups", "classes",
               "dc_dispatches", "dc_rows", "dc_decided_rows",
               "dc_skipped_scans", "wgl_backend")},
           "fallback_rows": sum(1 for r in res if "fallback" in r)}
    return res, run, plans, rec.certified_at()


def dc_peel_library(inv, cluster, active, rounds):
    """K4's whole function as PyTorch calls on the plan's device, for
    ``rounds`` rounds of every row: per round a scatter_reduce_ amin of
    the alive ops' event index and an amax of their invocation by
    cluster, the argmin, a gather and the alive mask's update. A round
    without progress changes nothing, so ``rounds`` at the launch's
    largest round count gives the kernel's decided [B]."""
    big = 1 << 30
    idx = torch.arange(inv.shape[1], device=inv.device, dtype=torch.int32)
    cl = cluster.long()
    alive = active.clone()
    m_resp = torch.empty_like(inv)
    m_inv = torch.empty_like(inv)
    for _ in range(rounds):
        at = torch.where(alive, cl, 0)
        m_resp.fill_(big).scatter_reduce_(1, at, torch.where(alive, idx, big),
                                          "amin")
        m_inv.fill_(-1).scatter_reduce_(1, at, torch.where(alive, inv, -1),
                                        "amax")
        a1 = m_resp.argmin(dim=1, keepdim=True)
        g1 = m_resp.gather(1, a1)
        g2 = m_resp.scatter(1, a1, big).amin(dim=1, keepdim=True)
        peel = (m_resp < big) & (m_inv <= torch.where(idx == a1, g2, g1))
        alive &= ~peel.gather(1, cl)
    return ~alive.any(dim=1)


# The empty kernel (csrc/launch_floor.cu) that the launch floor is timed
# with, launched through ctypes as the wrappers launch their kernels.
FLOOR_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "jepsen_torch", "ops", "csrc", "launch_floor.cu")
_FLOOR_LIB = None


def floor_library(path=None):
    """The empty kernel's library: built from this checkout's source, or
    loaded from ``path`` (a library another process built)."""
    global _FLOOR_LIB
    if _FLOOR_LIB is None:
        import ctypes
        sym = {"launch_floor": ([ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p], ctypes.c_int)}
        if path is None:
            from jepsen_torch.ops._build import build_library
            _FLOOR_LIB = build_library(FLOOR_SRC, sym)
        else:
            _FLOOR_LIB = ctypes.CDLL(path)
            fn = _FLOOR_LIB.launch_floor
            fn.argtypes, fn.restype = sym["launch_floor"]
    return _FLOOR_LIB


def floor_launches(grids, path=None):
    """Prepared launches (for ``time_launches``) of the empty kernel on
    each ``(blocks, threads)`` grid."""
    lib = floor_library(path)

    def one(blocks, threads):
        def launch():
            err = lib.launch_floor(blocks, threads,
                                   torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"the empty kernel was refused: {err}")
        return (lambda: None), launch
    return [one(b, t) for b, t in grids]


def dc_grid(B, E):
    """K4's launch grid on a [B, E] plan: the warp tier's blocks of
    cuda_dc.WARP_ROWS rows, else a block a row (256 threads each)."""
    from jepsen_torch.ops import cuda_dc
    if cuda_dc.tier(E) == "warp":
        return -(-B // cuda_dc.WARP_ROWS), 256
    return B, 256


def dc_measure(dev, plans):
    """K4 over the padded plans a path gave it: the kernel alone
    (``time_launches``, 5 runs after a warm-up) and through its wrapper,
    the empty kernel on the same grids (``floor_ms``, the launch floor),
    the plain version's time on CPU copies (host clock, one run) and
    parity with it, the whole peel as PyTorch calls on the card for each
    launch's largest round count (``dc_peel_library``, ``library_ms``),
    the rounds' distribution, each plan's tier, and the bound over the
    real rows: each event's active byte and each active event's inv and
    cluster read once and two outputs written once, over the memory rate,
    against the peel's operations on each round's alive ops and live
    clusters (``dc_work``) over the int32 rate. ``plans`` is [(padded
    plan, real rows)]."""
    from jepsen_torch.ops import cuda_dc
    from jepsen_torch.ops import dc_monitor as D
    real = [b for _, b in plans]
    plans = [p for p, _ in plans]
    ts = [[torch.from_numpy(a).to(dev) for a in p] for p in plans]
    caps = [p[0].shape[1] + 1 for p in plans]
    ms = time_launches([(lambda: None, cuda_dc.prepare(*t, c)[0])
                        for t, c in zip(ts, caps)], reps=5)
    wrapper_ms = time_cuda(lambda: [cuda_dc.dc_peel(*t, c)
                                    for t, c in zip(ts, caps)], reps=5)
    floor_ms = time_launches(floor_launches([dc_grid(*p[0].shape)
                                             for p in plans]), reps=5)
    got = [cuda_dc.dc_peel(*t, c) for t, c in zip(ts, caps)]
    cpu = [[torch.from_numpy(a) for a in p] for p in plans]
    t0 = time.perf_counter()
    want = [D.plain_dc_peel(*c) for c in cpu]
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max(tensors_err(g[0].cpu(), w[0]), tensors_err(g[1].cpu(),
                                                             w[1]))
              for g, w in zip(got, want))
    # Rounds of the real rows (the padding rows run none).
    rounds = [r for (_, w), b in zip(want, real) for r in w[:b].tolist()]
    # The library route over the same plans, each for its launch's most
    # rounds; its decided must be the plain version's.
    most = [int(w[1].max()) if len(w[1]) else 0 for w in want]
    lib = [dc_peel_library(*t, r) for t, r in zip(ts, most)]
    require(all(torch.equal(x.cpu(), w[0]) for x, w in zip(lib, want)),
            "dc_peel_library != plain_dc_peel")
    library_ms = time_cuda(lambda: [dc_peel_library(*t, r)
                                    for t, r in zip(ts, most)], reps=3)
    nbytes = op_rounds = cluster_rounds = 0
    for (inv, cl, act), b, (_, w) in zip(plans, real, want):
        nbytes += act[:b].size + int(act[:b].sum()) * 8 + b * 5
        r, o, c = dc_work(inv[:b], cl[:b], act[:b])
        require(r.tolist() == w[:b].tolist(),
                "dc_work's replay differs from plain_dc_peel's rounds")
        op_rounds, cluster_rounds = op_rounds + o, cluster_rounds + c
    ops = op_rounds * DC_OP_OPS + cluster_rounds * DC_CLUSTER_OPS
    hist: dict = {}
    for r in rounds:
        hist[r] = hist.get(r, 0) + 1
    return {"launches": len(plans),
            "shapes": sorted({tuple(p[0].shape) for p in plans}),
            "real_rows": sum(real),
            "tier": sorted({cuda_dc.tier(p[0].shape[1]) for p in plans}),
            "tier_per_plan": [[*p[0].shape, cuda_dc.tier(p[0].shape[1])]
                              for p in plans],
            "ms": ms, "wrapper_ms": wrapper_ms, "floor_ms": floor_ms,
            "plain_ms": plain_ms, "plain_on": "cpu",
            "library_ms": library_ms,
            "library_call": "the whole peel: scatter_reduce_ amin and amax, "
                            "argmin, gathers and the mask update a round, "
                            "each launch's most rounds",
            "library_rounds": most,
            "rounds_hist": hist_json(hist), "rows": len(rounds),
            "op_rounds": op_rounds, "cluster_rounds": cluster_rounds,
            "equal": err == 0, "max_abs_err": err,
            **launch_bound(nbytes, ops)}


def dc_batch(dev, L, cas, oracle, label, stale_rows):
    """One full-width rw batch through check_batch_columnar three ways in
    one run (dc, xla, auto after the probe): verdicts and bad ops equal
    across them, dc's certified rows equal to the host twin's, a 32-row
    sample equal to wgl_check on the worker pool, and K4 measured on the
    plans the dc run gave it."""
    jobs = [rw_job(s, DC_STALE if s in stale_rows else 0.0)
            for s in range(DC_ROWS)]
    hists = [rw_history(j) for j in jobs]
    runs, verdicts, plans = {}, {}, None
    for backend in ("dc", "xla", "auto"):
        res, run, p, at = dc_run(L, cas, hists, backend,
                                 measure=backend == "dc")
        require(run["fallback_rows"] == 0,
                f"{label} {backend}: rows went to the host")
        require(all(r["valid"] is True or "op" in r for r in res),
                f"{label} {backend}: result shape")
        runs[backend] = run
        verdicts[backend] = [verdict(r) for r in res]
        if backend == "dc":
            plans, certified = p, [jobs[i] for i in at]
            run["wgl_dc_rows"] = sum(r.get("provenance") == "wgl-dc"
                                     for r in res)
            require(all(r["valid"] is True for r in res
                        if r.get("provenance") == "wgl-dc"),
                    f"{label}: a wgl-dc row is not valid")
    for b in ("dc", "auto"):
        require(verdicts[b] == verdicts["xla"],
                f"{label}: {b} verdicts or bad ops differ from xla")
    require(runs["dc"]["launches"]["dc_peel"] > 0,
            f"{label}: dc_peel was not launched")
    sample = dc_sample(stale_rows)
    for s, w in zip(sample, oracle([jobs[s] for s in sample])):
        require(verdicts["xla"][s] == w,
                f"{label}: row {s} differs from wgl_check")
    measure = dc_measure(dev, plans)
    require(measure["equal"], f"{label}: dc_peel != plain on the path")
    require(measure["tier"] == ["warp"],
            f"{label}: a plan of the path left K4's warp tier: "
            f"{measure['tier']}")
    ws: dict = {}
    for j in jobs:
        ws[j[1]] = ws.get(j[1], 0) + 1
    return {"batch": label, "rows": DC_ROWS, "n_ops": DC_OPS,
            "n_procs": hist_json(ws), "stale_rows": len(stale_rows),
            "invalid": sum(v is not True for v, _ in verdicts["xla"]),
            "oracle_rows": len(sample), "runs": runs, "kernel": measure,
            "certified_jobs": certified}


def dc_skip_batch(L, cas, jobs):
    """The rows the peel loop certified in the healthy batch, checked as
    a batch of their own under dc and xla: every chunk is certified
    whole, so dc must skip every K1 launch, and xla's K1 verdicts must
    agree."""
    hists = [rw_history(j) for j in jobs]
    runs, verdicts = {}, {}
    for backend in ("dc", "xla"):
        res, run, _, _ = dc_run(L, cas, hists, backend)
        runs[backend], verdicts[backend] = run, [verdict(r) for r in res]
    st = runs["dc"]["stats"]
    require(verdicts["dc"] == verdicts["xla"]
            and all(v is True for v, _ in verdicts["xla"]),
            "certified batch: a verdict differs from xla's or is invalid")
    require(runs["dc"]["k1_launches"] == 0
            and st["dc_skipped_scans"] == st["chunks"] > 0,
            "certified batch: a chunk launched K1 under dc")
    return {"batch": "certified", "rows": len(jobs), "runs": runs}


def phase_dc_path(dev, L, oracle):
    """The peel prefilter at full width: probe_and_persist() (its
    launches counted apart), then the healthy and the faulty batch, and
    the healthy batch's certified rows alone, where every chunk skips."""
    from jepsen_torch import fleet
    from jepsen_torch.models.core import cas_register
    zero_counts(L)
    t0 = time.perf_counter()
    rates = fleet.probe_and_persist()
    probe = {"probe_s": time.perf_counter() - t0, "rates": rates,
             "launches": counts(L)}
    require(probe["launches"]["dc_peel"] > 0 and rates["dc_events_per_s"],
            "the dc rate probe did not run K4")
    healthy = dc_batch(dev, L, cas_register, oracle, "healthy", set())
    faulty = dc_batch(dev, L, cas_register, oracle, "faulty",
                      DC_STALE_ROWS)
    whole = dc_skip_batch(L, cas_register, healthy.pop("certified_jobs"))
    del faulty["certified_jobs"]
    emit({"phase": "dc_path", "probe": probe,
          "table": fleet.CostRouter().table(ws=tuple(range(
              DC_W0, DC_W0 + DC_WS)), events=2 * DC_OPS + 1),
          "batches": [healthy, faulty, whole], "oracle_s": oracle.s})
    require(healthy["runs"]["dc"]["stats"]["dc_skipped_scans"] > 0,
            "healthy batch: no scan was skipped")
    # A dc-routed chunk launches K1 alone unless the peel loop decided
    # every row of it: each skipped scan is one K1 launch saved.
    for b in (healthy, faulty):
        for backend in ("dc", "auto"):
            r = b["runs"][backend]
            require(r["launches"]["wgl_frontier_group"] == 0
                    and r["k1_launches"] == r["stats"]["chunks"]
                    - r["stats"]["dc_skipped_scans"],
                    f"{b['batch']} {backend}: K1 launches != chunks - "
                    "skipped scans")
    return probe, healthy, faulty, whole


def route_corpus():
    """route_check's mixed corpus, each history with its oracle job."""
    from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_batch
    from jepsen_torch.workloads.synth import (synth_cas_history,
                                              synth_la_history)
    kw = {k: v for k, v in ROUTE_CAS.items() if k != "n"}
    out = [(synth_cas_history(s, **kw), ("cas", s))
           for s in range(ROUTE_CAS["n"])]
    # Half the rw rows are healthy rows of the dc path's batch, its
    # oracle rows first (their oracle is remembered), half stale ones of
    # other seeds.
    half = ROUTE_RW // 2
    first = dc_sample()
    seeds = first + [s for s in range(DC_ROWS) if s not in first]
    out += [(rw_history(rw_job(s, 0.0)), ("rw", rw_job(s, 0.0)))
            for s in seeds[:half]]
    out += [(rw_history(rw_job(s, DC_STALE)), ("rw", rw_job(s, DC_STALE)))
            for s in range(DC_ROWS, DC_ROWS + half)]
    out += [(synth_la_history(s, n_ops=ROUTE_LA["n_ops"],
                              corrupt=1.0 if s % 7 == 0 else 0.0),
             ("la", s)) for s in range(ROUTE_LA["n"])]
    out += [(h, ("txn", i)) for i, (h, _) in
            enumerate(synth_txn_batch(TxnSpec(**ROUTE_TXN)))]
    return out


def cas_oracle(seed):
    """``wgl_check`` on one route_check cas history, regenerated from
    its seed in the worker: (valid, bad op index or None)."""
    from jepsen_torch.checkers.linearizable import wgl_check
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.workloads.synth import synth_cas_history
    kw = {k: v for k, v in ROUTE_CAS.items() if k != "n"}
    r = wgl_check(cas_register(), synth_cas_history(seed, **kw))
    return r["valid"], (r.get("op") or {}).get("index")


def phase_route_check(dev, L, pool, oracle):
    """route_check on a mixed corpus after probe_and_persist(): every
    unit priced on the H100's probed rates and each backend group run as
    one batch. Every row is held to an engine other than the one that
    decided it: rows a device group decided to their host oracle on the
    worker pool (wgl_check, check_graph_host, check_txn_host; the rw
    rows to a 32-row wgl_check sample), and every linearizable row to the
    frontier-only device verdicts (``wgl_backend="xla"``)."""
    from jepsen_torch import fleet
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import cuda_graph
    from jepsen_torch.ops.graph import check_graph_host, extract_graph
    from jepsen_torch.ops.txn_graph import check_txn_host, extract_txn_graph
    rates = fleet.probe_and_persist()
    corpus = route_corpus()
    hists = [h for h, _ in corpus]
    zero_counts(L)
    cuda_graph.LAUNCHES = cuda_graph.TXN_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, routing = fleet.route_check(cas_register(), hists)
    route_s = time.perf_counter() - t0
    launches = {**counts(L), "graph_closure": cuda_graph.LAUNCHES,
                "txn_closure": cuda_graph.TXN_LAUNCHES}
    require(len(res) == len(hists) and all("backend" in r for r in res),
            "route_check: a result without its backend")
    by_fam: dict = {}
    for (h, (fam, key)), r in zip(corpus, res):
        by_fam.setdefault(fam, []).append((key, h, r))
    t0 = time.perf_counter()
    for fam in ("cas", "rw"):
        rows = by_fam[fam]
        frontier = L.check_batch_columnar(
            cas_register(), [h for _, h, _ in rows], details="invalid",
            scheduler_opts={"wgl_backend": "xla"})
        for (k, _, r), f in zip(rows, frontier):
            require(verdict(r) == verdict(f),
                    f"route_check: {fam} row {k} != the frontier-only "
                    "verdict")
    cas = [(s, r) for s, _, r in by_fam["cas"]
           if r["backend"] != "host-oracle"]
    for (s, r), w in zip(cas, host_oracle(pool, cas_oracle,
                                          [s for s, _ in cas])):
        require(verdict(r) == w, f"route_check: cas row {s} != wgl_check")
    rw = by_fam["rw"]
    half = len(rw) // 2
    pick = list(range(DC_ORACLE_ROWS // 2)) + np.linspace(
        half, len(rw) - 1, DC_ORACLE_ROWS // 2).astype(int).tolist()
    for i, w in zip(pick, oracle([rw[i][0] for i in pick])):
        require(verdict(rw[i][2]) == w,
                f"route_check: rw row {rw[i][0]} != wgl_check")
    la = by_fam["la"]
    for (s, h, r), w in zip(la, host_oracle(
            pool, check_graph_host, [extract_graph(h) for _, h, _ in la])):
        require({k: v for k, v in r.items() if k != "backend"}
                == {**w, "provenance": r["provenance"]},
                f"route_check: la row {s} != check_graph_host")
    txn = by_fam["txn"]
    for (i, h, r), w in zip(txn, host_oracle(
            pool, check_txn_host, [extract_txn_graph(h) for _, h, _ in txn])):
        require({k: v for k, v in r.items() if k != "backend"}
                == {**w, "provenance": r["provenance"]},
                f"route_check: txn row {i} != check_txn_host")
    oracle_s = time.perf_counter() - t0
    backends_by_family = {
        fam: {b: sum(r["backend"] == b for _, _, r in rows)
              for b in sorted({r["backend"] for _, _, r in rows})}
        for fam, rows in by_fam.items()}
    w_cas = sorted(fleet.estimate_w(h) for _, h, _ in by_fam["cas"])
    emit({"phase": "route_check", "units": len(hists),
          "corpus": {"cas": ROUTE_CAS, "rw": {"n": ROUTE_RW,
                                              "n_ops": DC_OPS,
                                              "stale_half": DC_STALE},
                     "la": {**ROUTE_LA, "source": "bench.py:849-852"},
                     "txn": ROUTE_TXN},
          "route_check_s": route_s, "units_per_s": len(hists) / route_s,
          "backends": routing["backends"], "chosen": routing["chosen"],
          "backends_by_family": backends_by_family,
          "cas_estimate_w": {"min": w_cas[0], "max": w_cas[-1]},
          "est_cost_s": routing["est_cost_s"], "rates": rates,
          "launches": launches,
          "invalid": sum(r["valid"] is not True for r in res),
          "oracle_s": oracle_s})
    require(launches["dc_peel"] > 0 or "wgl-dc" not in routing["backends"],
            "route_check: the wgl-dc group launched no K4")
    return {"launches": launches, "backends": routing["backends"]}


def dc_entry(probe, batches, route, parity_err) -> dict:
    """The kernels-line entry of K4: launches per path, times and bound
    of the healthy batch's dc run (the faulty batch's beside them)."""
    keys = ("ms", "wrapper_ms", "floor_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kh, kf = batches[0]["kernel"], batches[1]["kernel"]
    by_path = {
        f"check_batch_columnar_{b}": sum(
            x["runs"][b]["launches"]["dc_peel"] for x in batches
            if b in x["runs"]) for b in ("dc", "auto")}
    by_path.update({
        "route_check": route["launches"]["dc_peel"],
        "probe": probe["launches"]["dc_peel"]})
    return {"name": "dc_peel", "route": "cuda",
            "source": "jepsen_torch/ops/csrc/dc_peel.cu",
            "replaces": "jepsen_tpu/ops/dc_monitor.py:372",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "parity": True,
            "max_abs_err": max(parity_err, kh["max_abs_err"],
                               kf["max_abs_err"]),
            **{k: kh[k] for k in keys}, "tier": kh["tier"],
            "tier_per_plan": kh["tier_per_plan"],
            "library_call": kh["library_call"],
            "plain_on": "cpu", "rounds_hist": kh["rounds_hist"],
            "faulty_batch": {k: kf[k] for k in keys + ("tier",
                                                       "tier_per_plan")}}


def fold_entry(name, replaces, path, parity_err) -> dict:
    """The kernels-line entry of one fold kernel: launches per
    check_*_batch of the full-width path (and the bench batch), times
    and bound of its full-width batches (the largest of its batches'
    times where an entry serves several families, each family beside
    it)."""
    mine = [b for b in path["families"] if b["kernel"]["entry"] == name]
    if name == "fold_counts":
        mine.append({**path["bench"], "check": "bench_total_queue"})
    worst = max(mine, key=lambda b: b["kernel"]["ms"])["kernel"]
    keys = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"name": name, "route": "cuda",
            "source": "jepsen_torch/ops/csrc/folds.cu",
            "replaces": replaces,
            "launches": sum(b["launches"] for b in mine),
            "launches_by_path": {b["check"]: b["launches"] for b in mine},
            "parity": True,
            "max_abs_err": max([parity_err] + [b["kernel"]["max_abs_err"]
                                              for b in mine]),
            **{k: worst[k] for k in keys}, "plain_on": "cpu",
            "by_batch": {b["check"]: {k: b["kernel"][k] for k in keys}
                         for b in mine}}


# ------------------------------------------- the fault ladder's phases

# The instrumented entry's random cases, (V, W, w_live, K1, shared
# target), at every edge of its plan: the warp tier at one, two, four
# and eight masks a lane (W 1-8) with one and two state words (V 33-64 at
# W 5-8), the table as nibble images, int8 targets, and past the warp
# tier's budget in device memory (K1 = 800 at V = 64); the block tier
# (W 9-14 at one state word, 9-13 at two) with the table staged and past
# shared memory beside both frontiers (K1 = 3,000 at V = 64, W 12); the
# device-memory tier (W 15 and 16 at one word, 14 at two), with the table
# staged and in device memory (K1 = 4,000); V = 1, 8, 33, 40, 48 and 64;
# w_live < W; shared and per-row targets; int8 and int32 slot tables.
# random_tables gives pads that carry live slot kinds (row 0 is all pads)
# and rows that fail early.
INSTRUMENT_CASES = ((1, 1, None, 3, True), (8, 1, None, 5, False),
                    (8, 2, None, 7, True), (8, 5, None, 7, False),
                    (64, 5, 3, 200, True), (33, 5, None, 9, False),
                    (8, 6, None, 7, True), (48, 6, None, 40, True),
                    (64, 6, None, 800, True), (8, 7, 5, 9, False),
                    (64, 7, None, 200, False), (8, 8, None, 12, False),
                    (40, 8, 6, 130, True), (64, 8, None, 9, True),
                    (8, 9, 6, 12, False), (64, 12, None, 9, False),
                    (64, 12, 5, 3000, True), (8, 13, None, 9, True),
                    (8, 14, 5, 9, False), (33, 14, None, 9, True),
                    (8, 15, 5, 9, True), (8, 16, 3, 6, True),
                    (64, 16, 4, 4000, True))

# Every (tier, table form) of the instrumented plan the cases must reach.
INSTRUMENT_PLANS = {(tier, form) for tier in ("warp", "block", "device")
                    for form in ("int8", "device", "nibble")}

# Hand-built rows (count_edge_rows) at each tier of the instrumented
# entry: the warp tier at one and eight masks a lane, the block tier
# with lane and warp slot bits (W 9) and with register bits too (W 12),
# the device-memory tier (W 16).
COUNT_EDGE_WIDTHS = (5, 8, 9, 12, 16)
COUNT_EDGE_EVENTS = 40


def count_chain(W: int) -> tuple:
    """The slots of count_edge_rows' chain at window W, ascending: lane
    slot bits, then (W > 5) bits of a lane's registers (W <= 8) or of
    other warps and of a thread's own masks (W > 8)."""
    if W <= 5:
        return tuple(range(W))
    return (1, 4, 5, W - 1) if W <= 8 else (2, 6, W - 2, W - 1)


def count_edge_rows(W: int) -> dict:
    """Rows whose closure passes tell the reference's schedule (slots in
    place, in order, every event counted) from three broken ones: a body
    that steps every slot at once from the pass's first frontier, one
    that skips pads and one that stops counting at a row's failure. Kind
    t < k of the k-slot chain (count_chain) sends state t to t + 1; kind
    k reaches nothing. Over COUNT_EDGE_EVENTS events, after the listed
    ones every event is a pad whose slots reach nothing (one pass each):
      0: a close with the chain's kinds on ascending slots: one pass
         walks the whole chain, one more sees no change (at once: k + 1);
      1: the chain on descending slots: a pass a link, k + 1;
      2: three pads carrying the ascending chain, two passes each and
         dropped, then a close reaching nothing: one pass;
      3: an OK on the chain's first slot (two passes), then an OK on the
         same slot, freed, which fails: the 38 events after it count one
         pass each, the tile's pads after it counted once only;
      4: closes of slot 0's kind 0, the first two passes and 30 more one
         each, then a failure at the tile's last event (31) and a close
         and pads in the next tile.
    Returns the four event tables (numpy, shared target), V and each
    row's passes."""
    chain = count_chain(W)
    k, N, V = len(chain), COUNT_EDGE_EVENTS, 8
    K1 = k + 1
    target = np.full((K1, V), -1, np.int32)
    for t in range(k):
        target[t, t] = t + 1
    ev_type = np.zeros((5, N), np.int8)
    ev_slot = np.zeros((5, N), np.int8)
    ev_slots = np.full((5, N, W), K1 - 1, np.int8)
    up = np.full(W, K1 - 1, np.int8)
    down = up.copy()
    for t, i in enumerate(chain):
        up[i] = t
        down[chain[k - 1 - t]] = t
    ev_type[0, 0], ev_slots[0, 0] = 3, up
    ev_type[1, 0], ev_slots[1, 0] = 3, down
    ev_slots[2, :3] = up
    ev_type[2, 3] = 3
    ev_type[3, :2], ev_slot[3, :2] = 2, chain[0]
    ev_slots[3, 0] = up
    ev_slots[3, 1] = up
    ev_slots[3, 1, chain[0]] = K1 - 1
    ev_type[4, :31] = 3
    ev_slots[4, :32, 0] = 0
    ev_type[4, 31], ev_slot[4, 31] = 2, chain[-1]
    ev_type[4, 33] = 3
    ev_slots[4, 33, 0] = 0
    pads = N - 1
    passes = np.array([2 + pads, k + 1 + pads, 3 * 2 + 1 + (N - 4),
                       2 + 1 + (N - 2), 2 + 30 + 1 + (N - 32)], np.int32)
    return {"args": (ev_type, ev_slot, ev_slots, target), "V": V,
            "passes": passes}


# Rows of each real bucket whose pass count the plain version replays
# (the north-star bucket is replayed whole, to time the plain version);
# 16, cut from 32 when the la phases joined the script. Of the keyed
# headline's buckets every INSTRUMENT_HELD_EVERY-th is replayed (every
# one until the mesh phases joined the script); the kernel's passes on
# every bucket still add up to the path's total and its outputs equal
# K1's.
INSTRUMENT_HELD_ROWS = 16
INSTRUMENT_HELD_EVERY = 2


def instrument_vs(args, V, W, w_live, dev, L, held=None):
    """One batch through the instrumented entry, K1's check and (on its
    first ``held`` rows, all when None) the plain version's pass count.
    Returns (equal, max_abs_err, passes [B] int64, invalid rows,
    plain seconds)."""
    kv, kb, kf, ki = L.get_kernel(V, W, w_live=w_live,
                                  instrument=True)(*args)
    rv, rb, rf = L.get_kernel(V, W, w_live=w_live)(*args)
    n = args[0].shape[0] if held is None else min(held, args[0].shape[0])
    sub = [a[:n] for a in args[:3]] + [args[3] if args[3].dim() == 2
                                       else args[3][:n]]
    pi = torch.zeros(n, dtype=torch.int64, device=dev)
    plain_s = 0.0
    if n:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L.plain_wgl(*sub, 0, *L.initial_carry(n, V, W, dev), V=V, W=W,
                    w_live=w_live, iters=pi)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    ki = ki.to(torch.int64)
    equal = (torch.equal(ki[:n], pi) and torch.equal(kv, rv)
             and torch.equal(kb, rb) and torch.equal(kf, rf))
    err = max(tensors_err(kb, rb), tensors_err(kf, rf),
              tensors_err(kv, rv),
              int((ki[:n] - pi).abs().max()) if n else 0)
    return equal, err, ki, int((~kv).sum()), plain_s


def instrument_launches(L, buckets, dev, instrument):
    """Prepared launches of the instrumented entry (or K1's) over whole
    buckets, for time_launches."""
    out = []
    for b in buckets:
        a = bucket_args(b, dev)
        kw = dict(V=b.V, W=b.W, w_live=b.eff_w_live)
        if instrument:
            kw["iters"] = torch.zeros(b.batch, dtype=torch.int32,
                                      device=dev)
        out.append(prepared_single(L, *a, 0,
                                   *L.initial_carry(b.batch, b.V, b.W, dev),
                                   **kw))
    return out


def instrument_times(L, buckets, dev) -> dict:
    """The instrumented entry and K1 on the same buckets in one call:
    kernel alone (time_launches) and through the wrappers (CUDA events
    around the check calls)."""
    argsets = [(b, bucket_args(b, dev)) for b in buckets]

    def wrapped(instrument):
        kerns = [L.get_kernel(b.V, b.W, w_live=b.eff_w_live,
                              instrument=instrument) for b, _ in argsets]
        return lambda: [k(*a) for k, (_, a) in zip(kerns, argsets)]

    return {"ms": time_launches(instrument_launches(L, buckets, dev, True),
                                reps=3),
            "k1_ms": time_launches(instrument_launches(L, buckets, dev,
                                                       False), reps=3),
            "wrapper_ms": time_cuda(wrapped(True), reps=3),
            "k1_wrapper_ms": time_cuda(wrapped(False), reps=3)}


def phase_instrument_parity(dev, L, ns_buckets, hl_buckets, ns_bound,
                            hl_bound):
    """The instrumented entry (K2 instrument) against the plain version's
    pass count bit for bit, and against K1's valid, bad and frontier:
    random cases at every edge of its plan, the hand-built rows of
    count_edge_rows at each tier (against their known counts too), then
    the north-star bucket and the keyed headline's dispatched buckets,
    which its path (``measure_closure_iters``) measures with the launch
    counts set to 0 just before. ``ns_bound`` and ``hl_bound`` are K1's
    bytes and needed operations on the two batches (the same work; the
    count adds four bytes a row)."""
    out = {"phase": "instrument_parity", "cases": [], "edge_rows": []}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2026)
    max_err, tiers = 0, set()
    for V, W, wl, K1, shared in INSTRUMENT_CASES:
        args = random_tables(rng, 64, RANDOM_EVENTS, V, W, wl, K1, shared,
                             dev)
        eq, err, passes, inv, _ = instrument_vs(args, V, W, wl, dev, L)
        plan = L.cuda_wgl.smem_plan(V, W, wl, K1=K1, shared_target=shared,
                                    instrument=True)
        tiers.add((plan["tier"], plan["table_form"]))
        live_pads = int(((args[0] == 0)[..., None]
                         & (args[2][..., :wl or W] >= 0)
                         & (args[2][..., :wl or W] < K1 - 1)).any(-1).sum())
        out["cases"].append({"V": V, "W": W, "w_live": wl, "K1": K1,
                             "shared_target": shared, "rows": 64,
                             "events": RANDOM_EVENTS, "invalid": inv,
                             "pads_with_live_kinds": live_pads,
                             "passes": int(passes.sum()),
                             "tier": plan["tier"],
                             "table_form": plan["table_form"], "equal": eq})
        require(eq, f"instrumented != plain/K1 on random tables V={V} "
                    f"W={W}")
        require(inv > 0 and live_pads > 0,
                f"case V={V} W={W} has no failing row or no live pad")
        max_err = max(max_err, err)
    require(tiers == INSTRUMENT_PLANS,
            f"the instrumented cases missed a plan: "
            f"{sorted(INSTRUMENT_PLANS - tiers)}")
    for W in COUNT_EDGE_WIDTHS:
        rows = count_edge_rows(W)
        args = tuple(on(a, dev) for a in rows["args"])
        eq, err, passes, _, _ = instrument_vs(args, rows["V"], W, None, dev,
                                              L)
        want = torch.from_numpy(rows["passes"]).to(dev, torch.int64)
        tier = L.cuda_wgl.smem_plan(rows["V"], W, K1=args[3].shape[0],
                                    instrument=True)["tier"]
        out["edge_rows"].append({"W": W, "tier": tier,
                                 "passes": passes.tolist(), "equal": eq})
        require(eq and torch.equal(passes, want),
                f"instrumented != plain/K1 or the known counts on the "
                f"hand-built rows at W={W}: {passes.tolist()}")
        max_err = max(max_err, err)

    # The path: measure_closure_iters on the north-star bucket and on the
    # keyed headline's dispatched buckets.
    zero_counts(L)
    L.cuda_wgl.INSTRUMENT_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_ns = L.measure_closure_iters(ns_buckets, device=dev)
    m_hl = L.measure_closure_iters(hl_buckets, device=dev)
    measure_s = time.perf_counter() - t0
    launches = L.cuda_wgl.INSTRUMENT_LAUNCHES
    others = counts(L)
    require(launches > 0, "measure_closure_iters did not launch the "
                          "instrumented entry")
    require(not any(others.values()),
            f"measure_closure_iters launched another kernel: {others}")

    # Each real bucket again: passes against the plain version (the
    # north-star bucket whole, the others on their first rows), outputs
    # against K1, and the totals against the path's.
    real = []
    for label, bs, m in (("north_star", ns_buckets, m_ns),
                         ("headline", hl_buckets, m_hl)):
        total, plain_s = 0, 0.0
        for j, b in enumerate(bs):
            held = (None if label == "north_star" else INSTRUMENT_HELD_ROWS
                    if j % INSTRUMENT_HELD_EVERY == 0 else 0)
            eq, err, passes, inv, ps = instrument_vs(
                bucket_args(b, dev), b.V, b.W, b.eff_w_live, dev, L, held)
            require(eq, f"instrumented != plain/K1 on the {label} bucket "
                        f"V={b.V} W={b.W}")
            max_err = max(max_err, err)
            total += int(passes.sum())
            plain_s += ps
        require(total == m["iters"], f"{label}: passes {total} != "
                                     f"measure_closure_iters {m['iters']}")
        k1 = ns_bound if label == "north_star" else hl_bound
        rows = sum(b.batch for b in bs)
        real.append({"batch": label, "buckets": len(bs), "rows": rows,
                     "buckets_by_W": hist_json(collections.Counter(
                         b.W for b in bs)),
                     "closure_iters_total": m["iters"],
                     "vpu_lane_ops": m["lane_ops"],
                     "plain_s": plain_s, **instrument_times(L, bs, dev),
                     **launch_bound(k1["bytes"] + 4 * rows,
                                    k1["needed_ops"])})
    out.update(launches=launches, measure_closure_iters_s=measure_s,
               batches=real, max_abs_err=max_err,
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    ns = real[0]
    return {"launches": launches, "max_abs_err": max_err,
            "ms": ns["ms"], "wrapper_ms": ns["wrapper_ms"],
            "k1_ms": ns["k1_ms"], "plain_ms": ns["plain_s"] * 1e3,
            "bound_ms": ns["bound_ms"], "bound_by": ns["bound_by"],
            "headline": {k: real[1][k] for k in (
                "buckets", "rows", "buckets_by_W", "ms", "k1_ms",
                "wrapper_ms", "k1_wrapper_ms", "closure_iters_total",
                "vpu_lane_ops", "bound_ms", "bound_by")}}


# The fault phases' WGL batch: the keyed headline's shape, its count cut
# from 10,000 to 1,000 histories to keep the run's time.
FAULT_SPEC = dict(HEADLINE_SPEC, n=1_000)
FAULT_STICKY_ROWS = 32
# Rows per chunk of the killed and resumed runs: several chunks retire
# before the kill.
FAULT_CHUNK_ROWS = 256
# The recovery each single schedule must show in the stats.
ENGAGED = {"oom": "oom_events", "timeout": "watchdog_fired",
           "wedge": "watchdog_fired", "corrupt": "corrupt_chunks"}


def engaged(inj, stats, name) -> dict:
    """A schedule fired, and its recovery shows in the stats."""
    kind = name.split("@")[0]
    require(inj.log, f"schedule {name} never fired")
    require(stats["faults_injected"] == len(inj.log),
            f"{name}: faults_injected {stats['faults_injected']} != "
            f"{len(inj.log)}")
    require(stats[ENGAGED[kind]] >= 1 and stats["retries"] >= 1,
            f"{name}: the ladder did not engage: {stats}")
    return {k: stats[k] for k in ("retries", "oom_events", "bisections",
                                  "watchdog_fired", "corrupt_chunks",
                                  "quarantined_rows", "faults_injected")}


def phase_wgl_faults(dev, L, S, cas):
    """The WGL checker under the checker nemesis on the card: every
    single-fault schedule, a sticky corruption, a kill and a resume from
    the chunk journal, and a run launched on a side stream."""
    import tempfile

    from jepsen_torch.ops.faults import (FaultInjector, FaultPlan,
                                         InjectedKill, single_fault_schedules)
    from jepsen_torch.store import ChunkJournal, spec_digest
    spec = S.SynthSpec(**FAULT_SPEC)
    t_phase = time.perf_counter()
    out = {"phase": "wgl_faults", "spec": FAULT_SPEC, "schedules": []}

    def run(**kw):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, b = L.check_synth(cas(), spec, stats_out=stats, **kw)
        return v, b, stats, time.perf_counter() - t0

    fv, fb, fstats, fs = run()
    ev, eb, _, es = run(scheduler=False)
    require(np.array_equal(fv, ev) and np.array_equal(fb, eb),
            "fault-free scheduler != scheduler=False")
    require(fstats["retries"] == 0 and fstats["quarantined_rows"] == 0,
            "the fault-free run walked the ladder")
    out.update(fault_free_s=fs, exact_s=es, invalid=int((~fv).sum()),
               dispatches=fstats["dispatches"])
    for name, plan in single_fault_schedules():
        inj = FaultInjector(plan)
        v, b, stats, s = run(faults=inj)
        require(np.array_equal(v, fv) and np.array_equal(b, fb),
                f"{name}: verdicts differ from the fault-free run")
        out["schedules"].append({"schedule": name, "s": s,
                                 "log": inj.log,
                                 **engaged(inj, stats, name)})

    # A run launched on a side stream: the retire threads copy back on
    # the launch's stream.
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        v, b, _, s = run()
    require(np.array_equal(v, fv) and np.array_equal(b, fb),
            "a side-stream run differs from the fault-free run")
    out["side_stream_s"] = s

    # Sticky corruption on the first rows: every row quarantined to the
    # host oracle, verdicts unchanged.
    sub, _ = S.synth_cas_device(spec, rows=(0, FAULT_STICKY_ROWS),
                                key_meta=False)
    inj = FaultInjector(FaultPlan.sticky("decode", "corrupt"))
    stats = {}
    t0 = time.perf_counter()
    v, b = L.check_columnar(cas(), sub, faults=inj, stats_out=stats,
                            scheduler_opts={"max_retries": 1})
    sticky_s = time.perf_counter() - t0
    dstats = {}
    L.check_columnar(cas(), sub, stats_out=dstats)
    require(np.array_equal(v, fv[:FAULT_STICKY_ROWS])
            and np.array_equal(b, fb[:FAULT_STICKY_ROWS]),
            "sticky corruption: verdicts differ from the fault-free run")
    require(stats["quarantined_rows"] == dstats["rows"] > 0,
            f"sticky corruption quarantined {stats['quarantined_rows']} of "
            f"{dstats['rows']} rows")
    out["sticky_corrupt"] = {"histories": FAULT_STICKY_ROWS,
                             "rows": dstats["rows"], "s": sticky_s,
                             "quarantined_rows": stats["quarantined_rows"],
                             "corrupt_chunks": stats["corrupt_chunks"]}

    # Kill at decode chunk 2 with a journal, then resume from it.
    opts = {"chunk_rows": FAULT_CHUNK_ROWS}
    with tempfile.TemporaryDirectory() as tmp:
        key = {"spec": spec_digest(spec), "model": "cas-register"}
        path = os.path.join(tmp, "wgl.journal.jsonl")
        j1 = ChunkJournal(path, key)
        try:
            run(faults=FaultInjector(FaultPlan.single("decode", "kill",
                                                      chunk=2)),
                journal=j1, scheduler_opts=opts)
            require(False, "the kill did not fire")
        except InjectedKill:
            pass
        j1.close()
        j2 = ChunkJournal(path, key, resume=True)
        decided = len(j2.decided())
        L.DISPATCH_LOG.clear()
        v, b, stats, s = run(journal=j2, scheduler_opts=opts)
        logged = sum(n for _, _, _, n in L.DISPATCH_LOG)
        j2.finish()
    require(np.array_equal(v, fv) and np.array_equal(b, fb),
            "resumed verdicts differ from the fault-free run")
    subs = fstats["rows"]
    require(0 < decided < subs, f"the journal held {decided} of {subs}")
    require(stats["rows"] == subs - decided and logged <= subs - decided,
            f"resume re-dispatched decided rows: {stats['rows']} rows "
            f"scheduled, {logged} logged, {subs - decided} undecided")
    out["kill_resume"] = {"rows": subs, "journaled": decided,
                          "resumed_rows_scheduled": stats["rows"],
                          "dispatch_log_rows": logged,
                          "dispatches": stats["dispatches"],
                          "resume_s": s}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


GRAPH_FAULT_CHUNK_ROWS = 256
PROVENANCE = {"device", "device-retried", "host-fallback"}


def same_but_provenance(got, want, label) -> int:
    """Result dicts equal field for field but provenance, which must be
    a legal tag; returns the rows off the happy path."""
    off = 0
    for i, (g, w) in enumerate(zip(got, want)):
        require(len(got) == len(want)
                and {**g, "provenance": None} == {**w, "provenance": None},
                f"{label}: row {i} differs from the fault-free run")
        require(g["provenance"] in PROVENANCE, f"{label}: row {i} tag")
        off += g["provenance"] != "device"
    return off


def phase_graph_faults(dev):
    """The graph and isolation checkers under the checker nemesis on the
    card: the bench batches under every single-fault schedule, and a
    kill and a resume from the chunk journal each."""
    import tempfile

    from jepsen_torch.checkers.cycle import check_graphs_batch
    from jepsen_torch.isolation import certify_batch
    from jepsen_torch.ops.faults import (FaultInjector, FaultPlan,
                                         InjectedKill, single_fault_schedules)
    from jepsen_torch.ops.graph import extract_graph
    from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_batch
    from jepsen_torch.ops.txn_graph import extract_txn_graph
    from jepsen_torch.store import ChunkJournal
    from jepsen_torch.workloads.synth import synth_la_history
    t_phase = time.perf_counter()
    graphs = [extract_graph(synth_la_history(
        s, n_ops=30, corrupt=1.0 if s % 7 == 0 else 0.0), "list-append")
        for s in range(GRAPH_BENCH_HISTORIES)]
    txns = [extract_txn_graph(h) for h, _ in synth_txn_batch(
        TxnSpec(**ISO_BENCH))]
    out = {"phase": "graph_faults", "batches": []}
    for label, fn, items in (("graph_bench", check_graphs_batch, graphs),
                             ("isolation_bench", certify_batch, txns)):
        base = fn(items)
        rec = {"batch": label, "rows": len(items), "schedules": []}
        for name, plan in single_fault_schedules():
            inj = FaultInjector(plan)
            stats = {}
            t0 = time.perf_counter()
            got = fn(items, faults=inj, stats_out=stats)
            s = time.perf_counter() - t0
            off = same_but_provenance(got, base, f"{label} {name}")
            require(off > 0, f"{label} {name}: no row records a recovery")
            rec["schedules"].append({"schedule": name, "s": s,
                                     "recovered_rows": off,
                                     **engaged(inj, stats, name)})
        opts = {"chunk_rows": GRAPH_FAULT_CHUNK_ROWS}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{label}.journal.jsonl")
            key = {"batch": label}
            j1 = ChunkJournal(path, key)
            try:
                fn(items, faults=FaultInjector(FaultPlan.single(
                    "dispatch", "kill", chunk=1)), journal=j1,
                   scheduler_opts=opts)
                require(False, f"{label}: the kill did not fire")
            except InjectedKill:
                pass
            j1.close()
            j2 = ChunkJournal(path, key, resume=True)
            decided = len(j2.decided())
            stats = {}
            got = fn(items, journal=j2, scheduler_opts=opts,
                     stats_out=stats)
            j2.finish()
        require(0 < decided < len(items),
                f"{label}: the journal held {decided} rows")
        require(stats["graphs"] == len(items) - decided,
                f"{label}: resume re-dispatched decided rows")
        # A resumed row is bare: its verdict and class (the graph
        # anomaly, or the isolation level) without a witness.
        cls = "level" if "level" in base[0] else "anomaly"
        for i, (g, w) in enumerate(zip(got, base)):
            require(g["valid"] == w["valid"] and g[cls] == w[cls],
                    f"{label}: resumed row {i} differs")
            if not g.get("resumed"):
                require(g == w, f"{label}: fresh row {i} differs")
        rec["kill_resume"] = {"journaled": decided,
                              "resumed_rows_dispatched": stats["graphs"]}
        out["batches"].append(rec)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_real_oom(dev, L):
    """classify_failure on real failures of the card: an allocation far
    past its memory (torch's OutOfMemoryError, "oom"), a launch the
    kernel library refuses (another CUDA error: None), and the library's
    cudaErrorMemoryAllocation code ("oom"); the allocator gives back what
    the failed attempt took."""
    import ctypes

    from jepsen_torch.ops import _build
    from jepsen_torch.ops.faults import classify_failure
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        torch.empty(4 * total, dtype=torch.uint8, device=dev)
        require(False, "an allocation of 4x the card's memory succeeded")
    except torch.cuda.OutOfMemoryError as e:
        oom = classify_failure(e)
    after = torch.cuda.memory_allocated(dev)
    require(oom == "oom", f"a real OutOfMemoryError classified {oom!r}")
    require(after == before, f"memory_allocated {before} -> {after}")
    lib = L.cuda_wgl._library()
    group = L.cuda_wgl._Group()           # no members: refused
    try:
        L.cuda_wgl._raise_on(lib, lib.wgl_frontier_group_launch(
            ctypes.byref(group), 8 * 32, 0,
            L.cuda_wgl._stream(dev)), "wgl_frontier_group")
        require(False, "a group of no members launched")
    except _build.CudaLaunchError as e:
        refused = {"code": e.code, "class": classify_failure(e),
                   "message": str(e)}
    require(refused["class"] is None, f"a refused launch: {refused}")
    alloc = _build.CudaLaunchError(
        "wgl_frontier", _build.CUDA_ERROR_MEMORY_ALLOCATION,
        lib.wgl_frontier_error(_build.CUDA_ERROR_MEMORY_ALLOCATION)
        .decode())
    require(classify_failure(alloc) == "oom",
            "cudaErrorMemoryAllocation is not an oom")
    torch.cuda.synchronize()
    out = {"phase": "real_oom", "requested_bytes": 4 * total,
           "oom_class": oom, "memory_allocated_before": before,
           "memory_allocated_after": after, "refused_launch": refused,
           "memory_allocation_code": {"message": str(alloc),
                                      "class": classify_failure(alloc)}}
    emit(out)
    return out


# The list-append generator (K8c) and the campaign engines.
# Parity cases vary one axis of LA_BASE at a time (processes, keys, ops,
# corruption), then the la path's two batches: the full-width one
# (V 1,024, as GRAPH_WIDE) and the reference bench's shape (V 32).
LA_BASE = dict(family="la", n=256, seed=4, n_procs=5, n_ops=300, n_keys=2,
               corrupt=0.6)
# The full-width batch's count, cut from 32, then from 16 when
# native_path joined the script and from 8 when online_path did, for the
# script's time (its host refinement takes seconds a history); its
# length is uncut.
LA_WIDE = dict(family="la", n=4, n_ops=1_000, n_keys=8, corrupt=0.5)
LA_BENCH = dict(family="la", n=2_000, n_ops=30, corrupt=0.15)
# K8c is timed alone on 10,000 histories of 1,000 ops (the north-star
# batch's size) at the full-width batch's keys and corruption.
LA_TIMING = dict(LA_WIDE, n=10_000)
# Host-oracle rows of the full-width batch: this many corrupted and this
# many clean ones (each cyclic graph's oracle takes seconds); every row
# of the bench batch.
LA_ORACLE_ROWS = 4
# Bytes a line of a la batch: int8 type and fn, int16 process, int32 key
# and val.
LA_LINE_BYTES = 1 + 2 + 1 + 4 + 4
# The seed campaign and the fuzz loop: the keyed headline's shape at
# 1,000 histories with a crash window on top of its timeouts.
CAMPAIGN_SPEC = dict(FAULT_SPEC, crash_lo=100, crash_hi=900, p_crash=0.05)
CAMPAIGN_SEEDS = (0, 1, 2)
FUZZ_ROUNDS = 2
FUZZ_NEIGHBORHOOD = 4
FUZZ_WITNESSES = 8
# Every FUZZ_VERIFY-th neighbour is re-checked by the host engine.
FUZZ_VERIFY = 8


def phase_la_synth_parity(dev, S, cuda_synth):
    """K8c against plain_la_core on the card, bit for bit, every output:
    each axis of LA_BASE at its edges (one process: an empty line-decode
    window; one op; keys past the kernel's local array), the la path's
    two shapes, a row slice and explicit stream keys."""
    import dataclasses
    t_phase = time.perf_counter()
    base = S.SynthSpec(**LA_BASE)
    rep = dataclasses.replace
    cases = [(f"n_procs_{p}", rep(base, n_procs=p))
             for p in (1, 2, 4, 5, 12, 40, 100)]
    cases += [(f"n_keys_{k}", rep(base, n_keys=k))
              for k in (1, 2, 8, 16, 17, 33, 64)]
    # Past the warp's shared memory: the per-key counts (K 1,500) and the
    # ring (P 1,500) in device scratch, the lines (P 500) stored straight
    # to the outputs.
    cases += [("counts_in_device", rep(base, n=64, n_keys=1500)),
              ("lines_direct", rep(base, n=64, n_procs=500, n_ops=1000,
                                   n_keys=8)),
              ("ring_in_device", rep(base, n=32, n_procs=1500, n_ops=2000,
                                     n_keys=8))]
    cases += [(f"n_ops_{n}", rep(base, n_ops=n)) for n in (1, 2, 1000)]
    cases += [(f"corrupt_{c}", rep(base, corrupt=c)) for c in (0, 0.6, 1.0)]
    cases += [("keys_33_procs_12_ops_1000",
               rep(base, n_keys=33, n_procs=12, n_ops=1000, corrupt=1.0)),
              ("wide", S.SynthSpec(**LA_WIDE)),
              ("bench", S.SynthSpec(**LA_BENCH))]
    out = {"phase": "la_synth_parity", "cases": []}
    err = 0
    for label, sp in cases:
        k, p = synth_case(S, cuda_synth, sp, dev)
        torch.cuda.synchronize()
        require(set(k) == set(p), f"{label}: outputs {sorted(k)} != "
                                  f"{sorted(p)}")
        equal = all(torch.equal(k[n], p[n]) for n in p)
        err = max(err, outputs_err(k, p))
        out["cases"].append({"case": label, "rows": sp.n,
                             "lines": 2 * sp.n_ops, "n_procs": sp.n_procs,
                             "n_keys": sp.n_keys, "corrupt": sp.corrupt,
                             "corrupted": int(p["corrupted"].sum()),
                             "plan": cuda_synth.synth_plan(
                                 "la", sp.n_procs, sp.n_ops, sp.n_keys),
                             "equal": equal})
        require(equal, f"la kernel != plain on {label}")
    require(all(c["corrupted"] > 0 for c in out["cases"]
                if c["corrupt"] > 0 and c["lines"] > 4),
            "a corrupt case hit no row: the pick is untested")
    sp = rep(base, n=300, n_keys=4)
    full, _ = synth_case(S, cuda_synth, sp, dev)
    part, plain = synth_case(S, cuda_synth, sp, dev, rows=(100, 250))
    torch.cuda.synchronize()
    sliced = all(torch.equal(full[n][100:250], part[n])
                 and torch.equal(part[n], plain[n]) for n in plain)
    require(sliced, "a la row slice differs from the full batch")
    rows = np.array([5, 5, 17, 40, 2, 255], np.uint32)
    keys = S.history_keys_for(base.seed, rows)
    keys["sched"][1] = S.fold_in(keys["sched"][1], np.uint32(0xF00D))
    k, p = synth_case(S, cuda_synth, base, dev, keys=keys)
    kfull, _ = synth_case(S, cuda_synth, base, dev)
    torch.cuda.synchronize()
    keyed = (all(torch.equal(k[n], p[n]) for n in p)
             and all(torch.equal(k[n][2], kfull[n][17]) for n in p))
    require(keyed, "la kernel with explicit keys != plain or the batch")
    err = max(err, outputs_err(k, p))
    out.update(row_slice_equal=sliced, explicit_keys_equal=keyed,
               max_abs_err=err, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return err


def la_bound(spec) -> dict:
    """Least time of K8c on ``spec``'s batch: the bytes it must move (the
    three stream keys read once; type, process, fn, key and val written
    once a line, corrupted once a row) and the integer operations of its
    schedule and value draws (the corruption draws and every other
    operation come on top), whichever is larger."""
    B, n = spec.n, spec.n_ops
    nbytes = B * 3 * 4 + B * 2 * n * LA_LINE_BYTES + B
    ops = (B * n * 2 + B * 2) * FOLD_IN_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "draw_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def la_kernel_measure(dev, S, cuda_synth) -> dict:
    """K8c on the kernel-timing batch: alone by CUDA events (prepared
    launch, outputs allocated outside the window), through its wrapper,
    and the plain version on the card, held bit for bit."""
    spec = S.SynthSpec(**LA_TIMING)
    args = S.la_inputs(spec, device=dev)
    st = S.la_static(spec)
    launch, out = cuda_synth.prepare_la(*args, **st)
    ms = time_launches([(lambda: None, launch)], reps=5)
    wrapper_ms = time_cuda(lambda: cuda_synth.synth_la(*args, **st), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = S.plain_la_core(*args, **st)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = outputs_err(out, plain)
    require(err == 0, "la kernel != plain on the kernel-timing batch")
    return {"spec": LA_TIMING, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "max_abs_err": err,
            "corrupted": int(plain["corrupted"].sum()), **la_bound(spec)}


def la_batch(dev, pool, S, cuda_synth, label, fields, oracle_rows):
    """The la path on one spec: synthesize on the card, decode_la each
    row, check_graphs_batch(family="list-append") on the card; every
    corrupted row invalid with a G2 cycle and every clean row valid, and
    ``oracle_rows(batch)`` against check_graph_host on the worker pool."""
    from jepsen_torch.checkers.cycle import check_graphs_batch
    from jepsen_torch.ops import cuda_graph
    from jepsen_torch.ops.graph import (check_graph_host, encode_graphs,
                                        extract_graph)
    spec = S.SynthSpec(**fields)
    cuda_synth.LA_LAUNCHES = 0
    cuda_graph.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch, meta = S.synthesize(spec)
    t1 = time.perf_counter()
    hists = [S.decode_la(batch, r) for r in range(batch.batch)]
    t2 = time.perf_counter()
    timings, stats = {}, {}
    res = check_graphs_batch(hists, family="list-append", timings=timings,
                             stats_out=stats)
    t3 = time.perf_counter()
    launches = {"synth_la": cuda_synth.LA_LAUNCHES,
                "graph_closure": cuda_graph.LAUNCHES}
    require(all(launches.values()), f"{label}: a kernel of the la path "
                                    f"was not launched: {launches}")
    require(meta is None and len(res) == spec.n, f"{label}: shapes")
    corrupted = batch.corrupted
    require(0 < corrupted.sum() < spec.n, f"{label}: corrupted rows "
                                          f"{int(corrupted.sum())}")
    for r, x in enumerate(res):
        want = (False, "G2") if corrupted[r] else (True, None)
        require((x["valid"], x["anomaly"]) == want,
                f"{label}: row {r} (corrupted {bool(corrupted[r])}): "
                f"{x['valid']}, {x['anomaly']}")
    graphs = [extract_graph(h, "list-append") for h in hists]
    rows = oracle_rows(corrupted)
    t4 = time.perf_counter()
    want = host_oracle(pool, check_graph_host, [graphs[i] for i in rows])
    oracle_s = time.perf_counter() - t4
    for i, w in zip(rows, want):
        require({**res[i], "provenance": "host"} == w,
                f"{label}: row {i} differs from check_graph_host")
    # K5 on this batch's graphs, alone, against its plain version: with
    # K8c's time it gives the card's busy share of the path.
    closure = closure_measure(dev, "graph", encode_graphs(graphs))
    require(closure["equal"], f"{label}: closure kernel != plain")
    total = t3 - t0
    return {"batch": label, "spec": fields, "launches": launches,
            "synth_s": t1 - t0, "decode_s": t2 - t1,
            "check_graphs_batch_s": t3 - t2, "split_s": timings,
            "path_s": total, "histories_per_s": spec.n / total,
            "corrupted": int(corrupted.sum()), "stats": stats,
            "oracle_rows": len(rows), "oracle_s": oracle_s,
            "graph_closure": closure}


def phase_la_path(dev, pool, S, cuda_synth):
    """The la path at full width and at the bench's shape on the card,
    then K8c alone on the kernel-timing batch."""
    t_phase = time.perf_counter()

    def wide_rows(corrupted):
        bad = np.flatnonzero(corrupted)[:LA_ORACLE_ROWS]
        good = np.flatnonzero(~corrupted)[:LA_ORACLE_ROWS]
        return sorted(bad.tolist() + good.tolist())

    wide = la_batch(dev, pool, S, cuda_synth, "wide", LA_WIDE, wide_rows)
    bench = la_batch(dev, pool, S, cuda_synth, "bench", LA_BENCH,
                     lambda c: list(range(len(c))))
    out = {"phase": "la_path", "batches": [wide, bench],
           "kernel": la_kernel_measure(dev, S, cuda_synth),
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def counted(L, cuda_synth, fn):
    """fn() with the WGL and generator launch counts set to 0 just
    before; returns (result, launches)."""
    cuda_synth.LAUNCHES = 0
    L.cuda_wgl.LAUNCHES = 0
    L.cuda_wgl.GROUP_LAUNCHES = 0
    torch.cuda.synchronize()
    res = fn()
    torch.cuda.synchronize()
    return res, {"synth_device": cuda_synth.LAUNCHES,
                 "wgl_frontier": L.cuda_wgl.LAUNCHES,
                 "wgl_frontier_group": L.cuda_wgl.GROUP_LAUNCHES}


def phase_campaign(dev, L, S, cuda_synth):
    """run_synth_seeds over CAMPAIGN_SEEDS on the card: seed by seed
    (each seed's dispatches and rows), then the whole campaign killed
    mid seed 1 by the checker nemesis and resumed from its checkpoint and
    journals: the summaries equal the uninterrupted run's, seed 0 is not
    run again, and only seed 1's undecided rows and seed 2's are
    dispatched."""
    import tempfile
    from pathlib import Path

    from jepsen_torch.ops.faults import FaultInjector, FaultPlan, InjectedKill
    from jepsen_torch.runtime import run_synth_seeds
    from jepsen_torch.store import Store
    t_phase = time.perf_counter()
    spec = S.SynthSpec(**CAMPAIGN_SPEC)
    want, per_seed = {}, []

    def seed_by_seed():
        for s in CAMPAIGN_SEEDS:
            L.DISPATCH_LOG.clear()
            r = run_synth_seeds(spec, [s], checkpoint=False)
            want[str(s)] = r["seeds"][str(s)]
            require(len(L.DISPATCH_LOG) < L.DISPATCH_LOG.maxlen,
                    f"seed {s}: the dispatch log overflowed")
            per_seed.append({"seed": s, "dispatches": len(L.DISPATCH_LOG),
                             "rows": sum(n for *_, n in L.DISPATCH_LOG)})

    t0 = time.perf_counter()
    _, launches = counted(L, cuda_synth, seed_by_seed)
    seeds_s = time.perf_counter() - t0
    require(launches["synth_device"] == len(CAMPAIGN_SEEDS)
            and launches["wgl_frontier"] + launches["wgl_frontier_group"],
            f"run_synth_seeds missed a kernel: {launches}")
    require(any(w["invalid"] for w in want.values()),
            "the campaign found no invalid history")
    d0, d1 = per_seed[0]["dispatches"], per_seed[1]["dispatches"]
    require(d1 >= 2, f"seed 1 takes {d1} dispatches: no mid-seed kill")
    kill_at = d0 + d1 // 2
    with tempfile.TemporaryDirectory() as tmp:
        st = Store(tmp)
        inj = FaultInjector(FaultPlan.single("dispatch", "kill",
                                             chunk=kill_at, deadline_s=5.0))
        killed = False
        try:
            run_synth_seeds(spec, CAMPAIGN_SEEDS, store_root=st, name="c",
                            check_kwargs={"faults": inj})
        except InjectedKill:
            killed = True
        require(killed, f"the kill at dispatch {kill_at} never fired")
        cdir = Path(tmp) / "c"
        decided = 0
        jp = cdir / "seed-1.journal.jsonl"
        if jp.exists():
            for line in jp.read_text().splitlines()[1:]:
                try:
                    decided += len(json.loads(line)["rows"])
                except ValueError:
                    pass
        require((cdir / "seed-0.json").exists()
                and not (cdir / "seed-1.json").exists(),
                "the kill did not land in seed 1")
        L.DISPATCH_LOG.clear()
        t0 = time.perf_counter()
        got = run_synth_seeds(spec, CAMPAIGN_SEEDS, store_root=st, name="c",
                              resume=True)
        resume_s = time.perf_counter() - t0
        logged = sum(n for *_, n in L.DISPATCH_LOG)
        left = not (cdir / "campaign.jsonl").exists()
    require(got["seeds"]["0"].pop("resumed", False) is True,
            "seed 0 was run again")
    require(not any("resumed" in v for v in got["seeds"].values()),
            "an unfinished seed came back resumed")
    require(got["seeds"] == want, "resumed summaries != uninterrupted")
    undecided = per_seed[1]["rows"] - decided + per_seed[2]["rows"]
    require(logged == undecided, f"resume dispatched {logged} rows, "
                                 f"{undecided} undecided")
    require(left, "the checkpoint outlived the campaign")
    n = spec.n * len(CAMPAIGN_SEEDS)
    out = {"phase": "campaign", "spec": CAMPAIGN_SPEC,
           "seeds": list(CAMPAIGN_SEEDS), "summaries": want,
           "per_seed": per_seed, "launches": launches, "seeds_s": seeds_s,
           "histories_per_s": n / seeds_s, "kill_at_dispatch": kill_at,
           "seed1_journaled": decided, "resume_rows_dispatched": logged,
           "resume_s": resume_s, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_fuzz(dev, L, S, cuda_synth):
    """fuzz_campaign on the card over CAMPAIGN_SPEC, every FUZZ_VERIFY-th
    neighbour re-checked by the host engine: no disagreement, and at
    least one invalid neighbourhood."""
    from jepsen_torch.fuzz import fuzz_campaign
    t_phase = time.perf_counter()
    spec = S.SynthSpec(**CAMPAIGN_SPEC)
    t0 = time.perf_counter()
    res, launches = counted(L, cuda_synth, lambda: fuzz_campaign(
        spec, rounds=FUZZ_ROUNDS, neighborhood=FUZZ_NEIGHBORHOOD,
        max_witnesses=FUZZ_WITNESSES, name=None, verify=FUZZ_VERIFY))
    fuzz_s = time.perf_counter() - t0
    require(launches["synth_device"] >= 2 * FUZZ_ROUNDS
            and launches["wgl_frontier"] + launches["wgl_frontier_group"],
            f"fuzz_campaign missed a kernel: {launches}")
    require(res["disagreements"] == 0,
            f"device and host disagree: {res['round_results']}")
    require(res["neighborhood_invalid"] >= 1 and res["verified"] > 0,
            f"vacuous fuzz run: {res['neighborhood_invalid']} invalid "
            f"neighbours, {res['verified']} verified")
    histories = res["checked"] + res["neighborhoods"]
    out = {"phase": "fuzz", "spec": CAMPAIGN_SPEC,
           **{k: res[k] for k in ("rounds", "modes", "checked", "invalid",
                                  "neighborhoods", "neighborhood_invalid",
                                  "verified", "disagreements",
                                  "min_anomaly_lines")},
           "invalid_by_mode": [r.get("invalid_by_mode")
                               for r in res["round_results"]],
           "launches": launches, "fuzz_s": fuzz_s,
           "histories_per_s": histories / fuzz_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# The online path (jepsen_torch.online): a live store the size of a Jepsen
# campaign's, checked by the daemon while its WALs are written. 16 live
# tenants (of the daemon's default max_tenants 64): ONLINE_TENANTS CAS
# runs of the north-star shape (2,000 ops by 5 processes over 5 values,
# a quarter corrupted), one more from the same generator over 40 values
# (its state space crosses 32 states while it runs: V 64), and one wide
# run whose process count puts its mask axis (peak window + 1) inside
# K1's wide tiers and under the daemon's max_w 14. Each WAL is written by
# the port's HistoryWAL in flushes of ONLINE_FLUSH_OPS ops, the daemon
# ticking between flushes (check_interval_ops the same, poll_s 0); the
# first daemon is dropped after ONLINE_RESTART_ROUND rounds and a new
# one takes the store over. Every ONLINE_FULL_EVERY-th delta check of
# each tenant is held to the full-prefix check on the card, after the
# run.
ONLINE_TENANTS = 14
ONLINE_CAS = dict(n_procs=5, n_ops=2_000, n_values=5, corrupt=0.25)
ONLINE_WIDE_PROCS = 12
ONLINE_FLUSH_OPS = 64
ONLINE_FULL_EVERY = 4
ONLINE_RESTART_ROUND = 32
# The 40-value tenant, whose state space crosses 32 states while it runs.
ONLINE_WIDE_VOCAB = "cas40v"
# The one reason a carried frontier may be rebuilt in the fault-free run,
# by the reference's rule: a new kind (a value or cas pair first seen)
# re-enumerated the state space and renumbered its states, which the
# carry cannot follow. Each such rebuild must come with a vocabulary
# larger than at the tenant's previous one. (A window that outgrows the
# mask axis would rebuild too; with no :info op it must not happen.)
ONLINE_RENUMBERED = "vocabulary growth renumbered"
# The JT_ONLINE_DC rerun's tenants, cut for the script's time: the first
# ONLINE_DC_INVALID tenants the first run found invalid, the first
# ONLINE_DC_VALID valid CAS runs, and the wide run. The 40-value tenant
# is left out: its vocabulary re-enumeration is most of a run's host
# time, and its peel monitor latches at its first cas as on every CAS
# tenant.
ONLINE_DC_INVALID = 2
ONLINE_DC_VALID = 2
ONLINE_DELTA_PROVS = ("online-delta", "online-rebuild")


def online_store():
    """The live store's histories: {tenant: ops}, and the wide run's
    peak pending window."""
    from jepsen_torch.workloads.synth import (synth_cas_batch,
                                              synth_cas_history)
    hists = {f"cas{i:02d}": h for i, h in enumerate(
        synth_cas_batch(ONLINE_TENANTS, 0, **ONLINE_CAS))}
    hists[ONLINE_WIDE_VOCAB] = synth_cas_batch(
        1, ONLINE_TENANTS, **dict(ONLINE_CAS, n_values=40))[0]
    hists["wide"] = synth_cas_history(
        ONLINE_TENANTS + 1, **dict(ONLINE_CAS, n_procs=ONLINE_WIDE_PROCS))
    open_, peak = set(), 0
    for op in hists["wide"]:
        if op.type == "invoke":
            open_.add(op.process)
            peak = max(peak, len(open_))
        elif op.type in ("ok", "fail"):
            open_.discard(op.process)
    require(9 <= peak + 1 <= 14, f"the wide tenant's mask axis {peak + 1} "
            "is outside K1's wide tiers under max_w 14")
    return hists, peak


class OnlineRecorder:
    """While active: every ``run_carried_events`` call with its tenant
    (the correlation id the daemon's check opens), inputs and output, and
    every ``ResidentFrontier.advance`` with its host time and, where it
    raised FrontierInvalid, the tenant, the reason and the frontier's
    vocabulary size. The rest of a tick's split is read from the span
    tracer."""

    def __init__(self):
        self.calls, self.invalid = [], []
        self.advance_s = 0.0
        self.epoch = 0

    def __enter__(self):
        from jepsen_torch import telemetry
        from jepsen_torch.ops import linearize as L
        from jepsen_torch.ops.schedule import (FrontierInvalid,
                                               ResidentFrontier)
        rec = self
        run, advance = L.run_carried_events, ResidentFrontier.advance
        self._orig = [(L, "run_carried_events", run),
                      (ResidentFrontier, "advance", advance)]

        def tenant():
            return (telemetry.correlation() or "").split("/")[0]

        def recorded_run(V, W, target, ev_type, ev_slot, ev_slots, idx0,
                         carry, **kw):
            out = run(V, W, target, ev_type, ev_slot, ev_slots, idx0,
                      carry, **kw)
            if ev_type.shape[0]:
                rec.calls.append({
                    "tenant": tenant(), "epoch": rec.epoch, "V": V, "W": W,
                    "args": (target, ev_type, ev_slot, ev_slots, idx0,
                             carry), "out": out,
                    "close": int(ev_type[-1]) == 3})
            return out

        def timed_advance(fr, ops):
            t0 = time.perf_counter()
            try:
                return advance(fr, ops)
            except FrontierInvalid as e:
                rec.invalid.append((tenant(), str(e), len(fr.kinds)))
                raise
            finally:
                rec.advance_s += time.perf_counter() - t0
        L.run_carried_events = recorded_run
        ResidentFrontier.advance = timed_advance
        return self

    def __exit__(self, *exc):
        for obj, name, real in self._orig:
            setattr(obj, name, real)
        return False


def online_feed(L, dev, cas, base, hists, *, recorder=None, restart=None):
    """Writes every tenant's WAL with the port's HistoryWAL in flushes of
    ONLINE_FLUSH_OPS ops, ticking the daemon between flushes (a new
    daemon after ``restart`` rounds), then the stored history and the
    analyzed stamp; ticks until every tenant is finalized. Returns (the
    daemons, rounds, the ticks' host seconds)."""
    from jepsen_torch.history.codec import write_jsonl
    from jepsen_torch.history.core import index
    from jepsen_torch.history.wal import WAL_FILE, HistoryWAL
    from jepsen_torch.online import OnlineConfig, OnlineDaemon
    from jepsen_torch.store import Store

    def daemon():
        return OnlineDaemon(store=Store(base), config=OnlineConfig(
            model=cas(), device=dev, poll_s=0,
            check_interval_ops=ONLINE_FLUSH_OPS, crash_quiet_s=3600))

    def tick():
        t0 = time.perf_counter()
        daemons[-1].tick()
        return time.perf_counter() - t0
    wals = {}
    for i, name in enumerate(hists):
        d = os.path.join(base, name, "r1")
        wals[name] = HistoryWAL(os.path.join(d, WAL_FILE),
                                {"test": {"name": name}, "seed": i},
                                flush_ms=1e12)
        wals[name].stamp_phase("run")
    daemons = [daemon()]
    tick_s = 0.0
    rounds = -(-max(len(h) for h in hists.values()) // ONLINE_FLUSH_OPS)
    for r in range(rounds):
        for name, h in hists.items():
            for op in h[r * ONLINE_FLUSH_OPS:(r + 1) * ONLINE_FLUSH_OPS]:
                wals[name].append_op(op)
            wals[name].sync()
        if restart is not None and r == restart:
            daemons.append(daemon())      # the first is dropped, not closed
            if recorder is not None:
                recorder.epoch = 1
        tick_s += tick()
    for name, h in hists.items():
        write_jsonl(os.path.join(base, name, "r1", "history.jsonl"),
                    index([op.with_() for op in h]))
        wals[name].stamp_phase("analyzed")
        wals[name].close()
    for _ in range(4):
        tick_s += tick()
        if daemons[-1].idle():
            break
    require(daemons[-1].idle() and len(daemons[-1].tenants) == len(hists),
            "online_path: a tenant was not finalized")
    return daemons, rounds, tick_s


def online_plain_replay(L, calls, dev) -> dict:
    """Check (a): every recorded resume launch held to the plain version
    from the same carry, field for field (valid, bad, F and Fb), with the
    operations its data needs (``plain_wgl(ops=)``). The launches of one
    (V, W, table rows) are the rows of one ``plain_wgl`` call, each with
    its own table, events padded with EV_PAD (whose closure is dropped).
    Every recorded launch starts from a valid carry (a latched frontier
    launches no more), so ``bad`` comes back as the row's first failing
    event and is shifted by the row's own ``idx0``, the global ordinal
    the kernel was given."""
    groups = {}
    for c in calls:
        groups.setdefault((c["V"], c["W"], c["args"][0].shape),
                          []).append(c)
    out = {"launches": 0, "plain_ms": 0.0, "err": 0, "groups": len(groups),
           "ops": 0, "by_tenant": collections.Counter()}
    for (V, W, _), rows in groups.items():
        B = len(rows)
        N = max(int(c["args"][1].shape[0]) for c in rows)
        ev_type = np.zeros((B, N), np.int8)
        ev_slot = np.zeros((B, N), np.int8)
        ev_slots = np.zeros((B, N, W), np.int32)
        for b, c in enumerate(rows):
            n = int(c["args"][1].shape[0])
            ev_type[b, :n], ev_slot[b, :n] = c["args"][1], c["args"][2]
            ev_slots[b, :n] = c["args"][3]
        carry = [np.concatenate([c["args"][5][k] for c in rows])
                 for k in ("F", "Fb", "valid", "bad")]
        require(carry[2].all(), "online_path: a resume launch started "
                "from an invalid carry")
        target = np.stack([c["args"][0] for c in rows])
        a = [on(ev_type, dev), on(ev_slot, dev), on(ev_slots, dev),
             on(target, dev), 0, on(carry[0].view(np.int32), dev),
             on(carry[1].view(np.int32), dev), on(carry[2], dev),
             on(carry[3], dev)]
        ops = torch.zeros(B, dtype=torch.int64, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        valid, bad, F, Fb = L.plain_wgl(*a, V=V, W=W, w_live=W, ops=ops)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["plain_ms"] += (time.perf_counter() - t0) * 1e3
        bad = bad.cpu().numpy().astype(np.int64)
        idx0 = np.array([c["args"][4] for c in rows], np.int64)
        bad = np.where(bad == 2**31 - 1, bad, bad + idx0)
        got = (valid.cpu().numpy(), bad, F.cpu().numpy(), Fb.cpu().numpy())
        for b, c in enumerate(rows):
            o = c["out"]
            want = (o["valid"][0], o["bad"][0], o["F"][0].view(np.int32),
                    o["Fb"][0].view(np.int32))
            for g, w in zip(got, want):
                out["err"] = max(out["err"], int(np.abs(
                    np.asarray(g[b], np.int64)
                    - np.asarray(w, np.int64)).max()))
            out["by_tenant"][c["tenant"]] += 1
        out["launches"] += B
        out["ops"] += int(ops.sum())
    require(out["launches"] == len(calls) and out["err"] == 0,
            f"online_path: a resume launch differs from the plain version "
            f"(max abs err {out['err']})")
    out["by_tenant"] = dict(out["by_tenant"])
    return out


def online_calls_measure(L, calls, dev) -> dict:
    """Every recorded resume launch replayed on the card, the kernel alone
    (``time_launches``) beside the empty kernel on its grid, by shape;
    every launch held to the plain version (``online_plain_replay``); and
    the bytes the launches must move (the events, the table, the carry in
    and out) with the operations their data needs, for the bound."""
    by_shape, kernel_ms, floor_ms, grids, nbytes = {}, 0.0, 0.0, {}, 0
    for c in calls:
        target, ev_type, ev_slot, ev_slots, idx0, carry = c["args"]
        V, W = c["V"], c["W"]
        a = [on(np.asarray(ev_type, np.int8)[None], dev),
             on(np.asarray(ev_slot, np.int8)[None], dev),
             on(np.asarray(ev_slots, np.int32)[None], dev),
             on(target, dev), idx0,
             on(carry["F"].view(np.int32), dev),
             on(carry["Fb"].view(np.int32), dev),
             on(carry["valid"], dev), on(carry["bad"], dev)]
        kw = {"V": V, "W": W, "w_live": W}
        plan = L.cuda_wgl.smem_plan(V, W, W, K1=target.shape[0],
                                    shared_target=True)
        grid = ((1, plan["threads"]) if plan["tier"] == "warp"
                else (plan["cluster_ctas"], plan["threads"]))
        ms = time_launches([prepared_single(L, *a, **kw)], reps=1)
        if grid not in grids:
            grids[grid] = time_launches(floor_launches([grid]), reps=3)
        fl = grids[grid]
        kernel_ms += ms
        floor_ms += fl
        key = f"V{V}_W{W}_{plan['tier']}"
        s = by_shape.setdefault(key, {"launches": 0, "events": 0,
                                      "ms": 0.0, "floor_ms": 0.0})
        s["launches"] += 1
        s["events"] += int(ev_type.shape[0])
        s["ms"] += ms
        s["floor_ms"] += fl
        carry_bytes = 2 * carry["F"].nbytes + 1 + 4
        nbytes += (int(ev_type.shape[0]) * (2 + 4 * W) + target.nbytes
                   + 2 * carry_bytes)
    for s in by_shape.values():
        s["mean_ms"] = s["ms"] / s["launches"]
        s["floor_mean_ms"] = s["floor_ms"] / s["launches"]
    plain = online_plain_replay(L, calls, dev)
    plain.update(launch_bound(nbytes, plain.pop("ops")))
    plain["ms"] = kernel_ms
    return {"by_shape": by_shape, "launches": len(calls),
            "kernel_ms": kernel_ms, "floor_ms": floor_ms, "plain": plain}


def online_hold_full(L, dev, cas, base, tenants) -> dict:
    """Check (b): every ONLINE_FULL_EVERY-th delta verdict of each tenant
    (valid, bad op index), as the daemon decided and journaled it,
    against ``check_batch_columnar(details="invalid")`` of the same
    prefix of the tenant's WAL on the card, all the prefixes as rows of
    one call."""
    from jepsen_torch.history.wal import WAL_FILE, read_wal
    from jepsen_torch.online import _bad_index, checkable_prefix
    rows, want = [], []
    for (name, _), t in tenants.items():
        ops = read_wal(os.path.join(base, name, "r1", WAL_FILE))["ops"]
        ks = sorted(k for k, (_, _, p) in t._decided.items()
                    if p in ONLINE_DELTA_PROVS)
        for k in ks[ONLINE_FULL_EVERY - 1::ONLINE_FULL_EVERY]:
            rows.append(checkable_prefix(ops[:k]))
            want.append((name, k) + t._decided[k][:2])
    t0 = time.perf_counter()
    full = L.check_batch_columnar(cas(), rows, device=dev,
                                  details="invalid")
    s = time.perf_counter() - t0
    for (name, k, valid, bad), r in zip(want, full):
        require((valid, bad) == (r.get("valid"), _bad_index(r)),
                f"online_path {name} at {k} ops: delta verdict "
                f"{valid, bad} != full check {r.get('valid')} "
                f"{_bad_index(r)}")
    return {"held": len(rows), "s": s}


def online_grow_carry(L, dev, cas) -> dict:
    """The carry's state axis widened in place on the card: one process
    writes 40 fresh values and reads each back (an append-stable state
    space), the last read corrupt; a frontier resumed every 16 ops widens
    from one state word to two without a rebuild, each tick's verdict
    equal to check_batch_columnar of the prefix on the card."""
    from jepsen_torch.history.ops import invoke_op, ok_op
    from jepsen_torch.online import _bad_index, checkable_prefix
    from jepsen_torch.ops.schedule import ResidentFrontier
    ops = []
    for v in range(1, 41):
        ops += [invoke_op(0, "write", v), ok_op(0, "write", v),
                invoke_op(0, "read", None),
                ok_op(0, "read", 999 if v == 40 else v)]
    for i, op in enumerate(ops):
        op.index = i
    fr = ResidentFrontier(cas(), device=dev)
    words = []
    for k in range(16, len(ops) + 1, 16):
        valid, bad = fr.advance(ops[:k])
        full = L.check_batch_columnar(cas(), [checkable_prefix(ops[:k])],
                                      device=dev, details="invalid")[0]
        require((valid, bad) == (full["valid"], _bad_index(full)),
                f"grow_carry at {k} ops: {valid, bad} != full check")
        words.append(int(fr.carry["F"].shape[1]))
    require(sorted(set(words)) == [1, 2] and (valid, bad)
            == (False, len(ops) - 1), "grow_carry: the carry did not "
            "widen in place, or the corrupt read was missed")
    return {"ticks": len(words), "words": words, "V": fr.v_pad,
            "states": fr.space.n_states}


def online_tick_split(spans, tick_s, advance_s) -> dict:
    """The host split of the daemon's ticks from the span tracer: the
    interim checks (``online.check``), the final checks
    (``online.finalize``) and the frontier's launches with their copies
    (``dispatch``, family frontier), with ``ResidentFrontier.advance``'s
    host time between the two."""
    def total(name, family=None):
        return sum(s["dur"] for s in spans if s["name"] == name and (
            family is None
            or s.get("args", {}).get("family") == family)) / 1e6
    checks = total("online.check")
    finalize = total("online.finalize")
    dispatch = total("dispatch", "frontier")
    return {"ticks": tick_s,
            "tail_and_discovery": tick_s - checks - finalize,
            "checks": checks, "ingest_walk": advance_s - dispatch,
            "launch_copies": dispatch,
            "verdict_bookkeeping": checks - advance_s,
            "finalize": finalize}


def phase_online_path(dev, L, cas):
    """The online daemon over a live store on the card: the checks
    (a)-(e) of its docstring in ``online_feed``'s run and its rerun."""
    import tempfile

    from jepsen_torch import telemetry
    from jepsen_torch.history.codec import read_jsonl
    from jepsen_torch.online import _bad_index
    t_phase = time.perf_counter()
    hists, peak = online_store()
    out = {"phase": "online_path", "tenants": len(hists),
           "ops": {k: len(h) for k, h in hists.items()}, "wide_peak": peak}
    telemetry.REGISTRY.reset()
    telemetry.configure(True)
    with tempfile.TemporaryDirectory(prefix="online_path") as base:
        zero_counts(L)
        torch.cuda.synchronize()
        try:
            with OnlineRecorder() as rec:
                t0 = time.perf_counter()
                daemons, rounds, tick_s = online_feed(
                    L, dev, cas, base, hists, recorder=rec,
                    restart=ONLINE_RESTART_ROUND)
                run_s = time.perf_counter() - t0
            spans = telemetry.spans()
        finally:
            telemetry.configure("env")
        launches = counts(L)
        require(len(spans) < telemetry.RING_SIZE,
                "online_path: the span ring overflowed")
        final_launches = launches["wgl_frontier"] - len(rec.calls)
        require(len(rec.calls) > 0, "online_path: no resume launch")
        require(0 <= final_launches <= len(hists),
                f"online_path: {launches['wgl_frontier']} launches counted, "
                f"{len(rec.calls)} of them resume launches")
        # Each resume launch's check: the dispatch span around it (the
        # same order: one thread) and that span's parent, online.check.
        disp = [s for s in spans if s["name"] == "dispatch"
                and s["args"].get("family") == "frontier"
                and s["args"].get("events")]
        require(len(disp) == len(rec.calls),
                f"online_path: {len(disp)} dispatch spans for "
                f"{len(rec.calls)} resume launches")
        by_id = {s["id"]: s for s in spans}
        for c, s in zip(rec.calls, disp):
            c["check"] = s["parent"]
        first, second = daemons
        stats = {k: first.stats[k] + second.stats[k] for k in first.stats}
        for k in ("check_errors", "stage_faults", "unknown_verdicts"):
            require(stats[k] == 0, f"online_path: {k} = {stats[k]}")
        # Every invalidation a renumbering, each at a larger vocabulary
        # than the tenant's previous one.
        invalid = {}
        for n, r, kinds in rec.invalid:
            require(r.startswith(ONLINE_RENUMBERED),
                    f"online_path {n}: a frontier was invalidated: {r}")
            seen = invalid.setdefault(n, [])
            require(not seen or kinds > seen[-1], f"online_path {n}: "
                    f"renumbered twice at a vocabulary of {kinds} kinds")
            seen.append(kinds)
        require(stats["frontier_invalidations"] == len(rec.invalid),
                f"online_path: {stats['frontier_invalidations']} "
                f"invalidations counted, {len(rec.invalid)} raised")
        provs = collections.Counter()
        verdicts = {}
        for (name, _), t in second.tenants.items():
            mine = {p for _, _, p in t._decided.values()}
            provs.update(p for _, _, p in t._decided.values())
            require(t.peak_w > 14 or mine <= set(ONLINE_DELTA_PROVS),
                    f"online_path {name}: provenances {sorted(mine)}")
            # (c) the final verdict against the post-mortem recheck.
            hist = read_jsonl(os.path.join(base, name, "r1",
                                           "history.jsonl"))
            post = L.check_batch_columnar(cas(), [hist], device=dev,
                                          details="invalid",
                                          min_device_batch=64)[0]
            require(json.loads(json.dumps(t.result, default=repr))
                    == json.loads(json.dumps(post, default=repr)),
                    f"online_path {name}: final verdict != recheck")
            verdicts[name] = (t.result["valid"], _bad_index(t.result),
                              (t.first_violation or {}).get("op_index"))
            # (d) the second daemon restored this tenant's checkpoint once.
            require(t.stats.get("frontier_restored") == 1,
                    f"online_path {name}: frontier_restored "
                    f"{t.stats.get('frontier_restored')}")
        # (d) the restart's first check of each tenant dispatched only the
        # suffix: its first launch resumes at the event ordinal where the
        # first daemon's last checkpoint stopped (unless that check
        # rebuilt the frontier).
        suffix = {}
        for (name, _), t in second.tenants.items():
            mine = [c for c in rec.calls if c["tenant"] == name]
            before = [c for c in mine if c["epoch"] == 0 and c["close"]]
            after = [c for c in mine if c["epoch"] == 1]
            if not after:
                continue                  # latched invalid: no launch
            head = [c for c in after if c["check"] == after[0]["check"]]
            k = by_id[head[0]["check"]]["args"]["ops"]
            rebuilt = t._decided[k][2] == "online-rebuild"
            resumed_at = before[-1]["args"][4]
            suffix[name] = sum(int(c["args"][1].shape[0]) for c in head)
            require(rebuilt or head[0]["args"][4] == resumed_at,
                    f"online_path {name}: the restart re-dispatched from "
                    f"event {head[0]['args'][4]}, not {resumed_at}")
        full = online_hold_full(L, dev, cas, base, second.tenants)
        delta_ev = sum(int(c["args"][1].shape[0]) for c in rec.calls)
        full_ev = sum(c["args"][4] + int(c["args"][1].shape[0])
                      for c in rec.calls if c["close"])
        ttfv = telemetry.metrics_prefixed("online.ttfv_s")[
            "online.ttfv_s"]
        meas = online_calls_measure(L, rec.calls, dev)
        out.update({
            "rounds": rounds, "run_s": run_s, "ticks": stats["ticks"],
            "checks": stats["checks"],
            "delta_checks": sum(provs[p] for p in ONLINE_DELTA_PROVS),
            "full_checks_held": full["held"], "full_checks_s": full["s"],
            "restart_after_ops": (ONLINE_RESTART_ROUND + 1)
            * ONLINE_FLUSH_OPS, "restart_suffix_events": suffix,
            "stats": stats, "provenances": dict(provs),
            "renumbered_at_kinds": invalid, "spans": len(spans),
            "delta_events": delta_ev, "full_rewalk_events": full_ev,
            "launches": len(rec.calls),
            "final_check_launches": final_launches,
            "device_ms": meas["kernel_ms"], "floor_ms": meas["floor_ms"],
            "by_shape": meas["by_shape"],
            "tick_split_s": online_tick_split(spans, tick_s, rec.advance_s),
            "device_share_of_ticks": meas["kernel_ms"] / 1e3 / tick_s,
            "ttfv_s": ttfv, "plain": meas["plain"]})
    # (e) the same store again with the peel monitor on, on a subset of
    # its tenants.
    bad = [k for k, v in verdicts.items() if v[0] is not True]
    good = [k for k, v in verdicts.items() if v[0] is True
            and k not in (ONLINE_WIDE_VOCAB, "wide")]
    rerun = {k: hists[k] for k in bad[:ONLINE_DC_INVALID]
             + good[:ONLINE_DC_VALID] + ["wide"] if k != ONLINE_WIDE_VOCAB}
    require(bad, "online_path: no tenant was found invalid")
    os.environ["JT_ONLINE_DC"] = "1"
    try:
        with tempfile.TemporaryDirectory(prefix="online_dc") as base:
            t0 = time.perf_counter()
            (dc_daemon,), _, _ = online_feed(L, dev, cas, base, rerun)
            out["dc_run_s"] = time.perf_counter() - t0
            verdicts_dc = {name: (t.result["valid"], _bad_index(t.result),
                                  (t.first_violation or {}).get("op_index"))
                           for (name, _), t in dc_daemon.tenants.items()}
            out["dc_stats"] = {k: dc_daemon.stats[k] for k in (
                "checks", "check_errors", "first_violations")}
    finally:
        del os.environ["JT_ONLINE_DC"]
    want = {k: v for k, v in verdicts.items() if k in rerun}
    require(verdicts_dc == want,
            f"online_path: JT_ONLINE_DC=1 changed a verdict: "
            f"{verdicts_dc} != {want}")
    out["dc_tenants"] = sorted(rerun)
    out["verdicts"] = verdicts
    out["grow_carry"] = online_grow_carry(L, dev, cas)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# The mesh phase (K3, the frontier-sharded step): the card named
# MESH_DEVICES times, as a one-process mesh. Kernel parity on explicit
# meshes (data x frontier), MESH_CASES: every mesh at four of the local
# windows 1, 8, 9, 13, 14, 15 and 16, with one and two state words and a
# shared and a per-row table. shard_close's plan (cuda_shard.close_plan)
# runs W_local 13 in its block tier (its widest on these few rows), 14
# over a cluster of 2 CTAs, 15 over 4 and 16 over 8, the narrower
# windows in the block tier; MESH_CLOSE_TIERS must each be reached. MESH_ROWS rows of MESH_EVENTS events a case (``mesh_tables``).
# W 18 on 2 x 4 at W_local 16 is left to mesh_path, whose W 18 Op-list
# and columnar rows run on that mesh with every entry held against its
# plain version on each input.
MESH_DEVICES = 8
MESH_CASES = (  # (n_data, D, W_local, V, shared target)
    (4, 2, 1, 40, False), (4, 2, 8, 8, True), (4, 2, 14, 40, False),
    (4, 2, 16, 40, False),
    (2, 4, 1, 8, True), (2, 4, 8, 40, False), (2, 4, 9, 8, True),
    (2, 4, 15, 8, True),
    (1, 8, 1, 40, False), (1, 8, 8, 8, True), (1, 8, 13, 8, True),
    (1, 8, 16, 8, True))
MESH_CLOSE_TIERS = ("block/1", "cluster/2", "cluster/4", "cluster/8")
MESH_ROWS = 8
MESH_EVENTS = 16
# The batch-sharded route's batch, the dryrun's shape
# (__graft_entry__.py: at least 256 CAS histories of 256 ops), and its
# rows held to wgl_check.
MESH_DATAN = dict(seed0=3, n_procs=4, n_ops=256, n_values=3, corrupt=0.25)
MESH_DATAN_ROWS = 256
MESH_ORACLE_ROWS = 8


# Links of mesh_tables' chain row: kinds K1 - 2 - j take state j to
# j + 1 (the last kinds of the table; K1 - 1 reaches no state).
MESH_CHAIN = 4


def mesh_tables(rng, B, N, V, W, WL, K1, shared, dev):
    """Random tables for the sharded step: ``random_tables`` with slots
    kept in [-1, W - 1] (as an encoder writes them), rows 4-7 mostly
    padding, and designed rows (each a row of its own at event 0, random
    after its designed events):

    * row 0 all padding; row 1 completing at event 0 on the top slot
      W - 1 with a kind that reaches no state (it fails there) and row 2
      with one that takes state 0 to 1 (it survives a top completion);
    * row 3, a chain down the local slots: slot WL - 1 - j takes state j
      to j + 1, so each in-order pass of shard_close adds one link and
      the last link's mask gains in pass MESH_CHAIN (the top links cross
      the cluster's rank bits);
    * row 4, a config that only slot WL - 1, the cluster's top rank bit,
      moves (state 0 to 1);
    * row 5, closing under slot 1 (state 0 to 1 to 2) and completing on
      it at event 0, with the same kinds at event 1: slot 1 is fresh
      there only because the OK freed it, and event 1's completion on
      slot 1 needs the config (2, state 2) that only it makes."""
    ev_type, ev_slot, ev_slots, target = (
        a.cpu().numpy() for a in pad_heavy(rng, list(random_tables(
            rng, B, N, V, W, None, K1, shared, torch.device("cpu")))))
    ev_slot = np.minimum(ev_slot, W - 1).astype(np.int8)
    ev_type[0] = 0
    for r, kind in ((1, K1 - 1), (2, K1 - 2)):
        ev_type[r, 0], ev_slot[r, 0] = 2, W - 1
        ev_slots[r, 0, :] = K1 - 1
        ev_slots[r, 0, W - 1] = kind

    def kinds_of(r):
        return target if shared else target[r]
    links = min(MESH_CHAIN, WL)
    freed = K1 - 2 - MESH_CHAIN
    for r in range(B):
        t = kinds_of(r)
        for j in range(MESH_CHAIN):
            t[K1 - 2 - j] = -1
            t[K1 - 2 - j, j] = j + 1
        t[freed] = -1
        t[freed, 0], t[freed, 1] = 1, 2
    ev_type[3, 0], ev_slots[3, 0, :] = 3, K1 - 1
    for j in range(links):
        ev_slots[3, 0, WL - 1 - j] = K1 - 2 - j
    ev_type[4, 0], ev_slots[4, 0, :] = 3, K1 - 1
    ev_slots[4, 0, WL - 1] = K1 - 2
    ev_type[5, :2], ev_slot[5, :2] = 2, 1
    ev_slots[5, :2, :] = K1 - 1
    ev_slots[5, :2, 1] = freed
    return tuple(on(a, dev) for a in (ev_type, ev_slot, ev_slots, target))


def paired_ops(errs: dict):
    """The walk's ``ops`` that launch each K3 entry on the card and run
    its plain version on copies of the same inputs, keep the kernel's
    outputs and record the largest difference per entry: each entry held
    against its plain version on every input the walk gives it."""
    from jepsen_torch.ops import cuda_shard as CS

    def close(F, recv, *a, **kw):
        Fp = F.clone()
        pc, pk = CS.plain_shard_close(Fp, recv, *a, **kw)
        c, k = CS.shard_close(F, recv, *a, **kw)
        errs["shard_close"] = max(errs["shard_close"], tensors_err(F, Fp),
                                  tensors_err(c, pc), tensors_err(k, pk))
        return c, k

    def image(F, *a, send=None, **kw):
        p = CS.plain_shard_image(F, *a, **kw)
        s = CS.shard_image(F, *a, send=send, **kw)
        errs["shard_image"] = max(errs["shard_image"], tensors_err(s, p))
        return s

    def commit(F, Fbad, top, ev_type, ev_slot, ev_slots, target, valid,
               bad, nonempty, **kw):
        mine = [t.clone() for t in (F, Fbad, valid, bad)]
        CS.plain_shard_commit(mine[0], mine[1], top, ev_type, ev_slot,
                              ev_slots, target, mine[2], mine[3], nonempty,
                              **kw)
        CS.shard_commit(F, Fbad, top, ev_type, ev_slot, ev_slots, target,
                        valid, bad, nonempty, **kw)
        errs["shard_commit"] = max([errs["shard_commit"]] + [
            tensors_err(x, y) for x, y in zip((F, Fbad, valid, bad), mine)])

    return {"shard_close": close, "shard_image": image,
            "shard_commit": commit}


def timed_plain(times: dict):
    """The plain versions as the walk's ``ops``, each call bracketed by
    synchronisations and timed by the host clock into ``times`` (ms)."""
    from jepsen_torch.ops import cuda_shard as CS

    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + (time.perf_counter()
                                                  - t0) * 1e3
            return out
        return run
    return {n: wrap(n, f) for n, f in CS.PLAIN.items()}


def k1_reference(L, V, W, args, dev):
    """K1 on the same rows, the sharded step's yardstick: the CUDA
    kernel up to its widest window, past it K1's plain version on the
    card."""
    if W <= L.cuda_wgl.MAX_W:
        return L.get_kernel(V, W)(*args)
    return L._plain_check(V, W, W, *args)


def phase_mesh_kernel_parity(dev, L):
    """K3's three entries against their plain versions on every input of
    the walk, and the walk's outputs against K1 on the same rows, on
    explicit meshes of the card named MESH_DEVICES times."""
    from jepsen_torch.parallel import checker_mesh, frontier_sharded_kernel
    from jepsen_torch.parallel import frontier as PF
    rng = np.random.default_rng(2026)
    errs = {"shard_close": 0, "shard_image": 0, "shard_commit": 0}
    from jepsen_torch.ops import cuda_shard as CS
    cases, k1_err, rounds = [], 0, 0
    tiers = collections.Counter()
    devices = [dev] * MESH_DEVICES
    for n_data, D, WL, V, shared in MESH_CASES:
        mesh = checker_mesh(n_data, D, devices=devices)
        W = WL + D.bit_length() - 1
        K1 = 9 if shared else 12
        args = mesh_tables(rng, MESH_ROWS, MESH_EVENTS, V, W, WL, K1,
                           shared, dev)
        r0, t0 = PF.ROUNDS, time.perf_counter()
        before = collections.Counter(CS.CLOSE_TIERS)
        got = frontier_sharded_kernel(V, W, mesh, shared)(
            *args, ops=paired_ops(errs))
        case_tiers = dict(collections.Counter(CS.CLOSE_TIERS) - before)
        tiers.update(case_tiers)
        want = k1_reference(L, V, W, args, dev)
        torch.cuda.synchronize()
        err = max(tensors_err(g, w) for g, w in zip(got, want))
        k1_err = max(k1_err, err)
        rounds += PF.ROUNDS - r0
        cases.append({"mesh": f"{n_data}x{D}", "W_local": WL, "W": W,
                      "V": V, "shared_target": shared, "rows": MESH_ROWS,
                      "events": MESH_EVENTS,
                      "invalid": int((~got[0]).sum()),
                      "rounds": PF.ROUNDS - r0, "k1_err": err,
                      "close_tiers": case_tiers,
                      "close_plan": {k: CS.close_plan(
                          WL, (V + 31) // 32, MESH_ROWS // n_data, V)[k]
                          for k in ("tier", "ctas", "threads",
                                    "smem_bytes")},
                      "s": time.perf_counter() - t0,
                      "top_fail": bool(not got[0][1]
                                       and int(got[1][1]) == 0)})
        require(err == 0, f"K3 != K1 on {n_data}x{D} W={W} V={V}")
        require(cases[-1]["top_fail"] and bool(got[0][0])
                and int(got[1][2]) != 0,
                f"the top-slot rows are not as built ({W}, {V})")
    require(all(v == 0 for v in errs.values()),
            f"a K3 entry != its plain version: {errs}")
    require(rounds > 0, "no exchange round ran")
    require(all(tiers[t] > 0 for t in MESH_CLOSE_TIERS),
            f"shard_close missed a tier: {dict(tiers)}")
    emit({"phase": "mesh_kernel_parity", "cases": cases, "errs": errs,
          "rounds": rounds, "k1_err": k1_err, "close_tiers": dict(tiers)})
    return max(list(errs.values()) + [k1_err]), dict(tiers)


class ShardRecorder:
    """Keeps every frontier-sharded check the production routes make while
    it is active, with its inputs, so that a route's K3 walks can be
    replayed, timed and held against plain versions afterwards."""

    def __enter__(self):
        from jepsen_torch.parallel import frontier as PF
        self.mod, self.orig, self.calls = PF, PF.frontier_sharded_kernel, []

        def build(V, W, mesh, shared_target=False):
            kern = self.orig(V, W, mesh, shared_target)

            def check(*args, **kw):
                self.calls.append((V, W, mesh, shared_target, kern, args))
                return kern(*args, **kw)
            return check
        PF.frontier_sharded_kernel = build
        return self

    def __exit__(self, *exc):
        self.mod.frontier_sharded_kernel = self.orig
        return False


def shard_counts() -> dict:
    from jepsen_torch.ops import cuda_shard
    from jepsen_torch.parallel import frontier as PF
    return {**cuda_shard.LAUNCHES, "rounds": PF.ROUNDS,
            "close_tiers": dict(cuda_shard.CLOSE_TIERS)}


def zero_shard_counts() -> None:
    from jepsen_torch.ops import cuda_shard
    from jepsen_torch.parallel import frontier as PF
    for k in cuda_shard.LAUNCHES:
        cuda_shard.LAUNCHES[k] = 0
    cuda_shard.CLOSE_TIERS.clear()
    PF.ROUNDS = 0


def k3_bound(k1: dict, work: dict) -> dict:
    """K1's bound on the timing walks' rows (``k1``, ``launch_bound`` of
    the bytes K1 must move and the operations their data needs), shared
    out over K3's entries by their part of that work at the card's
    rates: shard_close reads the inputs (events and table) and does the
    ORs under the local slots, shard_image the ORs under the top slots,
    shard_commit the completions' word tests and the outputs' writes
    (valid, bad, frontier). The entries' bounds add up to K1's."""
    part = {"shard_close": (work["read"], work["ors_local"]),
            "shard_image": (0, work["ors_top"]),
            "shard_commit": (work["written"], work["tests"])}
    t = {n: b / HBM_BYTES_PER_S + o / INT32_OPS_PER_S
         for n, (b, o) in part.items()}
    total = sum(t.values()) or 1.0
    return {n: {"bound_ms": k1["bound_ms"] * t[n] / total,
                "bound_by": k1["bound_by"], "bound_share": t[n] / total,
                "bytes": b, "needed_ops": o}
            for n, (b, o) in part.items()}


def k3_work(dev, L, V, W, mesh, args, work) -> tuple:
    """K1's work on one K3 walk's rows: adds the input bytes read
    (``read``), the output bytes written (``written``) and the needed
    operations split by ``closure_ops`` (ORs under local slots, under top
    slots, word tests) to ``work``; returns (bytes, operations), the
    split's sum held to ``plain_wgl(ops=)``."""
    ev = [a.to(dev) if isinstance(a, torch.Tensor) else on(a, dev)
          for a in args]
    B = ev[0].shape[0]
    nd = torch.zeros(B, dtype=torch.int64, device=dev)
    L.plain_wgl(*ev, 0, *L.initial_carry(B, V, W, dev),
                V=V, W=W, w_live=W, ops=nd)
    WL = W - (mesh.shape["frontier"].bit_length() - 1)
    split = [int(x.sum()) for x in closure_ops(
        L, (*ev, 0, *L.initial_carry(B, V, W, dev)),
        {"V": V, "W": W, "w_live": W}, top=WL)]
    require(sum(split) == int(nd.sum()),
            f"closure_ops {split} != plain_wgl {int(nd.sum())}")
    for k, x in zip(("ors_local", "ors_top", "tests"), split):
        work[k] += x
    read, written = frontier_bytes(L, ev[0], ev[2], ev[3], V, W, W,
                                   parts=True)
    work["read"] += read
    work["written"] += written
    return read + written, int(nd.sum())


def k3_measure(dev, L, calls, timed, k1_singles):
    """The recorded K3 walks of the routes (``calls``). Each is replayed
    through the kernels, through the plain versions and with every entry
    held against its plain version on each input it gets
    (``paired_ops``); the kernel walk's (valid, bad, frontier) must equal
    the plain walk's. On the timing walks (``calls[timed:]``): each
    kernel's device time (the profiler), the walk through the host loop
    (host clock), the plain versions' time per entry, launches and host
    rounds, the bound (K1's on the same rows, shared out by ``k3_bound``)
    and K1's data1wide time on them (``k1_singles``, recorded on the
    one-card route)."""
    from jepsen_torch.ops import cuda_shard as CS
    from jepsen_torch.parallel import frontier as PF
    errs = {n: 0 for n in PF.OPS}
    shard_ms, walk_ms, plain, launches = {}, 0.0, {}, {}
    close_tiers = collections.Counter()
    walk_err, rounds, k1_ops, nbytes = 0, 0, 0, 0
    work = dict.fromkeys(("read", "written", "ors_local", "ors_top",
                          "tests"), 0)
    for i, (V, W, mesh, shared, kern, args) in enumerate(calls):
        timing = i >= timed
        before, r0 = dict(CS.LAUNCHES), PF.ROUNDS
        tiers0 = collections.Counter(CS.CLOSE_TIERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = kern(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        walk = {k: v - before[k] for k, v in CS.LAUNCHES.items()}
        walk_tiers = collections.Counter(CS.CLOSE_TIERS) - tiers0
        walk_rounds = PF.ROUNDS - r0
        want = kern(*args, ops=timed_plain(plain if timing else {}))
        torch.cuda.synchronize()
        walk_err = max([walk_err] + [tensors_err(g, w)
                                     for g, w in zip(got, want)])
        kern(*args, ops=paired_ops(errs))
        if not timing:
            continue
        walk_ms += ms
        rounds += walk_rounds
        close_tiers.update(walk_tiers)
        for k, v in walk.items():
            launches[k] = launches.get(k, 0) + v
        for name, ms in kernel_split(lambda: kern(*args), reps=1).items():
            if name.startswith("shard_"):
                key = name.replace("_kernel", "")
                shard_ms[key] = shard_ms.get(key, 0.0) + ms
        nb, no = k3_work(dev, L, V, W, mesh, args, work)
        nbytes += nb
        k1_ops += no
    k1 = launch_bound(nbytes, k1_ops)
    entries = {n: {"ms": shard_ms.get(n, 0.0),
                   "launches": launches.get(n, 0),
                   "plain_ms": plain.get(n, 0.0), **b}
               for n, b in k3_bound(k1, work).items()}
    return {"walks": len(calls) - timed, "walks_held": len(calls),
            "walk_err": walk_err, "entry_errs": errs, "rounds": rounds,
            "close_tiers": dict(close_tiers),
            "walk_ms": walk_ms,
            "ms": sum(e["ms"] for e in entries.values()),
            "plain_ms": sum(plain.values()), "entries": entries,
            "k1_bound": k1,
            "k1_data1wide_ms": time_launches(
                [prepared_single(L, *a, **kw) for a, kw in k1_singles],
                reps=3)}


def phase_mesh_path(dev, L, S, cas, synth, wgl_check, sharded_before):
    """The production routes under the card named MESH_DEVICES times:
    wide Op-list rows (W 17, 18 and 19) and a columnar W 18 batch on the
    frontier route, the wide W 17 check_synth specs on it against their
    one-card data1wide run (K3 timed on them), and the dryrun's batch on
    the batch-sharded route against data1 and wgl_check."""
    from jepsen_torch import provision
    from jepsen_torch.history.columnar import ops_to_columnar
    from jepsen_torch.workloads.synth import synth_wide_window_history
    require(not sharded_before, f"a sharded route ran before the mesh "
                                f"phase: {dict(sharded_before)}")
    out = {"phase": "mesh_path", "devices": MESH_DEVICES}
    # The wide specs on one card first: data1wide, K1's launches kept.
    one_card, k1_singles = {}, []
    for inv in (False, True):
        ws = S.SynthSpec(family="wide", n=WIDE_ROWS, width=17, n_values=2,
                         invalid=inv)
        L.DISPATCH_LOG.clear()
        with LaunchRecorder(L.cuda_wgl) as k1:
            one_card[inv] = L.check_synth(cas(), ws, scheduler=False)
        require({p for p, *_ in L.DISPATCH_LOG} == {"data1wide"},
                f"one card: {list(L.DISPATCH_LOG)}")
        k1_singles += k1.singles
    hists = synth(MESH_DATAN_ROWS, **MESH_DATAN)
    L.DISPATCH_LOG.clear()
    data1 = L.check_batch(cas(), hists)
    require(not {p for p, *_ in L.DISPATCH_LOG} & {"dataN", "frontier"},
            f"one card: {list(L.DISPATCH_LOG)}")
    with provision.provisioned(MESH_DEVICES, dev):
        L._PROD_MESHES.clear()
        require(L.production_mesh(1, dev).shape
                == {"data": MESH_DEVICES, "frontier": 1}, "no data mesh")
        require(L.device_frontier_capacity(dev) == 3, "capacity != 3")
        zero_shard_counts()
        with ShardRecorder() as rec:
            # Op-list rows, each width valid and invalid.
            wide = [synth_wide_window_history(width=w, invalid=inv)
                    for w in (17, 18, 19) for inv in (False, True)]
            L.DISPATCH_LOG.clear()
            t0 = time.perf_counter()
            res = L.check_batch(cas(), wide)
            oplist_s = time.perf_counter() - t0
            routes = sorted({(p, w) for p, _, w, _ in L.DISPATCH_LOG})
            require(routes == [("frontier", 17), ("frontier", 18),
                               ("frontier", 19)], f"Op-list: {routes}")
            for h, r, inv in zip(wide, res, [False, True] * 3):
                require(r["valid"] is (not inv) and "fallback" not in r,
                        f"Op-list row {len(h) - 1}: {r.get('valid')}")
                require(not inv or (r["op"]["f"] == "read"
                                    and r["op"]["index"] == h[-1].index),
                        "Op-list: the invalid row's op is not the read")
            oplist = {"s": oplist_s, "routes": routes, **shard_counts()}
            # The columnar entry at W 18.
            pair = [synth_wide_window_history(width=18),
                    synth_wide_window_history(width=18, invalid=True)]
            L.DISPATCH_LOG.clear()
            cv, cb = L.check_columnar(cas(), ops_to_columnar(cas(), pair))
            require([p for p, *_ in L.DISPATCH_LOG] == ["frontier"]
                    and cv.tolist() == [True, False]
                    and int(cb[1]) == pair[1][-1].index,
                    f"columnar W 18: {list(L.DISPATCH_LOG)}")
            n_oplist = len(rec.calls)
            # The wide specs through the default check_synth.
            synth_runs = []
            for inv in (False, True):
                ws = S.SynthSpec(family="wide", n=WIDE_ROWS, width=17,
                                 n_values=2, invalid=inv)
                L.DISPATCH_LOG.clear()
                t0 = time.perf_counter()
                fv, fb = L.check_synth(cas(), ws)
                s = time.perf_counter() - t0
                require([p for p, *_ in L.DISPATCH_LOG] == ["frontier"],
                        f"wide spec: {list(L.DISPATCH_LOG)}")
                ov, ob = one_card[inv]
                require(np.array_equal(fv, ov) and np.array_equal(fb, ob),
                        f"wide spec invalid={inv}: frontier != data1wide")
                synth_runs.append({"invalid": inv, "s": s,
                                   "valid_rows": int(fv.sum())})
            # The batch-sharded route.
            L.DISPATCH_LOG.clear()
            t0 = time.perf_counter()
            dn = L.check_batch(cas(), hists)
            datan_s = time.perf_counter() - t0
            require("dataN" in {p for p, *_ in L.DISPATCH_LOG},
                    f"dataN: {list(L.DISPATCH_LOG)}")
            launches = shard_counts()
        require(all(launches[k] > 0 for k in ("shard_close", "shard_image",
                                              "shard_commit")),
                f"the mesh routes missed a K3 entry: {launches}")
        require([verdict(r) for r in dn] == [verdict(r) for r in data1],
                "dataN verdicts != data1")
        step = MESH_DATAN_ROWS // MESH_ORACLE_ROWS
        for i in range(0, MESH_DATAN_ROWS, step):
            require(verdict(wgl_check(cas(), hists[i])) == verdict(dn[i]),
                    f"dataN row {i} != wgl_check")
        measure = k3_measure(dev, L, rec.calls, n_oplist, k1_singles)
        require(measure["walk_err"] == 0
                and not any(measure["entry_errs"].values()),
                f"K3 on the routes' walks != its plain version: "
                f"{measure['walk_err']}, {measure['entry_errs']}")
    L._PROD_MESHES.clear()
    require(L.production_mesh(1, dev) is None
            or torch.cuda.device_count() > 1, "the mesh outlived its block")
    out.update(oplist=oplist, synth=synth_runs,
               dataN={"rows": MESH_DATAN_ROWS, "s": datan_s,
                      "invalid": sum(r["valid"] is False for r in dn),
                      "oracle_rows": MESH_ORACLE_ROWS},
               launches=launches, k3=measure)
    emit(out)
    return {"launches": launches, "k3": measure}


def mesh_entries(mesh, parity_err, parity_tiers) -> list:
    """The kernels-line entries of K3's three kernels: launches on the
    mesh routes, times on the wide W 17 specs, and each entry's share of
    K1's bound on those rows (``k3_bound``; the three add up to it);
    shard_close's launches by tier ("tier/CTAs a row") on the routes, on
    the timing walks and in the parity phase."""
    k3 = mesh["k3"]
    err = max([parity_err, k3["walk_err"]] + list(k3["entry_errs"].values()))
    out = []
    for name in ("shard_close", "shard_image", "shard_commit"):
        e = k3["entries"][name]
        tiers = ({"close_tiers": mesh["launches"]["close_tiers"],
                  "timing_close_tiers": k3["close_tiers"],
                  "parity_close_tiers": parity_tiers}
                 if name == "shard_close" else {"tier": "block/1"})
        out.append({
            "name": f"wgl_{name}", "route": "cuda",
            "source": "jepsen_torch/ops/csrc/wgl_shard.cu",
            "replaces": "jepsen_tpu/parallel/frontier.py:74",
            "launches": mesh["launches"][name],
            "rounds": mesh["launches"]["rounds"], **tiers,
            "parity": True, "max_abs_err": err,
            **{k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "bound_share", "bytes", "needed_ops")},
            "bound_of": "K1's bound on the same rows, shared out",
            "library_ms": None,
            "timing_batch": f"wide W 17 check_synth specs, {WIDE_ROWS} "
                            f"rows each, {MESH_DEVICES} devices",
            "k3_step": {k: k3[k] for k in ("walks", "walks_held",
                                           "rounds", "walk_ms", "ms",
                                           "plain_ms", "k1_data1wide_ms")}
            | {"k1_bound_ms": k3["k1_bound"]["bound_ms"],
               "k1_bound_by": k3["k1_bound"]["bound_by"]}})
    return out


def build_kernels(L, cuda_synth):
    """Build the six kernel libraries and the empty kernel's at once
    (one nvcc each, in parallel), and the native host engines (g++)
    beside them, so that no timed phase pays a build."""
    from concurrent.futures import ThreadPoolExecutor

    from jepsen_torch import native
    from jepsen_torch.ops import (_build, cuda_dc, cuda_folds, cuda_graph,
                                  cuda_shard)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(9) as pool:
        for f in [pool.submit(L.cuda_wgl.build),
                  pool.submit(cuda_synth.build),
                  pool.submit(cuda_graph.build),
                  pool.submit(cuda_folds.build),
                  pool.submit(cuda_dc.build),
                  pool.submit(cuda_shard.build),
                  pool.submit(floor_library),
                  pool.submit(native.lib), pool.submit(native.ingest)]:
            f.result()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "spill",
                                             "registers"))]
             for name, log in _build.BUILD_LOGS.items()
             if name.endswith(".cu")}
    return build_s, ptxas


def la_entry(la, parity_err) -> dict:
    """The kernels-line entry of K8c: launches on the la path's two
    batches, times and bound on the kernel-timing batch."""
    k = la["kernel"]
    by_path = {f"la_path_{b['batch']}": b["launches"]["synth_la"]
               for b in la["batches"]}
    return {"name": "synth_la", "route": "cuda",
            "source": "jepsen_torch/ops/csrc/synth_device.cu",
            "replaces": "jepsen_tpu/ops/synth_device.py:620",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "parity": True, "max_abs_err": max(parity_err,
                                               k["max_abs_err"]),
            **{f: k[f] for f in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                                 "bound_by")},
            "library_ms": None, "timing_batch": k["spec"]}


def closure_entry(name, replaces, path, bench, wide, parity_err) -> dict:
    """The kernels-line entry of one closure entry: launches per batch of
    its path, times and bound of the full-width batch, and the bench
    batch's beside them."""
    keys = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kb, kw = bench["kernel"], wide["kernel"]
    return {"name": name, "route": "cuda",
            "source": "jepsen_torch/ops/csrc/graph_closure.cu",
            "replaces": replaces,
            "launches": bench["launches"] + wide["launches"],
            "launches_by_path": {f"{path}_bench": bench["launches"],
                                 f"{path}_wide": wide["launches"]},
            "parity": True,
            "max_abs_err": max(parity_err, kb["max_abs_err"],
                               kw["max_abs_err"]),
            **{k: kw[k] for k in keys}, "buckets": kw["buckets"],
            "bench_batch": {"buckets": kb["buckets"],
                            **{k: kb[k] for k in keys}}}


# The keyed headline timed alone in another checkout of the package (its
# own build and import), for comparing two trees on one card.
HEADLINE_CHILD = r"""
import json, sys, time
import torch
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops import synth_device as S
kw, reps = json.loads(sys.argv[1]), int(sys.argv[2])
L.check_synth(cas_register(), S.SynthSpec(**dict(kw, n=64)))   # build, warm
runs = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L.check_synth(cas_register(), S.SynthSpec(**kw))
    torch.cuda.synchronize()
    runs.append(time.perf_counter() - t0)
print(json.dumps(runs))
"""


def headline_compare(trees, reps: int = 2) -> None:
    """The default check_synth on the keyed headline spec in each
    checkout of ``trees``, in the order given (for example parent,
    change, change, parent), each in a process of its own that builds
    that tree's kernels: seconds and histories per second per run."""
    out = {"phase": "headline_compare", "spec": HEADLINE_SPEC, "runs": []}
    for tree in trees:
        tree = os.path.abspath(tree)
        p = subprocess.run(
            [sys.executable, "-c", HEADLINE_CHILD, json.dumps(HEADLINE_SPEC),
             str(reps)], cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
            capture_output=True, text=True, timeout=1200)
        require(p.returncode == 0, f"{tree}: {p.stderr[-2000:]}")
        runs = json.loads(p.stdout.strip().splitlines()[-1])
        out["runs"].append({"tree": tree, "check_synth_s": runs,
                            "histories_per_s": [HEADLINE_SPEC["n"] / t
                                                for t in runs]})
    emit(out)


# The redesigned kernels timed alone in another checkout of the package
# (its own build and import) on inputs saved by kernels_compare: K1 over
# every launch of the dc batches' dc runs, K7a over each count family's
# full-width batch, K7b, K7c and K7d over the counter's, the queue's and
# the FIFO's, K5 and K6 over their CLOSURE_TIMING batches' buckets, K8a
# and K8c over the north-star and LA_TIMING batches (``synth_times``), K4
# over every plan of the dc batches' dc runs, K8b on the wide path's
# batch (``wide_times``), K2 instrument and K1 over the north-star and
# keyed headline buckets, each W's buckets apart, K2f over the keyed
# headline's group launches, the empty kernel on their grids, from the
# library this checkout built, and K3 over the wide W 17 specs' walks
# through this checkout's frontier_sharded_kernel on a mesh of the card
# named 8 times (each kernel's device time by the profiler, the walk by
# the host clock, its median of the reps). The timing helpers are this
# script's (its path is the third argument), so that every checkout is
# timed by one harness.
KERNELS_CHILD = r"""
import importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("harness", sys.argv[3])
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)
from jepsen_torch.ops import cuda_folds, cuda_graph
from jepsen_torch.ops import linearize as L
saved, reps = torch.load(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
out = {"k1_ms": {}, "k7a_ms": {}}
for label, launches in saved["k1"].items():
    prepared = []
    for ev, kw in launches:
        ev = [t.to(dev) for t in ev]
        carry = L.initial_carry(ev[0].shape[0], kw["V"], kw["W"], dev)
        prepared.append(CS.prepared_single(L, *ev, 0, *carry, **kw))
    out["k1_ms"][label] = CS.time_launches(prepared, reps=reps)
for fam, (ts, V) in saved["k7a"].items():
    ts = [None if t is None else t.to(dev) for t in ts]
    launch = cuda_folds.prepare_counts(fam, *ts, V)[0]
    out["k7a_ms"][fam] = CS.time_launches([(lambda: None, launch)],
                                          reps=reps)
out["scans_ms"] = {}
for entry, (ts, width) in saved.get("scans", {}).items():
    ts = [t.to(dev) for t in ts]
    prepare = getattr(cuda_folds, "prepare_" + entry.split("_")[0])
    launch = prepare(*ts, width)[0]
    out["scans_ms"][entry] = CS.time_launches([(lambda: None, launch)],
                                              reps=reps)
out["closures_ms"] = {}
for label, (entry, buckets) in saved.get("closures", {}).items():
    launches = [(lambda: None, cuda_graph.prepare(a.to(dev), V, entry)[0])
                for V, a in buckets]
    out["closures_ms"][label] = CS.time_launches(launches, reps=reps)
out["synth"] = {}
from jepsen_torch.ops import cuda_synth
for label, (family, keys, rest, st) in saved.get("synth", {}).items():
    args = ({s: t.to(dev) for s, t in keys.items()},
            *[t.to(dev) if torch.is_tensor(t) else t for t in rest])
    out["synth"][label] = CS.synth_times(cuda_synth, family, args, st, reps)
out["dc_ms"], out["wide"], out["floor_ms"] = {}, {}, {}
from jepsen_torch.ops import cuda_dc
for label, plans in saved.get("dc", {}).items():
    plans = [[t.to(dev) for t in p] for p in plans]
    launches = [(lambda: None, cuda_dc.prepare(*p, p[0].shape[1] + 1)[0])
                for p in plans]
    out["dc_ms"][label] = CS.time_launches(launches, reps=reps)
for label, (vk, st) in saved.get("wide", {}).items():
    out["wide"][label] = CS.wide_times(cuda_synth, vk.to(dev), st, reps,
                                       saved["floor"]["lib"])
out["instrument"] = {}
for label, buckets in saved.get("instrument", {}).items():
    by_w = {}
    for ev, kw in buckets:
        by_w.setdefault(kw["W"], []).append(([t.to(dev) for t in ev], kw))
    res = {"ms_by_W": {}, "k1_ms_by_W": {}}
    for W, bs in sorted(by_w.items()):
        for key, count in (("ms_by_W", True), ("k1_ms_by_W", False)):
            prepared = []
            for ev, kw in bs:
                B = ev[0].shape[0]
                extra = ({"iters": torch.zeros(B, dtype=torch.int32,
                                               device=dev)} if count else {})
                prepared.append(CS.prepared_single(
                    L, *ev, 0, *L.initial_carry(B, kw["V"], W, dev), **kw,
                    **extra))
            res[key][str(W)] = CS.time_launches(prepared, reps=reps)
    res["ms"] = sum(res["ms_by_W"].values())
    res["k1_ms"] = sum(res["k1_ms_by_W"].values())
    out["instrument"][label] = res
out["k2f_ms"] = {}
for label, groups in saved.get("k2f", {}).items():
    out["k2f_ms"][label] = CS.time_launches(
        [CS.prepared_group(L, m, [t.to(dev) for t in f], r)
         for m, f, r in groups], reps=reps)
for label, grids in saved.get("floor", {}).get("grids", {}).items():
    out["floor_ms"][label] = CS.time_launches(
        CS.floor_launches(grids, saved["floor"]["lib"]), reps=reps)
out["mesh"] = {}
for label, walks in saved.get("mesh", {}).items():
    import time
    from jepsen_torch.ops import cuda_shard
    from jepsen_torch.parallel import checker_mesh, frontier_sharded_kernel
    from jepsen_torch.parallel import frontier as PF
    runs = []
    for w in walks:
        nd, D = w["mesh"]
        mesh = checker_mesh(nd, D, devices=[dev] * (nd * D))
        runs.append((frontier_sharded_kernel(w["V"], w["W"], mesh,
                                             w["shared"]),
                     [t.to(dev) for t in w["args"]]))
    def walk():
        for kern, args in runs:
            kern(*args)
    walk()
    torch.cuda.synchronize()
    before = dict(cuda_shard.LAUNCHES)
    tiers = dict(getattr(cuda_shard, "CLOSE_TIERS", {}))
    r0 = PF.ROUNDS
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walk()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    launches = {k: (v - before[k]) // reps
                for k, v in cuda_shard.LAUNCHES.items()}
    close_tiers = {k: (v - tiers.get(k, 0)) // reps for k, v in
                   dict(getattr(cuda_shard, "CLOSE_TIERS", {})).items()}
    split = {k.replace("_kernel", ""): v for k, v in
             CS.kernel_split(walk, reps).items() if k.startswith("shard_")}
    out["mesh"][label] = {"ms": sum(split.values()), "split_ms": split,
                          "walk_ms": sorted(host)[len(host) // 2],
                          "walk_ms_runs": host, "launches": launches,
                          "close_tiers": close_tiers,
                          "rounds": (PF.ROUNDS - r0) // reps}
print(json.dumps(out))
"""

# The closure batches kernels_compare times: K5 on 32 full-width
# list-append histories (V 1024) and on 16 (the graph path's count until
# it was cut to GRAPH_WIDE's 8), K6 on 128 wide transactional histories
# (V 256, ISO_WIDE's shape).
CLOSURE_TIMING = (("graph_wide32", "graph", 32),
                  ("graph_path16", "graph", 16),
                  ("txn_wide128", "txn", 128))


def closure_batch(entry, n):
    """The packed buckets of ``n`` full-width graphs of ``entry``'s path
    (list-append histories of the graph path's width; transactional
    histories of ISO_WIDE's)."""
    if entry == "graph":
        from jepsen_torch.ops.graph import encode_graphs, extract_graph
        from jepsen_torch.workloads.synth import synth_la_history
        w = GRAPH_WIDE
        return encode_graphs([extract_graph(synth_la_history(
            s, n_ops=w["n_ops"], n_keys=w["n_keys"],
            corrupt=1.0 if s % 7 == 0 else 0.0), "list-append")
            for s in range(n)])
    from jepsen_torch.ops.synth_txn import TxnSpec, synth_txn_batch
    from jepsen_torch.ops.txn_graph import (encode_txn_graphs,
                                            extract_txn_graph)
    pairs = synth_txn_batch(TxnSpec(**dict(ISO_WIDE, n=n)))
    return encode_txn_graphs([extract_txn_graph(h) for h, _ in pairs])


def kernels_record_k1(out, saved) -> None:
    """K1's inputs: the launches of each dc batch's dc run and of the two
    wide W 17 check_synth specs, each from a fresh carry, with the bound
    and each launch's plan and time (``k1_launches_measure``)."""
    from jepsen_torch.history.columnar import ops_to_columnar
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import linearize as L
    from jepsen_torch.ops import synth_device as S

    def keep(label, k1):
        require(k1.singles and not k1.groups,
                f"{label}: no single-bucket launch, or a group launch")
        for a, kw in k1.singles:
            fresh = L.initial_carry(a[0].shape[0], kw["V"], kw["W"],
                                    a[0].device)
            require(a[4] == 0 and all(torch.equal(x, y) for x, y in
                                      zip(a[5:], fresh)),
                    f"{label}: a launch did not start from a fresh carry")
        saved["k1"][label] = [([t.cpu() for t in a[:4]], kw)
                              for a, kw in k1.singles]
        out["k1"][label] = k1_launches_measure(L, k1.singles)

    for label, stale_rows in (("healthy", set()),
                              ("faulty", set(range(0, DC_ROWS, 8)))):
        hists = [rw_history(rw_job(s, DC_STALE if s in stale_rows else 0.0))
                 for s in range(DC_ROWS)]
        with LaunchRecorder(L.cuda_wgl) as k1:
            cols = ops_to_columnar(cas_register(), hists, max_states=64)
            L.check_columnar(cas_register(), cols, details="invalid",
                             scheduler_opts={"wgl_backend": "dc"})
        keep(label, k1)
    for inv in (False, True):
        with LaunchRecorder(L.cuda_wgl) as k1:
            L.check_synth(cas_register(), S.SynthSpec(
                family="wide", n=WIDE_ROWS, width=17, n_values=2,
                invalid=inv), scheduler=False)
        keep(f"wide_w17_{'invalid' if inv else 'valid'}", k1)


def kernels_record_folds(out, saved, families) -> None:
    """Each fold family's lowered full-width batch as its check_*_batch
    hands it to the kernel, with the folds' bound, plain time and
    whole-function library route (``fold_measure``)."""
    from jepsen_torch.ops import folds as F
    w = FOLD_KERNELS_WIDE
    for family in families:
        hists = [fold_history(family, s, w["elements"], w["procs"])
                 for s in range(w["n"])]
        seen = []
        run_kernel = F.run_kernel

        def recording(lw, ts):
            seen.append((lw, ts))
            return run_kernel(lw, ts)
        F.run_kernel = recording
        try:
            getattr(F, FOLD_CHECKS[family])(hists)
        finally:
            F.run_kernel = run_kernel
        require(len(seen) == 1, f"{family}: {len(seen)} kernel calls")
        lw, ts = seen[0]
        m = fold_measure(ts[0].device, lw, ts)
        require(m["equal"], f"{family}: kernel != plain")
        if lw.entry == "fold_counts":
            out["k7a"][family] = m
            saved["k7a"][family] = ([None if t is None else t.cpu()
                                     for t in ts], lw.width)
        else:
            out["scans"][lw.entry] = m
            saved["scans"][lw.entry] = ([t.cpu() for t in ts], lw.width)


def kernels_record_closures(out, saved) -> None:
    """K5's and K6's CLOSURE_TIMING batches, with their bound, plain time
    and library route (``closure_measure``)."""
    dev = torch.device("cuda")
    for label, entry, n in CLOSURE_TIMING:
        buckets = closure_batch(entry, n)
        m = closure_measure(dev, entry, buckets)
        require(m["equal"], f"{label}: kernel != plain")
        out["closures"][label] = {"entry": entry, **m}
        saved["closures"][label] = (entry, [(b.V, torch.from_numpy(
            np.ascontiguousarray(b.adj, np.int32))) for b in buckets])


# Row counts of the generators' smaller timing batches (the first rows of
# the north-star and LA_TIMING batches): one row a scheduler of the
# card's 528, and about half of one wave of the row kernels' warps.
SYNTH_TIMING_ROWS = (528, 2112)


def kernels_record_synth(out, saved) -> None:
    """K8a's inputs on the north-star batch and K8c's on LA_TIMING, and on
    their first SYNTH_TIMING_ROWS rows, with their bounds."""
    import dataclasses

    from jepsen_torch.ops import synth_device as S
    dev = torch.device("cuda")
    for name, fields in (("cas_north_star", NS_SPEC),
                         ("la_timing", LA_TIMING)):
        full = S.SynthSpec(**fields)
        for rows in (None, *SYNTH_TIMING_ROWS):
            spec = full if rows is None else dataclasses.replace(full,
                                                                 n=rows)
            label = name if rows is None else f"{name}_rows_{rows}"
            if spec.family == "cas":
                keys, *rest = S.cas_inputs(spec, device=dev)
                st = S.cas_static(spec, key_meta=False)
                bound = synth_bound(spec)
            else:
                keys, *rest = S.la_inputs(spec, device=dev)
                st, bound = S.la_static(spec), la_bound(spec)
            saved["synth"][label] = (
                spec.family, {s: t.cpu() for s, t in keys.items()},
                [t.cpu() if torch.is_tensor(t) else t for t in rest], st)
            out["synth"][label] = {"spec": dataclasses.asdict(spec),
                                   **bound}


def kernels_time_trees(out, saved, trees, reps) -> None:
    """The saved inputs timed in each checkout of ``trees``, in the order
    given, each in a process of its own that builds that tree's
    kernels."""
    path = os.path.abspath(os.path.join("build", "kernels_compare.pt"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(saved, path)
    for tree in trees:
        tree = os.path.abspath(tree)
        p = subprocess.run(
            [sys.executable, "-c", KERNELS_CHILD, path, str(reps),
             os.path.abspath(__file__)],
            cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
            capture_output=True, text=True, timeout=1200)
        require(p.returncode == 0, f"{tree}: {p.stderr[-2000:]}")
        out["runs"].append({"tree": tree, **json.loads(
            p.stdout.strip().splitlines()[-1])})
    os.remove(path)


def kernels_record_dc(out, saved) -> None:
    """K4's inputs: the padded plans of each dc batch's dc run, with the
    bound, plain time, library route, floor and this checkout's times
    (``dc_measure``), and the plans' grids for the floor."""
    from jepsen_torch.history.columnar import ops_to_columnar
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import linearize as L
    dev = torch.device("cuda")
    for label, stale_rows in (("healthy", set()),
                              ("faulty", set(range(0, DC_ROWS, 8)))):
        hists = [rw_history(rw_job(s, DC_STALE if s in stale_rows else 0.0))
                 for s in range(DC_ROWS)]
        with DcRecorder() as rec:
            cols = ops_to_columnar(cas_register(), hists, max_states=64)
            L.check_columnar(cas_register(), cols, details="invalid",
                             scheduler_opts={"wgl_backend": "dc"})
        plans = rec.padded_plans()
        m = dc_measure(dev, plans)
        require(m["equal"] and m["tier"] == ["warp"],
                f"dc {label}: kernel != plain, or a plan off the warp tier")
        out["dc"][label] = m
        saved["dc"][label] = [[torch.from_numpy(a) for a in p]
                              for p, _ in plans]
        saved["floor"]["grids"][f"dc_{label}"] = [dc_grid(*p[0].shape)
                                                  for p, _ in plans]


def kernels_record_wide(out, saved) -> None:
    """K8b's input on the wide path's batch (WIDE_ROWS rows of width 17,
    valid), with its bound and its grid for the floor."""
    from jepsen_torch.ops import synth_device as S
    spec = S.SynthSpec(family="wide", n=WIDE_ROWS, width=17, n_values=2)
    st = dict(width=spec.width, n_values=spec.n_values,
              invalid=spec.invalid)
    saved["wide"]["wide_w17"] = (S.wide_inputs(spec, device="cpu"), st)
    saved["floor"]["grids"]["wide_w17"] = [wide_grid(spec.n)]
    out["wide"]["wide_w17"] = {"rows": spec.n, **st, **wide_bound(spec)}


def kernels_record_instrument(out, saved) -> None:
    """K2 instrument's inputs: the north-star bucket (the exact path's
    encode of the generated batch) and the keyed headline's dispatched
    buckets (the default check_synth's, recorded), each bucket's plan
    and rows by W, the headline's group launches (K2f, which shares the
    warp tier's body), and this checkout's instrumented grids for the
    floor."""
    from jepsen_torch.history.columnar import ColumnarOps
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import cuda_synth
    from jepsen_torch.ops import linearize as L
    from jepsen_torch.ops import synth_device as S
    from jepsen_torch.ops.encode import encode_columnar
    from jepsen_torch.ops.statespace import enumerate_statespace
    from jepsen_torch.workloads.synth import cas_kind_vocabulary
    spec = S.SynthSpec(**NS_SPEC)
    st = S.cas_static(spec, key_meta=False)
    host = {k: v.cpu().numpy() for k, v in cuda_synth.synth_cas(
        *S.cas_inputs(spec, device=torch.device("cuda")), **st).items()}
    cols = ColumnarOps(type=host["type"], process=host["process"],
                       kind=host["kind"],
                       kinds=cas_kind_vocabulary(spec.n_values))
    ns, _ = encode_columnar(enumerate_statespace(cas_register(), cols.kinds,
                                                 64), cols, max_slots=18)
    with BucketRecorder() as disp, LaunchRecorder(L.cuda_wgl) as rec:
        L.check_synth(cas_register(), S.SynthSpec(**HEADLINE_SPEC))
    # K2f, which shares the warp tier's body: the headline's group
    # launches, timed in each tree beside K2 instrument.
    require(rec.groups, "the keyed headline made no group launch")
    saved["k2f"] = {"headline": [(members, [t.cpu() for t in flat], rows)
                                 for members, flat, rows in rec.groups]}
    del rec
    for label, buckets in (("north_star", ns), ("headline", disp.buckets)):
        buckets = [b for b in buckets
                   if b.batch and b.W <= L.DATA_MAX_SLOTS]
        saved["instrument"][label] = [
            ([torch.from_numpy(np.array(a)) for a in (
                b.ev_type, b.ev_slot, b.ev_slots,
                b.target[0] if b.shared_target else b.target)],
             {"V": b.V, "W": b.W, "w_live": b.eff_w_live})
            for b in buckets]
        grids, plans = [], []
        for b in buckets:
            K1 = b.target.shape[-2]
            p = L.cuda_wgl.smem_plan(b.V, b.W, b.eff_w_live, K1=K1,
                                     shared_target=b.shared_target,
                                     instrument=True)
            R = p["rows_per_block"]
            grids.append((-(-b.batch // R), p["threads"]))
            plans.append({"V": b.V, "W": b.W, "rows": b.batch,
                          "events": b.ev_type.shape[1], "tier": p["tier"],
                          "table_form": p["table_form"]})
        saved["floor"]["grids"][f"instrument_{label}"] = grids
        out["instrument"][label] = {
            "buckets": len(buckets), "rows": sum(b.batch for b in buckets),
            "rows_by_W": hist_json(collections.Counter(
                {W: sum(b.batch for b in buckets if b.W == W)
                 for W in {b.W for b in buckets}})),
            "plans": plans}


def kernels_record_mesh(out, saved) -> None:
    """K3's inputs: the walks of the two wide W 17 ``check_synth`` specs
    (WIDE_ROWS rows each, valid and invalid) on the frontier route of the
    card named MESH_DEVICES times, with each walk's mesh, this tree's
    close plan for them and how many of its clusters the card keeps
    resident at once, and the bound (K1's on the same rows, shared out
    over the three kernels by ``k3_bound``)."""
    from jepsen_torch import provision
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import cuda_shard as CS
    from jepsen_torch.ops import linearize as L
    from jepsen_torch.ops import synth_device as S
    dev = torch.device("cuda")
    with provision.provisioned(MESH_DEVICES, dev):
        L._PROD_MESHES.clear()
        with ShardRecorder() as rec:
            for inv in (False, True):
                L.DISPATCH_LOG.clear()
                L.check_synth(cas_register(), S.SynthSpec(
                    family="wide", n=WIDE_ROWS, width=17, n_values=2,
                    invalid=inv))
                require([p for p, *_ in L.DISPATCH_LOG] == ["frontier"],
                        f"wide spec: {list(L.DISPATCH_LOG)}")
    L._PROD_MESHES.clear()
    work = dict.fromkeys(("read", "written", "ors_local", "ors_top",
                          "tests"), 0)
    nbytes = nops = 0
    walks, plans = [], []
    for V, W, mesh, shared, _, args in rec.calls:
        nd, D = mesh.shape["data"], mesh.shape["frontier"]
        ev = [torch.as_tensor(a.cpu() if isinstance(a, torch.Tensor)
                              else np.asarray(a)) for a in args]
        walks.append({"V": V, "W": W, "mesh": (nd, D), "shared": shared,
                      "args": ev})
        WL = W - (D.bit_length() - 1)
        plan = CS.close_plan(WL, (V + 31) // 32, ev[0].shape[0] // nd, V)
        plans.append({"W": W, "W_local": WL, "V": V, "mesh": f"{nd}x{D}",
                      "rows_per_launch": ev[0].shape[0] // nd, **plan,
                      "resident_clusters": CS.close_residency(
                          plan, (V + 31) // 32)})
        b, o = k3_work(dev, L, V, W, mesh, args, work)
        nbytes += b
        nops += o
    require(len(walks) == 2, f"{len(walks)} K3 walks on the wide specs")
    k1 = launch_bound(nbytes, nops)
    saved["mesh"]["wide_w17"] = walks
    out["mesh"]["wide_w17"] = {"walks": len(walks), "plans": plans,
                               "k1_bound": k1,
                               "bounds": k3_bound(k1, work)}


KERNEL_GROUPS = ("k1", "folds", "closures", "synth", "dc", "wide",
                 "instrument", "mesh")

def kernels_compare(trees, reps: int = 5, only=KERNEL_GROUPS) -> None:
    """K1 on the dc headline, K7a, K7b, K7c and K7d on the full-width
    fold batches, K5 and K6 on their CLOSURE_TIMING batches, K8a on the
    north-star batch and K8c on LA_TIMING, K4 on every plan of the dc
    headline's dc runs, K8b on the wide path's batch, and K2 instrument
    with K1 on the north-star bucket and the keyed headline's dispatched
    buckets (split by W) and K2f on the headline's group launches,
    beside the empty kernel on their grids, and K3 on the wide W 17
    specs' walks
    (``only`` names a subset of KERNEL_GROUPS): the same inputs timed in
    each checkout of ``trees`` in the order given (for example parent,
    change, change, parent).
    This checkout records the inputs and measures on them the bounds,
    the plain versions and the library routes (``kernels_record_*``)."""
    out = {"phase": "kernels_compare", "k1": {}, "k7a": {}, "scans": {},
           "closures": {}, "synth": {}, "dc": {}, "wide": {},
           "instrument": {}, "mesh": {}, "runs": []}
    saved = {"k1": {}, "k7a": {}, "scans": {}, "closures": {}, "synth": {},
             "dc": {}, "wide": {}, "instrument": {}, "mesh": {},
             "floor": {"lib": floor_library()._name, "grids": {}}}
    if "k1" in only:
        kernels_record_k1(out, saved)
    if "folds" in only:
        kernels_record_folds(out, saved, FOLD_COUNT_FAMILIES
                             + ("counter", "queue", "fifo"))
    if "closures" in only:
        kernels_record_closures(out, saved)
    if "synth" in only:
        kernels_record_synth(out, saved)
    if "dc" in only:
        kernels_record_dc(out, saved)
    if "wide" in only:
        kernels_record_wide(out, saved)
    if "instrument" in only:
        kernels_record_instrument(out, saved)
    if "mesh" in only:
        kernels_record_mesh(out, saved)
    kernels_time_trees(out, saved, trees, reps)
    emit(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] in (["--headline"], ["--kernels"]):
        smi = nvidia_smi()
        if sys.argv[1] == "--headline":
            headline_compare(sys.argv[2:])
        elif sys.argv[2:3] == ["--only"]:
            only = sys.argv[3].split(",")
            require(set(only) <= set(KERNEL_GROUPS),
                    f"--only takes {','.join(KERNEL_GROUPS)}")
            kernels_compare(sys.argv[4:], only=only)
        else:
            kernels_compare(sys.argv[2:])
        print(smi, flush=True)
        return 0
    from jepsen_torch.checkers.linearizable import prepare_history, wgl_check
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import cuda_synth
    from jepsen_torch.ops import linearize as L
    from jepsen_torch.ops import synth_device as S
    from jepsen_torch.ops.encode import bucket_encode
    from jepsen_torch.workloads.synth import synth_cas_batch

    t_start = time.perf_counter()
    smi = nvidia_smi()
    dev = torch.device("cuda")
    # With nothing provisioned a one-card host has no mesh: every phase
    # before mesh_path keeps its one-card route, and no sharded dispatch
    # may happen until then (counted here).
    one_card = torch.cuda.device_count() == 1
    require(not one_card or (L.production_mesh(1, dev) is None
                             and L.production_mesh(2, dev) is None),
            "a production mesh exists with nothing provisioned")
    sharded = collections.Counter()
    dispatch_sharded = L._dispatch_sharded

    def counted_sharded(kind, *a, **kw):
        sharded[kind] += 1
        return dispatch_sharded(kind, *a, **kw)
    L._dispatch_sharded = counted_sharded
    build_s, ptxas = build_kernels(L, cuda_synth)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    wgl_err = phase_kernel_parity(dev, L, synth_cas_batch, cas_register,
                                  prepare_history, bucket_encode)
    phase_tier_cut(dev, L, S, cas_register)
    synth_err = phase_synth_parity(dev, S, cuda_synth)
    oplist = phase_oplist_path(dev, L, synth_cas_batch, cas_register,
                               prepare_history, bucket_encode, wgl_check)
    main_k = phase_columnar_path(dev, L, S, cuda_synth, cas_register,
                                 wgl_check)
    group_err = phase_group_parity(dev, L, S, cas_register)
    sched = phase_scheduler_path(dev, L, S, cuda_synth, cas_register,
                                 wgl_check)
    sides = phase_scheduler_sides(dev, L, S, cuda_synth, synth_cas_batch,
                                  cas_register)
    phase_native_path(dev, L, S, cas_register, wgl_check)
    # The closure's plain version is a float32 matmul chain: keep it in
    # full float32 (the default) so that the comparison is plainly exact.
    torch.backends.cuda.matmul.allow_tf32 = False
    closure_err = phase_graph_kernel_parity(dev)
    # The host oracles of the graph phases are pure Python: they run on a
    # pool of worker processes, started only now so that no worker sits
    # beside the earlier phases' host timings, and stopped right after.
    workers = min(8, len(os.sched_getaffinity(0)))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        gb, gw = phase_graph_path(dev, pool)
        ib, iw = phase_isolation_path(dev, pool)
        fold_err = phase_fold_kernel_parity(dev)
        folds = phase_fold_path(dev, pool)
        oracle = RwOracle(pool)
        oracle.prefetch(dc_oracle_jobs())
        dc_err = phase_dc_kernel_parity(dev)
        probe, dch, dcf, dcw = phase_dc_path(dev, L, oracle)
        route = phase_route_check(dev, L, pool, oracle)
        la_err = phase_la_synth_parity(dev, S, cuda_synth)
        la = phase_la_path(dev, pool, S, cuda_synth)
    # The fault ladder's phases, after every kernel is built.
    # K1's work on the headline's buckets: the scheduler path's group and
    # single launches over the same rows.
    hl_k1 = {k: sched["group"][k] + sched["single"][k]
             for k in ("bytes", "needed_ops")}
    inst = phase_instrument_parity(dev, L, main_k.pop("buckets"),
                                   sched.pop("buckets"),
                                   main_k["wgl_frontier"], hl_k1)
    phase_wgl_faults(dev, L, S, cas_register)
    phase_graph_faults(dev)
    phase_real_oom(dev, L)
    camp = phase_campaign(dev, L, S, cuda_synth)
    fz = phase_fuzz(dev, L, S, cuda_synth)
    # The online daemon over a live store (K1's resume entry), before the
    # mesh is provisioned.
    onl = phase_online_path(dev, L, cas_register)
    # The multi-device routes (K3), on the card named MESH_DEVICES times.
    mesh_err, mesh_tiers = phase_mesh_kernel_parity(dev, L)
    mesh = phase_mesh_path(dev, L, S, cas_register, synth_cas_batch,
                           wgl_check, sharded if one_card else {})
    emit({"phase": "done", "chip_smoke_s": time.perf_counter() - t_start})

    def dc_launches(entry):
        """An entry's launches on the dc path's runs and route_check."""
        out = {f"check_batch_columnar_{b}": sum(
            x["runs"][b]["launches"][entry] for x in (dch, dcf, dcw)
            if b in x["runs"]) for b in ("dc", "xla", "auto")}
        out["route_check"] = route["launches"][entry]
        return out

    wk, sk = main_k["wgl_frontier"], main_k["synth_device"]
    # K8b: the wide W 17 specs' launches, exact and through the scheduler.
    wg = main_k["wide_generator"]
    wide_gen_by_path = {
        "check_synth_wide_w17": sum(w["launches"]["synth_wide"]
                                    for w in main_k["wide"]),
        "check_synth_scheduler_wide_w17": sides["synth_wide"]}
    sl, gk = sched["launches"], sched["group"]
    # K1's wide tiers: the dc headline's dc runs (the healthy batch's
    # times and bound, the faulty batch's beside them) and the wide W 17
    # check_synth specs.
    dk = {b: x["runs"]["dc"] for b, x in (("healthy", dch),
                                          ("faulty", dcf))}
    wide_by_path = {
        "check_synth_wide_w17": sum(w["launches"]["wgl_frontier_wide"]
                                    for w in main_k["wide"]),
        **dc_launches("wgl_frontier_wide")}
    emit({"kernels": [{
        "name": "wgl_frontier", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/wgl_frontier.cu",
        "replaces": "jepsen_tpu/ops/pallas_wgl.py:190",
        "launches": wk["launches"],
        "launches_by_path": {"check_batch": oplist["launches"],
                             "check_synth": wk["launches"],
                             "check_synth_scheduler": sl["wgl_frontier"],
                             "check_batch_scheduler":
                                 sides["wgl_frontier"],
                             "online_path": onl["launches"],
                             **dc_launches("wgl_frontier")},
        "parity": True,
        "max_abs_err": max(wgl_err, oplist["max_abs_err"],
                           wk["max_abs_err"],
                           sched["single"]["max_abs_err"]),
        "ms": wk["ms"], "plain_ms": wk["plain_ms"],
        "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
        "library_ms": None, "wrapper_ms": wk["wrapper_ms"],
        "tier": wk["tier"], "w_warp": L.cuda_wgl.W_WARP,
        "scheduler_path": {k: sched["single"][k] for k in (
            "launches", "ms", "wrapper_ms", "bound_ms", "bound_by")}}, {
        "name": "wgl_frontier_wide", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/wgl_frontier.cu",
        "replaces": "jepsen_tpu/ops/pallas_wgl.py:190",
        "launches": sum(wide_by_path.values()),
        "launches_by_path": wide_by_path, "parity": True,
        "max_abs_err": wgl_err, "ms": dk["healthy"]["k1_ms"],
        "plain_ms": dk["healthy"]["k1"]["plain_ms"], "plain_on": "cuda",
        "plain_rows": dk["healthy"]["k1"]["plain_rows"],
        "plain_rows_of": dk["healthy"]["k1"]["plain_rows_of"],
        "bound_ms": dk["healthy"]["k1"]["bound_ms"],
        "bound_by": dk["healthy"]["k1"]["bound_by"], "library_ms": None,
        "timing_batch": "dc headline, healthy, every K1 launch of its dc "
                        "run",
        "dc_runs": {b: {"k1_ms": r["k1_ms"], **{k: r["k1"][k] for k in (
            "plain_ms", "plain_rows", "bound_ms", "bound_by", "needed_ops",
            "bytes", "launches")}} for b, r in dk.items()},
        "check_synth_wide_w17": [{k: w[k] for k in ("invalid", "k1_ms",
                                                    "k1_plans")}
                                 for w in main_k["wide"]]}, {
        "name": "synth_device", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/synth_device.cu",
        "replaces": "jepsen_tpu/ops/synth_device.py:361",
        "launches": sk["launches"],
        "launches_by_path": {"check_synth": sk["launches"],
                             "check_synth_scheduler": sl["synth_device"],
                             "run_synth_seeds":
                                 camp["launches"]["synth_device"],
                             "fuzz": fz["launches"]["synth_device"]},
        "parity": True,
        "max_abs_err": max(synth_err, sk["max_abs_err"]),
        "ms": sk["ms"], "wrapper_ms": sk["wrapper_ms"],
        "plain_ms": sk["plain_ms"],
        "bound_ms": sk["bound_ms"], "bound_by": sk["bound_by"],
        "library_ms": None}, {
        "name": "synth_wide", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/synth_device.cu",
        "replaces": "jepsen_tpu/ops/synth_device.py:735",
        "launches": sum(wide_gen_by_path.values()),
        "launches_by_path": wide_gen_by_path, "parity": True,
        "max_abs_err": synth_err,
        **{k: wg[k] for k in ("ms", "timed", "wrapper_ms", "floor_ms",
                              "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "timing_batch": f"{WIDE_ROWS} rows, width 17"},
        {
        "name": "wgl_frontier_group", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/wgl_frontier.cu",
        "replaces": "jepsen_tpu/ops/linearize.py:355",
        "launches": sl["wgl_frontier_group"],
        "launches_by_path": {"check_synth_scheduler":
                             sl["wgl_frontier_group"],
                             "check_batch_scheduler":
                                 sides["wgl_frontier_group"],
                             **dc_launches("wgl_frontier_group")},
        "parity": True,
        "max_abs_err": max(group_err, gk["max_abs_err"]),
        "ms": gk["ms"], "plain_ms": gk["plain_ms"],
        "bound_ms": gk["bound_ms"], "bound_by": gk["bound_by"],
        "library_ms": None, "wrapper_ms": gk["wrapper_ms"],
        "w_warp": L.cuda_wgl.W_WARP,
        "members_by_tier_and_W": gk["members_by_tier_and_W"]},
        closure_entry("graph_closure", "jepsen_tpu/ops/graph.py:416",
                      "check_graphs_batch", gb, gw, closure_err),
        closure_entry("txn_closure", "jepsen_tpu/ops/txn_graph.py:412",
                      "certify_batch", ib, iw, closure_err),
        fold_entry("fold_counts", "jepsen_tpu/ops/folds.py:137,151,233,309,"
                   "365", folds, fold_err),
        fold_entry("counter_scan", "jepsen_tpu/ops/folds.py:410", folds,
                   fold_err),
        fold_entry("queue_scan", "jepsen_tpu/ops/folds.py:517", folds,
                   fold_err),
        fold_entry("fifo_scan", "jepsen_tpu/ops/folds.py:574", folds,
                   fold_err),
        dc_entry(probe, (dch, dcf, dcw), route, dc_err), {
        "name": "wgl_frontier_instrument", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/wgl_frontier.cu",
        "replaces": "jepsen_tpu/ops/linearize.py:158,243",
        "launches": inst["launches"],
        "launches_by_path": {"measure_closure_iters": inst["launches"]},
        "parity": True, "max_abs_err": inst["max_abs_err"],
        "ms": inst["ms"], "wrapper_ms": inst["wrapper_ms"],
        "plain_ms": inst["plain_ms"], "bound_ms": inst["bound_ms"],
        "bound_by": inst["bound_by"], "library_ms": None,
        "k1_ms": inst["k1_ms"], "headline": inst["headline"]}, {
        "name": "wgl_frontier_resume", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/wgl_frontier.cu",
        "replaces": "jepsen_tpu/ops/linearize.py:158",
        "launches": onl["launches"],
        "launches_by_path": {"online_path": onl["launches"]},
        "parity": True, "max_abs_err": onl["plain"]["err"],
        "ms": onl["plain"]["ms"], "plain_ms": onl["plain"]["plain_ms"],
        "plain_on": "cuda", "bound_ms": onl["plain"]["bound_ms"],
        "bound_by": onl["plain"]["bound_by"], "library_ms": None,
        "timing_batch": f"every resume launch of the online path "
                        f"({onl['plain']['launches']}), the plain version "
                        f"batched in {onl['plain']['groups']} calls",
        "all_launches_ms": onl["device_ms"], "floor_ms": onl["floor_ms"],
        "by_shape": onl["by_shape"]},
        la_entry(la, la_err)] + mesh_entries(mesh, mesh_err, mesh_tiers)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
