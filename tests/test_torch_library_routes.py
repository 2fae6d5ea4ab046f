"""The whole-function library routes that ``chip_smoke.py`` times beside
the hand-written kernels (``library_ms`` in its kernels line), held bit
for bit to the kernels' plain versions on small CPU inputs, and the edge
rows it builds for the kernels' parity cases.

The port never calls these routes: they are yardsticks. ``chip_smoke.py``
is loaded by its path, as the script it is; it imports no jax.
Tolerance: none (integer and boolean outputs).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_torch.ops import cuda_dc, cuda_folds
from jepsen_torch.ops import dc_monitor as D
from jepsen_torch.ops import folds as F
from jepsen_torch.ops.graph import plain_graph_closure
from jepsen_torch.ops.txn_graph import plain_txn_closure

from _graph_planes import random_planes

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke_harness", Path(__file__).resolve().parents[1] /
    "chip_smoke.py")
CS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CS)


def same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("V", [1, 2, 31, 33, 200, 4096])
def test_queue_scan_library_matches_plain(V):
    """The stable sort by value, cumsum and scatter_reduce_ route: the
    multiset's counts, the verdict and the first missing dequeue."""
    rng = np.random.default_rng(V)
    lines = CS.fold_lines(rng, 12, 300, V, queue=True)
    ts = [torch.from_numpy(a) for a in lines]
    want = F.plain_queue_scan(*ts, V)
    same(CS.queue_scan_library(ts, V), want)
    assert set(want[0].tolist()) <= {0, 1}


def test_queue_scan_library_on_the_edge_rows():
    """The edge rows of chip_smoke's queue cases (misses at line 0, the
    last line, tile and chunk edges, of two values that one thread of
    the fold takes, a hot value) fail where they were put, in the plain
    version and in the library route."""
    N, V = 700, 600
    lines, firsts = CS.queue_edge_lines(N, V, cuda_folds.queue_plan(N, V))
    ts = [torch.from_numpy(a) for a in lines]
    want = F.plain_queue_scan(*ts, V)
    assert len(firsts) == 10
    assert want[1][:len(firsts)].tolist() == firsts
    assert want[0].tolist() == [0] * 11 + [1]
    same(CS.queue_scan_library(ts, V), want)


@pytest.mark.parametrize("entry", ["graph", "txn"])
@pytest.mark.parametrize("V", [8, 32, 64, 128])
def test_closure_library_matches_plain(entry, V):
    """The bfloat16 matmul squarings (the reference's algorithm) give the
    plain closure's cyc and node on every plane, the txn entry's derived
    SI plane included: seeded planes at three densities and the special
    planes (empty, self-loop, one edge, the V-long cycle)."""
    rng = np.random.default_rng(V)
    l_in = 3 if entry == "graph" else 4
    adj = np.concatenate([random_planes(rng, 4, l_in, V, d)
                          for d in (0.02, 0.1, 0.4)]
                         + [CS.graph_planes(rng, V, l_in, 1)[-4:]
                            .view(np.uint32)])
    t = torch.from_numpy(np.ascontiguousarray(adj).view(np.int32))
    plain = plain_graph_closure if entry == "graph" else plain_txn_closure
    want = plain(t, V)
    same(CS.closure_library(t, V, entry), want)
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("kind", ["pairs", "random", "one", "shifted"])
def test_dc_peel_library_matches_plain(kind):
    """K4's whole-function route (scatter_reduce_ amin and amax, argmin,
    gathers and the mask update a round), run for the plan's most
    rounds, decides every row as the plain version does: a round without
    progress changes nothing."""
    rng = np.random.default_rng(len(kind))
    for E in (1, 2, 33, 128, 300):
        ts = [torch.from_numpy(a) for a in CS.dc_plan_rows(rng, 6, E, kind)]
        decided, rounds = D.plain_dc_peel(*ts)
        same([CS.dc_peel_library(*ts, int(rounds.max()))], [decided])
        # Fewer rounds leave the rows that need more undecided.
        short = CS.dc_peel_library(*ts, max(int(rounds.max()) - 1, 0))
        assert not (short & ~decided).any()


def test_dc_parity_cases_reach_every_tier_and_cap():
    """chip_smoke's K4 parity cases: every tier, both caps in each, and
    shifted rows whose least alive event's cluster is not 0."""
    cases = CS.dc_cases(np.random.default_rng(8))
    tiers = {cuda_dc.tier(inv.shape[1]) for _, inv, _, _, _ in cases}
    assert tiers == {"warp", "smem", "global"}
    capped = {(cuda_dc.tier(inv.shape[1]), cap)
              for _, inv, _, _, cap in cases if cap}
    assert capped == {(t, c) for t in tiers for c in CS.DC_PARITY_CAPS}
    for label, inv, cl, act, _ in cases:
        if label.startswith("shifted") and inv.shape[1] > 1:
            first = act.argmax(1)
            assert (cl[np.arange(len(cl)), first] != 0).any(), label
