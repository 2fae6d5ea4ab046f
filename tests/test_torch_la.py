"""The port's list-append generator (K8c) and its path into the graph
checker, against the reference.

``plain_la_core`` (the plain PyTorch version of the CUDA kernel, which
``synth_la_device(device="cpu")`` runs) must give every LaBatch field bit
for bit equal to the reference's ``_la_core`` under numpy over the whole
grid of processes, keys, op counts and corruption rates, and equal to the
reference's ``synth_la_device(backend="device")`` (jax on the CPU) on a
set of shapes that takes every value of that grid. ``decode_la`` must
give the reference's Op lists, and the la path (``synthesize`` ->
``decode_la`` -> ``check_graphs_batch(family="list-append")``) the
reference's result dicts, corrupted rows invalid with a G2 cycle. The
CUDA kernel is held against the plain version on the card by
chip_smoke.py. Tolerance: none.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.cycle import check_graphs_batch as r_check
from jepsen_tpu.ops import graph as RG
from jepsen_tpu.ops import synth_device as R

from jepsen_torch.checkers.cycle import check_graphs_batch
from jepsen_torch.ops import cuda_synth
from jepsen_torch.ops import graph as G
from jepsen_torch.ops import synth_device as S

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

FIELDS = ("type", "process", "fn", "key", "val", "corrupted")
PROCS, KEYS, OPS, CORRUPT = (1, 2, 5), (1, 2, 3, 17), (1, 2, 40), \
    (0.0, 0.6, 1.0)
GRID = list(itertools.product(PROCS, KEYS, OPS, CORRUPT))
# Shapes for the jax side: every value of the grid at least once, each
# compiled once for all three corruption rates (a dynamic argument).
JAX_SHAPES = ((1, 1, 1), (2, 2, 2), (5, 3, 40), (2, 17, 40), (1, 3, 2),
              (5, 17, 1), (5, 2, 40))
# The reference test's corpus (tests/test_synth_device.py:160).
PATH_SPEC = dict(family="la", n=24, seed=5, n_procs=4, n_ops=16, n_keys=2,
                 corrupt=0.6)


def la_spec(P, K, ops, c, **kw):
    return dict(dict(family="la", n=24, seed=5, n_procs=P, n_ops=ops,
                     n_keys=K, corrupt=c), **kw)


def assert_batch_equal(got, want):
    assert got.n_keys == want.n_keys
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("P,K,n,c", GRID,
                         ids=[f"p{P}-k{K}-n{n}-c{c}" for P, K, n, c in GRID])
def test_plain_la_core_matches_reference(P, K, n, c):
    fields = la_spec(P, K, n, c)
    rspec, pspec = R.SynthSpec(**fields), S.SynthSpec(**fields)
    kd = R._resolve_keys(rspec, None, None)
    want = R._la_core(np, kd, R._thresh24(c), n_procs=P, n_ops=n, n_keys=K)
    keys, ct = S.la_inputs(pspec, device="cpu")
    got = S.plain_la_core(keys, ct, **S.la_static(pspec))
    assert set(got) == set(want)
    for f in FIELDS:
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    batch = S.synth_la_device(pspec, device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(batch, f), got[f].numpy()), f


@pytest.fixture(scope="module")
def jax_batches():
    """The reference's jitted generator on every JAX_SHAPES shape and
    corruption rate, computed once for the module."""
    return {(P, K, n, c): R.synth_la_device(R.SynthSpec(**la_spec(
                P, K, n, c)), backend="device")
            for P, K, n in JAX_SHAPES for c in CORRUPT}


@pytest.mark.parametrize("P,K,n", JAX_SHAPES,
                         ids=[f"p{P}-k{K}-n{n}" for P, K, n in JAX_SHAPES])
def test_synth_la_device_matches_jitted_reference(jax_batches, P, K, n):
    for c in CORRUPT:
        want = jax_batches[(P, K, n, c)]
        got = S.synth_la_device(S.SynthSpec(**la_spec(P, K, n, c)),
                                device="cpu")
        assert_batch_equal(got, want)
        for f in FIELDS:
            assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert any(jax_batches[(P, K, n, c)].corrupted.any()
               for c in CORRUPT) or n < 3


def test_corruption_hits_rows():
    """The grid really reaches the corruption pick (a stale read needs an
    earlier completed append to its key)."""
    b = S.synth_la_device(S.SynthSpec(**la_spec(5, 2, 40, 1.0)),
                          device="cpu")
    assert b.corrupted.sum() > b.batch // 2


def test_row_slice_equals_the_full_batch():
    spec = S.SynthSpec(**la_spec(5, 3, 40, 0.6, n=50))
    full = S.synth_la_device(spec, device="cpu")
    a = S.synth_la_device(spec, rows=(0, 17), device="cpu")
    b = S.synth_la_device(spec, rows=(17, 50), device="cpu")
    for f in FIELDS:
        assert np.array_equal(np.concatenate([getattr(a, f),
                                              getattr(b, f)]),
                              getattr(full, f)), f


def test_explicit_keys_match_reference():
    fields = la_spec(4, 3, 40, 0.6)
    rows = np.array([5, 5, 17, 40, 2], np.uint32)
    keys = R.history_keys_for(fields["seed"], rows)
    keys["sched"][1] = R.fold_in(np, keys["sched"][1], np.uint32(0xF00D))
    want = R.synth_la_device(R.SynthSpec(**fields), keys=keys,
                             backend="numpy")
    got = S.synth_la_device(S.SynthSpec(**fields), keys=keys, device="cpu")
    assert_batch_equal(got, want)


def op_fields(ops):
    return [(o.index, o.process, o.type, o.f, o.value, o.time)
            for o in ops]


@pytest.fixture(scope="module")
def path_batches():
    return (R.synth_la_device(R.SynthSpec(**PATH_SPEC), backend="numpy"),
            S.synthesize(S.SynthSpec(**PATH_SPEC), device="cpu"))


def test_decode_la_matches_reference(path_batches):
    rb, (pb, meta) = path_batches
    assert meta is None and isinstance(pb, S.LaBatch)
    assert_batch_equal(pb, rb)
    for r in range(pb.batch):
        assert op_fields(S.decode_la(pb, r)) == \
            op_fields(R.decode_la(rb, r)), r


def test_la_path_result_dicts_match_reference(path_batches):
    """The port's twin of test_la_corruption_is_a_g2_anomaly: the la
    path's result dicts equal the reference checker's on the same
    decoded histories, corrupted rows invalid with a G2 cycle, clean
    rows valid, and the host oracle agrees."""
    rb, (pb, _) = path_batches
    want = r_check([R.decode_la(rb, r) for r in range(rb.batch)],
                   family="list-append")
    hists = [S.decode_la(pb, r) for r in range(pb.batch)]
    got = check_graphs_batch(hists, family="list-append", device="cpu")
    assert got == want
    assert pb.corrupted.sum() > 0, "corpus never corrupted: vacuous"
    for r, res in enumerate(got):
        if pb.corrupted[r]:
            assert res["valid"] is False and res["anomaly"] == "G2", r
        else:
            assert res["valid"] is True, r
        host = G.check_graph_host(G.extract_graph(hists[r], "list-append"))
        assert {**res, "provenance": "host"} == host, r
        assert host == RG.check_graph_host(RG.extract_graph(
            R.decode_la(rb, r), "list-append")), r


def test_check_synth_still_refuses_la():
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import linearize as L
    with pytest.raises(ValueError):
        L.check_synth(cas_register(), S.SynthSpec(**PATH_SPEC),
                      device="cpu")


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatcher runs the plain version; the CUDA wrapper
    itself takes only CUDA tensors and never falls back."""
    spec = S.SynthSpec(**PATH_SPEC)
    keys, ct = S.la_inputs(spec, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_synth.synth_la(keys, ct, **S.la_static(spec))
    out = S.la_core(keys, ct, **S.la_static(spec))
    assert out["type"].shape == (spec.n, 2 * spec.n_ops)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = S.SynthSpec(**PATH_SPEC)
    for call in (lambda: S.synth_la_device(spec),
                 lambda: S.synthesize(spec)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert S.synth_la_device(spec, device="cpu").batch == spec.n


@pytest.mark.parametrize("bad", [dict(n_procs=0), dict(n_ops=0),
                                 dict(n_keys=0)])
def test_degenerate_shapes_raise(bad):
    spec = dataclasses.replace(S.SynthSpec(**PATH_SPEC), **bad)
    with pytest.raises(ValueError):
        S.synth_la_device(spec, device="cpu")
