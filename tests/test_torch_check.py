"""The port's entry points against the reference, field for field.

``jepsen_torch.ops.linearize.check_batch(device="cpu", scheduler=False,
partition=False)`` (the exact-W oracle path: encoder, plain version of
the kernel, host decode) must return the same result dicts as
``jepsen_tpu.ops.linearize.check_batch_tpu(scheduler=False,
partition=False)`` and as both packages' host oracles ``wgl_check``.
Windows stay at W <= 16: the reference's test mesh hosts wider windows on
its frontier route, where one GPU hands the rows to the host engine.
Also: ``convert.batch_from_arrays`` on reference-encoded buckets, and
frontier carries exported by the reference and imported by the port.
Tolerance: none (dict and array equality).
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.linearizable import (prepare_history as r_prepare,
                                              wgl_check as r_wgl)
from jepsen_tpu.history.ops import invoke_op as r_invoke, ok_op as r_ok
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops.encode import bucket_encode as r_bucket_encode
from jepsen_tpu.workloads.synth import synth_cas_batch as r_synth

from jepsen_torch.checkers.linearizable import (linearizable,
                                                wgl_check as p_wgl)
from jepsen_torch.convert import batch_from_arrays
from jepsen_torch.history.ops import invoke_op as p_invoke, ok_op as p_ok
from jepsen_torch.models.core import cas_register as p_cas
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.encode import EncodedBatch
from jepsen_torch.workloads.synth import synth_cas_batch as p_synth

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

CORPUS = dict(seed0=101, n_procs=4, n_ops=24, n_values=3, corrupt=0.35,
              p_info=0.15)


def corpora(n=30, wide=True):
    """Seeded corpus with invalid rows and info ops, plus (``wide``) one
    history whose pending window overflows max_slots=5: an encode
    failure that goes to the host engine."""
    r, p = r_synth(n, **CORPUS), p_synth(n, **CORPUS)
    if wide:
        r += r_synth(1, seed0=7, n_procs=9, n_ops=40, p_info=0.3)
        p += p_synth(1, seed0=7, n_procs=9, n_ops=40, p_info=0.3)
    return r, p


@pytest.fixture(scope="module")
def checked():
    r, p = corpora()
    got = L.check_batch(p_cas(), p, device="cpu", max_slots=5,
                        scheduler=False, partition=False)
    want = R.check_batch_tpu(r_cas(), r, max_slots=5, scheduler=False,
                             partition=False)
    return r, p, got, want


def test_check_batch_matches_check_batch_tpu(checked):
    _, _, got, want = checked
    assert got == want
    assert any(w["valid"] is False for w in want)
    assert any("fallback" in w for w in want)


def test_check_batch_matches_both_host_oracles(checked):
    r, p, got, _ = checked
    for i, (g, rh, ph) in enumerate(zip(got, r, p)):
        for oracle in (p_wgl(p_cas(), ph), r_wgl(r_cas(), rh)):
            assert g["valid"] == oracle["valid"], i
            if oracle["valid"] is False:
                assert g["op"]["index"] == oracle["op"]["index"], i
            assert g.get("configs") == oracle.get("configs"), i


def test_default_window_matches_reference():
    r, p = corpora(n=24, wide=False)
    got = L.check_batch(p_cas(), p, device="cpu", scheduler=False,
                        partition=False)
    assert got == R.check_batch_tpu(r_cas(), r, scheduler=False,
                                    partition=False)


def test_invalid_config_sample_parity():
    def hist(invoke, ok):
        return [invoke(0, "write", 1), invoke(1, "write", 2),
                ok(0, "write", 1), ok(1, "write", 2),
                invoke(2, "read", None), ok(2, "read", 7)]
    want = R.check_one_tpu(r_cas(), hist(r_invoke, r_ok),
                           scheduler=False, partition=False)
    got = L.check_one(p_cas(), hist(p_invoke, p_ok), device="cpu",
                      scheduler=False, partition=False)
    assert got == want
    assert got["valid"] is False and got["configs"]


@pytest.mark.parametrize("backend,kw", [("host", {}),
                                        ("cuda", {"device": "cpu"})])
def test_linearizable_checker_backends(backend, kw):
    _, p = corpora(n=6, wide=False)
    chk = linearizable(backend, **kw)
    for h in p:
        got = chk.check({}, p_cas(), h)
        # the device backend streams through the scheduler, which tags
        # each result with the engine that decided it
        assert got.pop("provenance", "device") == "device"
        assert got == p_wgl(p_cas(), h)
    with pytest.raises(ValueError):
        linearizable("tpu")


def test_window_overflow_goes_to_the_host_engine():
    # W = 19 exceeds one card: the bucket raises WindowOverflow before
    # any launch, and run_buckets hands it back for host fallback.
    B, N, W = 2, 8, 19
    batch = EncodedBatch(
        ev_type=np.zeros((B, N), np.int8), ev_slot=np.zeros((B, N), np.int8),
        ev_slots=np.zeros((B, N, W), np.int8),
        ev_opidx=np.zeros((B, N), np.int32),
        target=np.full((B, 2, 8), -1, np.int32), V=8, W=W,
        indices=[0, 1], failures=[])
    (b, out), = L.run_buckets([batch], device="cpu")
    assert b is batch and isinstance(out, L.WindowOverflow)
    with pytest.raises(L.WindowOverflow):
        L.run_encoded_batch(batch, device="cpu")


def test_wide_window_routes(monkeypatch):
    """W = 17 takes the data1wide route (frontier in device memory on the
    card); MAX_FRONTIER_ELEMENTS chunks the batch."""
    monkeypatch.setattr(L, "MAX_FRONTIER_ELEMENTS", 1 << 17)
    B, N, W = 3, 2, 17
    batch = EncodedBatch(
        ev_type=np.full((B, N), 2, np.int8),
        ev_slot=np.zeros((B, N), np.int8),
        ev_slots=np.ones((B, N, W), np.int8),
        ev_opidx=np.zeros((B, N), np.int32),
        target=np.full((B, 2, 8), -1, np.int32), V=8, W=W,
        indices=[0, 1, 2], failures=[], w_live=1)
    L.DISPATCH_LOG.clear()
    valid, bad, front = L.run_encoded_batch(batch, True, device="cpu")
    assert L.DISPATCH_LOG[-1] == ("data1wide", 8, W, B)
    # every completion of an empty slot fails at event 0
    assert not valid.any() and (bad == 0).all()
    assert front.shape == (B, 1, 1 << W) and front[:, 0, 0].all()


def test_batch_from_arrays_feeds_reference_buckets():
    r, _ = corpora(n=20, wide=False)
    buckets = r_bucket_encode(r_cas(), [r_prepare(h) for h in r],
                              max_slots=16)
    for b in buckets:
        want = R.run_encoded_batch(b, return_frontier=True)
        got = L.run_encoded_batch(batch_from_arrays(b), True, device="cpu")
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
        pb = batch_from_arrays(b)
        assert pb.indices == b.indices and pb.spaces is None


def test_imported_reference_carry_resumes_identically():
    """A carry the reference wrote (export_frontier) resumes in the port
    exactly as in the reference, and the port writes the same row."""
    r, _ = corpora(n=4, wide=False)
    b = r_bucket_encode(r_cas(), [r_prepare(h) for h in r[3:4]])[0]
    V, W = b.V, b.W
    n = int((b.ev_type[0] != 0).sum())
    half = n // 2
    args = (b.target[0], b.ev_type[0, :half], b.ev_slot[0, :half],
            b.ev_slots[0, :half])
    rest = (b.target[0], b.ev_type[0, half:n], b.ev_slot[0, half:n],
            b.ev_slots[0, half:n])
    c1 = R.run_carried_events(V, W, args[0], *args[1:], 0,
                              R.frontier_carry_init(V, W))
    row = R.export_frontier(c1)
    carry = L.import_frontier(row, V, W)
    assert carry is not None
    want = R.run_carried_events(V, W, rest[0], *rest[1:], half, c1)
    got = L.run_carried_events(V, W, rest[0], *rest[1:], half, carry,
                               device="cpu")
    for k in ("valid", "bad", "F", "Fb"):
        np.testing.assert_array_equal(got[k], want[k])
    assert L.export_frontier(got) == R.export_frontier(want)
    # The port's own fresh carry equals the reference's.
    init = L.frontier_carry_init(V, W)
    for k, v in R.frontier_carry_init(V, W).items():
        np.testing.assert_array_equal(init[k], v)
    # Foreign or stale rows are cache misses, never errors.
    assert L.import_frontier(row, V, W + 1) is None
    assert L.import_frontier({"v": 1, "shape": [1, 1, 1 << W],
                              "F": "!", "Fb": "!"}, V, W) is None


def test_fused_bad_rows_matches_reference():
    """Rows whose first failure fell on an EV_FUSED step; invalid rows
    elsewhere and valid rows are not among them."""
    batch = EncodedBatch(
        ev_type=np.array([[2, 4, 2], [4, 2, 0], [2, 4, 3], [4, 4, 4]],
                         np.int8),
        ev_slot=np.zeros((4, 3), np.int8),
        ev_slots=np.zeros((4, 3, 2), np.int8),
        ev_opidx=np.zeros((4, 3), np.int32),
        target=np.full((4, 2, 8), -1, np.int32), V=8, W=2,
        indices=[0, 1, 2, 3], failures=[])
    valid = np.array([False, False, False, True])
    bad = np.array([1, 1, 1, R.INT32_MAX], np.int32)
    bad[2] = 0
    got = L.fused_bad_rows(batch, valid, bad)
    np.testing.assert_array_equal(got, R.fused_bad_rows(batch, valid, bad))
    np.testing.assert_array_equal(got, [0])


def test_grow_frontier_states_matches_reference():
    c = R.frontier_carry_init(8, 4)
    want = R.grow_frontier_states(c, 1, 2)
    got = L.grow_frontier_states(L.frontier_carry_init(8, 4), 1, 2)
    for k in ("F", "Fb"):
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        L.grow_frontier_states(got, 2, 1)
