"""The port's columnar path against the reference, field for field.

``ops_to_columnar``/``columnar_to_ops``, ``encode_columnar`` and the
entry points ``check_columnar``, ``check_batch_columnar`` and
``check_synth`` on the CPU (``device="cpu"``: the plain versions of both
kernels) with ``scheduler=False, partition=False`` (the exact-W oracle
path) must match the reference's with the same flags (and
``native=False`` for the walks): the same arrays,
the same buckets, the same verdict arrays and result dicts. Batches stay
small (at most 48 histories of at most 60 ops) so the reference compiles
few (V, W) shapes. Tolerance: none (array and dict equality).
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.history.columnar import (columnar_to_ops as r_to_ops,
                                         ops_to_columnar as r_to_cols)
from jepsen_tpu.history.ops import info_op as r_info
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops import synth_device as RS
from jepsen_tpu.ops.encode import encode_columnar as r_encode_columnar
from jepsen_tpu.ops.statespace import enumerate_statespace as r_space
from jepsen_tpu.workloads.synth import synth_cas_batch as r_synth

from jepsen_torch.convert import cols_from_arrays
from jepsen_torch.history.columnar import columnar_to_ops, ops_to_columnar
from jepsen_torch.history.ops import info_op as p_info
from jepsen_torch.models.core import cas_register as p_cas
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops import synth_device as PS
from jepsen_torch.ops.encode import encode_columnar
from jepsen_torch.ops.statespace import enumerate_statespace
from jepsen_torch.workloads.synth import synth_cas_batch as p_synth

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

CORPUS = dict(seed0=404, n_procs=4, n_ops=40, n_values=3, corrupt=0.35,
              p_info=0.15)
# Invalid rows (corrupt), timeouts and crashes; pending windows of 3 to
# 9, so some rows overflow MAX_SLOTS.
CAS_SPEC = dict(family="cas", n=48, seed=21, n_procs=3, n_ops=60,
                n_values=4, corrupt=0.5, p_info=0.02, crash_lo=50,
                crash_hi=54, p_crash=0.5)
MAX_SLOTS = 6


def corpora(n=24):
    """Seeded Op-list corpus in both packages (the same generator): fail,
    info and read ops, plus a nemesis op the walk must skip."""
    r, p = r_synth(n, **CORPUS), p_synth(n, **CORPUS)
    r[0].insert(3, r_info("nemesis", "start"))
    p[0].insert(3, p_info("nemesis", "start"))
    for h in r + p:
        for i, op in enumerate(h):
            op.index = i
    return r, p


def test_ops_to_columnar_matches_reference():
    r, p = corpora()
    rc = r_to_cols(r_cas(), r, native=False)
    pc = ops_to_columnar(p_cas(), p)
    for f in ("type", "process", "kind", "index"):
        a, b = getattr(pc, f), getattr(rc, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert pc.kinds == rc.kinds
    assert (pc.type == -1).any() and (pc.type == 2).any()
    for row in range(pc.batch):
        for propagated in (False, True):
            want = [o.to_dict() for o in r_to_ops(rc, row, propagated)]
            got = [o.to_dict() for o in columnar_to_ops(pc, row,
                                                        propagated)]
            assert got == want


def _bucket_fields(b):
    return {"ev_type": b.ev_type, "ev_slot": b.ev_slot,
            "ev_slots": b.ev_slots, "ev_opidx": b.ev_opidx,
            "target": np.asarray(b.target), "V": b.V, "W": b.W,
            "indices": b.indices, "shared_target": b.shared_target,
            "w_live": b.w_live, "orig_n_events": b.orig_n_events,
            "failures": b.failures}


@pytest.mark.parametrize("max_slots", [MAX_SLOTS, 16])
def test_encode_columnar_matches_reference(max_slots):
    rc, _ = RS.synth_cas_device(RS.SynthSpec(**CAS_SPEC), backend="numpy")
    pc = cols_from_arrays(rc)
    rb, rf = r_encode_columnar(r_space(r_cas(), rc.kinds, 64), rc,
                               max_slots=max_slots, native=False)
    pb, pf = encode_columnar(enumerate_statespace(p_cas(), pc.kinds, 64),
                             pc, max_slots=max_slots)
    assert pf == rf
    assert len(pb) == len(rb) > 1
    for b, w in zip(pb, rb):
        got, want = _bucket_fields(b), _bucket_fields(w)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k
            else:
                assert got[k] == want[k], k
    if max_slots == MAX_SLOTS:
        assert rf


def test_encode_columnar_refuses_fusion():
    """Fusion and renumbering are ported (tests/test_torch_fusion.py
    holds their arrays against the reference): the flags the oracle
    leaves off now encode, keep every row, and leave the failures as
    they were."""
    pc, _ = PS.synth_cas_device(PS.SynthSpec(**CAS_SPEC), device="cpu")
    space = enumerate_statespace(p_cas(), pc.kinds, 64)
    plain, pf = encode_columnar(space, pc, max_slots=MAX_SLOTS)
    for kw in ({"fuse": True}, {"renumber": True}):
        bs, fails = encode_columnar(space, pc, max_slots=MAX_SLOTS, **kw)
        assert fails == pf
        assert sorted(i for b in bs for i in b.indices) == \
            sorted(i for b in plain for i in b.indices)


@pytest.fixture(scope="module")
def synth_cols():
    rc, _ = RS.synth_cas_device(RS.SynthSpec(**CAS_SPEC), backend="numpy")
    return rc, cols_from_arrays(rc)


@pytest.mark.parametrize("details", [False, True, "invalid"])
def test_check_columnar_matches_reference(synth_cols, details):
    rc, pc = synth_cols
    want = R.check_columnar(r_cas(), rc, max_slots=MAX_SLOTS,
                            details=details, scheduler=False,
                            partition=False)
    got = L.check_columnar(p_cas(), pc, device="cpu", max_slots=MAX_SLOTS,
                           details=details, scheduler=False,
                           partition=False)
    if details is False:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert not got[0].all()
    else:
        assert got == want
        # overflow rows went to the host engine with the same reason
        fell = [r for r in got if "fallback" in r]
        assert fell and all(r["provenance"] == "host-fallback"
                            for r in fell)
        assert any(r["valid"] is False for r in got)


@pytest.mark.parametrize("details", [True, "invalid"])
def test_check_batch_columnar_matches_reference(details):
    r, p = corpora(16)
    want = R.check_batch_columnar(r_cas(), r, details=details,
                                  max_slots=MAX_SLOTS, scheduler=False,
                                  partition=False)
    got = L.check_batch_columnar(p_cas(), p, device="cpu", details=details,
                                 max_slots=MAX_SLOTS, scheduler=False,
                                 partition=False)
    assert got == want
    assert any(w["valid"] is False for w in want)


def test_check_batch_columnar_explosion_falls_back_to_check_batch():
    """A vocabulary whose state space passes max_states leaves the
    columnar path for the per-history one, in both packages."""
    kw = dict(seed0=9, n_procs=3, n_ops=12, n_values=12, corrupt=0.5)
    r, p = r_synth(6, **kw), p_synth(6, **kw)
    want = R.check_batch_columnar(r_cas(), r, max_states=8,
                                  scheduler=False, partition=False)
    got = L.check_batch_columnar(p_cas(), p, device="cpu", max_states=8,
                                 scheduler=False, partition=False)
    assert got == want
    assert got == L.check_batch(p_cas(), p, device="cpu", max_states=8,
                                scheduler=False, partition=False)


@pytest.mark.parametrize("spec", [
    CAS_SPEC,
    dict(family="wide", n=8, seed=4, width=6, n_values=2, invalid=False),
    dict(family="wide", n=8, seed=4, width=6, n_values=2, invalid=True),
], ids=["cas", "wide6_valid", "wide6_invalid"])
@pytest.mark.parametrize("details", [False, True])
def test_check_synth_matches_reference(spec, details):
    want = R.check_synth(r_cas(), RS.SynthSpec(**spec), synth="numpy",
                         scheduler=False, partition=False, details=details,
                         max_slots=8)
    got = L.check_synth(p_cas(), PS.SynthSpec(**spec), device="cpu",
                        details=details, max_slots=8, scheduler=False,
                        partition=False)
    if details is False:
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        valid = got[0]
    else:
        assert got == want
        valid = np.array([r["valid"] for r in got])
    if spec["family"] == "wide":
        assert (valid == (not spec["invalid"])).all()
    else:
        assert not valid.all() and valid.any()


def test_check_synth_returns_meta_and_timings():
    spec = PS.SynthSpec(**CAS_SPEC)
    split = {}
    (v, b), meta = L.check_synth(p_cas(), spec, device="cpu",
                                 return_meta=True, timings=split)
    assert meta.spec == spec and meta.peak_w.shape == (spec.n,)
    assert meta.key_peak_w is None
    assert set(split) == {"synth_s", "encode_s", "device_s", "fallback_s"}
    assert all(t >= 0 for t in split.values())


def test_keyed_batches_are_refused():
    """Keyed batches are no longer refused: the per-key partition is
    ported (tests/test_torch_partition.py). On the exact path a keyed
    batch partitions by default, as in the reference."""
    spec = dict(CAS_SPEC, n_keys=3)
    got = L.check_synth(p_cas(), PS.SynthSpec(**spec), device="cpu",
                        scheduler=False)
    want = R.check_synth(r_cas(), RS.SynthSpec(**spec), synth="numpy",
                         scheduler=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    cols, _ = PS.synth_cas_device(PS.SynthSpec(**spec), device="cpu")
    v, b = L.check_columnar(p_cas(), cols, device="cpu", scheduler=False)
    np.testing.assert_array_equal(v, got[0])
    np.testing.assert_array_equal(b, got[1])
