"""The port's history generators against the reference, bit for bit.

``jepsen_torch.ops.synth_device.synth_cas_device(device="cpu")`` (the
plain PyTorch version of the generator kernel) must give arrays and
metadata digest-identical to the reference's ``synth_cas_device`` under
``backend="numpy"`` and ``backend="device"`` (jax on the CPU); the same
for the wide-window family. The CUDA kernel is held against the plain
version on the card by chip_smoke.py. Tolerance: none (digests of the
raw bytes).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import synth_device as R

from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops import synth_device as S

# The reference test file's keyed and fault-scheduled specs, then the
# edges of the generator: unkeyed with and without corruption, one value
# (no corruption possible), one process (no concurrency), one and two
# ops (the closed-form schedule's smallest cases).
SPEC = dict(family="cas", n=64, seed=3, n_procs=4, n_ops=18, n_values=3,
            n_keys=3, corrupt=0.4, p_info=0.1)
FAULT_SPEC = dict(family="cas", n=48, seed=11, n_procs=4, n_ops=18,
                  n_values=3, p_info=0.15, crash_lo=4, crash_hi=12,
                  p_crash=0.5)
UNKEYED = dict(family="cas", n=40, seed=5, n_procs=5, n_ops=30, n_values=4)
CAS_SPECS = {
    "spec": SPEC,
    "fault_spec": FAULT_SPEC,
    "unkeyed_corrupt": dict(UNKEYED, corrupt=0.6),
    "unkeyed_clean": UNKEYED,
    "one_value": dict(UNKEYED, n_values=1, corrupt=0.6),
    "one_proc": dict(UNKEYED, n_procs=1, corrupt=0.6, p_info=0.2),
    "one_op": dict(UNKEYED, n_procs=5, n_ops=1, corrupt=0.6),
    "two_ops": dict(UNKEYED, n_procs=5, n_ops=2, corrupt=0.6, p_info=0.3),
}
WIDE_SPECS = {f"w{w}_{'invalid' if inv else 'valid'}":
              dict(family="wide", n=6, seed=2, width=w, n_values=2,
                   invalid=inv)
              for w in (6, 17) for inv in (False, True)}


def digest(cols, meta=None) -> str:
    """The reference test file's digest: fields, key column, metadata."""
    h = hashlib.sha256()
    for arr in (cols.type, cols.process, cols.kind):
        h.update(np.ascontiguousarray(arr).tobytes())
    if getattr(cols, "key", None) is not None:
        h.update(np.ascontiguousarray(cols.key).tobytes())
    if meta is not None:
        h.update(np.ascontiguousarray(meta.peak_w).tobytes())
        if meta.key_peak_w is not None:
            h.update(np.ascontiguousarray(meta.key_peak_w).tobytes())
    return h.hexdigest()


def both(fields):
    return R.SynthSpec(**fields), S.SynthSpec(**fields)


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("name", sorted(CAS_SPECS))
def test_cas_generator_matches_reference(name, backend):
    rspec, pspec = both(CAS_SPECS[name])
    rc, rm = R.synth_cas_device(rspec, backend=backend)
    pc, pm = S.synth_cas_device(pspec, device="cpu")
    assert digest(pc, pm) == digest(rc, rm)
    for f in ("type", "process", "kind", "key"):
        a, b = getattr(pc, f), getattr(rc, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
    if rm.key_present is not None:
        assert np.array_equal(pm.key_present, rm.key_present)
    else:
        assert pm.key_present is None
    assert pc.kinds == rc.kinds


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("name", sorted(WIDE_SPECS))
def test_wide_generator_matches_reference(name, backend):
    rspec, pspec = both(WIDE_SPECS[name])
    rc, rm = R.synth_wide_device(rspec, backend=backend)
    pc, pm = S.synth_wide_device(pspec, device="cpu")
    assert digest(pc, pm) == digest(rc, rm)
    assert pc.kinds == rc.kinds


def test_corrupted_rows_exist():
    """The corrupt spec really perturbs reads (the digest cases would
    otherwise not reach the corruption pick)."""
    spec = S.SynthSpec(**CAS_SPECS["unkeyed_corrupt"])
    clean = S.synth_cas_device(dataclasses.replace(spec, corrupt=0.0),
                               device="cpu")[0]
    hit = S.synth_cas_device(spec, device="cpu")[0]
    assert (clean.kind != hit.kind).any(axis=1).sum() > 5


@pytest.mark.parametrize("name", ["spec", "fault_spec"])
def test_row_slices_equal_the_full_batch(name):
    spec = S.SynthSpec(**CAS_SPECS[name])
    full, fm = S.synth_cas_device(spec, device="cpu")
    a, am = S.synth_cas_device(spec, rows=(0, 20), device="cpu")
    b, bm = S.synth_cas_device(spec, rows=(20, spec.n), device="cpu")
    for f in ("type", "process", "kind", "key"):
        if getattr(full, f) is not None:
            assert np.array_equal(np.concatenate(
                [getattr(a, f), getattr(b, f)]), getattr(full, f)), f
    assert np.array_equal(np.concatenate([am.peak_w, bm.peak_w]),
                          fm.peak_w)
    if fm.key_peak_w is not None:
        assert np.array_equal(np.concatenate(
            [am.key_peak_w, bm.key_peak_w]), fm.key_peak_w)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cas = S.SynthSpec(**UNKEYED)
    wide = S.SynthSpec(**WIDE_SPECS["w6_valid"])
    for call in (lambda: S.synth_cas_device(cas),
                 lambda: S.synth_wide_device(wide),
                 lambda: S.synthesize(cas),
                 lambda: L.check_synth(cas_register(), cas)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert S.synthesize(cas, device="cpu")[0].batch == cas.n


def test_la_family_synthesizes_but_check_synth_refuses_it():
    """The la family generates (its rows lower to dependency graphs for
    checkers.cycle), but check_synth takes only the columnar families,
    as the reference's does."""
    la = S.SynthSpec(family="la", n=4, n_ops=8)
    batch, meta = S.synthesize(la, device="cpu")
    assert isinstance(batch, S.LaBatch) and meta is None
    assert batch.batch == 4 and batch.n_lines == 16
    with pytest.raises(ValueError):
        L.check_synth(cas_register(), la, device="cpu")


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatcher runs the plain version; the CUDA
    wrapper itself takes only CUDA tensors and never falls back."""
    from jepsen_torch.ops import cuda_synth
    spec = S.SynthSpec(**UNKEYED)
    args = S.cas_inputs(spec, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_synth.synth_cas(*args, **S.cas_static(spec))
    out = S.cas_core(*args, **S.cas_static(spec))
    assert out["type"].shape == (spec.n, 2 * spec.n_ops)


def test_explicit_keys_and_crash_windows_match_reference():
    """A neighbourhood batch: explicit stream keys and per-row crash
    windows, as the reference's fuzz loop passes them."""
    fields = dict(FAULT_SPEC, corrupt=0.5)
    rspec, pspec = both(fields)
    rows = np.array([5, 5, 17, 40, 2], np.uint32)
    keys = R.history_keys_for(fields["seed"], rows)
    keys["sched"][1] = R.fold_in(np, keys["sched"][1], np.uint32(0xF00D))
    lo = np.array([0, 4, 8, 2, 16], np.int32)
    hi = np.array([18, 9, 12, 3, 18], np.int32)
    rc, rm = R.synth_cas_device(rspec, keys=keys, crash_lo=lo, crash_hi=hi,
                                backend="numpy")
    pc, pm = S.synth_cas_device(pspec, keys=keys, crash_lo=lo, crash_hi=hi,
                                device="cpu")
    assert digest(pc, pm) == digest(rc, rm)
    ref_keys = R.history_keys_for(fields["seed"], rows)
    assert all(np.array_equal(S.history_keys_for(fields["seed"], rows)[s],
                              ref_keys[s]) for s in S.STREAMS)
