"""The port's event fusion, state renumbering, bucket merging and the
plain version of the group launch, against the reference.

``fuse_walked`` on random walks, ``encode_columnar(fuse=True,
renumber=True)`` and ``encode_history(fuse=True)`` must give the
reference's arrays; ``widen_batch``/``merge_batches`` over renumbered
groups must give the reference's arrays and verdicts; and
``plain_fused_wgl`` (what a group launch computes) must equal the
reference's ``get_fused_kernel`` bit for bit on the CPU. Inputs are made
from seeds with numpy (or each package's own copy of the synthesizer)
and stay small. Tolerance: none (array equality, dtypes included).
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.linearizable import prepare_history as r_prepare
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import encode as r_enc
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops import synth_device as RS
from jepsen_tpu.ops.statespace import enumerate_statespace as r_space
from jepsen_tpu.workloads.synth import synth_cas_batch as r_synth

from jepsen_torch.checkers.linearizable import prepare_history as p_prepare
from jepsen_torch.convert import cols_from_arrays
from jepsen_torch.models.core import cas_register as p_cas
from jepsen_torch.ops import encode as p_enc
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.statespace import (enumerate_statespace as p_space,
                                         restrict_statespace)
from jepsen_torch.workloads.synth import synth_cas_batch as p_synth

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

# Sequential stretches (few processes) so runs fuse; a value domain past
# 32 states so rows renumber into one-word sub-spaces.
FUSE_SPEC = dict(family="cas", n=40, seed=13, n_procs=2, n_ops=40,
                 n_values=40, corrupt=0.3, p_info=0.05)
NARROW_SPEC = dict(family="cas", n=40, seed=17, n_procs=2, n_ops=40,
                   n_values=3, corrupt=0.3, p_info=0.05)


def _fields(b):
    return {"ev_type": b.ev_type, "ev_slot": b.ev_slot,
            "ev_slots": b.ev_slots, "ev_opidx": b.ev_opidx,
            "target": np.asarray(b.target), "V": b.V, "W": b.W,
            "indices": list(b.indices), "shared_target": b.shared_target,
            "w_live": b.w_live, "orig_n_events": b.orig_n_events,
            "failures": list(b.failures)}


def assert_same(p, r):
    got, want = _fields(p), _fields(r)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    if r.spaces is not None:
        assert [repr(s.states) for s in p.spaces] == \
            [repr(s.states) for s in r.spaces]


def _random_walk(rng, R_, E, S, K):
    """Walk-shaped arrays: single-candidate stretches (one occupied
    slot), concurrent events and trailing padding."""
    n_events = rng.integers(2, E + 1, R_).astype(np.int32)
    ev_slot = rng.integers(0, S, (R_, E)).astype(np.int8)
    ev_slots = np.full((R_, E, S), K, np.int8)
    for r in range(R_):
        for e in range(n_events[r]):
            q = ev_slot[r, e]
            ev_slots[r, e, q] = rng.integers(0, K)
            if rng.random() < 0.3:          # a second pending op
                o = (q + 1) % S
                ev_slots[r, e, o] = rng.integers(0, K)
    ev_opidx = np.arange(E, dtype=np.int32)[None].repeat(R_, 0) * 2 + 1
    return ev_slot, ev_slots, ev_opidx, n_events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_walked_matches_reference(seed):
    rng = np.random.default_rng(seed)
    K, V = 7, 9
    target = rng.integers(-1, V, (K, V)).astype(np.int32)
    walk = _random_walk(rng, 24, 30, 3, K)
    p_reg, r_reg = {}, {}
    for cap in (24, 2):
        got = p_enc.fuse_walked(*walk, target, sentinel=K, fused_start=K + 1,
                                cap=cap, extra=(walk[2] * 3,),
                                registry=p_reg)
        want = r_enc.fuse_walked(*walk, target, sentinel=K,
                                 fused_start=K + 1, cap=cap,
                                 extra=(walk[2] * 3,), registry=r_reg)
        for g, w in zip(got[:6], want[:6]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[6], want[6]):
            np.testing.assert_array_equal(g, w)
        assert got[4].any(), "the walk must fuse something"
    assert list(p_reg["by_seq"].items()) == list(r_reg["by_seq"].items())


def test_fusable_segments_and_compose_match_reference():
    rng = np.random.default_rng(3)
    cands = [np.array([1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1], bool),
             np.array([0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0], bool)]
    cands += list(rng.random((6, 11)) < 0.7)
    row, f, b = p_enc._fusable_runs(np.stack(cands))
    for r, cand in enumerate(cands):
        got = [(int(x), int(y)) for x, y in zip(f[row == r], b[row == r])]
        assert got == r_enc._fusable_segments(cand)
    t = np.array([[1, 2, -1], [2, -1, 0], [0, 0, 1]], np.int32)
    for ks in ((0,), (0, 1), (2, 0, 1, 1)):
        np.testing.assert_array_equal(p_enc._compose_rows(t, ks),
                                      r_enc._compose_rows(t, ks))


def _cols(spec):
    rc, _ = RS.synth_cas_device(RS.SynthSpec(**spec), backend="numpy",
                                key_meta=False)
    return rc, cols_from_arrays(rc)


@pytest.mark.parametrize("spec", [FUSE_SPEC, NARROW_SPEC],
                         ids=["two_words", "one_word"])
def test_encode_columnar_fused_renumbered_matches_reference(spec):
    rc, pc = _cols(spec)
    rs, ps = r_space(r_cas(), rc.kinds, 64), p_space(p_cas(), pc.kinds, 64)
    r_reg, p_reg = {}, {}
    rb, rf = r_enc.encode_columnar(rs, rc, max_slots=16, native=False,
                                   fuse=True, renumber=True,
                                   fuse_registry=r_reg)
    pb, pf = p_enc.encode_columnar(ps, pc, max_slots=16, fuse=True,
                                   renumber=True, fuse_registry=p_reg)
    assert pf == rf
    assert len(pb) == len(rb)
    for a, b in zip(pb, rb):
        assert_same(a, b)
    assert any((b.ev_type == p_enc.EV_FUSED).any() for b in pb)
    if spec is FUSE_SPEC:
        # some rows renumbered into a one-word sub-space
        assert {b.V for b in pb} & {v for v in range(8, 33)}
        assert any(b.V > 32 for b in pb) or len({b.V for b in pb}) > 1


def test_encode_history_fused_matches_reference():
    kw = dict(seed0=31, n_procs=2, n_ops=30, n_values=4, corrupt=0.3,
              p_info=0.1)
    r = [r_prepare(h) for h in r_synth(16, **kw)]
    p = [p_prepare(h) for h in p_synth(16, **kw)]
    n_fused = 0
    for rh, ph in zip(r, p):
        a = p_enc.encode_history(p_cas(), ph, fuse=True)
        b = r_enc.encode_history(r_cas(), rh, fuse=True)
        for k in ("ev_type", "ev_slot", "ev_slots", "ev_opidx"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (a.max_live, a.n_events, a.orig_events) == \
            (b.max_live, b.n_events, b.orig_events)
        assert (a.fused_rows is None) == (b.fused_rows is None)
        if a.fused_rows is not None:
            np.testing.assert_array_equal(a.fused_rows, b.fused_rows)
            n_fused += 1
    assert n_fused
    pb = p_enc.bucket_encode(p_cas(), p, fuse=True)
    rb = r_enc.bucket_encode(r_cas(), r, fuse=True)
    assert len(pb) == len(rb)
    for a, b in zip(pb, rb):
        assert_same(a, b)


def test_restrict_statespace_is_memoized():
    """The fuse registry and merge_batches key on StateSpace identity:
    repeated restrictions must return the same object."""
    space = p_space(p_cas(), cols_from_arrays(_cols(FUSE_SPEC)[0]).kinds,
                    64)
    a, lut_a = restrict_statespace(space, [0, 1, 3, 7])
    b, lut_b = restrict_statespace(space, [7, 3, 1, 0])
    assert a is b
    np.testing.assert_array_equal(lut_a, lut_b)


def _renumbered_groups(mod, space_fn, cas, cols, registry):
    """Two streamed encode groups of one batch (the scheduler's
    iter_columnar_groups shape), fused and renumbered with one
    registry."""
    space = space_fn(cas(), cols.kinds, 64)
    half = cols.batch // 2
    out = []
    for lo, hi in ((0, half), (half, cols.batch)):
        sub = type(cols)(type=cols.type[lo:hi], process=cols.process[lo:hi],
                         kind=cols.kind[lo:hi], kinds=cols.kinds)
        kw = {} if mod is p_enc else {"native": False}
        bs, _ = mod.encode_columnar(space, sub, max_slots=16, fuse=True,
                                    renumber=True, fuse_registry=registry,
                                    **kw)
        for b in bs:
            b.indices = [i + lo for i in b.indices]
            b.failures = []
        out.extend(bs)
    return out


def test_merge_batches_across_renumbered_groups():
    rc, pc = _cols(FUSE_SPEC)
    pbs = _renumbered_groups(p_enc, p_space, p_cas, pc, {})
    rbs = _renumbered_groups(r_enc, r_space, r_cas, rc, {})
    assert len(pbs) == len(rbs)
    by_v = {}
    for pb, rb in zip(pbs, rbs):
        by_v.setdefault(pb.V, []).append((pb, rb))
    merged_shared = merged_split = 0
    for V, pairs in by_v.items():
        W = max(pb.W for pb, _ in pairs) + 1
        got = p_enc.merge_batches([pb for pb, _ in pairs], W)
        want = r_enc.merge_batches([rb for _, rb in pairs], W)
        assert_same(got, want)
        if len(pairs) > 1:
            merged_shared += got.shared_target
            merged_split += not got.shared_target
        # widening and merging preserve every row's verdict
        gv, gb, _ = L.run_encoded_batch(got, device="cpu")
        for pb, _ in pairs:
            v, b, _ = L.run_encoded_batch(p_enc.widen_batch(pb, W),
                                          device="cpu")
            pos = {i: r for r, i in enumerate(got.indices)}
            for r, i in enumerate(pb.indices):
                assert gv[pos[i]] == v[r]
                if not v[r]:
                    assert gb[pos[i]] == b[r]
    assert merged_shared + merged_split > 0


def _group_inputs(seed):
    """Random member chunks of mixed shapes: V 8/40/48, W 4..9, shared
    and per-row targets, int8 and int32 slot tables."""
    rng = np.random.default_rng(seed)
    shapes = [(8, 4, None, True, 7), (40, 6, 4, False, 9),
              (48, 5, None, True, 130), (8, 9, 7, False, 12)]
    members, flat_np = [], []
    for V, W, wl, shared, K1 in shapes:
        B, N = int(rng.integers(3, 7)), int(rng.integers(10, 24))
        ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
        ev_slot = rng.integers(0, wl or W, (B, N)).astype(np.int8)
        ev_slots = rng.integers(0, K1, (B, N, W)).astype(
            np.int8 if K1 < 127 else np.int32)
        shape = (K1, V) if shared else (B, K1, V)
        target = rng.integers(-1, V, shape).astype(np.int32)
        target[rng.random(shape) < 0.4] = -1
        target[..., K1 - 1, :] = -1
        members.append((V, W, wl, shared))
        flat_np += [ev_type, ev_slot, ev_slots, target]
    return members, flat_np


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_fused_wgl_matches_reference_fused_kernel(seed):
    members, flat_np = _group_inputs(seed)
    want = R.get_fused_kernel(members)(*flat_np)
    flat = [torch.from_numpy(a) for a in flat_np]
    got = L.plain_fused_wgl(members, flat)
    assert len(got) == len(want) == 3 * len(members)
    for i in range(len(members)):
        v, b, f = got[3 * i:3 * i + 3]
        wv, wb, wf = (np.asarray(x) for x in want[3 * i:3 * i + 3])
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(b.numpy(), wb)
        np.testing.assert_array_equal(f.numpy().view(np.uint32), wf)
    assert any(not bool(got[3 * i].all()) for i in range(len(members)))
    # The dispatch by device: CPU tensors take the plain version. With
    # rows=, padding rows (all EV_PAD) past each member's real rows are
    # skipped, and their outputs are what a full walk leaves them.
    padded, rows = [], []
    for i, (V, W, wl, shared) in enumerate(members):
        ev_type, ev_slot, ev_slots, target = flat_np[4 * i:4 * i + 4]
        B, pad = ev_type.shape[0], 3
        rows.append(B)
        padded += [np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                               a.dtype)])
                   for a in (ev_type, ev_slot, ev_slots)]
        padded.append(target if shared else np.concatenate(
            [target, np.full((pad,) + target.shape[1:], -1, np.int32)]))
    padded = [torch.from_numpy(a) for a in padded]
    skipped = L.get_fused_kernel(members)(*padded, rows=rows)
    full = L.plain_fused_wgl(members, padded)
    for i in range(3 * len(members)):
        assert torch.equal(skipped[i], full[i])
        assert torch.equal(skipped[i][:rows[i // 3]], got[i])
