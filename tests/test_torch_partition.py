"""The port's per-key pre-partition against the reference.

Linearizability is local: a history over independent keys is
linearizable iff each per-key projection is. ``ops.partition`` strains
keyed histories into per-key sub-histories before encoding and
recombines verdicts with the witness key. Pinned here, without faults
or journals (the port does not carry them yet): the columnar strain
line for line against the per-key projection and the reference's
arrays, the W collapse, unkeyed pass-through, the Op-list strain, the
``merge_kv_histories`` round trip, and keyed ``check_columnar`` /
``check_synth`` / ``check_batch`` verdicts, bad ops and witness keys
against the reference on the CPU. Each package builds its Op lists with
its own ``KV`` from the same seeds. Tolerance: none (exact equality).
"""
import numpy as np
import pytest
import torch

from jepsen_tpu.independent import KV as R_KV
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops import partition as RP
from jepsen_tpu.ops import synth_device as RS
from jepsen_tpu.workloads.synth import synth_cas_history as r_hist

from jepsen_torch.checkers.linearizable import wgl_check
from jepsen_torch.convert import cols_from_arrays
from jepsen_torch.history.columnar import PAD, columnar_to_ops
from jepsen_torch.history.ops import invoke_op, ok_op
from jepsen_torch.independent import KV, is_kv, subhistory
from jepsen_torch.models.core import cas_register as p_cas
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops import synth_device as PS
from jepsen_torch.ops.partition import (merge_kv_histories,
                                        partition_columnar,
                                        partition_histories,
                                        pending_w_hist, recombine_verdicts)
from jepsen_torch.workloads.synth import synth_cas_history as p_hist

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

# A keyed batch with both verdicts, info ops and some key skew.
KEYED = dict(family="cas", n=32, seed=21, n_procs=4, n_ops=30, n_values=3,
             corrupt=0.3, p_info=0.1, n_keys=4)


@pytest.fixture(scope="module")
def keyed_cols():
    rc, _ = RS.synth_cas_device(RS.SynthSpec(**KEYED), backend="numpy",
                                key_meta=False)
    return rc, cols_from_arrays(rc)


def test_columnar_strain_matches_per_key_projection(keyed_cols):
    """Every sub row is line for line the per-key projection of its
    original row, sub order is ascending (history, key), and the arrays
    equal the reference's strain."""
    rc, cols = keyed_cols
    pb = partition_columnar(cols)
    assert pb is not None and pb.n_histories == KEYED["n"]
    order = list(zip(pb.sub_history.tolist(),
                     [-1 if k is None else int(k) for k in pb.sub_key]))
    assert order == sorted(order), "sub order must be (history, key)"
    for s in range(pb.n_subs):
        row, k = int(pb.sub_history[s]), pb.sub_key[s]
        want = [(int(cols.type[row, j]), int(cols.process[row, j]),
                 int(cols.kind[row, j]), j)
                for j in range(cols.n_lines)
                if cols.type[row, j] != PAD
                and (int(cols.key[row, j]) == int(k)
                     or int(cols.key[row, j]) < 0)]
        got = [(int(pb.cols.type[s, j]), int(pb.cols.process[s, j]),
                int(pb.cols.kind[s, j]), int(pb.cols.index[s, j]))
               for j in range(pb.cols.n_lines)
               if pb.cols.type[s, j] != PAD]
        assert got == want, (s, row, k)
    ref = RP.partition_columnar(rc)
    for f in ("type", "process", "kind", "index"):
        np.testing.assert_array_equal(getattr(pb.cols, f),
                                      getattr(ref.cols, f), err_msg=f)
    np.testing.assert_array_equal(pb.sub_history, ref.sub_history)
    assert pb.sub_key == ref.sub_key


def test_columnar_strain_collapses_w(keyed_cols):
    _, cols = keyed_cols
    pb = partition_columnar(cols)
    pre, post = pending_w_hist(cols), pending_w_hist(pb.cols)
    assert max(post) < max(pre)
    # The strain relieves the axis the kernel pays — total frontier
    # words, n * 2^W — not just the row count.
    assert sum(n << w for w, n in post.items()) \
        < sum(n << w for w, n in pre.items())
    assert pre == RP.pending_w_hist(keyed_cols[0])


def test_unkeyed_batch_passes_through():
    cols, _ = PS.synth_cas_device(
        PS.SynthSpec(n=8, seed=3, n_ops=10), device="cpu")   # n_keys=1
    assert cols.key is None
    assert partition_columnar(cols) is None
    hists = [p_hist(s, n_ops=8) for s in range(4)]
    assert partition_histories(hists) is None


def test_oplist_strain_shares_the_subhistory_machinery():
    """partition_histories == independent.subhistory per key, op
    identity preserved; unkeyed ops replicate into every sub."""
    parts = {0: [invoke_op(0, "write", 1), ok_op(0, "write", 1)],
             1: [invoke_op(0, "read", None), ok_op(0, "read", None)]}
    h = merge_kv_histories(parts)
    nem, nem_ok = invoke_op(9, "read", None), ok_op(9, "read", None)
    h = h[:2] + [nem, nem_ok] + h[2:]
    for i, op in enumerate(h):
        op.index = i
    subs, sub_hist, sub_key = partition_histories([h])
    assert sub_hist.tolist() == [0, 0]
    assert sub_key == [0, 1]
    for k, sub in zip(sub_key, subs):
        assert sub == subhistory(k, h)
        assert nem in sub and nem_ok in sub


def test_merge_kv_roundtrip():
    parts = {k: p_hist(40 + k, n_procs=2, n_ops=6) for k in range(3)}
    h = merge_kv_histories(parts)
    assert all(is_kv(op.value) for op in h)
    subs, _, keys = partition_histories([h])
    for k, sub in zip(keys, subs):
        want = [(op.type, op.f, op.value) for op in parts[k]]
        got = [(op.type, op.f, op.value) for op in sub]
        assert got == want, k
    # the same interleave as the reference's
    r = RP.merge_kv_histories({k: r_hist(40 + k, n_procs=2, n_ops=6)
                               for k in range(3)})
    assert [o.to_dict() for o in h] == [o.to_dict() for o in r]


def test_partitioned_columnar_matches_exact_per_key(keyed_cols):
    """Keyed check_columnar (auto strain, scheduler) equals the exact
    per-key oracle and the reference's verdicts and bad ops."""
    rc, cols = keyed_cols
    pb = partition_columnar(cols)
    v, b = L.check_columnar(p_cas(), pb.cols, device="cpu",
                            partition=False, scheduler=False)
    want_v, want_b, _ = recombine_verdicts(v, b, pb.sub_history,
                                           pb.sub_key, pb.n_histories)
    assert not want_v.all(), "corpus must exercise both verdicts"
    got_v, got_b = L.check_columnar(p_cas(), cols, device="cpu")
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_b, want_b)
    ref_v, ref_b = R.check_columnar(r_cas(), rc)
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_b, ref_b)


@pytest.mark.parametrize("details", ["invalid", True])
def test_partitioned_details_carry_witness_key(keyed_cols, details):
    rc, cols = keyed_cols
    got = L.check_columnar(p_cas(), cols, device="cpu", details=details)
    want = R.check_columnar(r_cas(), rc, details=details)
    assert got == want
    pb = partition_columnar(cols)
    n_bad = 0
    for i, r in enumerate(got):
        if r["valid"] is not False:
            continue
        n_bad += 1
        bad, key = r["op"]["index"], r["independent_key"]
        assert int(cols.key[i, bad]) == int(key)
        sub = [s for s in range(pb.n_subs)
               if int(pb.sub_history[s]) == i and pb.sub_key[s] == key][0]
        exact = wgl_check(p_cas(), columnar_to_ops(pb.cols, sub))
        assert exact["valid"] is False and exact["op"]["index"] == bad
    assert n_bad > 0


@pytest.mark.parametrize("details", [False, "invalid"])
def test_keyed_check_synth_matches_reference(details):
    spec = dict(KEYED, seed=5, n=24)
    got = L.check_synth(p_cas(), PS.SynthSpec(**spec), device="cpu",
                        details=details)
    want = R.check_synth(r_cas(), RS.SynthSpec(**spec), synth="numpy",
                         details=details)
    if details is False:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert not got[0].all()
    else:
        assert got == want


def _kv_histories(KV_, hist):
    return [merge_kv_histories_of(KV_, {
        k: hist(100 + 10 * i + k, n_procs=3, n_ops=8,
                corrupt=0.5 if (i + k) % 2 else 0.0)
        for k in range(3)}) for i in range(6)]


def merge_kv_histories_of(KV_, parts):
    """merge_kv_histories with a given package's KV class."""
    if KV_ is KV:
        return merge_kv_histories(parts)
    return RP.merge_kv_histories(parts)


def test_partitioned_check_batch_oplists():
    """The Op-list entries (check_batch, check_batch_columnar,
    partition="auto") on KV histories: parity against per-key exact
    checks and against the reference."""
    mine = _kv_histories(KV, p_hist)
    ref = _kv_histories(R_KV, r_hist)
    rs = L.check_batch(p_cas(), mine, device="cpu")
    assert rs == R.check_batch_tpu(r_cas(), ref)
    hit_invalid = False
    for h, r in zip(mine, rs):
        per_key = {k: wgl_check(p_cas(), subhistory(k, h))
                   for k in (0, 1, 2)}
        assert (r["valid"] is True) == all(x["valid"] is True
                                          for x in per_key.values())
        if r["valid"] is False:
            hit_invalid = True
            wk = r["independent_key"]
            assert per_key[wk]["valid"] is False
            assert r["op"]["index"] == per_key[wk]["op"]["index"]
    assert hit_invalid
    assert L.check_batch_columnar(p_cas(), mine, device="cpu") == \
        R.check_batch_columnar(r_cas(), ref)
