"""The port's host encoder and state-space enumeration against the
reference's: the same seeded histories (each package generates them with
its own copy of the synthesizer) give identical arrays, bounds, row
indices and failures. Tolerance: none (array equality, dtypes
included)."""
import numpy as np
import pytest

from jepsen_tpu.checkers.linearizable import prepare_history as r_prepare
from jepsen_tpu.history.ops import invoke_op as r_invoke, ok_op as r_ok
from jepsen_tpu.models import core as r_models
from jepsen_tpu.ops import encode as r_enc
from jepsen_tpu.ops import statespace as r_ss
from jepsen_tpu.workloads.synth import synth_cas_batch as r_synth

from jepsen_torch.checkers.linearizable import prepare_history as p_prepare
from jepsen_torch.history.ops import invoke_op as p_invoke, ok_op as p_ok
from jepsen_torch.models import core as p_models
from jepsen_torch.ops import encode as p_enc
from jepsen_torch.ops import statespace as p_ss
from jepsen_torch.workloads.synth import synth_cas_batch as p_synth

SYNTH = dict(n=40, seed0=21, n_procs=5, n_ops=30, n_values=4,
             corrupt=0.3, p_info=0.15)


def both(**kw):
    kw = {**SYNTH, **kw}
    n = kw.pop("n")
    r = [r_prepare(h) for h in r_synth(n, **kw)]
    p = [p_prepare(h) for h in p_synth(n, **kw)]
    return r, p


def assert_same_batch(p, r):
    for name in ("ev_type", "ev_slot", "ev_slots", "ev_opidx", "target"):
        a, b = getattr(p, name), getattr(r, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (p.V, p.W, p.w_live, p.shared_target) == \
        (r.V, r.W, r.w_live, r.shared_target)
    assert p.indices == r.indices
    assert p.failures == r.failures
    assert [s.states for s in p.spaces] is not None
    assert [repr(s.states) for s in p.spaces] == \
        [repr(s.states) for s in r.spaces]


def test_synthesizers_agree():
    r, p = both()
    assert [[o.to_dict() for o in h] for h in p] == \
        [[o.to_dict() for o in h] for h in r]


@pytest.mark.parametrize("max_slots", [16, 5])
def test_bucket_encode_matches_reference(max_slots):
    r, p = both()
    rb = r_enc.bucket_encode(r_models.cas_register(), r,
                             max_slots=max_slots)
    pb = p_enc.bucket_encode(p_models.cas_register(), p,
                             max_slots=max_slots)
    assert len(pb) == len(rb) > 1
    for a, b in zip(pb, rb):
        assert_same_batch(a, b)
    if max_slots == 5:
        assert rb[0].failures, "a tight window must produce failures"


def test_batch_encode_matches_reference():
    r, p = both(n=12)
    assert_same_batch(
        p_enc.batch_encode(p_models.cas_register(), p, pad_batch_to=16),
        r_enc.batch_encode(r_models.cas_register(), r, pad_batch_to=16))


def _cas_walk(invoke, ok, n=400, n_values=14, seed=3):
    """One process's successful CAS walk: ~n distinct (from, to) kinds."""
    rng = np.random.default_rng(seed)
    h, cur = [invoke(0, "write", 0), ok(0, "write", 0)], 0
    for _ in range(n):
        nxt = int(rng.integers(n_values))
        h += [invoke(0, "cas", [cur, nxt]), ok(0, "cas", [cur, nxt])]
        cur = nxt
    return h


def test_wide_vocabulary_uses_int32_slot_tables():
    # >= 127 op kinds: slot tables widen to int32 in both encoders.
    r = [r_prepare(_cas_walk(r_invoke, r_ok))]
    p = [p_prepare(_cas_walk(p_invoke, p_ok))]
    rb = r_enc.batch_encode(r_models.cas_register(), r)
    pb = p_enc.batch_encode(p_models.cas_register(), p)
    assert pb.ev_slots.dtype == np.int32
    assert_same_batch(pb, rb)


def test_state_space_explosion_is_a_failure():
    r, p = both(n=6)
    rb = r_enc.bucket_encode(r_models.cas_register(), r, max_states=3)
    pb = p_enc.bucket_encode(p_models.cas_register(), p, max_states=3)
    assert pb[0].failures == rb[0].failures and pb[0].failures


def test_slot_ops_at_event_matches_reference():
    r, p = both(n=8)
    for rh, ph in zip(r, p):
        rs = r_ss.enumerate_statespace(r_models.cas_register(),
                                       r_ss.history_kinds(rh), 64)
        ps = p_ss.enumerate_statespace(p_models.cas_register(),
                                       p_ss.history_kinds(ph), 64)
        for e in (None, 0, 3):
            assert p_enc.slot_ops_at_event(ps, ph, e) == \
                r_enc.slot_ops_at_event(rs, rh, e)


def test_fused_encoding_is_not_ported():
    """Event fusion is ported now: a fused per-history encoding equals
    the reference's (tests/test_torch_fusion.py covers it in depth)."""
    r, p = both(n=4, n_procs=2)
    for rh, ph in zip(r, p):
        a = p_enc.encode_history(p_models.cas_register(), ph, fuse=True)
        b = r_enc.encode_history(r_models.cas_register(), rh, fuse=True)
        for name in ("ev_type", "ev_slot", "ev_slots", "ev_opidx"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
        assert (a.n_events, a.orig_events) == (b.n_events, b.orig_events)


def _mutex_history(invoke, ok):
    return [invoke(0, "acquire"), ok(0, "acquire"), invoke(1, "acquire"),
            invoke(0, "release"), ok(0, "release"), ok(1, "acquire")]


def _queue_history(invoke, ok):
    return [invoke(0, "enqueue", 1), invoke(1, "enqueue", 2),
            ok(0, "enqueue", 1), ok(1, "enqueue", 2),
            invoke(2, "dequeue", 2), ok(2, "dequeue", 2)]


@pytest.mark.parametrize("model,history", [
    ("cas_register", None), ("mutex", _mutex_history),
    ("fifo_queue", _queue_history), ("unordered_queue", _queue_history),
    ("set_model", None)])
def test_statespace_matches_reference(model, history):
    if history is None:
        r, p = both(n=1)
        rh, ph = r[0], p[0]
        if model == "set_model":
            rh = [r_invoke(0, "add", 1), r_ok(0, "add", 1),
                  r_invoke(1, "read", [1]), r_ok(1, "read", [1])]
            ph = [p_invoke(0, "add", 1), p_ok(0, "add", 1),
                  p_invoke(1, "read", [1]), p_ok(1, "read", [1])]
    else:
        rh, ph = history(r_invoke, r_ok), history(p_invoke, p_ok)
    if model.endswith("queue"):
        # Enqueues grow the state without bound: both enumerations
        # refuse the vocabulary at the same state bound.
        with pytest.raises(r_ss.StateSpaceExplosion) as re:
            r_ss.enumerate_statespace(getattr(r_models, model)(),
                                      r_ss.history_kinds(rh), 64)
        with pytest.raises(p_ss.StateSpaceExplosion) as pe:
            p_ss.enumerate_statespace(getattr(p_models, model)(),
                                      p_ss.history_kinds(ph), 64)
        assert str(pe.value) == str(re.value)
        return
    rs = r_ss.enumerate_statespace(getattr(r_models, model)(),
                                   r_ss.history_kinds(rh), 64)
    ps = p_ss.enumerate_statespace(getattr(p_models, model)(),
                                   p_ss.history_kinds(ph), 64)
    assert [repr(s) for s in ps.states] == [repr(s) for s in rs.states]
    assert ps.kinds == rs.kinds and ps.kind_index == rs.kind_index
    np.testing.assert_array_equal(ps.target, rs.target)
    assert ps.identity_kinds == rs.identity_kinds
    v, k = ps.n_states + 3, ps.n_kinds + 2
    np.testing.assert_array_equal(ps.padded_target(v, k),
                                  rs.padded_target(v, k))
