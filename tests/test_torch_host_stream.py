"""The legacy lockstep stream (``synth="host"``) against the reference's.

* ``workloads.synth.synth_cas_columnar`` byte for byte the reference's
  over ``n_keys`` 1 and 8, ``p_info`` and ``corrupt``, and
  ``synthesize(spec, "host", rows=...)`` slices (a slice generates the
  batch up to its end row); ``synth_la_batch`` and the host la and wide
  families as equal Op lists.
* ``check_synth(synth="host", device="cpu")``: the slice as a whole,
  generator → native ingest and encode walks → scheduler → the plain
  frontier versions → the fused-run rows re-derived by the C++ batch
  engine, with the reference's arrays and result dicts; only the cas
  family.
* ``run_synth_seeds(synth="host")``: the reference's summaries, and a
  checkpoint written by one package resumes in the other.

Inputs come from numpy seeds, a few dozen short rows. Tolerance: none.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import runtime as RRUN
from jepsen_tpu import store as RSTORE
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import faults as RF
from jepsen_tpu.ops import linearize as RL
from jepsen_tpu.ops import synth_device as R
from jepsen_tpu.workloads import synth as RS

from jepsen_torch import runtime, store
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import faults as PF
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops import synth_device as P
from jepsen_torch.workloads import synth as S

# One intra-op thread: test processes running side by side must not
# oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
P_OPTS = {"scheduler_opts": {"chunk_rows": 8, "fuse_width": 4}}
R_OPTS = {"scheduler_opts": {"chunk_rows": 8, "fuse_width": 4,
                             "shard_min_rows": 1 << 30}}
STREAMS = [
    ("plain", dict(n_procs=4, n_ops=20, n_values=3)),
    ("corrupt_info", dict(n_procs=5, n_ops=24, n_values=4, corrupt=0.4,
                          p_info=0.15)),
    ("keyed8", dict(n_procs=5, n_ops=30, n_values=3, corrupt=0.3,
                    p_info=0.05, n_keys=8)),
]


def cols_equal(a, b):
    assert a.kinds == b.kinds
    for f in ("type", "process", "kind", "key", "index"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("kw", [c[1] for c in STREAMS],
                         ids=[c[0] for c in STREAMS])
@pytest.mark.parametrize("seed", [0, 7])
def test_synth_cas_columnar_bytes(kw, seed):
    cols_equal(S.synth_cas_columnar(24, seed=seed, **kw),
               RS.synth_cas_columnar(24, seed=seed, **kw))


def test_unkeyed_stream_has_no_key_draws():
    """n_keys=1 is the historical stream draw for draw: no key column,
    and the same arrays as a call that never names n_keys."""
    kw = dict(n_procs=4, n_ops=20, n_values=3, corrupt=0.3, p_info=0.1)
    one = S.synth_cas_columnar(16, seed=3, n_keys=1, **kw)
    assert one.key is None
    cols_equal(one, S.synth_cas_columnar(16, seed=3, **kw))


@pytest.mark.parametrize("rows", [None, (0, 8), (5, 19)])
def test_synthesize_host_rows(rows):
    fields = dict(family="cas", n=24, seed=4, n_procs=4, n_ops=18,
                  n_values=3, corrupt=0.4, p_info=0.1, n_keys=3)
    got, gm = P.synthesize(P.SynthSpec(**fields), "host", rows=rows)
    want, wm = R.synthesize(R.SynthSpec(**fields), "host", rows=rows)
    assert gm is None and wm is None
    cols_equal(got, want)
    # The stream depends on (seed, n): a slice is the tail of the batch
    # of its end row.
    lo, hi = rows or (0, 24)
    prefix = S.synth_cas_columnar(
        hi, seed=4, n_procs=4, n_ops=18, n_values=3, corrupt=0.4,
        p_info=0.1, n_keys=3)
    assert got.type.tobytes() == prefix.type[lo:].tobytes()
    assert got.key.tobytes() == prefix.key[lo:].tobytes()


def as_dicts(hists):
    return [[op.to_dict() for op in h] for h in hists]


def test_synth_la_batch_and_host_op_list_families():
    kw = dict(n_procs=3, n_ops=16, n_keys=2, corrupt=0.5)
    assert as_dicts(S.synth_la_batch(6, seed0=2, **kw)) == \
        as_dicts(RS.synth_la_batch(6, seed0=2, **kw))
    for fields in (dict(family="la", n=6, seed=2, n_procs=3, n_ops=16,
                        n_keys=2, corrupt=0.5),
                   dict(family="wide", n=4, seed=1, width=6, n_values=2,
                        invalid=True)):
        got, gm = P.synthesize(P.SynthSpec(**fields), "host", rows=(1, 4))
        want, wm = R.synthesize(R.SynthSpec(**fields), "host", rows=(1, 4))
        assert gm is None and wm is None
        assert as_dicts(got) == as_dicts(want)
    with pytest.raises(ValueError):
        P.synthesize(P.SynthSpec(family="cas", n=2), "jax")


CHECKS = [
    ("unkeyed", dict(family="cas", n=32, seed=5, n_procs=4, n_ops=24,
                     n_values=3, corrupt=0.5, p_info=0.1)),
    ("keyed", dict(family="cas", n=24, seed=2, n_procs=5, n_ops=30,
                   n_values=3, corrupt=0.4, p_info=0.05, n_keys=4)),
]


@pytest.mark.parametrize("fields", [c[1] for c in CHECKS],
                         ids=[c[0] for c in CHECKS])
@pytest.mark.parametrize("scheduler", [True, False],
                         ids=["scheduler", "exact"])
def test_check_synth_host_matches_reference(fields, scheduler):
    """The slice as a whole: verdicts and bad ops, and the details
    dicts, equal to the reference's check_synth(synth="host")."""
    pspec, rspec = P.SynthSpec(**fields), R.SynthSpec(**fields)
    got = L.check_synth(cas_register(), pspec, synth="host", device=CPU,
                        scheduler=scheduler, **P_OPTS)
    want = RL.check_synth(r_cas(), rspec, synth="host",
                          scheduler=scheduler, **R_OPTS)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert not got[0].all() and got[0].any()
    got_d = L.check_synth(cas_register(), pspec, synth="host", device=CPU,
                          scheduler=scheduler, details=True, **P_OPTS)
    want_d = RL.check_synth(r_cas(), rspec, synth="host",
                            scheduler=scheduler, details=True, **R_OPTS)
    assert got_d == want_d


def test_check_synth_host_takes_only_cas():
    spec = P.SynthSpec(family="wide", n=2, width=5)
    with pytest.raises(ValueError, match="cas family"):
        L.check_synth(cas_register(), spec, synth="host", device=CPU)
    out, meta = L.check_synth(
        cas_register(), P.SynthSpec(family="cas", n=4, n_ops=8),
        synth="host", device=CPU, return_meta=True)
    assert meta is None and len(out[0]) == 4


CAMPAIGN = dict(family="cas", n=32, seed=0, n_procs=4, n_ops=18,
                n_values=3, corrupt=0.4, p_info=0.1)
SEEDS = [0, 1]


def kill(pkg, chunk=8):
    f = RF if pkg == "ref" else PF
    return f.FaultInjector(f.FaultPlan.single("dispatch", "kill",
                                              chunk=chunk, deadline_s=5.0))


@pytest.fixture(scope="module")
def ref_campaign(tmp_path_factory):
    return RRUN.run_synth_seeds(
        R.SynthSpec(**CAMPAIGN), SEEDS, synth="host",
        store_root=RSTORE.Store(tmp_path_factory.mktemp("ref")),
        name="ref", check_kwargs=R_OPTS)


def test_run_synth_seeds_host_matches_reference(ref_campaign, tmp_path):
    got = runtime.run_synth_seeds(P.SynthSpec(**CAMPAIGN), SEEDS,
                                  synth="host", store_root=store.Store(
                                      tmp_path), name="c", device=CPU,
                                  check_kwargs=P_OPTS)
    assert got == ref_campaign
    assert got["invalid"] > 0


@pytest.mark.parametrize("killed,resumed", [("ref", "port"),
                                            ("port", "ref")])
def test_host_checkpoint_crosses_packages(ref_campaign, tmp_path, killed,
                                          resumed):
    """A host-stream campaign killed mid-seed under one package resumes
    under the other (checkpoint and journals keyed with "host") with the
    uninterrupted run's summaries."""
    rspec, pspec = R.SynthSpec(**CAMPAIGN), P.SynthSpec(**CAMPAIGN)
    run = {"ref": lambda **kw: RRUN.run_synth_seeds(
               rspec, SEEDS, synth="host",
               store_root=RSTORE.Store(tmp_path), name="x", **kw),
           "port": lambda **kw: runtime.run_synth_seeds(
               pspec, SEEDS, synth="host", store_root=store.Store(tmp_path),
               name="x", device=CPU, **kw)}
    opts = {"ref": R_OPTS, "port": P_OPTS}
    with pytest.raises((PF.InjectedKill, RF.InjectedKill)):
        run[killed](check_kwargs=dict(opts[killed], faults=kill(killed)))
    assert (tmp_path / "x" / "campaign.jsonl").exists()
    got = run[resumed](check_kwargs=opts[resumed], resume=True)
    assert got["seeds"]["0"].pop("resumed") is True
    assert got == ref_campaign
