"""The port's campaign engines on the cas generator against the reference:
fuzz neighbourhoods (``ops.synth_device.neighbor_keys``,
``synth_cas_neighbors``), the seed campaign (``runtime.run_synth_seeds``)
with its durable checkpoint (``store.CampaignCheckpoint``), and the fuzz
loop (``fuzz.fuzz_round``, ``fuzz.fuzz_campaign``).

Each runs with ``device="cpu"`` (the plain versions of the kernels) and
must give the reference's keys, rows and summaries field for field. A
campaign killed by the checker nemesis resumes without running a
completed seed again or dispatching a decided row again, and the
checkpoint and journal files are the reference's, so a campaign killed
under one package resumes under the other. Tolerance: none.
"""
import json

import numpy as np
import pytest
import torch

from jepsen_tpu import fuzz as RFUZZ
from jepsen_tpu import runtime as RRUN
from jepsen_tpu import store as RSTORE
from jepsen_tpu.ops import faults as RF
from jepsen_tpu.ops import synth_device as R

from jepsen_torch import fuzz, runtime, store
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import synth_device as S
from jepsen_torch.ops import faults as PF
from jepsen_torch.ops.faults import InjectedKill
from jepsen_torch.ops.linearize import DISPATCH_LOG

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

# The reference's campaign test spec (tests/test_synth_device.py:390),
# unkeyed so that journal rows are histories; the keyed fuzz spec adds a
# fault surface (timeouts and a crash window) so that every neighbourhood
# mode runs.
CAMPAIGN = dict(family="cas", n=32, seed=0, n_procs=4, n_ops=18,
                n_values=3, n_keys=1, corrupt=0.4, p_info=0.1)
FUZZ = dict(family="cas", n=32, seed=21, n_procs=4, n_ops=18, n_values=3,
            n_keys=3, corrupt=0.5, p_info=0.1, crash_lo=2, crash_hi=10,
            p_crash=0.3)
SEEDS = [0, 1]
P_OPTS = {"scheduler_opts": {"chunk_rows": 8}}
# The reference also shards large chunks over its devices; the port has
# one card, so the reference is told never to.
R_OPTS = {"scheduler_opts": {"chunk_rows": 8, "shard_min_rows": 1 << 30}}
FUZZ_KW = dict(rounds=1, neighborhood=2, max_witnesses=3)
CPU = "cpu"


def both(fields):
    return R.SynthSpec(**fields), S.SynthSpec(**fields)


def kill(pkg, chunk=8):
    """The checker nemesis of ``pkg`` killing the run at the ``chunk``-th
    dispatch (the default lands in seed 1 of CAMPAIGN after its first
    chunk retired: seed 0 takes five dispatches, and the next one's
    verdicts land while the kill's chunk is dispatched)."""
    f = RF if pkg == "ref" else PF
    return f.FaultInjector(f.FaultPlan.single("dispatch", "kill",
                                              chunk=chunk, deadline_s=5.0))


def journal_rows(path) -> int:
    """Rows an interrupted run's journal decided."""
    if not path.exists():
        return 0
    n = 0
    for line in path.read_text().splitlines()[1:]:
        try:
            n += len(json.loads(line)["rows"])
        except ValueError:
            pass
    return n


@pytest.fixture(scope="module")
def ref_campaign(tmp_path_factory):
    """The reference's uninterrupted seed campaign."""
    st = RSTORE.Store(base=tmp_path_factory.mktemp("ref_campaign"))
    return RRUN.run_synth_seeds(R.SynthSpec(**CAMPAIGN), SEEDS,
                                store_root=st, name="w",
                                check_kwargs=R_OPTS)


@pytest.fixture(scope="module")
def ref_fuzz():
    """The reference's fuzz campaign, host-verified on every other
    neighbour."""
    return RFUZZ.fuzz_campaign(R.SynthSpec(**FUZZ), name=None, verify=2,
                               check_kwargs=R_OPTS, **FUZZ_KW)


# ------------------------------------------------ neighbourhoods

NEIGHBORS = [(5, m, v) for m in S.NEIGHBOR_MODES for v in range(3)] + \
    [(0, "nemesis", 4), (31, "values", 1)]


def test_neighbor_keys_match_reference():
    rspec, pspec = both(FUZZ)
    assert S.NEIGHBOR_MODES == R.NEIGHBOR_MODES
    rk, rlo, rhi = R.neighbor_keys(rspec, NEIGHBORS)
    pk, plo, phi = S.neighbor_keys(pspec, NEIGHBORS)
    for s in S.STREAMS:
        assert pk[s].dtype == np.uint32 and np.array_equal(pk[s], rk[s]), s
    assert np.array_equal(plo, rlo) and np.array_equal(phi, rhi)
    with pytest.raises(ValueError, match="mode"):
        S.neighbor_keys(pspec, [(0, "sideways", 0)])


@pytest.mark.parametrize("rows", [5, 8, 11])
def test_synth_cas_neighbors_match_reference(rows):
    rspec, pspec = both(FUZZ)
    neigh = NEIGHBORS[:rows]
    rc, rm = R.synth_cas_neighbors(rspec, neigh, backend="device")
    pc, pm = S.synth_cas_neighbors(pspec, neigh, device=CPU)
    assert pc.batch == rc.batch == rows
    for f in ("type", "process", "kind", "key"):
        assert np.array_equal(getattr(pc, f), getattr(rc, f)), f
    assert pc.kinds == rc.kinds
    assert np.array_equal(pm.peak_w, rm.peak_w)
    assert pm.key_peak_w is None and rm.key_peak_w is None


# ------------------------------------------------ the seed campaign

def test_run_synth_seeds_matches_reference(ref_campaign, tmp_path):
    got = runtime.run_synth_seeds(S.SynthSpec(**CAMPAIGN), SEEDS,
                                  store_root=store.Store(tmp_path),
                                  name="w", check_kwargs=P_OPTS, device=CPU)
    assert got == ref_campaign
    assert got["invalid"] > 0
    assert not (tmp_path / "w" / "campaign.jsonl").exists()
    assert sorted(p.name for p in (tmp_path / "w").iterdir()) == \
        ["seed-0.json", "seed-1.json"]
    plain = runtime.run_synth_seeds(S.SynthSpec(**CAMPAIGN), SEEDS,
                                    checkpoint=False, check_kwargs=P_OPTS,
                                    device=CPU, synth="numpy")
    assert plain["seeds"] == got["seeds"]


def test_run_synth_seeds_kill_and_resume(ref_campaign, tmp_path):
    """The port's twin of test_run_synth_seeds_kill_and_resume: killed
    mid-seed-1, the resumed campaign loads seed 0's summary (running
    none of it again), dispatches only seed 1's undecided rows, and
    deletes its checkpoint."""
    spec, st = S.SynthSpec(**CAMPAIGN), store.Store(tmp_path)
    with pytest.raises(InjectedKill):
        runtime.run_synth_seeds(spec, SEEDS, store_root=st, name="c",
                                check_kwargs=dict(P_OPTS,
                                                  faults=kill("port")),
                                device=CPU)
    cdir = tmp_path / "c"
    assert (cdir / "campaign.jsonl").exists()
    assert (cdir / "seed-0.json").exists()
    decided = journal_rows(cdir / "seed-1.journal.jsonl")
    assert decided > 0, "nothing of seed 1 retired before the kill"
    DISPATCH_LOG.clear()
    got = runtime.run_synth_seeds(spec, SEEDS, store_root=st, name="c",
                                  resume=True, check_kwargs=P_OPTS,
                                  device=CPU)
    assert got["seeds"]["0"].pop("resumed") is True
    assert got == ref_campaign
    redispatched = sum(nrows for _, _, _, nrows in DISPATCH_LOG)
    assert redispatched == spec.n - decided
    assert not (cdir / "campaign.jsonl").exists()


def test_campaign_mismatch_on_a_wrong_key(tmp_path):
    p = tmp_path / "campaign.jsonl"
    ck = store.CampaignCheckpoint(p, {"name": "a", "seeds": [0]})
    ck.started(0, tmp_path)
    ck.close()
    with pytest.raises(store.CampaignMismatch, match="different campaign"):
        store.CampaignCheckpoint(p, {"name": "a", "seeds": [0, 1]},
                                 resume=True)
    assert issubclass(store.CampaignMismatch, ValueError)
    # Without resume a fresh campaign replaces the file.
    store.CampaignCheckpoint(p, {"name": "b"}).close()
    assert json.loads(p.read_text().splitlines()[0])["key"] == {"name": "b"}


def test_checkpoint_file_format_is_the_references(tmp_path):
    """The same transitions give the same bytes in both packages; each
    loads the other's file, a torn tail dropped."""
    key = {"name": "fmt", "seeds": [3, 4, 5]}
    for name, cls in (("port", store.CampaignCheckpoint),
                      ("ref", RSTORE.CampaignCheckpoint)):
        ck = cls(tmp_path / name, key)
        ck.started(3, "d3")
        ck.done(3)
        ck.started(4, "d4")
        ck.close()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    with open(tmp_path / "ref", "a") as f:
        f.write('{"seed": 4, "sta')
    p = store.CampaignCheckpoint(tmp_path / "ref", key, resume=True)
    r = RSTORE.CampaignCheckpoint(tmp_path / "port", key, resume=True)
    for s in (3, 4, 5):
        assert p.seed_state(s) == r.seed_state(s)
    assert p.seed_state(3) == {"dir": "d3", "done": True}
    p.done(4)
    p.finish()
    r.finish()
    assert not (tmp_path / "ref").exists()


@pytest.mark.parametrize("killed,resumed", [("ref", "port"),
                                            ("port", "ref")])
def test_checkpoint_crosses_packages(ref_campaign, tmp_path, killed,
                                     resumed):
    """A campaign killed mid-seed-1 under one package resumes under the
    other from the same checkpoint, summaries and journal, with the
    uninterrupted run's summaries."""
    rspec, pspec = both(CAMPAIGN)
    run = {"ref": lambda **kw: RRUN.run_synth_seeds(
               rspec, SEEDS, store_root=RSTORE.Store(tmp_path), name="x",
               **kw),
           "port": lambda **kw: runtime.run_synth_seeds(
               pspec, SEEDS, store_root=store.Store(tmp_path), name="x",
               device=CPU, **kw)}
    opts = {"ref": R_OPTS, "port": P_OPTS}
    with pytest.raises((InjectedKill, RF.InjectedKill)):
        run[killed](check_kwargs=dict(opts[killed], faults=kill(killed)))
    assert journal_rows(tmp_path / "x" / "seed-1.journal.jsonl") > 0
    got = run[resumed](check_kwargs=opts[resumed], resume=True)
    assert got["seeds"]["0"].pop("resumed") is True
    assert got == ref_campaign


def test_synth_labels(tmp_path):
    """"host" (the legacy lockstep stream) runs in both packages with
    the same summaries; an unknown label raises, and fuzz keeps its
    refusal of the legacy stream, as the reference's does."""
    rspec, spec = both(CAMPAIGN)
    want = RRUN.run_synth_seeds(rspec, [0], synth="host", checkpoint=False,
                                check_kwargs=R_OPTS)
    got = runtime.run_synth_seeds(spec, [0], synth="host", checkpoint=False,
                                  device=CPU, check_kwargs=P_OPTS)
    assert got == want
    with pytest.raises(ValueError):
        runtime.run_synth_seeds(spec, [0], synth="jax", checkpoint=False,
                                device=CPU)
    with pytest.raises(ValueError, match="generator family"):
        fuzz.fuzz_campaign(spec, synth="host", name=None, device=CPU)


def test_campaigns_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = S.SynthSpec(**dict(CAMPAIGN, n=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_synth_seeds(spec, [0], checkpoint=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.fuzz_campaign(spec, name=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.synth_cas_neighbors(spec, [(0, "order", 0)])


# ------------------------------------------------ the fuzz loop

def test_fuzz_campaign_matches_reference(ref_fuzz):
    got = fuzz.fuzz_campaign(S.SynthSpec(**FUZZ), name=None, verify=2,
                             check_kwargs=P_OPTS, device=CPU, **FUZZ_KW)
    assert got == ref_fuzz
    rnd = got["round_results"][0]
    assert got["modes"] == list(S.NEIGHBOR_MODES)
    assert got["neighborhoods"] > 0 and got["neighborhood_invalid"] > 0
    assert got["verified"] > 0 and got["disagreements"] == 0
    assert got["min_anomaly_lines"] is not None
    assert set(rnd["invalid_by_mode"]) <= set(S.NEIGHBOR_MODES)


def test_fuzz_round_matches_reference(ref_fuzz):
    want = dict(ref_fuzz["round_results"][0])
    del want["round"]
    got = fuzz.fuzz_round(cas_register(), S.SynthSpec(**FUZZ),
                          synth="device", neighborhood=2, max_witnesses=3,
                          modes=S.NEIGHBOR_MODES, journal_dir=None,
                          resume=False, verify=2, check_kwargs=P_OPTS,
                          device=CPU)
    assert got == want


def test_fuzz_kill_and_resume_redispatches_zero_neighborhoods(tmp_path):
    """The port's twin of the reference test: killed mid-neighbourhood,
    the resumed campaign gives the uninterrupted summary and dispatches
    only the rows neither journal decided."""
    spec = S.SynthSpec(**dict(FUZZ, n_keys=1, p_info=0.0, p_crash=0.0))
    kw = dict(FUZZ_KW, neighborhood=4)
    want = fuzz.fuzz_campaign(spec, name=None, check_kwargs=P_OPTS,
                              device=CPU, **kw)
    assert want["neighborhoods"] == 24
    # The base batch takes four dispatches and the 24 neighbours three:
    # the seventh lands after the first neighbourhood chunk retired.
    with pytest.raises(InjectedKill):
        fuzz.fuzz_campaign(spec, store_root=store.Store(tmp_path),
                           name="fz", device=CPU,
                           check_kwargs=dict(P_OPTS,
                                             faults=kill("port", chunk=6)),
                           **kw)
    decided = sum(journal_rows(tmp_path / "fz" / f"fuzz-{spec.seed}.{s}"
                               ".jsonl") for s in ("base", "neigh"))
    assert decided > spec.n, "the kill must land in the neighbourhood"
    DISPATCH_LOG.clear()
    got = fuzz.fuzz_campaign(spec, store_root=store.Store(tmp_path),
                             name="fz", resume=True, check_kwargs=P_OPTS,
                             device=CPU, **kw)
    assert {k: v for k, v in got.items() if k != "name"} == \
        {k: v for k, v in want.items() if k != "name"}
    total = want["checked"] + want["neighborhoods"]
    redispatched = sum(nrows for _, _, _, nrows in DISPATCH_LOG)
    assert redispatched == total - decided
    assert not (tmp_path / "fz" / "campaign.jsonl").exists()
    assert json.loads((tmp_path / "fz" / "fuzz-summary.json").read_text()
                      )["neighborhoods"] == want["neighborhoods"]
