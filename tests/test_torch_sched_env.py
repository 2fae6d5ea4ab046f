"""The scheduler's environment knobs: the port reads the reference's
variables with the reference's defaults and parsing.

The reference reads most of its knobs once, when ``ops/schedule.py`` is
imported, so both packages run in one child process that sets each
variable, reloads the reference's module and drives each package's
``BucketScheduler`` over the same mixed-window buckets and each
package's ``GraphScheduler`` over the same list-append graphs. The plan
keys of the two packages' ``stats`` dicts must be equal under every
knob, and each knob must move the plan away from the defaults. Outside
the fuse-width case both schedulers get ``fuse_width=1``: under the
tests' settings (JT_COMPILE_CACHE=0) the reference's default fuse width
is 1 and the port's is 4, since the port has no compile to save. The
degradation ladder's knobs move its settings instead: the retry budget
and backoff, each scheduler's watchdog deadlines for one bucket (the
first wait with its grace, then without), and, under a sticky
out-of-memory (the bisection floor) or a sticky corruption (the retry
budget), the learned safe sizes and the ladder's counters. Tolerance:
none.
"""
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_torch.ops.schedule import KNOBS, BucketScheduler, knob

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

PLAN_KEYS = {"wgl": ("classes", "chunks", "dispatches", "fused_groups",
                     "rows", "pad_rows", "events", "orig_events",
                     "event_routed_rows", "event_routed_dispatches",
                     "backpressure_events"),
             "graph": ("graphs", "buckets", "chunks", "closure_matmuls",
                       "mxu_macs")}

# One case per knob: the variables set for it. The event-chunk case also
# lowers the route threshold, since the chunk applies only on that route.
CASES = {
    "chunk_rows": {"JT_SCHED_CHUNK_ROWS": "8"},
    "max_classes": {"JT_SCHED_CLASSES": "2"},
    "fuse_width": {"JT_SCHED_FUSE_WIDTH": "2"},
    "max_queue": {"JT_SCHED_MAX_QUEUE": "1"},
    "event_route_events": {"JT_EVENT_ROUTE_EVENTS": "24"},
    "event_chunk": {"JT_EVENT_ROUTE_EVENTS": "24", "JT_EVENT_CHUNK": "8"},
    "graph_chunk_rows": {"JT_GRAPH_CHUNK_ROWS": "4"},
    "retry_max": {"JT_RETRY_MAX": "1"},
    "retry_backoff_s": {"JT_RETRY_BACKOFF_S": "0.5"},
    "watchdog_min_s": {"JT_WATCHDOG_MIN_S": "30"},
    "watchdog_lane_ops_per_s": {"JT_WATCHDOG_LANE_OPS_PER_S": "2.5e3"},
    "watchdog_mxu_macs_per_s": {"JT_WATCHDOG_MXU_MACS_PER_S": "1e3"},
    "watchdog_factor": {"JT_WATCHDOG_FACTOR": "64"},
    "watchdog_compile_grace_s": {"JT_WATCHDOG_COMPILE_GRACE_S": "7.5"},
    "bisect_floor_rows": {"JT_BISECT_FLOOR_ROWS": "4"},
}

# Cases whose plans also run a sticky fault (their knob moves only what
# the ladder does), and the default's for comparison.
FAULTED = ("default", "retry_max", "bisect_floor_rows")

CHILD = r"""
import importlib, json, os, sys
import torch
torch.set_num_threads(1)
from jepsen_tpu.checkers.linearizable import prepare_history as r_prep
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops.encode import bucket_encode as r_enc
from jepsen_tpu.ops import graph as RG
import jepsen_tpu.ops.schedule as RS
from jepsen_tpu.workloads.synth import synth_cas_history as r_hist
from jepsen_tpu.workloads.synth import synth_la_history as r_la
from jepsen_torch.checkers.linearizable import prepare_history
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import graph as PG
from jepsen_torch.ops import schedule as PS
from jepsen_torch.ops.encode import bucket_encode
from jepsen_torch.workloads.synth import synth_cas_history, synth_la_history

cases, keys = json.loads(sys.argv[1]), json.loads(sys.argv[2])
faulted = json.loads(sys.argv[3])
from jepsen_tpu.ops import faults as RF
from jepsen_torch.ops import faults as PF

def hists(h):
    return [h(i, n_procs=2 + i % 7, n_ops=20,
              corrupt=0.4 if i % 3 == 0 else 0.0,
              p_info=0.25 if i % 4 == 0 else 0.0) for i in range(60)]

rb = r_enc(r_cas(), [r_prep(h) for h in hists(r_hist)])
pb = bucket_encode(cas_register(),
                   [prepare_history(h) for h in hists(synth_cas_history)])
rg = RG.encode_graphs([RG.extract_graph(r_la(s, n_ops=8 + s))
                       for s in range(20)])
pg = PG.encode_graphs([PG.extract_graph(synth_la_history(s, n_ops=8 + s))
                       for s in range(20)])
def ladder(sch, gs, b, g):
    return {"max_retries": sch.max_retries, "backoff_s": sch.backoff_s,
            "deadline": [sch._deadline(b, 64), sch._deadline(b, 64)],
            "graph_deadline": [gs._deadline(g, 8), gs._deadline(g, 8)]}

def sticky(make, faults, kind, buckets):
    sch = make(faults.FaultInjector(faults.FaultPlan.sticky(
        "dispatch" if kind == "oom" else "decode", kind)))
    list(sch.run(list(buckets)))
    return {"safe_bp": sorted(map(list, sch._safe_bp.items())),
            **{k: sch.stats[k] for k in (
                "retries", "bisections", "oom_events", "corrupt_chunks",
                "quarantined_rows")}}

out = {}
for name, env in cases.items():
    os.environ.update(env)
    importlib.reload(RS)
    opts = {} if "JT_SCHED_FUSE_WIDTH" in env else {"fuse_width": 1}
    r = RS.BucketScheduler(wgl_backend="xla", prewarm=False,
                           shard_min_rows=1 << 30, **opts)
    list(r.run(list(rb)))
    p = PS.BucketScheduler(device="cpu", **opts)
    list(p.run(list(pb)))
    rgs = RS.GraphScheduler(compilation_cache=False)
    list(rgs.run(rg))
    pgs = PS.GraphScheduler(device="cpu")
    list(pgs.run(pg))
    out[name] = {
        "ref": {"wgl": {k: r.stats[k] for k in keys["wgl"]},
                "graph": {k: rgs.stats[k] for k in keys["graph"]},
                "ladder": ladder(RS.BucketScheduler(prewarm=False),
                                 RS.GraphScheduler(compilation_cache=False),
                                 rb[0], rg[0])},
        "port": {"wgl": {k: p.stats[k] for k in keys["wgl"]},
                 "graph": {k: pgs.stats[k] for k in keys["graph"]},
                 "ladder": ladder(PS.BucketScheduler(device="cpu"),
                                  PS.GraphScheduler(device="cpu"),
                                  pb[0], pg[0])}}
    if name in faulted:
        small, psmall = [b for b in rb if b.W <= 4], [b for b in pb
                                                      if b.W <= 4]
        for kind in ("oom", "corrupt"):
            out[name]["ref"][kind] = sticky(
                lambda f: RS.BucketScheduler(
                    faults=f, prewarm=False, fuse_width=1, chunk_rows=32,
                    shard_min_rows=1 << 30, wgl_backend="xla"),
                RF, kind, small)
            out[name]["port"][kind] = sticky(
                lambda f: PS.BucketScheduler(faults=f, fuse_width=1,
                                             chunk_rows=32, device="cpu"),
                PF, kind, psmall)
    for var in env:
        del os.environ[var]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def plans():
    """{case: {"ref": plan, "port": plan}} for every case and for the
    defaults, from one child process."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JT_SCHED_", "JT_EVENT_", "JT_RETRY_",
                                "JT_WATCHDOG_", "JT_BISECT_",
                                "JT_FAULT_PLAN"))}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               JT_COMPILE_CACHE="0", JT_DISPATCH_OVERHEAD_US="0")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", CHILD,
         json.dumps({"default": {}, **CASES}), json.dumps(PLAN_KEYS),
         json.dumps(FAULTED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_knob_gives_the_references_plan(plans, case):
    got = plans[case]
    assert got["port"] == got["ref"], case
    assert got["port"] != plans["default"]["port"], \
        f"{case} did not move the plan"


def test_defaults_are_unchanged(plans, monkeypatch):
    for var, _, _ in KNOBS.values():
        monkeypatch.delenv(var, raising=False)
    assert {n: knob(n) for n in KNOBS} == {
        "chunk_rows": 1024, "max_classes": 5, "fuse_width": 4,
        "max_queue": 0, "event_route_events": 8192, "event_chunk": 2048,
        "graph_chunk_rows": 2048, "retry_max": 3, "retry_backoff_s": 0.25,
        "watchdog_min_s": 120.0, "watchdog_lane_ops_per_s": 1e8,
        "watchdog_mxu_macs_per_s": 1e11, "watchdog_factor": 32.0,
        "watchdog_compile_grace_s": 900.0, "bisect_floor_rows": 16,
        "shard_min_rows": 8}
    assert plans["default"]["port"] == plans["default"]["ref"]


def test_malformed_knob_is_logged_and_ignored(monkeypatch, caplog):
    monkeypatch.setenv("JT_SCHED_CHUNK_ROWS", "many")
    monkeypatch.setenv("JT_SCHED_FUSE_WIDTH", "99")
    with caplog.at_level(logging.WARNING, logger="jepsen.schedule"):
        sch = BucketScheduler(device="cpu")
    assert sch.chunk_rows == 1024
    assert "JT_SCHED_CHUNK_ROWS" in caplog.text
    # Past the group entry's member limit the width is capped.
    assert sch.fuse_width == 8
