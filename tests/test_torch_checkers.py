"""The port's checker surface against the reference's, on the CPU.

* ``check_safe`` (an exception becomes ``valid: "unknown"``), ``compose``
  (parallel and serial, the verdict lattice) and ``always_valid``.
* ``brute_check`` (the permutation oracle) against the reference's on
  random small histories: the same verdict and witness order.
* Every ``LinearizableChecker`` backend against its reference
  counterpart, whole dicts: host, native, cuda (``device="cpu"``)
  against the reference's tpu backend on JAX's CPU, brute, and
  competition (the winner's dict against the reference engine of the
  same name, and its verdict and bad op against both engines).
* ``render_svg`` strings identical for invalid results; ``linear.svg``
  written into the run dir, and a render failure leaving the verdict.
* ``IndependentChecker`` and ``BatchLinearizableChecker`` result dicts
  field for field, with identical per-key artifact files
  (results.json, history.txt, history.jsonl, linear.svg).
* The pool seam: ``LinearPool.take`` served to both checkers, skipped
  by brute and by a batch checker with engine keyword arguments, and
  ``_linear_unit_kinds`` over checker trees.

Histories come from the packages' seeded generators (the same seeds in
both), a few dozen rows of 10-80 ops. Tolerance: none, exact equality.
"""
import importlib
import json
from pathlib import Path

import pytest
import torch

from jepsen_tpu import independent as RI
from jepsen_tpu import runtime as RR
from jepsen_tpu import store as RS
from jepsen_tpu.checkers import core as RCORE
from jepsen_tpu.checkers import linear_report as RREP
from jepsen_tpu.history import ops as RO
from jepsen_tpu.history.core import index as r_index
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.native import wgl_check_native as r_native
from jepsen_tpu.ops.linearize import check_one_tpu as r_check_one
from jepsen_tpu.workloads import synth as RSY

from jepsen_torch import independent as PI
from jepsen_torch import runtime as PR
from jepsen_torch import store as PS
from jepsen_torch.checkers import core as PCORE
from jepsen_torch.checkers import linear_report as PREP
from jepsen_torch.history import ops as PO
from jepsen_torch.history.core import index as p_index
from jepsen_torch.models.core import cas_register as p_cas
from jepsen_torch.native import wgl_check_native as p_native
from jepsen_torch.ops.linearize import check_one as p_check_one
from jepsen_torch.workloads import synth as PSY

# The checkers packages export the functions ``linearizable`` and
# ``brute``, which shadow the submodules of the same names.
RB = importlib.import_module("jepsen_tpu.checkers.brute")
PB = importlib.import_module("jepsen_torch.checkers.brute")
RLIN = importlib.import_module("jepsen_tpu.checkers.linearizable")
PLIN = importlib.import_module("jepsen_torch.checkers.linearizable")

torch.set_num_threads(1)

PKGS = {
    "ref": dict(core=RCORE, brute=RB, lin=RLIN, rep=RREP, ind=RI, rt=RR,
                store=RS, ops=RO, index=r_index, cas=r_cas, synth=RSY),
    "port": dict(core=PCORE, brute=PB, lin=PLIN, rep=PREP, ind=PI, rt=PR,
                 store=PS, ops=PO, index=p_index, cas=p_cas, synth=PSY),
}
CUDA = {"ref": ("tpu", {}), "port": ("cuda", {"device": "cpu"})}


def jsonable(x):
    return json.loads(json.dumps(x, default=repr))


def corpus(pkg, n=12, seed=3, **kw):
    kw = {"n_procs": 3, "n_ops": 10, "n_values": 3, "corrupt": 0.3, **kw}
    return PKGS[pkg]["synth"].synth_cas_batch(n, seed, **kw)


def keyed(pkg, n_keys=4, n_ops=12, seed=15, corrupt=0.9):
    """One KV-valued history: per-key cas histories on disjoint
    processes, interleaved op by op, indexed."""
    P = PKGS[pkg]
    subs = [P["synth"].synth_cas_history(seed + k, n_procs=3, n_ops=n_ops,
                                         n_values=3, corrupt=corrupt)
            for k in range(n_keys)]
    out = []
    for i in range(max(len(s) for s in subs)):
        for k, s in enumerate(subs):
            if i < len(s):
                op = s[i]
                out.append(P["ops"].Op(
                    process=op.process + 3 * k, type=op.type, f=op.f,
                    value=P["ind"].tuple_(k, op.value)))
    return P["index"](out)


# ------------------------------------------------------------ core

class Boom(Exception):
    pass


def boom(test, model, history, opts):
    raise Boom("nope")


@pytest.mark.parametrize("parallel", [True, False])
def test_check_safe_and_compose(parallel):
    got = {}
    for pkg, P in PKGS.items():
        core = P["core"]
        h = corpus(pkg, 1)[0]
        safe = core.check_safe(boom, {}, P["cas"](), h)
        assert safe["valid"] == "unknown" and "Boom: nope" in safe["error"]
        c = core.compose({"lin": P["lin"].linearizable("host"),
                          "ok": core.always_valid(),
                          "fn": core.FnChecker(
                              lambda t, m, hh, o: {"valid": len(hh) > 0}),
                          "boom": boom}, parallel=parallel)
        r = c.check({}, P["cas"](), h)
        r["boom"] = {k: v for k, v in r["boom"].items() if k != "error"}
        got[pkg] = jsonable(r)
        assert core.merge_valid([True, "unknown"]) == "unknown"
        assert core.merge_valid([True, "unknown", False]) is False
    assert got["port"] == got["ref"]
    assert got["port"]["valid"] in ("unknown", False)


# ----------------------------------------------------------- brute

@pytest.mark.parametrize("seed", range(6))
def test_brute_check_matches_the_reference(seed):
    for kw in ({}, {"n_procs": 4, "p_info": 0.2}):
        rs = [RB.brute_check(r_cas(), h)
              for h in corpus("ref", 8, seed, **kw)]
        ps = [PB.brute_check(p_cas(), h)
              for h in corpus("port", 8, seed, **kw)]
        assert ps == rs
    assert any(r["valid"] is False for r in ps)
    with pytest.raises(ValueError, match="capped"):
        PB.brute_check(p_cas(), corpus("port", 1, n_ops=40)[0])


# ------------------------------------------------------- backends

@pytest.mark.parametrize("backend", ["host", "native", "cuda", "brute"])
def test_linearizable_backend_matches_the_reference(backend):
    got = {}
    for pkg, P in PKGS.items():
        name, kw = CUDA[pkg] if backend == "cuda" else (backend, {})
        chk = P["lin"].linearizable(name, **kw)
        got[pkg] = [jsonable(chk.check({}, P["cas"](), h))
                    for h in corpus(pkg, 10, 21)]
    assert got["port"] == got["ref"]
    assert any(r["valid"] is False for r in got["port"])


def test_competition_matches_both_engines():
    chk = PLIN.linearizable("competition", device="cpu")
    rchk = RLIN.linearizable("competition")
    engines = {"native": r_native, "cuda": r_check_one}
    for rh, ph in zip(corpus("ref", 10, 33), corpus("port", 10, 33)):
        before = dict(chk.wins)
        r = chk.check({}, p_cas(), ph)
        won = next(k for k in chk.wins if chk.wins[k] != before.get(k, 0))
        assert jsonable(r) == jsonable(engines[won](r_cas(), rh))
        want = rchk.check({}, r_cas(), rh)
        for other in (p_native(p_cas(), ph),
                      p_check_one(p_cas(), ph, device="cpu"), want):
            assert r["valid"] == other["valid"]
            assert r.get("op") == other.get("op")
    assert sum(chk.wins.values()) == 10


def test_competition_racer_that_raises_falls_through(monkeypatch):
    from jepsen_torch.ops import linearize as L

    def broken(*a, **kw):
        raise RuntimeError("card lost")
    monkeypatch.setattr(L, "check_one", broken)
    chk = PLIN.linearizable("competition", device="cpu")
    h = corpus("port", 1, 2)[0]
    assert chk.check({}, p_cas(), h) == p_native(p_cas(), h)
    assert chk.wins == {"native": 1}


EXIT_CHILD = r"""
import importlib, pathlib, sys, time
sys.path.insert(0, sys.argv[1])
PLIN = importlib.import_module("jepsen_torch.checkers.linearizable")
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import linearize as L
from jepsen_torch.workloads.synth import synth_cas_batch
PLIN.RACER_EXIT_WAIT_S = float(sys.argv[4])

def slow(*a, **kw):
    time.sleep(float(sys.argv[3]))
    pathlib.Path(sys.argv[2]).write_text("finished")
    raise RuntimeError("lost anyway")
L.check_one = slow
h = synth_cas_batch(1, 0, n_ops=10)[0]
r = PLIN.linearizable("competition", device="cpu").check(
    {}, cas_register(), h)
print(r["valid"], flush=True)
"""


@pytest.mark.parametrize("racer_s,wait_s,finished", [(1.0, 30.0, True),
                                                     (60.0, 1.0, False)])
def test_exit_waits_for_a_lost_racer_a_bounded_time(tmp_path, racer_s,
                                                     wait_s, finished):
    """A lost racer still running at exit is waited for, at most
    RACER_EXIT_WAIT_S: the exit is clean, and a wedged racer delays it by
    that wait only."""
    import subprocess
    import sys
    import time
    marker = tmp_path / "racer"
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", EXIT_CHILD,
                          str(Path(__file__).resolve().parents[1]),
                          str(marker), str(racer_s), str(wait_s)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True"]
    assert marker.exists() is finished
    assert time.monotonic() - t0 < 45


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="unknown linearizability"):
        PLIN.linearizable("tpu")


# ---------------------------------------------------------- render

def invalid_corpus(pkg):
    return [h for h in corpus(pkg, 30, 41, n_ops=30, corrupt=0.5)
            if PKGS[pkg]["lin"].wgl_check(PKGS[pkg]["cas"](), h)["valid"]
            is False][:6]


def test_render_svg_strings_identical():
    rs, ps = invalid_corpus("ref"), invalid_corpus("port")
    assert len(ps) == len(rs) >= 3
    for rh, ph in zip(rs, ps):
        rr = RLIN.wgl_check(r_cas(), rh)
        pr = PLIN.wgl_check(p_cas(), ph)
        assert PREP.render_svg(p_cas(), ph, pr) == \
            RREP.render_svg(r_cas(), rh, rr)
    assert PREP.TYPE_COLORS == __import__(
        "jepsen_tpu.checkers.timeline", fromlist=["TYPE_COLORS"]
    ).TYPE_COLORS


def run_tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_linear_svg_written_and_render_failure_keeps_verdict(
        tmp_path, monkeypatch):
    trees = {}
    for pkg, P in PKGS.items():
        h = invalid_corpus(pkg)[0]
        handle = P["store"].StoreHandle(tmp_path / pkg)
        r = P["lin"].linearizable("host").check(
            {"store_handle": handle}, P["cas"](), h)
        assert r["valid"] is False
        trees[pkg] = run_tree(tmp_path / pkg)
    assert list(trees["port"]) == ["linear.svg"]
    assert trees["port"] == trees["ref"]

    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(PREP, "write_analysis", broken)
    h = invalid_corpus("port")[0]
    r = PLIN.linearizable("host").check(
        {"store_handle": PS.StoreHandle(tmp_path / "x")}, p_cas(), h)
    assert r["valid"] is False


# ----------------------------------------------------- independent

@pytest.mark.parametrize("lifted", ["independent", "batch"])
def test_lifted_checkers_match_with_identical_artifacts(tmp_path, lifted):
    got, trees = {}, {}
    for pkg, P in PKGS.items():
        if lifted == "independent":
            chk = P["ind"].checker(P["lin"].linearizable("host"))
        else:
            chk = P["ind"].BatchLinearizableChecker(
                **({"device": "cpu"} if pkg == "port" else {}))
        handle = P["store"].StoreHandle(tmp_path / pkg)
        got[pkg] = jsonable(chk.check({"store_handle": handle}, P["cas"](),
                                      keyed(pkg)))
        trees[pkg] = run_tree(tmp_path / pkg)
    assert got["port"] == got["ref"]
    assert got["port"]["failures"]
    assert trees["port"] == trees["ref"]
    svgs = [k for k in trees["port"] if k.endswith("linear.svg")]
    assert len(svgs) == len(got["port"]["failures"])
    if lifted == "batch":
        assert got["port"]["oracle-spot"]["agree"] is True


def test_batch_checker_oracle_disagreement_is_unknown(monkeypatch):
    monkeypatch.setattr(PB, "brute_check",
                        lambda model, h, **kw: {"valid": "flipped"})
    chk = PI.BatchLinearizableChecker(device="cpu")
    r = PCORE.check_safe(chk, {}, p_cas(), keyed("port"))
    assert r["valid"] == "unknown" and "self-check failed" in r["error"]


@pytest.mark.parametrize("oracle_spot", [0, 1])
def test_batch_checker_oracle_spot_matches(oracle_spot):
    a = PI.BatchLinearizableChecker(device="cpu", oracle_spot=oracle_spot)
    b = RI.BatchLinearizableChecker(oracle_spot=oracle_spot)
    got = jsonable(a.check({}, p_cas(), keyed("port")))
    assert got == jsonable(b.check({}, r_cas(), keyed("ref")))
    spot = got.get("oracle-spot")
    assert (spot is None) if oracle_spot == 0 else len(spot["keys"]) == 1


# ------------------------------------------------------------ pool

def test_pool_seam_through_linear_pool_take():
    got = {}
    for pkg, P in PKGS.items():
        h = keyed(pkg)
        keys = P["ind"].history_keys(h)
        pool = P["rt"].LinearPool()
        for k in keys:
            pool.results[(0, k)] = {"valid": True, "pooled": k}
        pool.results[(0, None)] = {"valid": False, "pooled": "whole"}
        test = {"_linear_pool": pool, "_pool_run": 0}
        dev = {"device": "cpu"} if pkg == "port" else {}
        out = {
            "batch": P["ind"].BatchLinearizableChecker(
                oracle_spot=0, **dev).check(test, P["cas"](), h),
            # Engine kwargs of its own: the pool is never read.
            "batch_kw": P["ind"].BatchLinearizableChecker(
                max_slots=16, **dev).check(test, P["cas"](), h),
            "lifted": P["ind"].checker(P["lin"].linearizable("host")).check(
                test, P["cas"](), h),
            "whole": P["lin"].linearizable("host").check(
                test, P["cas"](), h),
            "brute": P["lin"].linearizable("brute").check(
                test, P["cas"](), P["ind"].subhistory(keys[0], h)),
        }
        # take() hands out copies.
        out["whole"]["mutated"] = True
        assert "mutated" not in pool.take(test, None)
        got[pkg] = jsonable(out)
        core = P["core"]
        lin = P["lin"].linearizable
        trees = [lin("host"), lin("brute"), P["ind"].checker(lin("host")),
                 P["ind"].BatchLinearizableChecker(**dev),
                 core.compose({"a": lin("brute"),
                               "b": P["ind"].checker(lin("native"))}),
                 core.compose({"a": lin("host"),
                               "b": P["ind"].checker(lin("host"))})]
        got[pkg]["kinds"] = [P["rt"]._linear_unit_kinds(t) for t in trees]
    assert got["port"] == got["ref"]
    assert got["port"]["batch"]["results"]["0"]["pooled"] == 0
    assert "pooled" not in got["port"]["batch_kw"]["results"]["0"]
    assert "pooled" not in got["port"]["brute"]
