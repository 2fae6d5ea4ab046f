"""The port's recheck registry and command line (jepsen_torch.recheck,
jepsen_torch.cli) against the reference's, on the CPU.

* Every family's good and bad stored run through ``jepsen_torch.cli.main
  recheck --device cpu`` and the reference's ``cli.main recheck`` on the
  same store: equal exit codes (0 good, 1 bad) and equal JSON lines, and
  ``recheck_family`` dicts field for field.
* Bank constants read per run from test.json (and a contradicting flag
  winning with a warning); ``independent`` defaulting from test.json.
* ``salvage --model cas --device cpu`` over a torn WAL: the same JSON
  line and exit code as the reference's.
* ``FAMILY_NAMES == set(registry())``, the copied suite constants, and
  bad arguments (exit 254).

Stored runs of a few ops each. Tolerance: none.
"""
import json
import logging

import pytest
import torch

from jepsen_tpu import cli as RCLI
from jepsen_tpu import recheck as RRE
from jepsen_tpu import store as RS

from jepsen_torch import cli as PCLI
from jepsen_torch import recheck as PRE
from jepsen_torch import store as PS
from jepsen_torch.history.core import index
from jepsen_torch.history.ops import invoke_op as inv, ok_op as ok
from jepsen_torch.history.wal import WAL_FILE, WAL_MAGIC
from jepsen_torch.independent import tuple_

torch.set_num_threads(1)

FAMILIES = {
    "set": ([inv(0, "add", 1), ok(0, "add", 1), inv(0, "add", 2),
             ok(0, "add", 2), inv(1, "read", None), ok(1, "read", [1, 2])],
            [inv(0, "add", 1), ok(0, "add", 1), inv(0, "add", 2),
             ok(0, "add", 2), inv(1, "read", None), ok(1, "read", [1])]),
    "crdb-set": ([inv(0, "add", 1), ok(0, "add", 1), inv(1, "read", None),
                  ok(1, "read", [1])],
                 [inv(0, "add", 1), ok(0, "add", 1), inv(0, "add", 2),
                  ok(0, "add", 2), inv(1, "read", None), ok(1, "read", [2])]),
    "queue": ([inv(0, "enqueue", 7), ok(0, "enqueue", 7),
               inv(1, "dequeue", None), ok(1, "dequeue", 7)],
              [inv(1, "dequeue", None), ok(1, "dequeue", 9)]),
    "total-queue": ([inv(0, "enqueue", 7), ok(0, "enqueue", 7),
                     inv(1, "drain", None), ok(1, "drain", [7])],
                    [inv(0, "enqueue", 7), ok(0, "enqueue", 7),
                     inv(0, "enqueue", 8), ok(0, "enqueue", 8),
                     inv(1, "drain", None), ok(1, "drain", [7])]),
    "ids": ([inv(0, "generate", None), ok(0, "generate", 1),
             inv(1, "generate", None), ok(1, "generate", 2)],
            [inv(0, "generate", None), ok(0, "generate", 1),
             inv(1, "generate", None), ok(1, "generate", 1)]),
    "counter": ([inv(0, "add", 5), ok(0, "add", 5), inv(1, "read", None),
                 ok(1, "read", 5)],
                [inv(0, "add", 5), ok(0, "add", 5), inv(1, "read", None),
                 ok(1, "read", 99)]),
    "bank": ([inv(0, "read", None), ok(0, "read", {a: 10 for a in range(5)})],
             [inv(0, "read", None), ok(0, "read", {a: 7 for a in range(5)})]),
    "mutex": ([inv(0, "acquire", None), ok(0, "acquire", None),
               inv(0, "release", None), ok(0, "release", None)],
              [inv(0, "acquire", None), ok(0, "acquire", None),
               inv(1, "acquire", None), ok(1, "acquire", None)]),
    "fifo-queue": ([inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                    inv(0, "enqueue", 2), ok(0, "enqueue", 2),
                    inv(1, "dequeue", None), ok(1, "dequeue", 1)],
                   [inv(0, "enqueue", 1), ok(0, "enqueue", 1),
                    inv(0, "enqueue", 2), ok(0, "enqueue", 2),
                    inv(1, "dequeue", None), ok(1, "dequeue", 2)]),
    "cas": ([inv(0, "write", 1), ok(0, "write", 1), inv(1, "read", None),
             ok(1, "read", 1)],
            [inv(0, "write", 1), ok(0, "write", 1), inv(1, "read", None),
             ok(1, "read", 2)]),
    "cas-absent": ([inv(1, "read", None), ok(1, "read", "absent"),
                    inv(0, "write", 1), ok(0, "write", 1)],
                   [inv(0, "write", 1), ok(0, "write", 1),
                    inv(1, "read", None), ok(1, "read", "absent")]),
}


def jsonable(x):
    return json.loads(json.dumps(x, default=repr))


def store_runs(tmp_path, monkeypatch, name, runs, test=None):
    """Runs written by the port under ./store, the default store of both
    command lines."""
    monkeypatch.chdir(tmp_path)
    s = PS.Store("store")
    for i, h in enumerate(runs):
        hd = s.create(name, ts=f"r{i}")
        if test is not None:
            hd.save_test(test[i] if isinstance(test, list) else test)
        hd.save_history(index([op.with_() for op in h]))
    return s


def run_main(main, args, capsys):
    with pytest.raises(SystemExit) as e:
        main(args)
    out = capsys.readouterr().out.strip().splitlines()
    return e.value.code or 0, json.loads(out[-1]) if out else None


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_through_the_cli(tmp_path, monkeypatch, capsys,
                                      family):
    good, bad = FAMILIES[family]
    s = store_runs(tmp_path, monkeypatch, "good", [good])
    store_runs(tmp_path, monkeypatch, "bad", [bad, good])
    for name, want_rc in (("good", 0), ("bad", 1)):
        args = ["recheck", "--test", name, "--model", family]
        got = run_main(PCLI.main, args + ["--device", "cpu"], capsys)
        want = run_main(RCLI.main, args, capsys)
        assert got == want
        assert got[0] == want_rc
        assert jsonable(PRE.recheck_family(s, name, family, device="cpu")) \
            == jsonable(RRE.recheck_family(RS.Store("store"), name, family))


def test_family_names_cover_the_registry():
    assert set(PRE.FAMILY_NAMES) == set(PRE.registry())
    assert PRE.FAMILY_NAMES == RRE.FAMILY_NAMES
    from jepsen_tpu.suites.etcd import ABSENT
    assert PRE.ABSENT == ABSENT
    for family, spec in PRE.registry().items():
        want = RRE.registry()[family]
        assert spec["kind"] == want["kind"]
        if spec["kind"] == "linear":
            assert repr(spec["model"]()) == repr(want["model"]())
        else:
            assert spec.get("fold") == want.get("fold")


def test_bank_constants_read_per_run(tmp_path, monkeypatch, caplog):
    from jepsen_tpu.suites.cockroachdb import BankChecker, bank_workload
    h3 = [inv(0, "read", None), ok(0, "read", {a: 20 for a in range(3)})]
    h7 = [inv(0, "read", None), ok(0, "read", {a: 4 for a in range(7)})]
    tests = [{"name": "bank3", "invariants": bank_workload(
        {"accounts": a, "balance": b})["invariants"]}
        for a, b in ((3, 20), (7, 4))]
    s = store_runs(tmp_path, monkeypatch, "bank3", [h3, h7], test=tests)
    r = RS.Store("store")
    for kw in ({}, {"accounts": 5, "balance": 10}):
        got = PRE.recheck_family(s, "bank3", "bank", device="cpu", **kw)
        assert jsonable(got) == jsonable(
            RRE.recheck_family(r, "bank3", "bank", **kw))
        assert got["valid"] is (not kw)
    with caplog.at_level(logging.WARNING, logger="jepsen.recheck"):
        PRE.recheck_family(s, "bank3", "bank", accounts=5, device="cpu")
    assert any("contradicts the stored run" in x.message
               for x in caplog.records)
    for h in (h3, h7, [inv(0, "read", None)]):
        ops = [op.with_() for op in h]
        assert PRE.BankChecker(3, 20).check({}, None, ops) == \
            BankChecker(3, 20).check({}, None, ops)


def test_independent_defaults_from_test_json(tmp_path, monkeypatch,
                                             capsys):
    h = [inv(0, "write", tuple_(1, 1)), ok(0, "write", tuple_(1, 1)),
         inv(1, "read", tuple_(1, None)), ok(1, "read", tuple_(1, 1)),
         inv(2, "write", tuple_(2, 5)), ok(2, "write", tuple_(2, 5)),
         inv(3, "read", tuple_(2, None)), ok(3, "read", tuple_(2, 6))]
    s = store_runs(tmp_path, monkeypatch, "reg", [h],
                   test={"name": "reg", "invariants": {"independent": True}})
    assert PRE.stored_invariants(s, "reg") == {"independent": True}
    got = PRE.recheck_family(s, "reg", "cas", device="cpu")
    assert set(got["runs"]["r0"]["results"]) == {1, 2}
    assert jsonable(got) == jsonable(
        RRE.recheck_family(RS.Store("store"), "reg", "cas"))
    args = ["recheck", "--test", "reg", "--model", "cas"]
    for extra in ([], ["--no-independent"]):
        assert run_main(PCLI.main, args + extra + ["--device", "cpu"],
                        capsys) == run_main(RCLI.main, args + extra, capsys)


def test_salvage_through_the_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("JT_SALVAGE_MIN_AGE_S", "0")
    lines = [json.dumps({"wal": WAL_MAGIC, "test": {"name": "w"}, "seed": 1,
                         "pid": 2 ** 22 + 12345, "phase": "setup"}),
             json.dumps({"phase": "run", "wal_ops": 0})]
    for k in range(6):
        v = 999 if k == 4 else k
        for typ, f, val in (("invoke", "write", k), ("ok", "write", k),
                            ("invoke", "read", None), ("ok", "read", v)):
            lines.append(json.dumps({"process": k % 2, "type": typ,
                                     "f": f, "value": val}))
    text = "\n".join(lines) + "\n" + lines[-1][:9]
    got = {}
    for pkg, main, extra in (("port", PCLI.main, ["--device", "cpu"]),
                             ("ref", RCLI.main, [])):
        d = tmp_path / pkg / "store" / "w" / "r0"
        d.mkdir(parents=True)
        (d / WAL_FILE).write_text(text)
        monkeypatch.chdir(tmp_path / pkg)
        assert run_main(main, ["salvage", "--list"], capsys)[1][
            "incomplete"] == ["w/r0"]
        got[pkg] = run_main(main, ["salvage", "--model", "cas"] + extra,
                            capsys)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1
    assert got["port"][1]["recheck"]["w"] == {"valid": False,
                                              "runs": {"r0": False}}


@pytest.mark.parametrize("args", [[], ["nope"], ["recheck"],
                                  ["salvage", "--run", "x"]])
def test_bad_arguments_exit_254(tmp_path, monkeypatch, capsys, args):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        PCLI.main(args)
    assert e.value.code == 254
