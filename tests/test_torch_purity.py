"""The port stands alone: jepsen_torch, chip_smoke.py and tools/ import
neither jax nor anything of jepsen_tpu, and nothing runs on the CPU unless the
caller asks for it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "jepsen_torch"
# Every module and package of the port (a package by its __init__.py).
MODULES = sorted(
    ".".join((p.parent if p.name == "__init__.py" else p.with_suffix(""))
             .relative_to(ROOT).parts)
    for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert {"jepsen_torch.ops.linearize", "jepsen_torch.ops.synth_device",
            "jepsen_torch.ops.cuda_synth", "jepsen_torch.ops._build",
            "jepsen_torch.history.columnar", "jepsen_torch.ops.faults",
            "jepsen_torch.ops.graph", "jepsen_torch.ops.cuda_graph",
            "jepsen_torch.ops.txn_graph", "jepsen_torch.ops.synth_txn",
            "jepsen_torch.checkers.cycle",
            "jepsen_torch.isolation", "jepsen_torch.ops.folds",
            "jepsen_torch.ops.cuda_folds", "jepsen_torch.checkers.simple",
            "jepsen_torch.utils.core", "jepsen_torch.ops.dc_monitor",
            "jepsen_torch.ops.cuda_dc", "jepsen_torch.fleet",
            "jepsen_torch.store", "jepsen_torch.runtime",
            "jepsen_torch.fuzz", "jepsen_torch.provision",
            "jepsen_torch.parallel.mesh", "jepsen_torch.parallel.frontier",
            "jepsen_torch.ops.cuda_shard", "jepsen_torch.native",
            "jepsen_torch.online", "jepsen_torch.history.wal",
            "jepsen_torch.history.codec", "jepsen_torch.telemetry",
            "jepsen_torch.recheck", "jepsen_torch.cli",
            "jepsen_torch.checkers.brute",
            "jepsen_torch.checkers.linear_report",
            "jepsen_torch.checkers.core", "jepsen_torch.independent"
            } <= set(MODULES)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"] +
                         sorted((ROOT / "tools").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_entry_points_need_a_card_unless_told(monkeypatch):
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import linearize as L
    from jepsen_torch.workloads.synth import synth_cas_batch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hists = synth_cas_batch(2, n_ops=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.check_batch(cas_register(), hists)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.check_one(cas_register(), hists[0])
    assert L.check_batch(cas_register(), hists, device="cpu")


@pytest.mark.parametrize("name", [
    "check_sets_batch", "check_crdb_sets_batch", "check_total_queues_batch",
    "check_unique_ids_batch", "check_counters_batch", "check_queues_batch",
    "check_fifo_queues_batch"])
def test_fold_checks_need_a_card_unless_told(monkeypatch, name):
    from jepsen_torch.history.ops import invoke_op, ok_op
    from jepsen_torch.ops import folds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fold = getattr(folds, name)
    h = [invoke_op(0, "add", 1), ok_op(0, "add", 1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fold([h])
    assert len(fold([h], device="cpu")) == 1


def test_recheck_entry_points_need_a_card_unless_told(monkeypatch,
                                                    tmp_path, capsys):
    from jepsen_torch import cli, recheck
    from jepsen_torch.checkers.linearizable import linearizable
    from jepsen_torch.history.core import index
    from jepsen_torch.independent import BatchLinearizableChecker
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.store import Store
    from jepsen_torch.workloads.synth import synth_cas_batch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    s = Store("store")
    s.create("t", ts="r0").save_history(index(synth_cas_batch(1, n_ops=6)[0]))
    calls = [
        lambda: s.recheck("t", cas_register()),
        lambda: s.recheck("t", cas_register(), independent=True),
        lambda: s.recheck_isolation("t"),
        lambda: recheck.recheck_family(s, "t", "cas"),
        lambda: recheck.recheck_family(s, "t", "bank"),
        lambda: BatchLinearizableChecker(),
        lambda: linearizable("cuda"),
        lambda: linearizable("competition"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit) as e:
        cli.main(["recheck", "--test", "t", "--model", "cas"])
    assert e.value.code == 255
    assert s.recheck("t", cas_register(), device="cpu")["valid"] is True
    with pytest.raises(SystemExit) as e:
        cli.main(["recheck", "--test", "t", "--model", "cas",
                  "--device", "cpu"])
    assert e.value.code == 0


def test_cli_without_a_card_says_so(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "jepsen_torch.cli",
                          "recheck", "--test", "t", "--model", "cas"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 255
    assert "no CUDA device" in out.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
