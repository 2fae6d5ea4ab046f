"""Command-line entry points of the port: ``recheck`` and ``salvage``.

Mirrors the reference's ``cli.py`` dispatch (jepsen/src/jepsen/
cli.clj:201-276): ``run_cli`` parses a subcommand map and exits 0 when
the analysis is valid, 1 when it is invalid, 254 on bad arguments and
255 when the harness itself crashed. Both commands work on the default
store (``./store``) and check on the CUDA card unless ``--device``
names another device (``--device cpu`` runs the plain versions).

    python -m jepsen_torch.cli recheck --test NAME --model cas
    python -m jepsen_torch.cli salvage --model cas

The reference's other commands (``test``, which runs a suite; ``watch``,
``fuzz``, ``fleet``, ``serve`` and the tracing, metrics, ingest and lint
commands) are not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import sys
import traceback
from typing import Dict, List, Optional, Sequence


def run_cli(subcommands: Dict[str, dict],
            argv: Optional[Sequence[str]] = None) -> None:
    """Dispatch argv against a subcommand map and exit with the contract
    above (cli.clj:201-276)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s{%(threadName)s} %(levelname)s %(name)s - "
               "%(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="jepsen-torch")
    sub = parser.add_subparsers(dest="command")
    for name, spec in subcommands.items():
        p = sub.add_parser(name)
        if spec.get("add_opts"):
            spec["add_opts"](p)

    if not argv or argv[0] in ("-h", "--help"):
        parser.print_help()
        sys.exit(254 if not argv else 0)
    if argv[0] not in subcommands:
        print(f"Usage: jepsen-torch COMMAND [OPTIONS ...]\n"
              f"Commands: {', '.join(sorted(subcommands))}")
        sys.exit(254)

    try:
        opts = parser.parse_args(argv)
    except SystemExit as e:
        sys.exit(0 if e.code == 0 else 254)

    try:
        code = subcommands[argv[0]]["run"](opts)
        sys.exit(code or 0)
    except SystemExit:
        raise
    except BaseException:
        logging.getLogger("jepsen.cli").fatal(
            "The test harness itself crashed (not the system under "
            "test). Cause:\n%s", traceback.format_exc())
        sys.exit(255)


def _add_device(p) -> None:
    p.add_argument("--device", default=None,
                   help="Device the checks run on (default: the CUDA "
                        "card; 'cpu' runs the plain versions)")


def recheck_cmd() -> dict:
    """``recheck --test NAME --model FAMILY``: re-analyze every stored
    run of a test (the replay seam). Every checker family a suite can
    record is accepted: linearizable models ride the batched device
    path, fold families pool all runs into one ops.folds dispatch, bank
    replays the balance invariant (the jepsen_torch.recheck registry)."""
    from .recheck import FAMILY_NAMES

    def add_opts(p):
        p.add_argument("--test", required=True,
                       help="Stored test name (store/<name>/...)")
        p.add_argument("--model", default="cas-absent",
                       choices=list(FAMILY_NAMES))
        # Invariant constants default from the stored run's test.json
        # ("invariants"): flags only override what the run recorded,
        # and a contradiction logs a warning.
        p.add_argument("--independent",
                       action=argparse.BooleanOptionalAction,
                       default=None,
                       help="Strain per-key subhistories first "
                            "(default: what the stored run recorded; "
                            "--no-independent forces whole-history "
                            "units)")
        p.add_argument("--accounts", type=int, default=None,
                       help="bank: expected account count (default: "
                            "the stored run's invariants, else 5)")
        p.add_argument("--balance", type=int, default=None,
                       help="bank: expected per-account start balance "
                            "(default: the stored run's invariants, "
                            "else 10)")
        p.add_argument("--resume", action="store_true", default=False,
                       help="Continue an interrupted recheck from its "
                            "durable chunk journal: rows with "
                            "journaled verdicts are never "
                            "re-dispatched")
        _add_device(p)

    def run(opts):
        import json as _json

        from .recheck import recheck_family
        from .store import DEFAULT
        out = recheck_family(DEFAULT, opts.test, opts.model,
                             independent=opts.independent,
                             accounts=opts.accounts,
                             balance=opts.balance,
                             resume=opts.resume, device=opts.device)
        line = {"valid": out["valid"],
                "runs": {ts: r["valid"]
                         for ts, r in out["runs"].items()}}
        if "resume_hits" in out:
            line["resume_hits"] = out["resume_hits"]
        print(_json.dumps(line, default=str))
        return 0 if out["valid"] is True else 1

    return {"recheck": {"add_opts": add_opts, "run": run}}


def salvage_cmd() -> dict:
    """``salvage [--test NAME] [--run TS] [--model FAMILY]``: salvage to
    verdict for crashed runs. With no arguments, lists and salvages
    every incomplete run (live WAL present, no results.json);
    ``--test``/``--run`` narrow the sweep. Salvage drops the torn WAL
    tail, completes dangling invocations as ``:info`` and writes the
    standard history files; ``--model FAMILY`` then rechecks the
    salvaged runs under that family."""
    from .recheck import FAMILY_NAMES

    def add_opts(p):
        p.add_argument("--test", default=None,
                       help="Salvage only this stored test's runs")
        p.add_argument("--run", default=None,
                       help="Salvage only this run timestamp "
                            "(requires --test)")
        p.add_argument("--model", default=None,
                       choices=list(FAMILY_NAMES),
                       help="After salvaging, recheck the salvaged "
                            "tests under this checker family")
        p.add_argument("--list", action="store_true", default=False,
                       help="Only list incomplete runs; salvage "
                            "nothing")
        _add_device(p)

    def run(opts):
        import json as _json
        import os as _os
        import time as _time

        from .history.wal import WAL_FILE, wal_header, writer_alive
        from .recheck import recheck_family
        from .store import DEFAULT

        if opts.run and not opts.test:
            print("--run requires --test")
            return 254
        if opts.model and not opts.list:
            # Resolve the device before salvaging anything: a sweep
            # that cannot reach its verdicts changes nothing.
            from .ops.device import resolve_device
            resolve_device(opts.device)
        targets = [(n, t) for n, t in DEFAULT.incomplete()
                   if (opts.test is None or n == opts.test)
                   and (opts.run is None or t == opts.run)]
        # A WAL still being written is a live run, not a crashed one:
        # the blind sweep skips a WAL whose writer pid is alive on this
        # host, or that changed within $JT_SALVAGE_MIN_AGE_S (default
        # 5 s). Naming an explicit --test --run overrides both.
        explicit = bool(opts.test and opts.run)
        skipped_live = []
        if not explicit:
            min_age = float(_os.environ.get("JT_SALVAGE_MIN_AGE_S",
                                            "5"))
            now = _time.time()

            def live(n, t):
                wal = DEFAULT.run_dir(n, t) / WAL_FILE
                return (writer_alive(wal_header(wal))
                        or now - wal.stat().st_mtime < min_age)

            fresh = [(n, t) for n, t in targets if live(n, t)]
            skipped_live = [f"{n}/{t}" for n, t in fresh]
            targets = [x for x in targets if x not in fresh]
        out = {"incomplete": [f"{n}/{t}" for n, t in targets],
               "skipped_live": skipped_live,
               "salvaged": {}, "errors": {}}
        salvaged_ts: Dict[str, List[str]] = {}
        if not opts.list:
            for n, t in targets:
                # One unreadable WAL must not abort the sweep.
                try:
                    out["salvaged"][f"{n}/{t}"] = DEFAULT.salvage(n, t)
                    salvaged_ts.setdefault(n, []).append(t)
                except Exception as e:
                    out["errors"][f"{n}/{t}"] = str(e)
        if opts.model and not opts.list:
            out["recheck"] = {}
            for name in sorted(salvaged_ts):
                # Only the runs salvaged in this sweep.
                r = recheck_family(DEFAULT, name, opts.model,
                                   timestamps=salvaged_ts[name],
                                   device=opts.device)
                out["recheck"][name] = {
                    "valid": r["valid"],
                    "runs": {ts: run_r["valid"]
                             for ts, run_r in r["runs"].items()}}
        print(_json.dumps(out, default=str))
        if opts.list:
            return 0
        if out["errors"]:
            return 1          # partial recovery is visible to scripts
        if opts.model:
            return 0 if all(r["valid"] is True
                            for r in out["recheck"].values()) else 1
        return 0

    return {"salvage": {"add_opts": add_opts, "run": run}}


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cli({**recheck_cmd(), **salvage_cmd()}, argv)


if __name__ == "__main__":
    main()
