"""Re-analysis of stored histories by checker family.

The reference framework re-derives results by running a test's checker
over a loaded history in the REPL (store.clj:165-171 and the checker
API); here every family a suite records is reachable from the command
line. The linearizable models ride the batched device path
(``Store.recheck``), the fold families pool every stored run into one
device dispatch per fold (ops.folds), and the bank invariant replays on
the host. One registry, so ``cli recheck --model`` accepts anything a
suite can produce. Every entry point runs on the card unless the caller
passes ``device="cpu"``, and raises without a card otherwise.

The registry's two suite constants, the etcd suite's ``ABSENT`` register
value and the cockroachdb suite's ``BankChecker``, are copies here: the
suites themselves are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

from .checkers.core import Checker
from .store import Store

# The etcd suite's initial register value: the workload model starts as
# CASRegister(ABSENT), so pre-first-write reads linearize and a
# post-write ABSENT read is a violation.
ABSENT = "absent"


class BankChecker(Checker):
    """Balance-sum invariant over ok reads (bank.clj:112-143): every read
    must see exactly ``accounts`` balances summing to the constant total,
    none negative (the cockroachdb suite's checker)."""

    def __init__(self, accounts: int = 5, balance: int = 10):
        self.accounts = accounts
        self.total = accounts * balance

    def check(self, test, model, history, opts=None) -> dict:
        bad = []
        n_reads = 0
        for op in history:
            if not (op.type == "ok" and op.f == "read"
                    and isinstance(op.value, dict)):
                continue
            n_reads += 1
            balances = op.value
            err = None
            if len(balances) != self.accounts:
                err = f"{len(balances)} accounts, expected {self.accounts}"
            elif sum(balances.values()) != self.total:
                err = (f"total {sum(balances.values())}, "
                       f"expected {self.total}")
            elif any(b < 0 for b in balances.values()):
                err = "negative balance"
            if err:
                bad.append({"op": op.to_dict(), "error": err})
        if n_reads == 0:
            return {"valid": "unknown", "error": "bank was never read"}
        return {"valid": not bad, "reads": n_reads,
                "bad-reads": bad[:10],
                "bad-read-count": len(bad)}


def _linear(model_fn) -> dict:
    return {"kind": "linear", "model": model_fn}


def _fold(batch_fn_name: str) -> dict:
    return {"kind": "fold", "fold": batch_fn_name}


def registry() -> Dict[str, dict]:
    """Family name -> how to re-derive verdicts for its stored
    histories. Linearizable families give a model for the WGL device
    path; fold families name their ops.folds batch checker (resolved
    lazily); "bank" replays the invariant on the host."""
    from .models.core import cas_register, fifo_queue, mutex
    return {
        "cas": _linear(cas_register),
        "cas-absent": _linear(lambda: cas_register(ABSENT)),
        "mutex": _linear(mutex),
        "fifo-queue": _linear(fifo_queue),
        "set": _fold("check_sets_batch"),
        "crdb-set": _fold("check_crdb_sets_batch"),
        "queue": _fold("check_queues_batch"),
        "total-queue": _fold("check_total_queues_batch"),
        "ids": _fold("check_unique_ids_batch"),
        "counter": _fold("check_counters_batch"),
        "bank": {"kind": "bank"},
    }


FAMILY_NAMES = ("cas", "cas-absent", "mutex", "fifo-queue", "set",
                "crdb-set", "queue", "total-queue", "ids", "counter",
                "bank")


def run_invariants(store: Store, test_name: str, ts: str) -> dict:
    """One stored run's serialized analysis constants: the
    ``invariants`` entry suites put in the test map so the replay seam
    re-derives the same invariant the run was checked under (bank
    accounts and balance, independent keys) instead of trusting
    operator flags. Empty when the run recorded none. Reads only the
    run's test.json."""
    import json

    tj = store.run_dir(test_name, ts) / "test.json"
    if not tj.exists():
        return {}
    try:
        inv = json.loads(tj.read_text()).get("invariants")
    except Exception:
        return {}
    return inv if isinstance(inv, dict) else {}


def stored_invariants(store: Store, test_name: str) -> dict:
    """The newest stored run's invariants (see run_invariants): the
    default for whole-test knobs like ``independent``; per-run constants
    (bank) resolve per run instead."""
    for ts in reversed(store.tests().get(test_name, [])):
        inv = run_invariants(store, test_name, ts)
        if inv:
            return inv
    return {}


def _resolve_constant(name: str, explicit, stored, default):
    """Stored-run constants win when the operator passed nothing; an
    explicit flag wins but warns when it contradicts the stored run."""
    import logging
    if explicit is None:
        return stored if stored is not None else default
    if stored is not None and explicit != stored:
        logging.getLogger("jepsen.recheck").warning(
            "recheck --%s=%s contradicts the stored run's %s=%s "
            "(test.json invariants); using the explicit flag",
            name, explicit, name, stored)
    return explicit


def recheck_family(store: Store, test_name: str, family: str, *,
                   independent: Optional[bool] = None,
                   accounts: Optional[int] = None,
                   balance: Optional[int] = None,
                   resume: bool = False,
                   timestamps=None, device=None) -> dict:
    """Re-analyze every stored run of ``test_name`` under ``family``, or
    only ``timestamps`` when given (the salvage command passes just the
    runs it salvaged), on ``device`` (the card unless the caller names
    another; without one this raises, whatever the family).

    Returns the Store.recheck shape: {"valid", "runs": {ts: {"valid",
    "results"}}}. Linearizable families delegate to Store.recheck
    (batched device dispatch, optional per-key straining); fold families
    pool every stored run into one ops.folds dispatch; "bank" replays
    the balance-sum invariant on the host.

    ``independent``, ``accounts`` and ``balance`` default from the
    stored runs' ``invariants``; pass them only to override what a run
    recorded (a mismatch logs a warning). ``resume=True`` continues an
    interrupted linearizable recheck from its chunk journal; the fold
    and bank families re-derive from scratch (one cheap dispatch)."""
    from .ops.device import resolve_device
    from .store import group_unit_results

    dev = resolve_device(device)
    spec = registry()[family]
    inv = stored_invariants(store, test_name)
    independent = bool(_resolve_constant(
        "independent", independent, inv.get("independent"), False))
    if spec["kind"] == "linear":
        return store.recheck(test_name, spec["model"](),
                             timestamps=timestamps,
                             independent=independent, resume=resume,
                             device=dev)

    ts = (list(timestamps) if timestamps is not None
          else store.tests().get(test_name, []))
    units, labels = store.strain_units(test_name, ts,
                                       independent=independent)
    if not units:
        return {"valid": "unknown", "runs": {},
                "error": f"no stored histories for {test_name!r}"}

    if spec["kind"] == "fold":
        from .ops import folds
        rs = getattr(folds, spec["fold"])(units, device=dev)
    else:                                  # bank
        # Constants resolve per run: each stored history is checked
        # against its own recorded constants, and a run that recorded
        # none gets the historical defaults, never a sibling's.
        chk_by_ts: Dict[str, BankChecker] = {}
        rs = []
        for (t, _), h in zip(labels, units):
            chk = chk_by_ts.get(t)
            if chk is None:
                ri = run_invariants(store, test_name, t)
                chk = chk_by_ts[t] = BankChecker(
                    accounts=_resolve_constant(
                        "accounts", accounts, ri.get("accounts"), 5),
                    balance=_resolve_constant(
                        "balance", balance, ri.get("balance"), 10))
            rs.append(chk.check({}, None, h))

    return group_unit_results(labels, rs)
