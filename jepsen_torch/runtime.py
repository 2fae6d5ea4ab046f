"""The synthesis seed campaign (the reference's ``runtime.synth_seed_summary``
and ``runtime.run_synth_seeds``) and the seeded-batch verdict pool the
linearizable checkers consult (``LinearPool``, ``_linear_unit_kinds``).

A campaign checks one generated batch per seed (``spec`` with the seed
folded in) through ``ops.linearize.check_synth``: the generator kernel
(or, with ``synth="host"``, the legacy host stream), the per-key
partition, the encode walk and the frontier kernel on the card, or the
plain versions with ``device="cpu"``. Durability is the
reference's: a ``store.CampaignCheckpoint`` over the seed list and one
``store.ChunkJournal`` per seed batch, both keyed by ``store.spec_digest``
and in the reference's file formats, so a campaign killed under one
package resumes under the other.

Of the pool only the class and the checker-tree walk are here: the
checkers read a pool that a runner armed on the test map. The runner
that arms it (the reference's ``run_seeds``, one pooled dispatch across
seeded cluster runs) belongs to the cluster runner, which is not ported
yet; nor are the run store lifecycle and the telemetry spans of the
reference's module.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from .ops.synth_device import SYNTH_LABELS

log = logging.getLogger("jepsen.runtime")


def _generator_family(synth: str) -> None:
    """Refuse a synth label neither package generates: "device" and
    "numpy" name the generator family (the kernel on the card, its plain
    version on the CPU), "host" the legacy lockstep stream
    (workloads.synth). The label is part of every journal and
    checkpoint key."""
    if synth not in SYNTH_LABELS:
        raise ValueError(f"unknown synth {synth!r}")


def synth_seed_summary(model, sspec, *, synth: str = "device",
                       journal=None, check_kwargs: Optional[dict] = None,
                       device=None) -> dict:
    """One synth seed's generate-and-check, summarized: returns
    {"checked", "invalid", "bad_sample"} (the first ten invalid rows with
    their bad-op indices), field for field the reference's."""
    from .ops.linearize import check_synth

    _generator_family(synth)
    valid, bad = check_synth(model, sspec, synth=synth, device=device,
                             journal=journal, **(check_kwargs or {}))
    inv = np.flatnonzero(~np.asarray(valid))
    return {"checked": int(len(valid)),
            "invalid": int(inv.size),
            "bad_sample": [[int(r), int(np.asarray(bad)[r])]
                           for r in inv[:10].tolist()]}


def run_synth_seeds(spec, seeds, *, synth: str = "device", model=None,
                    name: str = "synth-campaign", store_root=None,
                    checkpoint: bool = True, resume: bool = False,
                    check_kwargs: Optional[dict] = None,
                    device=None) -> dict:
    """A seed campaign whose histories are generated, not executed: each
    seed checks one ``spec``-shaped batch (seed folded in) through
    ``check_synth`` on ``device`` (the card unless the caller names
    another).

    With ``checkpoint`` (the default) the campaign keeps a
    CampaignCheckpoint under ``store_root.base / name`` and one
    ChunkJournal per seed batch: a killed campaign resumed with
    ``resume=True`` runs no completed seed again (their summaries load
    from ``seed-<s>.json``), and the in-flight seed resumes its journal,
    dispatching none of its decided rows again. Returns {"seeds": {seed:
    {checked, invalid, bad_sample}}, "invalid": total, "valid": bool};
    resumed seeds carry ``"resumed": True``."""
    from .models.core import cas_register
    from .store import (ChunkJournal, CampaignCheckpoint, DEFAULT,
                        atomic_write_json, spec_digest)

    _generator_family(synth)
    seeds = [int(s) for s in seeds]
    model = model if model is not None else cas_register()
    root = store_root if store_root is not None else DEFAULT
    cdir = Path(root.base) / name
    ckpt = None
    if checkpoint:
        cdir.mkdir(parents=True, exist_ok=True)
        ckpt = CampaignCheckpoint(
            cdir / "campaign.jsonl",
            {"name": name, "seeds": seeds,
             "spec": spec_digest(spec, synth=synth)},
            resume=resume)
    out: dict = {"seeds": {}, "invalid": 0, "valid": True}
    try:
        for s in seeds:
            sspec = dataclasses.replace(spec, seed=s)
            state = ckpt.seed_state(s) if ckpt is not None else None
            summary_path = cdir / f"seed-{s}.json" if checkpoint else None
            if state is not None and state["done"]:
                try:
                    summ = json.loads(summary_path.read_text())
                    summ["resumed"] = True
                    out["seeds"][str(s)] = summ
                    out["invalid"] += summ["invalid"]
                    continue
                except Exception:
                    log.warning("synth campaign resume: seed %s done "
                                "but summary unreadable; re-running", s)
            journal = None
            if checkpoint:
                ckpt.started(s, cdir)
                journal = ChunkJournal(
                    cdir / f"seed-{s}.journal.jsonl",
                    {"spec": spec_digest(sspec, synth=synth)},
                    resume=state is not None or resume)
            try:
                summ = synth_seed_summary(
                    model, sspec, synth=synth, journal=journal,
                    check_kwargs=check_kwargs, device=device)
            finally:
                if journal is not None:
                    journal.close()
            if checkpoint:
                atomic_write_json(summary_path, summ)
                journal.finish()
                ckpt.done(s)
            out["seeds"][str(s)] = summ
            out["invalid"] += summ["invalid"]
        if ckpt is not None:
            ckpt.finish()
    finally:
        if ckpt is not None:
            ckpt.close()
    out["valid"] = out["invalid"] == 0
    return out


class LinearPool:
    """Precomputed linearizability verdicts for a batch of seeded runs.

    ``results`` maps (run_index, independent_key_or_None) -> result
    dict. The linearizable checkers consult the pool (via the
    ``_linear_pool`` / ``_pool_run`` test keys) before dispatching an
    engine; a miss falls back to normal computation, so the pool is an
    accelerator, never a correctness gate."""

    def __init__(self):
        self.results: dict = {}

    def take(self, test: dict, key) -> Optional[dict]:
        """Pooled result for this test's (run, key) unit, copied so a
        consumer's later mutation (render fields, fallback notes) cannot
        alias the pool or another consumer's view."""
        r = self.results.get((test.get("_pool_run"), key))
        return dict(r) if r is not None else None


def _linear_unit_kinds(checker) -> tuple:
    """(per_key, whole): which unit shapes the checker tree will ask
    the pool for: per-key subhistories (independent linearizable
    lifts) and/or the whole history (plain linearizable)."""
    from .checkers.core import Compose
    from .checkers.linearizable import LinearizableChecker
    from .independent import BatchLinearizableChecker, IndependentChecker

    per_key = whole = False

    def walk(c, lifted):
        nonlocal per_key, whole
        if isinstance(c, Compose):
            for sub in c.checker_map.values():
                walk(sub, lifted)
        elif isinstance(c, BatchLinearizableChecker):
            per_key = True
        elif isinstance(c, IndependentChecker):
            walk(c.checker, True)
        elif isinstance(c, LinearizableChecker):
            if c.backend == "brute":
                return       # independent oracle: never pooled
            if lifted:
                per_key = True
            else:
                whole = True

    walk(checker, False)
    return per_key, whole
