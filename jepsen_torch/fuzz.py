"""Witness-guided synthesis fuzzing: generate, check, mutate, re-check.

The reference's ``fuzz.py``: check a seeded CAS batch, and for every
invalid history (a witness) re-synthesize its neighbourhood of the
generator's streams (``order``: the same ops in new interleavings;
``values``: the same schedule with new values; ``nemesis``: a shifted
crash window and re-drawn fault coins) and check that neighbourhood as
one batch, on the card (or with ``device="cpu"`` the plain versions).

  * ``verify=N``: every Nth neighbourhood history also decodes to Op
    lists and re-checks on the exact host engine (``wgl_check``, per key
    for keyed batches); a verdict disagreement is a checker bug.
  * The smallest invalid neighbour (fewest real lines) is kept as
    ``min_anomaly``.

Durability is the seed campaign's: each round's base and neighbourhood
batches check under their own ChunkJournals keyed by
``store.spec_digest``, and rounds advance through a CampaignCheckpoint,
both in the reference's formats. A killed campaign resumed with
``resume=True`` dispatches no decided history or neighbourhood again.
The reference's telemetry spans and ``fuzz.*`` counters are not ported:
the round summaries carry the same values.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger("jepsen.fuzz")


def _round_spec(spec, r: int):
    """Round r's base spec: the campaign's seed stream is seed + r."""
    return dataclasses.replace(spec, seed=spec.seed + r)


def _host_verdicts(model, ncols):
    """``host_valid(row)``: the exact host engine's verdict on one
    neighbourhood row (the AND over its per-key sub-histories for a
    keyed batch), or None where the engine gave up."""
    from .checkers.linearizable import wgl_check
    from .history.columnar import columnar_to_ops
    from .ops.partition import partition_columnar
    cache: dict = {}
    pb = partition_columnar(ncols)
    if pb is None:
        def host_valid(r):
            v = wgl_check(model, columnar_to_ops(ncols, r),
                          space_cache=cache)["valid"]
            return v if isinstance(v, bool) else None
        return host_valid
    subs_of: Dict[int, List[int]] = {}
    for s, h in enumerate(pb.sub_history.tolist()):
        subs_of.setdefault(int(h), []).append(s)

    def host_valid(r):
        vs = [wgl_check(model, columnar_to_ops(pb.cols, s),
                        space_cache=cache)["valid"]
              for s in subs_of.get(r, [])]
        if any(v is False for v in vs):
            return False
        return True if all(v is True for v in vs) else None
    return host_valid


def fuzz_round(model, rspec, *, synth: str, neighborhood: int,
               max_witnesses: int, modes: Sequence[str],
               journal_dir: Optional[Path], resume: bool,
               verify: Optional[int] = None,
               check_kwargs: Optional[dict] = None, device=None) -> dict:
    """One generate, check, mutate, re-dispatch round. Returns the round
    summary; journals (when ``journal_dir`` is set) make it resumable
    mid-round with no decided row dispatched again. (The reference
    splits this into ``fuzz_round`` and ``_fuzz_round_impl`` to wrap it
    in a telemetry span; without telemetry the two are one.)"""
    from .history.columnar import PAD
    from .ops.linearize import check_columnar, check_synth
    from .ops.synth_device import synth_cas_neighbors
    from .store import ChunkJournal, spec_digest

    # Neighbourhoods are perturbations of the generator family's streams.
    if synth not in ("device", "numpy"):
        raise ValueError("fuzz runs on the generator family "
                         f"(synth='device' or 'numpy'), not {synth!r}")
    kw = dict(check_kwargs or {})
    base_j = neigh_j = None
    if journal_dir is not None:
        base_j = ChunkJournal(
            journal_dir / f"fuzz-{rspec.seed}.base.jsonl",
            {"spec": spec_digest(rspec, synth=synth, stage="base")},
            resume=resume)
    try:
        valid, bad = check_synth(model, rspec, device=device,
                                 journal=base_j, **kw)
    finally:
        if base_j is not None:
            base_j.close()

    witnesses = np.flatnonzero(~np.asarray(valid))[:max_witnesses]
    neighbors = [(int(row), mode, var)
                 for row in witnesses.tolist()
                 for mode in modes
                 for var in range(neighborhood)]
    out = {
        "seed": int(rspec.seed),
        "checked": int(len(valid)),
        "invalid": int((~np.asarray(valid)).sum()),
        "witnesses": [int(w) for w in witnesses.tolist()],
        "neighborhoods": len(neighbors),
        "neighborhood_invalid": 0,
        "min_anomaly_lines": None,
        "verified": 0,
        "disagreements": 0,
    }
    if not neighbors:
        if base_j is not None:
            base_j.finish()       # round complete: nothing to mutate
        return out

    ncols, _meta = synth_cas_neighbors(rspec, neighbors, device=device)
    if journal_dir is not None:
        neigh_j = ChunkJournal(
            journal_dir / f"fuzz-{rspec.seed}.neigh.jsonl",
            {"spec": spec_digest(rspec, synth=synth, stage="neigh",
                                 neighborhood=neighborhood,
                                 modes=list(modes),
                                 witnesses=[int(w) for w in witnesses])},
            resume=resume)
    try:
        nvalid, nbad = check_columnar(model, ncols, device=device,
                                      journal=neigh_j, **kw)
    finally:
        if neigh_j is not None:
            neigh_j.close()
    nvalid = np.asarray(nvalid)
    inv_rows = np.flatnonzero(~nvalid)
    out["neighborhood_invalid"] = int(inv_rows.size)
    if inv_rows.size:
        lines = (ncols.type[inv_rows] != PAD).sum(axis=1)
        wmin = int(inv_rows[int(lines.argmin())])
        out["min_anomaly_lines"] = int(lines.min())
        out["min_anomaly"] = {"neighbor": list(neighbors[wmin]),
                              "bad": int(np.asarray(nbad)[wmin])}
        by_mode: Dict[str, int] = {}
        for r in inv_rows.tolist():
            by_mode[neighbors[r][1]] = by_mode.get(neighbors[r][1], 0) + 1
        out["invalid_by_mode"] = by_mode

    if verify:
        # A deterministic stride of the neighbourhood re-checks on the
        # exact host engine; an oracle that gave up ("unknown") has no
        # verdict to disagree with.
        host_valid = _host_verdicts(model, ncols)
        bad_rows = []
        for r in range(0, len(neighbors), int(verify)):
            want = host_valid(r)
            if want is None:
                continue
            out["verified"] += 1
            if want != bool(nvalid[r]):
                bad_rows.append({"neighbor": list(neighbors[r]),
                                 "host": want, "device": bool(nvalid[r])})
        out["disagreements"] = len(bad_rows)
        if bad_rows:
            out["disagreement_sample"] = bad_rows[:5]
            log.error("fuzz: %d device/host verdict disagreements "
                      "(checker bug); first: %r", len(bad_rows),
                      bad_rows[0])
    # Journals only outlive an interrupted round.
    for j in (base_j, neigh_j):
        if j is not None:
            j.finish()
    return out


def fuzz_campaign(spec, *, rounds: int = 1, neighborhood: int = 4,
                  max_witnesses: int = 8,
                  modes: Optional[Sequence[str]] = None,
                  synth: str = "device", model=None, store_root=None,
                  name: Optional[str] = "fuzz", resume: bool = False,
                  verify: Optional[int] = None,
                  check_kwargs: Optional[dict] = None,
                  device=None) -> dict:
    """Drive ``rounds`` fuzz rounds, durably. Campaign state lives under
    ``store_root.base / name``: a CampaignCheckpoint over round ordinals
    (finished rounds load their ``fuzz-round-N.json`` summary; a killed
    campaign resumes the in-flight round from its chunk journals) and
    one summary JSON at the end. ``name=None`` runs without durability.
    ``disagreements`` > 0 means the checker itself is wrong somewhere."""
    from .models.core import cas_register
    from .ops.synth_device import NEIGHBOR_MODES
    from .store import (CampaignCheckpoint, DEFAULT, atomic_write_json,
                        spec_digest)

    if modes:
        modes = tuple(modes)
    else:
        # A spec with no fault surface never reads the fault stream or
        # the crash window, so its nemesis neighbours would be copies of
        # the witness: drop the mode by default.
        modes = tuple(m for m in NEIGHBOR_MODES
                      if m != "nemesis"
                      or spec.p_info > 0 or spec.p_crash > 0)
    model = model if model is not None else cas_register()
    cdir = ckpt = None
    if name is not None:
        root = store_root if store_root is not None else DEFAULT
        cdir = Path(root.base) / name
        cdir.mkdir(parents=True, exist_ok=True)
        ckpt = CampaignCheckpoint(
            cdir / "campaign.jsonl",
            {"fuzz": name, "rounds": rounds,
             "spec": spec_digest(spec, synth=synth, modes=list(modes),
                                 neighborhood=neighborhood,
                                 max_witnesses=max_witnesses)},
            resume=resume)
    round_outs: List[dict] = []
    try:
        for r in range(rounds):
            state = ckpt.seed_state(r) if ckpt is not None else None
            if state is not None and state["done"]:
                try:
                    round_outs.append(json.loads(
                        (cdir / f"fuzz-round-{r}.json").read_text()))
                    continue
                except Exception:
                    log.warning("fuzz resume: round %d marked done but "
                                "its summary is unreadable; re-running",
                                r)
            if ckpt is not None:
                ckpt.started(r, cdir)
            out = fuzz_round(model, _round_spec(spec, r), synth=synth,
                             neighborhood=neighborhood,
                             max_witnesses=max_witnesses, modes=modes,
                             journal_dir=cdir,
                             resume=state is not None or resume,
                             verify=verify, check_kwargs=check_kwargs,
                             device=device)
            out["round"] = r
            if cdir is not None:
                atomic_write_json(cdir / f"fuzz-round-{r}.json", out)
            if ckpt is not None:
                ckpt.done(r)
            round_outs.append(out)
        if ckpt is not None:
            ckpt.finish()
    finally:
        if ckpt is not None:
            ckpt.close()

    summary = {
        "name": name, "rounds": rounds, "synth": synth,
        "modes": list(modes),
        "checked": sum(o["checked"] for o in round_outs),
        "invalid": sum(o["invalid"] for o in round_outs),
        "neighborhoods": sum(o["neighborhoods"] for o in round_outs),
        "neighborhood_invalid": sum(o["neighborhood_invalid"]
                                    for o in round_outs),
        "verified": sum(o.get("verified", 0) for o in round_outs),
        "disagreements": sum(o.get("disagreements", 0)
                             for o in round_outs),
        "min_anomaly_lines": min(
            (o["min_anomaly_lines"] for o in round_outs
             if o.get("min_anomaly_lines") is not None), default=None),
        "round_results": round_outs,
    }
    if cdir is not None:
        atomic_write_json(cdir / "fuzz-summary.json", summary)
    return summary
