"""P-compositional pre-partition: split histories by key before encoding.

Linearizability is local (Herlihy & Wing; the P-compositionality frame
of arXiv:1504.00204 and the decrease-and-conquer monitors of
arXiv:2410.04581): a history over k independent keys/registers is
linearizable iff each per-key projection is. The WGL kernel's cost is
``2^W`` in the pending window W, and a multi-key history's window is
the SUM of its keys' concurrent+pinned ops — so partitioning first
collapses the expensive W classes multiplicatively: a W=14 keyed
history becomes k sub-histories at W<=6 each, 2^14 frontier words
becoming k * 2^6. This module owns that pre-encode stage for both
history forms:

  * **columnar** (``partition_columnar``): a keyed ColumnarOps batch
    (``cols.key``, workloads.synth ``n_keys``) strains into one flat
    sub-batch — one row per (history, key), lines gathered by key,
    unkeyed lines replicated into every sub (the independent.clj:233-244
    rule). The sub-batch's ``index`` column composes the partition map
    with any existing conversion map, so a sub-row's bad-op index is
    already in the ORIGINAL history's op-index space.
  * **Op lists** (``partition_histories``): KV-valued histories
    (jepsen_torch.independent.KV) strain through
    ``independent.subhistory``, the same strainer a per-key checker
    uses.

Recombination (``recombine_verdicts`` / ``recombine_details``) is
host-side and cheap: a history is valid iff all its sub-histories are;
the reported first-bad op is the invalid sub verdict with the smallest
original op index, and the witness carries ``independent_key`` — the
provenance the per-key checker has always reported.

Everything here is pure numpy/host work: the partition must compose
with CPU-only encode paths and never touch a device. The port has no
telemetry registry, so the strain records no span or counters; the
scheduler path's callers read the sub-row count off the result.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..history.ops import Op
from ..independent import KV, history_keys, is_kv, subhistory


@dataclass
class PartitionedBatch:
    """A keyed batch strained into per-(history, key) sub-rows.

    ``cols`` is the flat sub-batch (no key column — each sub-history is
    a plain single-register history); ``sub_history[s]`` is the original
    batch row sub ``s`` came from, ``sub_key[s]`` its key label (None
    for the unkeyed remainder of a row with no keyed lines). Sub order
    is deterministic — ascending (history row, key id) — which is what
    makes chunk-journal resume re-dispatch ZERO decided sub-histories.
    """

    cols: object
    sub_history: np.ndarray            # [S] int64
    sub_key: List                      # [S] key labels
    n_histories: int

    @property
    def n_subs(self) -> int:
        return int(self.sub_history.shape[0])


def pending_w_hist(cols) -> Dict[int, int]:
    """Pending-window histogram of a columnar batch BEFORE encoding:
    {peak window: rows}. The peak matches the encode walk's ``max_live``
    (invokes allocate, only ok-completions free — info ops stay pinned,
    exactly the 2^W axis the kernel pays). The bench's pre/post
    partition comparison is two of these.

    Device-synthesized batches (ops.synth_device) may carry the peaks as
    generator metadata; the full-batch cumsum re-scan is then
    skipped."""
    from ..history.columnar import C_INVOKE, C_OK
    meta = getattr(cols, "meta", None)
    peak = getattr(meta, "peak_w", None)
    if peak is None or len(peak) != cols.batch:
        delta = ((cols.type == C_INVOKE).astype(np.int32)
                 - (cols.type == C_OK).astype(np.int32))
        peak = np.maximum(np.cumsum(delta, axis=1).max(axis=1), 1)
    ws, counts = np.unique(peak, return_counts=True)
    return {int(w): int(c) for w, c in zip(ws, counts)}


def partition_columnar(cols) -> Optional[PartitionedBatch]:
    """Strain a keyed ColumnarOps batch into its per-key sub-batch.

    Returns None when the batch carries no key column or names at most
    one key (nothing to split — callers fall through to the
    unpartitioned path). Unkeyed lines (key < 0) replicate into every
    sub of their row; rows with ONLY unkeyed lines become a single
    sub with key None. Vectorized per distinct key — cost is
    O(keys * batch * lines) numpy, far below the encode walk it feeds.
    """
    from ..history.columnar import PAD, ColumnarOps
    key = getattr(cols, "key", None)
    if key is None:
        return None
    real = cols.type != PAD
    keyed = real & (key >= 0)
    uniq = np.unique(key[keyed]) if keyed.any() else np.empty(0, np.int64)
    if uniq.size <= 1 and not (real & ~keyed).any():
        return None

    unkeyed = real & (key < 0)
    has_unkeyed = bool(unkeyed.any())

    # The strain is timed inside the e2e window, so its numpy passes
    # are tuned for memory traffic: ``kmask`` folds the real-line mask
    # into one narrow key matrix up front (synth PADs retracted ops —
    # failed cas, dropped identity reads — AFTER stamping their key,
    # so a raw key compare would resurrect them), letting each per-key
    # pass touch 1 byte/line instead of 4 + a second mask pass. The
    # per-key pieces are independent (disjoint output rows) and run on
    # a thread pool — numpy releases the GIL for all of them.
    narrow = uniq.size and uniq.min() >= 0 and uniq.max() < 127
    kmask = np.where(real, key, -1).astype(
        np.int8 if narrow else key.dtype)
    cum_dtype = np.int16 if cols.type.shape[1] < (1 << 15) else np.int32

    def strain(k, rows, sel):
        """(sub rows, line coords, dest cols, per-sub counts) for one
        piece. ``sel`` full-batch when no unkeyed replication."""
        dst_all = sel.cumsum(axis=1, dtype=cum_dtype)
        rr, cc = np.nonzero(sel)
        dst = dst_all[rr, cc].astype(np.intp) - 1
        if sel.shape[0] == len(rows):          # subset form
            sl, sr = rr, rows[rr]
        else:                                  # full-batch form
            sub_of = np.empty(cols.batch, np.intp)
            sub_of[rows] = np.arange(len(rows))
            sl, sr = sub_of[rr], rr
        return k, rows, sl, sr, cc, dst, dst_all[rows, -1] \
            if sel.shape[0] != len(rows) else dst_all[:, -1]

    def piece(k):
        if has_unkeyed:
            hit = (kmask == k)
            rows = np.flatnonzero(hit.any(axis=1))
            return strain(k, rows, hit[rows] | unkeyed[rows])
        hit = kmask == k
        rows = np.flatnonzero(hit.any(axis=1))
        return strain(k, rows, hit)

    jobs: List = list(uniq.tolist())
    only_unkeyed = np.flatnonzero(real.any(axis=1)
                                  & ~keyed.any(axis=1))
    n_workers = min(max(len(jobs), 1), os.cpu_count() or 1)
    pool = None
    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(n_workers)   # shared by both phases
    if pool is not None:
        pieces = list(pool.map(piece, jobs))
    else:
        pieces = [piece(k) for k in jobs]
    if only_unkeyed.size:
        # Rows whose every real line is unkeyed: one passthrough sub.
        pieces.append(strain(None, only_unkeyed, real[only_unkeyed]))
    if not pieces:
        if pool is not None:
            pool.shutdown()
        return None

    Np = int(max(int(c.max()) for *_, c in pieces))
    S = int(sum(len(rows) for _, rows, *_ in pieces))

    typ = np.full((S, Np), PAD, cols.type.dtype)
    proc = np.zeros((S, Np), cols.process.dtype)
    kind = np.full((S, Np), -1, cols.kind.dtype)
    index = np.full((S, Np), -1, np.int32)
    sub_hist = np.empty(S, np.int64)
    sub_key: List = [None] * S

    starts = []
    s0 = 0
    for _, rows, *_ in pieces:
        starts.append(s0)
        s0 += len(rows)

    def scatter(arg):
        s0, (k, rows, sl, sr, cc, dst, _) = arg
        sl = s0 + sl
        typ[sl, dst] = cols.type[sr, cc]
        proc[sl, dst] = cols.process[sr, cc]
        kind[sl, dst] = cols.kind[sr, cc]
        # Compose the partition map with any conversion map: bad-op
        # indices reported off a sub-row land straight in the original
        # history's op-index space.
        index[sl, dst] = (cols.index[sr, cc]
                          if cols.index is not None
                          else cc.astype(np.int32))
        sub_hist[s0:s0 + len(rows)] = rows
        sub_key[s0:s0 + len(rows)] = [k] * len(rows)

    if pool is not None:
        list(pool.map(scatter, zip(starts, pieces)))
        pool.shutdown()
    else:
        for arg in zip(starts, pieces):
            scatter(arg)

    # Deterministic (history, key) order — the resume/journal contract.
    key_rank = np.array([-1 if k is None else int(k) for k in sub_key],
                        np.int64)
    order = np.lexsort((key_rank, sub_hist))
    sub = ColumnarOps(type=typ[order], process=proc[order],
                      kind=kind[order], kinds=cols.kinds,
                      index=index[order])
    return PartitionedBatch(cols=sub, sub_history=sub_hist[order],
                            sub_key=[sub_key[i] for i in order],
                            n_histories=cols.batch)


# ------------------------------------------------------- Op-list form

def history_has_kv(history: Sequence[Op], sample: int = 64) -> bool:
    """KV-valued history detection for the ``partition="auto"`` paths.
    Samples the first ``sample`` ops — KV workloads wrap every client
    value, so a deep-scan would only chase a pathological mix; callers
    with late-appearing keys pass ``partition=True`` explicitly."""
    for op in history[:sample]:
        if is_kv(op.value):
            return True
    return False


def partition_histories(histories: Sequence[List[Op]], *,
                        force: bool = False
                        ) -> Optional[Tuple[List[List[Op]], np.ndarray,
                                            List]]:
    """Strain KV-valued Op-list histories into per-key sub-histories.

    Returns ``(subs, sub_history, sub_key)`` — flat sub list plus the
    same mapping arrays as the columnar form — or None when no history
    carries KV values (sampled detection; ``force=True`` scans every
    op, for callers that already know the workload is keyed).
    Histories without keys pass through as a single sub (key None); op
    identity (and so ``op.index``) is preserved by the shared
    strainer, which is what maps bad ops back through the partition."""
    if not force and not any(history_has_kv(h) for h in histories):
        return None
    if force and not any(history_keys(h) for h in histories):
        return None
    subs: List[List[Op]] = []
    sub_hist: List[int] = []
    sub_key: List = []
    for i, h in enumerate(histories):
        ks = history_keys(h)
        if not ks:
            subs.append(list(h))
            sub_hist.append(i)
            sub_key.append(None)
            continue
        for k in ks:
            subs.append(subhistory(k, h))
            sub_hist.append(i)
            sub_key.append(k)
    return subs, np.asarray(sub_hist, np.int64), sub_key


# ------------------------------------------------------ recombination

def recombine_verdicts(valid: np.ndarray, bad: np.ndarray,
                       sub_history: np.ndarray, sub_key: Sequence,
                       n_histories: int
                       ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """(valid, bad) arrays over sub-rows -> arrays over histories.

    A history is valid iff every sub is; its bad index is the SMALLEST
    original op index among its invalid subs (the first violating op of
    the whole history — sub indices are already in original op-index
    space, see partition_columnar). Returns ``(valid, bad,
    bad_key)`` with ``bad_key`` mapping invalid history rows to the
    witnessing key."""
    from .linearize import INT32_MAX
    hv = np.ones(n_histories, bool)
    hb = np.full(n_histories, INT32_MAX, np.int32)
    bad_key: Dict[int, object] = {}
    inv = np.flatnonzero(~np.asarray(valid))
    for s in inv.tolist():
        h = int(sub_history[s])
        hv[h] = False
        b = int(np.asarray(bad)[s])
        if b < hb[h]:
            hb[h] = b
            bad_key[h] = sub_key[s]
    return hv, hb, bad_key


def recombine_details(results: Sequence[dict], sub_history: np.ndarray,
                      sub_key: Sequence, n_histories: int) -> List[dict]:
    """Per-sub result dicts -> per-history result dicts (host-engine
    shape). Valid histories return ``{"valid": True}`` (plus provenance
    when any sub left the happy path); invalid histories take the
    invalid sub with the smallest original bad-op index verbatim —
    op, configs, provenance — plus ``independent_key`` (the witness
    key) and ``failures`` (every invalid key), matching the lifted
    per-key checker's reporting."""
    from ..checkers.core import merge_valid
    by_hist: Dict[int, List[int]] = {}
    for s, h in enumerate(sub_history.tolist()):
        by_hist.setdefault(int(h), []).append(s)
    out: List[dict] = []
    for h in range(n_histories):
        subs = by_hist.get(h, [])
        rs = [results[s] for s in subs]
        vals = [r.get("valid") for r in rs]
        merged = merge_valid(vals) if rs else True
        if merged is True:
            r: dict = {"valid": True}
            provs = {x.get("provenance") for x in rs
                     if x.get("provenance") not in (None, "device")}
            if provs:
                r["provenance"] = sorted(provs)[0]
            if any(x.get("resumed") for x in rs):
                r["resumed"] = True
            out.append(r)
            continue
        bad_subs = [s for s in subs
                    if results[s].get("valid") is False]
        if not bad_subs:                   # only "unknown" subs
            r = dict(rs[vals.index(merged)])
            r["valid"] = merged
            out.append(r)
            continue

        def bad_index(s):
            op = results[s].get("op") or {}
            idx = op.get("index")
            return idx if idx is not None else (1 << 31) - 1

        win = min(bad_subs, key=bad_index)
        r = dict(results[win])
        r["valid"] = False
        r["independent_key"] = sub_key[win]
        r["failures"] = [sub_key[s] for s in bad_subs]
        out.append(r)
    return out


def merge_kv_histories(parts: Dict, relabel: bool = True) -> List[Op]:
    """Interleave per-key histories into one KV-valued history — the
    inverse of the strainer, used by tests and workload builders to
    manufacture multi-key histories with known per-key ground truth.
    ``parts`` maps key -> Op list; ops interleave round-robin in
    original order, values wrap in KV, and processes are relabeled
    (key-major) so keys never share a process."""
    from ..history.core import index as index_history
    items = sorted(parts.items(), key=lambda kv: repr(kv[0]))
    procs: Dict[Tuple, int] = {}
    merged: List[Op] = []
    cursors = [0] * len(items)
    while True:
        advanced = False
        for j, (k, h) in enumerate(items):
            if cursors[j] >= len(h):
                continue
            op = h[cursors[j]]
            cursors[j] += 1
            advanced = True
            p = op.process
            if relabel and isinstance(p, int):
                p = procs.setdefault((k, p), len(procs))
            merged.append(op.with_(process=p, value=KV(k, op.value),
                                   index=None))
        if not advanced:
            break
    return index_history(merged)
