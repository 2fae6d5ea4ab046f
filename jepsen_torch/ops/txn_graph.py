"""Transactional dependency graphs: the Adya isolation ladder as
boolean transitive closure on the card — the port of the reference's
``ops/txn_graph.py``.

Certifying the isolation level a history satisfies reduces to cycle
search over typed dependency graphs whose edge-type masks select the
level's forbidden phenomena ("Making Transaction Isolation Checking
Practical", PAPERS.md). This module generalizes ops/graph.py's three
cumulative planes to the ladder:

  * **edge types** — ``ww`` (version overwrite), ``wr`` (read-from,
    item or predicate), ``rwi`` (item anti-dependency), ``rwp``
    (predicate anti-dependency — the phantom edge), ``so`` (session
    order), ``rt`` (realtime order). One vertex per committed txn.

  * **packed planes** ([B, 4, V, V/32] int32 words, cumulative):
    G0 = ww∪so∪rt, G1c adds wr, G2-item adds rwi, G2 adds rwp.

  * **the SI plane** is derived on the device: snapshot isolation
    forbids exactly the cycles with no two consecutive anti-dependency
    edges (Fekete et al.), i.e. any cycle of ``A_SI = N ∪ (RW·N)``, N
    the non-anti-dep plane (the G1c mask) and RW the anti-dep edges (G2
    minus G1c). One launch decides all 5 cycle planes: [G0, G1c,
    G2-item, G2, G-SI] (the txn entry of ``csrc/graph_closure.cu``; on
    the CPU its plain version ``plain_txn_closure``).

  * **aborted/intermediate reads** (Adya G1a/G1b) are not cycles —
    they are per-history host-side flags carried in the graph meta and
    folded into the verdict by ``ladder_verdict``.

  * **the verdict** is the HIGHEST ladder level the history satisfies:
    read-uncommitted → read-committed → repeatable-read →
    snapshot-isolation → serializability.

The host DFS oracle twin (``check_txn_host``) shares no machinery with
the closure. Scheduling rides the parameterized
ops.schedule.GraphScheduler; the certifier surface lives in
jepsen_torch/isolation.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..history.core import pairs
from ..history.ops import Op, OK, FAIL
from .graph import (DepGraph, GraphBucket, _edges, _has_cycle_dfs,
                    _order_edges, _succ_lists, close_and_probe,
                    closure_iters, encode_graphs, pack_graph,
                    refine_witness, shortest_cycle, unpack_planes)
from .device import resolve_device

# Edge types, in packing order.
TXN_EDGE_TYPES = ("ww", "wr", "rwi", "rwp", "so", "rt")

# The four PACKED cumulative planes (the fifth, G-SI, is derived
# in the kernel from planes 1 and 3 — see plain_txn_closure).
TXN_PLANES = ("G0", "G1c", "G2-item", "G2")
TXN_LEVEL_TYPES = (
    ("ww", "so", "rt"),
    ("ww", "wr", "so", "rt"),
    ("ww", "wr", "rwi", "so", "rt"),
    ("ww", "wr", "rwi", "rwp", "so", "rt"),
)
N_TXN_PLANES = len(TXN_PLANES)

# Cycle-plane names as the kernel returns them (packed + derived SI).
CYC_NAMES = ("G0", "G1c", "G2-item", "G2", "G-SI")
N_CYC_PLANES = len(CYC_NAMES)

# The isolation ladder, weakest to strongest; "none" sits below
# read-uncommitted (a G0 write cycle violates even that). LADDER is
# the journal encoding: bad = LADDER.index(level) when not fully
# serializable, None (valid) otherwise.
ISO_LEVELS = ("read-uncommitted", "read-committed", "repeatable-read",
              "snapshot-isolation", "serializability")
LADDER = ("none",) + ISO_LEVELS

ISO_ABBREV = {"serializability": "SER", "snapshot-isolation": "SI",
              "repeatable-read": "RR", "read-committed": "RC",
              "read-uncommitted": "RU", "none": "NONE"}


def iso_abbrev(level: Optional[str]) -> str:
    return ISO_ABBREV.get(level or "", "?")


# ------------------------------------------------------------ extraction

_MOP_FS = ("r", "w", "append", "p")


def _norm_mops(value) -> List[list]:
    """Normalize one txn op value to a list of [f, k, v] micro-ops."""
    out = []
    for m in (value or ()):
        m = list(m)
        if len(m) == 2:
            m.append(None)
        if len(m) != 3 or m[0] not in _MOP_FS:
            raise ValueError(f"malformed txn micro-op {m!r}")
        out.append(m)
    return out


def extract_txn_graph(history: Sequence[Op]) -> DepGraph:
    """Lower one transactional history to its typed dependency graph.

    Vertices are committed txns in completion order. A txn with no
    completion (open) or an :info completion is committed iff any of
    its writes was observed by an ok txn — its installed writes are
    then its invoke intent (the standard Jepsen info-visibility rule).
    A FAILED txn whose write was observed keeps its vertex too (the
    chains stay well-defined) but every read of it raises the G1a
    flag; unobserved failed/info txns are excluded. Per (txn, key)
    only the FINAL register write installs a version — reads of
    earlier ones raise G1b. Register version order is completion
    order; append keys follow the list-append longest-observed rule;
    predicate reads carry a full snapshot and anti-depend (``rwp``)
    on the writer of the NEXT version after the one observed, per key
    — including keys the snapshot shows as absent."""
    client = [op for op in history if op.is_client]
    recs = []
    for inv, comp in pairs(client):
        if inv.f != "txn":
            continue
        if comp is not None and comp.type == OK:
            status, mops = "ok", _norm_mops(
                comp.value if comp.value is not None else inv.value)
        elif comp is not None and comp.type == FAIL:
            status, mops = "fail", _norm_mops(inv.value)
        else:
            status, mops = "info", _norm_mops(inv.value)
        recs.append({"proc": inv.process, "inv": inv.index,
                     "cmp": comp.index if comp is not None else None,
                     "status": status, "mops": mops})

    # Key modes: any append micro makes the key an append key.
    append_keys = {m[1] for r in recs for m in r["mops"]
                   if m[0] == "append"}

    # Observed item values, from ok txns' reads + predicate snapshots.
    observed = set()
    for r in recs:
        if r["status"] != "ok":
            continue
        for f, k, v in r["mops"]:
            if f == "r" and v is not None:
                if k in append_keys:
                    observed.update((k, e) for e in v)
                else:
                    observed.add((k, v))
            elif f == "p":
                observed.update((k2, v2) for k2, v2 in (v or ()))

    def _write_values(r):
        vals = set()
        finals = {}
        for f, k, v in r["mops"]:
            if f == "append":
                vals.add((k, v))
            elif f == "w":
                finals[k] = v
                vals.add((k, v))
        return vals, finals

    # Vertices: ok txns + non-ok txns with an observed write, in
    # completion order (open txns order by invoke at the end).
    big = 1 << 60
    keep = []
    for r in recs:
        if r["status"] == "ok":
            keep.append(r)
        else:
            vals, _ = _write_values(r)
            if vals & observed:
                keep.append(r)
    keep.sort(key=lambda r: (r["cmp"] if r["cmp"] is not None else big,
                             r["inv"]))
    verts = [{"inv": r["inv"],
              "cmp": r["cmp"] if r["cmp"] is not None else big + i,
              "proc": r["proc"], "f": "txn", "value": None,
              "status": r["status"]}
             for i, r in enumerate(keep)]

    # Writer tables. Register: final installs a version, earlier
    # writes are intermediates; values unique per key by contract.
    writer_final: Dict[Tuple, int] = {}
    writer_inter: Dict[Tuple, int] = {}
    writer_elem: Dict[Tuple, int] = {}
    chains: Dict = {}            # register key -> [vid] completion order
    app_order: Dict = {}         # append key -> [vid] completion order
    elem_by_key: Dict = {}       # append key -> {element: vid}
    for i, r in enumerate(keep):
        per_key_w: Dict = {}
        for f, k, v in r["mops"]:
            if f == "append":
                if (k, v) in writer_elem:
                    raise ValueError(
                        f"duplicate append element {v!r} on key {k!r}")
                writer_elem[(k, v)] = i
                elem_by_key.setdefault(k, {})[v] = i
                app_order.setdefault(k, []).append(i)
            elif f == "w":
                per_key_w.setdefault(k, []).append(v)
        for k, vs in per_key_w.items():
            for v in vs[:-1]:
                if (k, v) in writer_inter or (k, v) in writer_final:
                    raise ValueError(
                        f"duplicate write value {v!r} on key {k!r}")
                writer_inter[(k, v)] = i
            v = vs[-1]
            if (k, v) in writer_inter or (k, v) in writer_final:
                raise ValueError(
                    f"duplicate write value {v!r} on key {k!r}")
            writer_final[(k, v)] = i
            chains.setdefault(k, []).append(i)
    pos = {}                     # (key, vid) -> chain position
    for k, chain in chains.items():
        for j, w in enumerate(chain):
            pos[(k, w)] = j

    ww, wr, rwi, rwp = [], [], [], []
    g1a_reads, g1b_reads = [], []

    def _read_item(r_, k, v):
        """One committed register read; emits wr/rwi and G1 flags."""
        chain = chains.get(k, [])
        if v is None:
            if chain and chain[0] != r_:
                rwi.append((r_, chain[0]))
            return
        if (k, v) in writer_inter:
            w = writer_inter[(k, v)]
            if w != r_:
                g1b_reads.append({"vertex": r_, "key": k, "value": v,
                                  "writer": w})
                wr.append((w, r_))
            return
        w = writer_final.get((k, v))
        if w is None:
            raise ValueError(f"read of never-written value {v!r} "
                             f"on key {k!r}")
        if w == r_:
            return
        if keep[w]["status"] == "fail":
            g1a_reads.append({"vertex": r_, "key": k, "value": v,
                              "writer": w})
        wr.append((w, r_))
        j = pos[(k, w)] + 1
        if j < len(chain) and chain[j] != r_:
            rwi.append((r_, chain[j]))

    def _read_list(r_, k, obs):
        """One committed append-key read (list-append version rules)."""
        chain = _app_chain(k)
        celems = _longest_obs(k)
        j = 0
        while j < len(obs) and j < len(celems) and obs[j] == celems[j]:
            j += 1
        if j < len(obs):
            # Non-prefix read: an unconditional ww 2-cycle (two appends
            # claim one position, whatever the true order).
            w2 = writer_elem.get((k, obs[j]))
            if w2 is None:
                raise ValueError(f"read of never-appended element "
                                 f"{obs[j]!r} on key {k!r}")
            w1 = chain[j] if j < len(chain) else w2
            if w1 != w2:
                ww.extend([(w1, w2), (w2, w1)])
            if j > 0 and chain[j - 1] != r_:
                wr.append((chain[j - 1], r_))
            return
        for e in obs:
            w = writer_elem[(k, e)]
            if w != r_ and keep[w]["status"] == "fail":
                g1a_reads.append({"vertex": r_, "key": k, "value": e,
                                  "writer": w})
        m = len(obs)
        if m > 0 and chain[m - 1] != r_:
            wr.append((chain[m - 1], r_))
        if m < len(chain) and chain[m] != r_:
            rwi.append((r_, chain[m]))

    _chain_cache: Dict = {}

    def _longest_obs(k):
        lists = [v for r in keep if r["status"] == "ok"
                 for f, k2, v in r["mops"]
                 if f == "r" and k2 == k and v is not None]
        return max(lists, key=len, default=[])

    def _app_chain(k):
        if k in _chain_cache:
            return _chain_cache[k]
        chain = []
        for e in _longest_obs(k):
            w = writer_elem.get((k, e))
            if w is None:
                raise ValueError(f"read of never-appended element "
                                 f"{e!r} on key {k!r}")
            chain.append(w)
        in_chain = set(chain)
        chain += [w for w in app_order.get(k, []) if w not in in_chain]
        _chain_cache[k] = chain
        return chain

    def _read_pred(r_, snap):
        """One committed predicate read: snapshot of ALL present
        register keys. Per key with a version chain, the read
        anti-depends on the writer of the next version after the one
        observed (absent-from-snapshot = the initial version)."""
        sd = {}
        for k, v in (snap or ()):
            if k in append_keys:
                raise ValueError(
                    f"predicate over append key {k!r} unsupported")
            sd[k] = v
        for k in set(chains) | set(sd):
            if k in append_keys:
                raise ValueError(
                    f"predicate over append key {k!r} unsupported")
            chain = chains.get(k, [])
            v = sd.get(k)
            if v is None:
                succ = chain[0] if chain else None
            else:
                if (k, v) in writer_inter:
                    w = writer_inter[(k, v)]
                    if w != r_:
                        g1b_reads.append({"vertex": r_, "key": k,
                                          "value": v, "writer": w})
                        wr.append((w, r_))
                    continue
                w = writer_final.get((k, v))
                if w is None:
                    raise ValueError(f"predicate read of never-written "
                                     f"value {v!r} on key {k!r}")
                if w != r_:
                    if keep[w]["status"] == "fail":
                        g1a_reads.append({"vertex": r_, "key": k,
                                          "value": v, "writer": w})
                    wr.append((w, r_))
                j = pos[(k, w)] + 1
                succ = chain[j] if j < len(chain) else None
            if succ is not None and succ != r_:
                rwp.append((r_, succ))

    for i, r in enumerate(keep):
        if r["status"] != "ok":
            continue                 # non-ok vertices contribute writes only
        for f, k, v in r["mops"]:
            if f == "r":
                if k in append_keys:
                    _read_list(i, k, list(v or []))
                else:
                    _read_item(i, k, v)
            elif f == "p":
                _read_pred(i, v)

    # ww along register version chains (completion order).
    for k, chain in chains.items():
        ww.extend((chain[j], chain[j + 1])
                  for j in range(len(chain) - 1)
                  if chain[j] != chain[j + 1])
    # ww along append chains.
    for k in app_order:
        chain = _app_chain(k)
        ww.extend((chain[j], chain[j + 1])
                  for j in range(len(chain) - 1)
                  if chain[j] != chain[j + 1])

    so, rt = _order_edges(verts)
    vmeta = [{"index": (r["cmp"] if r["cmp"] is not None else r["inv"]),
              "process": r["proc"], "f": "txn", "status": r["status"]}
             for r in keep]
    return DepGraph(
        n=len(verts),
        edges={"ww": _edges(ww), "wr": _edges(wr), "rwi": _edges(rwi),
               "rwp": _edges(rwp), "so": so, "rt": rt},
        meta={"family": "txn", "vertices": vmeta,
              "g1a_reads": sorted(g1a_reads,
                                  key=lambda d: (d["vertex"], d["key"])),
              "g1b_reads": sorted(g1b_reads,
                                  key=lambda d: (d["vertex"], d["key"]))})


# -------------------------------------------------------------- encoding

def pack_txn_graph(g: DepGraph, V: int) -> np.ndarray:
    """[4, V, V/32] packed cumulative ladder planes (int32 words)."""
    return pack_graph(g, V, TXN_LEVEL_TYPES)


def encode_txn_graphs(graphs: Sequence[DepGraph],
                      indices: Optional[Sequence[int]] = None
                      ) -> List[GraphBucket]:
    """Bucket + pack a batch of txn graphs (graph-family bucketing,
    ladder planes)."""
    return encode_graphs(graphs, indices, level_types=TXN_LEVEL_TYPES)


# ----------------------------------------------------------- the closure

def plain_txn_closure(adj: torch.Tensor, V: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the closure kernel's txn entry, the
    reference's ``txn_kernel(V)`` arithmetic on torch tensors: int32
    [B, 4, V, words(V)] packed planes in; the SI plane ``min(N + RW·N,
    1)`` derived (N the G1c plane, RW = max(G2 - N, 0) the anti-dep
    edges) and stacked; all 5 planes closed. Returns (cyc, node) [B, 5]."""
    a = unpack_planes(adj, V)
    n = a[:, 1]
    rw = torch.clamp_min(a[:, 3] - n, 0.0)
    si = torch.clamp_max(n + torch.matmul(rw, n), 1.0)
    return close_and_probe(torch.cat([a, si[:, None]], dim=1), V)


def close_txn_planes(adj: torch.Tensor, V: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cyc, node) [B, 5] of packed int32 ladder planes on ``adj``'s
    device: the CUDA kernel's txn entry for a CUDA tensor, the plain
    version for a CPU tensor."""
    if adj.device.type == "cuda":
        from . import cuda_graph
        return cuda_graph.txn_closure(adj, V)
    return plain_txn_closure(adj, V)


def txn_closure(adj: np.ndarray, V: int, *, device=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The device entry: one bucket's int32 [B, 4, V, words(V)] ladder
    planes closed on ``device`` (the card unless the caller names
    another); returns numpy ``cyc`` bool [B, 5] and ``node`` int32
    [B, 5]."""
    t = torch.from_numpy(np.ascontiguousarray(adj, np.int32))
    cyc, node = close_txn_planes(t.to(resolve_device(device)), V)
    return cyc.cpu().numpy(), node.cpu().numpy()


def txn_op_model(V: int, levels: int = N_CYC_PLANES) -> Dict[str, float]:
    """Analytic device cost of one txn graph's ladder closure at
    padded vertex count V: the 5 closure planes plus ONE composition
    matmul for the derived SI plane (mxu_op_model's txn twin)."""
    it = closure_iters(V)
    matmuls = levels * it + 1
    return {"iterations": it, "matmuls": matmuls,
            "macs": float(matmuls) * V ** 3}


# -------------------------------------------------------------- verdicts

def ladder_verdict(g1a: bool, g1b: bool, cyc: Sequence[bool]
                   ) -> Tuple[str, Optional[str], Optional[int]]:
    """(level, anomaly, witness_plane) from the host G1 flags and the
    5 cycle-plane booleans [G0, G1c, G2-item, G2, G-SI].

    The level is the HIGHEST ladder rung the history satisfies; the
    anomaly names the phenomenon blocking the next rung, and
    witness_plane says which cycle plane to refine for it (None for
    the flag-based G1a/G1b, whose witness is the offending reads)."""
    cyc = [bool(c) for c in cyc]
    if cyc[0]:
        return "none", "G0", 0
    if g1a:
        return "read-uncommitted", "G1a", None
    if g1b:
        return "read-uncommitted", "G1b", None
    if cyc[1]:
        return "read-uncommitted", "G1c", 1
    if cyc[2] and cyc[4]:
        return "read-committed", "G2-item", 2
    if cyc[4]:
        return "repeatable-read", "G-SI", 4
    if cyc[3]:
        return "snapshot-isolation", "G2", 3
    return "serializability", None, None


def txn_result(g: DepGraph, level: str, anomaly: Optional[str],
               witness: Optional[List[dict]], provenance: str) -> dict:
    """The one result-dict shape both engines emit (parity is
    field-for-field over this dict, provenance aside)."""
    return {
        "valid": level == "serializability",
        "level": level,
        "anomaly": anomaly,
        "cycle": witness or [],
        "vertices": g.n,
        "edges": {t: int(len(g.edges.get(t, ())))
                  for t in TXN_EDGE_TYPES},
        "g1a": len(g.meta.get("g1a_reads", ())),
        "g1b": len(g.meta.get("g1b_reads", ())),
        "provenance": provenance,
    }


# ------------------------------------------------- host oracle + witness

def si_relation(g: DepGraph) -> Tuple[List[List[int]], Dict]:
    """A_SI = N ∪ (RW·N) successor lists plus the composition map
    {(u, w): v} recording the anti-dep midpoint for hops that are only
    reachable composed (direct N edges win)."""
    nsucc = _succ_lists(g, TXN_LEVEL_TYPES[1])
    rwsucc = _succ_lists(g, ("rwi", "rwp"))
    nsets = [set(s) for s in nsucc]
    asucc = [set(s) for s in nsucc]
    compose: Dict[Tuple[int, int], int] = {}
    for u in range(g.n):
        for v in rwsucc[u]:
            for w in nsucc[v]:
                asucc[u].add(w)
                if w not in nsets[u]:
                    compose.setdefault((u, w), v)
    return [sorted(s) for s in asucc], compose


def _si_witness(g: DepGraph) -> List[dict]:
    """Minimal SI witness: shortest cycle of A_SI, expanded back to
    the full vertex sequence (composed hops insert their anti-dep
    midpoint) with the edge types carrying each hop."""
    asucc, compose = si_relation(g)
    cyc = shortest_cycle(g.n, asucc)
    if cyc is None:
        return []
    full = []
    for i, u in enumerate(cyc):
        w = cyc[(i + 1) % len(cyc)]
        full.append(u)
        if (u, w) in compose:
            full.append(compose[(u, w)])
    sets = {t: {(int(a), int(b)) for a, b in g.edges.get(t, ())}
            for t in TXN_EDGE_TYPES}
    vmeta = g.meta.get("vertices") or [{} for _ in range(g.n)]
    out = []
    for i, v in enumerate(full):
        w = full[(i + 1) % len(full)]
        via = sorted(t for t in TXN_EDGE_TYPES if (v, w) in sets[t])
        out.append({"vertex": v, "via": via, **vmeta[v]})
    return out


def refine_txn_witness(g: DepGraph, anomaly: Optional[str],
                       plane: Optional[int]) -> List[dict]:
    """Host refinement for a non-serializable verdict: a minimal
    witness cycle for cycle planes (the derived SI plane expands its
    composed hops), or the offending reads for the G1a/G1b flags."""
    if anomaly is None:
        return []
    if plane is None:
        key = "g1a_reads" if anomaly == "G1a" else "g1b_reads"
        return [{"vertex": d["vertex"], "via": [anomaly.lower()],
                 "key": d["key"], "value": d["value"],
                 "writer": d["writer"]} for d in g.meta.get(key, ())]
    if plane == 4:
        return _si_witness(g)
    return refine_witness(g, plane, types=TXN_LEVEL_TYPES[plane])


def txn_cyc_host(g: DepGraph) -> List[bool]:
    """The 5 cycle-plane booleans, derived by DFS (deliberately NOT
    the closure algorithm — the independent oracle half)."""
    cyc = [_has_cycle_dfs(g.n, _succ_lists(g, types))
           for types in TXN_LEVEL_TYPES]
    asucc, _ = si_relation(g)
    cyc.append(_has_cycle_dfs(g.n, asucc))
    return cyc


def check_txn_host(g: DepGraph, provenance: str = "host") -> dict:
    """The pure-host oracle twin: DFS per ladder plane + the A_SI
    relation, same ladder walk, same result dict, same witness."""
    g1a = bool(g.meta.get("g1a_reads"))
    g1b = bool(g.meta.get("g1b_reads"))
    level, anomaly, plane = ladder_verdict(g1a, g1b, txn_cyc_host(g))
    witness = refine_txn_witness(g, anomaly, plane)
    return txn_result(g, level, anomaly, witness, provenance)
