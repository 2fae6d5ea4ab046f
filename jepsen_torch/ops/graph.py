"""Batched happens-before dependency graphs: Adya-style anomaly
detection as boolean transitive closure on the card.

The port of the reference's ``ops/graph.py``, the second checker family
of the north star: weak-isolation anomaly detection reduces to cycle
search over typed dependency graphs ("Making Transaction Isolation
Checking Practical", PAPERS.md).

  * **extraction** (host) — typed edges between completed operations:
    ``ww`` (version overwrite), ``wr`` (read-from), ``rw``
    (anti-dependency), ``po`` (same-process order) and ``rt`` (realtime
    order). Three history families lower here: unique-write register
    histories, list-append histories (Elle's workhorse) and Adya G2
    predicate-insert histories. The same rules as the reference, line
    for line.

  * **encoding** (host) — a batch of graphs becomes one bit-packed
    ``[B, L, V, V/32]`` uint32 adjacency per vertex-count bucket (V a
    power of two, at least GRAPH_MIN_V), where the L = 3 planes are the
    cumulative anomaly masks G0 = ww∪po∪rt, G1c adds wr, G2 adds rw.
    Padding vertices have no edges and never join a cycle.

  * **decision** (device) — per plane, the transitive closure and its
    diagonal: ``cyc`` (any vertex on a cycle) and ``node`` (the first
    such vertex, INT32_MAX when acyclic). On a CUDA tensor this is the
    hand-written kernel ``csrc/graph_closure.cu`` (``cuda_graph``); on a
    CPU tensor its plain version ``plain_graph_closure``, the
    reference's arithmetic (``A <- min(A + A·A, 1)``, closure_iters(V)
    squarings in float32). A graph is anomalous at the first cyclic
    level.

  * **refinement** (host) — a cyclic graph's minimal witness cycle
    (shortest, deterministic tie-break) for the report.

The host DFS oracle twin (``check_graph_host``) shares no machinery with
the closure. Scheduling lives in ops.schedule.GraphScheduler, the
Checker-protocol surface in checkers.cycle. ``IncrementalClosure`` keeps
the closure on the host as edges stream in, for the online daemon's live
isolation monitor (jepsen_torch.isolation.IncrementalIsolation), in the
packed layout of the kernel's planes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..history.core import pairs
from ..history.ops import Op, OK
from .device import resolve_device
from .faults import INT32_MAX, CorruptOutput


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length()


# Edge types, in packing order.
EDGE_TYPES = ("ww", "wr", "rw", "po", "rt")

# Cumulative anomaly masks: a graph's anomaly class is the FIRST level
# whose mask closes into a cycle (G0 ⊂ G1c ⊂ G2 as edge sets, so a
# later level can only add cycles, never remove one).
LEVELS = ("G0", "G1c", "G2")
LEVEL_TYPES = (
    ("ww", "po", "rt"),
    ("ww", "wr", "po", "rt"),
    ("ww", "wr", "rw", "po", "rt"),
)
N_LEVELS = len(LEVELS)

# Smallest vertex bucket: graphs pad up to at least this many vertices
# so tiny graphs share one compiled shape.
GRAPH_MIN_V = 8


@dataclass
class DepGraph:
    """One history's typed dependency graph.

    n     — vertex count (one vertex per completed-ok client op).
    edges — {type: int32 [E, 2] array of (from, to) vertex pairs}.
    meta  — report payload: ``vertices`` (per-vertex op descriptors,
            used by witness refinement), ``family``, and family
            extras (e.g. the Adya ``illegal_keys`` list).
    """

    n: int
    edges: Dict[str, np.ndarray]
    meta: dict = field(default_factory=dict)

    def edge_sets(self) -> Dict[str, set]:
        return {t: {(int(u), int(v)) for u, v in self.edges.get(t, ())}
                for t in EDGE_TYPES}


def _edges(pairs_list) -> np.ndarray:
    if not pairs_list:
        return np.zeros((0, 2), np.int32)
    return np.asarray(sorted(set(pairs_list)), np.int32).reshape(-1, 2)


# ------------------------------------------------------------ extraction

def _ok_pairs(history: Sequence[Op]):
    """(invoke, ok-completion) pairs for client ops, in invoke order."""
    client = [op for op in history if op.is_client]
    return [(inv, comp) for inv, comp in pairs(client)
            if comp is not None and comp.type == OK]


def _order_edges(verts) -> Tuple[np.ndarray, np.ndarray]:
    """(po, rt) edges over vertex descriptors carrying inv/cmp line
    indices and process ids. po chains same-process vertices in invoke
    order; rt is the full interval order complete(T1) < invoke(T2)
    (dense — the closure kernel absorbs redundancy for free, and a
    transitive reduction here could miss cycles)."""
    po = []
    by_proc: Dict = {}
    for i, v in enumerate(verts):
        by_proc.setdefault(v["proc"], []).append(i)
    for vs in by_proc.values():
        po.extend((vs[k], vs[k + 1]) for k in range(len(vs) - 1))
    if verts:
        inv = np.asarray([v["inv"] for v in verts])
        cmp_ = np.asarray([v["cmp"] for v in verts])
        u, w = np.nonzero(cmp_[:, None] < inv[None, :])
        rt = np.stack([u, w], axis=1).astype(np.int32)
    else:
        rt = np.zeros((0, 2), np.int32)
    return _edges(po), rt


def _vertex_meta(verts) -> List[dict]:
    return [{"index": v["cmp"], "process": v["proc"], "f": v["f"],
             "value": v["value"]} for v in verts]


def graph_register(history: Sequence[Op]) -> DepGraph:
    """Unique-write register histories (read/write/cas): every ok write
    (and cas to-value) must be unique — the standard dependency-graph
    precondition. The version order is the ok-write completion order
    (the completion-point convention this repo's recorders follow);
    reads of never-written values raise ValueError (that anomaly class
    belongs to the WGL checker)."""
    verts, writes, reads = [], [], []
    for inv, comp in _ok_pairs(history):
        i = len(verts)
        verts.append({"inv": inv.index, "cmp": comp.index,
                      "proc": inv.process, "f": inv.f,
                      "value": comp.value})
        if inv.f == "write":
            writes.append((i, comp.value))
        elif inv.f == "read":
            reads.append((i, comp.value))
        elif inv.f == "cas":
            a, b = comp.value
            reads.append((i, a))
            writes.append((i, b))
    vals = [v for _, v in writes]
    if len(set(vals)) != len(vals):
        raise ValueError("register extraction needs unique write values")
    writer = {v: i for i, v in writes}
    # Version order: ok writes by completion line index.
    chain = [i for i, _ in sorted(writes,
                                  key=lambda iv: verts[iv[0]]["cmp"])]
    pos = {i: k for k, i in enumerate(chain)}
    ww = [(chain[k], chain[k + 1]) for k in range(len(chain) - 1)]
    wr, rw = [], []
    for r, v in reads:
        if v is None:                       # initial value observed
            if chain and chain[0] != r:
                rw.append((r, chain[0]))
            continue
        w = writer.get(v)
        if w is None:
            raise ValueError(f"read of never-written value {v!r}")
        if w != r:
            wr.append((w, r))
        k = pos[w] + 1
        if k < len(chain) and chain[k] != r:
            rw.append((r, chain[k]))
    po, rt = _order_edges(verts)
    return DepGraph(
        n=len(verts),
        edges={"ww": _edges(ww), "wr": _edges(wr), "rw": _edges(rw),
               "po": po, "rt": rt},
        meta={"family": "register", "vertices": _vertex_meta(verts)})


def graph_list_append(history: Sequence[Op]) -> DepGraph:
    """List-append histories (Elle's workhorse): ``append`` ops carry
    ``[k, element]`` (elements unique per key), ok ``read`` ops observe
    ``[k, [elements...]]``. Per key, the longest observed list fixes
    the version order; ok appends never observed extend it in
    completion order. Reads that are NOT a prefix of the version order
    witness two appends claiming the same position — a ww contradiction
    encoded as a 2-cycle."""
    verts = []
    app: Dict = {}          # key -> {element: vertex}
    app_order: Dict = {}    # key -> [vertex] in completion order
    reads: Dict = {}        # key -> [(vertex, observed list)]
    for inv, comp in _ok_pairs(history):
        i = len(verts)
        verts.append({"inv": inv.index, "cmp": comp.index,
                      "proc": inv.process, "f": inv.f,
                      "value": comp.value})
        k, v = comp.value
        if inv.f == "append":
            app.setdefault(k, {})[v] = i
            app_order.setdefault(k, []).append(i)
        elif inv.f == "read":
            obs = list(v or [])
            if len(set(obs)) != len(obs):
                # Elements are unique by contract, so a duplicated
                # observation is malformed input, not a version — the
                # same degrade-to-unknown contract as a never-appended
                # element, never a confident verdict.
                raise ValueError(
                    f"read observes duplicated element(s) on key {k!r}")
            reads.setdefault(k, []).append((i, obs))
    ww, wr, rw = [], [], []
    for k in set(app) | set(reads):
        writer = app.get(k, {})
        obs_lists = [o for _, o in reads.get(k, [])]
        longest = max(obs_lists, key=len, default=[])
        chain = []
        for e in longest:
            w = writer.get(e)
            if w is None:
                raise ValueError(
                    f"read of never-appended element {e!r} on key {k!r}")
            chain.append(w)
        in_chain = set(chain)
        chain += [w for w in app_order.get(k, []) if w not in in_chain]
        ww.extend((chain[j], chain[j + 1]) for j in range(len(chain) - 1)
                  if chain[j] != chain[j + 1])
        celems = longest
        for r, obs in reads.get(k, []):
            j = 0
            while j < len(obs) and j < len(celems) and obs[j] == celems[j]:
                j += 1
            if j < len(obs):
                # Non-prefix read: writer(obs[j]) and writer(chain[j])
                # both extended the same j-prefix — whatever the true
                # version order, one overwrote the other and vice
                # versa: an unconditional ww 2-cycle.
                w2 = writer.get(obs[j])
                if w2 is None:
                    raise ValueError(f"read of never-appended element "
                                     f"{obs[j]!r} on key {k!r}")
                w1 = chain[j] if j < len(chain) else w2
                if w1 != w2:
                    ww.extend([(w1, w2), (w2, w1)])
                if j > 0 and chain[j - 1] != r:
                    wr.append((chain[j - 1], r))
                continue
            m = len(obs)
            if m > 0 and chain[m - 1] != r:
                wr.append((chain[m - 1], r))
            if m < len(chain) and chain[m] != r:
                rw.append((r, chain[m]))
    po, rt = _order_edges(verts)
    return DepGraph(
        n=len(verts),
        edges={"ww": _edges(ww), "wr": _edges(wr), "rw": _edges(rw),
               "po": po, "rt": rt},
        meta={"family": "list-append", "vertices": _vertex_meta(verts)})


def graph_adya_g2(history: Sequence[Op]) -> DepGraph:
    """Adya G2 predicate-insert histories (adya.py): per key, each
    committed insert's predicate read observed the key's tables EMPTY
    (else it would not have inserted) — so every pair of ok inserts on
    one key anti-depends on each other both ways: an rw 2-cycle, the
    canonical G2 witness. ``meta["illegal_keys"]`` carries the
    witnessing keys, field-comparable with G2Checker's host count."""
    from ..independent import KV
    verts, by_key = [], {}
    for inv, comp in _ok_pairs(history):
        if inv.f != "insert":
            continue
        v = comp.value
        k = v.key if isinstance(v, KV) else v[0]
        i = len(verts)
        verts.append({"inv": inv.index, "cmp": comp.index,
                      "proc": inv.process, "f": inv.f, "value": v,
                      "key": k})
        by_key.setdefault(k, []).append(i)
    rw, illegal = [], []
    for k, vs in by_key.items():
        if len(vs) < 2:
            continue
        illegal.append(k)
        rw.extend((a, b) for a in vs for b in vs if a != b)
    po, rt = _order_edges(verts)
    z = np.zeros((0, 2), np.int32)
    vmeta = _vertex_meta(verts)
    for m, v in zip(vmeta, verts):
        m["key"] = v["key"]
    return DepGraph(
        n=len(verts),
        edges={"ww": z, "wr": z, "rw": _edges(rw), "po": po, "rt": rt},
        meta={"family": "adya-g2", "vertices": vmeta,
              "illegal_keys": sorted(illegal)})


_FAMILIES = {"register": graph_register,
             "list-append": graph_list_append,
             "adya-g2": graph_adya_g2}


def extract_graph(history: Sequence[Op],
                  family: Optional[str] = None) -> DepGraph:
    """Lower one history to its dependency graph. ``family`` picks the
    extraction rules; None sniffs the op vocabulary (insert → adya-g2,
    append → list-append, else register)."""
    if family is None:
        fs = {op.f for op in history if op.is_client}
        family = ("adya-g2" if "insert" in fs
                  else "list-append" if "append" in fs else "register")
    return _FAMILIES[family](history)


# -------------------------------------------------------------- encoding

@dataclass
class GraphBucket:
    """One vertex-count bucket of packed graphs.

    adj — int32 [B, L, V, Wd] bitset adjacency (bit c of word w on row
    r = edge r → w*32+c; the reference's uint32 words carried as int32
    bit patterns, as torch has no uint32 arithmetic), one plane per
    cumulative anomaly mask.
    Padding rows/columns are all-zero and can never join a cycle, so
    true vertex counts need not travel with the bucket; ``indices``
    scatter verdicts back to the caller's rows."""

    adj: np.ndarray
    V: int
    indices: List[int]

    @property
    def batch(self) -> int:
        return int(self.adj.shape[0])


def bucket_v(n: int) -> int:
    """The padded vertex bucket a graph of n vertices encodes into."""
    return max(GRAPH_MIN_V, _pow2(max(n, 1)))


def pack_graph(g: DepGraph, V: int,
               level_types: Optional[Sequence[Sequence[str]]] = None
               ) -> np.ndarray:
    """[L, V, V/32] packed cumulative masks for one graph: the
    reference's uint32 words as int32 bit patterns. ``level_types``
    overrides the plane masks (txn isolation ladder)."""
    if level_types is None:
        level_types = LEVEL_TYPES
    Wd = max(V // 32, 1)
    dense = np.zeros((len(level_types), V, Wd * 32), np.uint8)
    for li, types in enumerate(level_types):
        for t in types:
            e = g.edges.get(t)
            if e is not None and len(e):
                dense[li, e[:, 0], e[:, 1]] = 1
    packed = np.packbits(dense, axis=-1, bitorder="little")
    return packed.view(np.int32)


def encode_graphs(graphs: Sequence[DepGraph],
                  indices: Optional[Sequence[int]] = None,
                  level_types: Optional[Sequence[Sequence[str]]] = None
                  ) -> List[GraphBucket]:
    """Bucket a batch of graphs by padded vertex count (powers of two,
    floor GRAPH_MIN_V) and pack each bucket's adjacency bitsets."""
    if indices is None:
        indices = list(range(len(graphs)))
    by_v: Dict[int, List[int]] = {}
    for j, g in enumerate(graphs):
        by_v.setdefault(bucket_v(g.n), []).append(j)
    out = []
    for V in sorted(by_v):
        js = by_v[V]
        out.append(GraphBucket(
            adj=np.stack([pack_graph(graphs[j], V, level_types)
                          for j in js]),
            V=V, indices=[indices[j] for j in js]))
    return out


# ----------------------------------------------------------- the closure

def closure_iters(V: int) -> int:
    """Squaring steps to close paths up to length V: after k steps the
    relation covers all paths of length <= 2^k."""
    return max(V - 1, 1).bit_length()


def words(V: int) -> int:
    """Packed uint32 words per adjacency row."""
    return max(V // 32, 1)


def unpack_planes(adj: torch.Tensor, V: int) -> torch.Tensor:
    """int32 [..., V, words(V)] packed rows -> float32 [..., V, V] 0/1
    (bit c of word w = column w*32 + c; torch's ``>>`` on int32 is
    arithmetic, and ``& 1`` keeps bit c whatever the sign)."""
    col = torch.arange(V, device=adj.device)
    bits = adj[..., col // 32] >> (col % 32).to(torch.int32)
    return (bits & 1).to(torch.float32)


def close_and_probe(a: torch.Tensor, V: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's closure and probe on float32 [B, L, V, V] 0/1
    planes: closure_iters(V) steps of ``A <- min(A + A·A, 1)``, then
    ``cyc`` bool [B, L] (any diagonal entry) and ``node`` int32 [B, L]
    (the first diagonal entry, INT32_MAX when there is none). The sums
    are exact in float32 (at most V + 1 < 2^24); on the card the caller
    keeps ``torch.backends.cuda.matmul.allow_tf32`` off."""
    for _ in range(closure_iters(V)):
        a = torch.clamp_max(a + torch.matmul(a, a), 1.0)
    diag = torch.diagonal(a, dim1=-2, dim2=-1) > 0.0
    cyc = diag.any(dim=-1)
    first = torch.argmax(diag.to(torch.int32), dim=-1).to(torch.int32)
    node = torch.where(cyc, first, torch.full_like(first, int(INT32_MAX)))
    return cyc, node


def plain_graph_closure(adj: torch.Tensor, V: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the closure kernel's graph entry:
    int32 [B, L, V, words(V)] packed planes -> (cyc, node) [B, L], the
    reference's ``graph_kernel(V)`` arithmetic on torch tensors."""
    return close_and_probe(unpack_planes(adj, V), V)


def close_planes(adj: torch.Tensor, V: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cyc, node) of packed int32 planes on ``adj``'s device: the CUDA
    kernel for a CUDA tensor (which launches or raises), the plain
    version for a CPU tensor."""
    if adj.device.type == "cuda":
        from . import cuda_graph
        return cuda_graph.graph_closure(adj, V)
    return plain_graph_closure(adj, V)


def graph_closure(adj: np.ndarray, V: int, *, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The device entry: one bucket's int32 [B, L, V, words(V)] planes
    closed on ``device`` (the card unless the caller names another);
    returns numpy ``cyc`` bool [B, L] and ``node`` int32 [B, L]."""
    t = torch.from_numpy(np.ascontiguousarray(adj, np.int32))
    cyc, node = close_planes(t.to(resolve_device(device)), V)
    return cyc.cpu().numpy(), node.cpu().numpy()


def validate_graph_decoded(cyc: np.ndarray, node: np.ndarray,
                           V: int) -> None:
    """Verdict-shape invariants for decoded graph chunks: acyclic
    levels carry the INT32_MAX sentinel, cyclic levels a vertex inside
    the padded axis — corrupt device output becomes a retryable fault,
    never a wrong verdict (the validate_decoded analog)."""
    c = np.asarray(cyc)
    nd = np.asarray(node)
    if c.dtype != np.bool_ or c.shape != nd.shape:
        raise CorruptOutput(
            f"graph verdict arrays malformed: cyc {c.dtype}{c.shape} "
            f"node {nd.dtype}{nd.shape}")
    if c.size and not (nd[~c] == INT32_MAX).all():
        raise CorruptOutput("acyclic level without the INT32_MAX sentinel")
    on = nd[c]
    if on.size and ((on < 0) | (on >= V)).any():
        raise CorruptOutput(
            f"cyclic level with on-cycle vertex outside [0, {V})")


def mxu_op_model(V: int, levels: int = N_LEVELS) -> Dict[str, float]:
    """Analytic device cost of one graph's closure at padded vertex
    count V: ``matmuls`` [V,V]x[V,V] products and their ``macs``
    (multiply-accumulates — the MXU currency of the reference, which the
    scheduler's ``mxu_macs`` stat keeps so that both packages' stats
    compare equal)."""
    it = closure_iters(V)
    return {"iterations": it, "matmuls": levels * it,
            "macs": float(levels) * it * V ** 3}


# ------------------------------------------------- host oracle + witness

def _succ_lists(g: DepGraph, types: Sequence[str]) -> List[List[int]]:
    succ: List[set] = [set() for _ in range(g.n)]
    for t in types:
        for u, v in g.edges.get(t, ()):
            succ[int(u)].add(int(v))
    return [sorted(s) for s in succ]


def _has_cycle_dfs(n: int, succ: List[List[int]]) -> bool:
    """Iterative three-color DFS — deliberately NOT the closure
    algorithm, so host and device verdicts are independently derived."""
    color = bytearray(n)                      # 0 white, 1 gray, 2 black
    for s0 in range(n):
        if color[s0]:
            continue
        color[s0] = 1
        stack = [(s0, 0)]
        while stack:
            v, i = stack[-1]
            if i < len(succ[v]):
                stack[-1] = (v, i + 1)
                w = succ[v][i]
                if color[w] == 1:
                    return True
                if color[w] == 0:
                    color[w] = 1
                    stack.append((w, 0))
            else:
                color[v] = 2
                stack.pop()
    return False


def shortest_cycle(n: int, succ: List[List[int]]) -> Optional[List[int]]:
    """Deterministic minimal witness: BFS from each vertex (ascending)
    for the shortest path back to itself; ties keep the first found.
    Returns the cycle's vertices in order (closed implicitly)."""
    from collections import deque
    best: Optional[List[int]] = None
    for s in range(n):
        if best is not None and len(best) == 1:
            break
        dist = [-1] * n
        prev = [-1] * n
        dist[s] = 0
        dq = deque([s])
        hit = None
        while dq and hit is None:
            v = dq.popleft()
            if best is not None and dist[v] + 1 >= len(best):
                continue
            for w in succ[v]:
                if w == s:
                    hit = v
                    break
                if dist[w] < 0:
                    dist[w] = dist[v] + 1
                    prev[w] = v
                    dq.append(w)
        if hit is not None:
            path = [hit]
            while path[-1] != s:
                path.append(prev[path[-1]])
            path.reverse()
            if best is None or len(path) < len(best):
                best = path
    return best


def refine_witness(g: DepGraph, level_index: int,
                   types: Optional[Sequence[str]] = None) -> List[dict]:
    """Host refinement of a device-flagged cyclic graph into the
    minimal witness cycle, annotated with per-vertex op descriptors and
    the edge types carrying each hop (the fused_refine pattern).
    ``types`` overrides the cumulative mask for families whose level
    masks are not LEVEL_TYPES (the txn isolation ladder)."""
    if types is None:
        types = LEVEL_TYPES[level_index]
    succ = _succ_lists(g, types)
    cyc = shortest_cycle(g.n, succ)
    if cyc is None:                  # defensive: caller said cyclic
        return []
    sets = {t: {(int(u), int(v)) for u, v in g.edges.get(t, ())}
            for t in types}
    vmeta = g.meta.get("vertices") or [{} for _ in range(g.n)]
    out = []
    for i, v in enumerate(cyc):
        w = cyc[(i + 1) % len(cyc)]
        via = sorted(t for t in types if (v, w) in sets[t])
        out.append({"vertex": v, "via": via, **vmeta[v]})
    return out


def graph_result(g: DepGraph, anomaly: Optional[str],
                 witness: Optional[List[dict]], provenance: str) -> dict:
    """The one result-dict shape both engines emit (parity is
    field-for-field over this dict)."""
    out = {
        "valid": anomaly is None,
        "anomaly": anomaly,
        "cycle": witness or [],
        "vertices": g.n,
        "edges": {t: int(len(g.edges.get(t, ()))) for t in EDGE_TYPES},
        "provenance": provenance,
    }
    if "illegal_keys" in g.meta:
        out["illegal-keys"] = list(g.meta["illegal_keys"])
    return out


def check_graph_host(g: DepGraph, provenance: str = "host") -> dict:
    """The pure-host oracle twin: DFS cycle search per cumulative mask,
    same result dict, same witness refinement."""
    for li, types in enumerate(LEVEL_TYPES):
        if _has_cycle_dfs(g.n, _succ_lists(g, types)):
            return graph_result(g, LEVELS[li], refine_witness(g, li),
                                provenance)
    return graph_result(g, None, None, provenance)


# --------------------------------------------- incremental closure

class IncrementalClosure:
    """Transitive-closure bitset maintained incrementally as edges
    arrive, the graph family's O(new edges) move: a live-monitored
    dependency graph must not re-close the whole [V, V] relation from
    scratch each tick. A copy of the reference's, host numpy.

    The closure lives as a packed uint32 bitset ``C`` ([V, V/32]; bit
    c of word w on row r = r reaches w*32+c), one plane per cumulative
    anomaly level (the LEVEL_TYPES masks, exactly the device kernel's
    layout — pack_graph's word order). Adding edge u → v touches only
    the AFFECTED rows: every vertex that reaches u (plus u itself)
    gains v's whole reach (plus v) in one vectorized OR over the
    existing closure, O(|pred(u)| * V/32) words, not a V^3 re-close.
    An edge already implied by the closure is a no-op.

    ``grow(n)`` widens the vertex space: within the padded bucket
    (power-of-two columns, GRAPH_MIN_V floor) new vertices are free —
    their bits were always zero — while crossing the bucket falls back
    to ONE full re-closure at the wider shape (counted in ``stats``),
    after which deltas are incremental again. The same invalidation
    discipline as the WGL resident frontier.

    ``anomaly()`` is the running verdict: the first cumulative level
    whose closure holds a diagonal bit (levels only ever gain edges,
    so the verdict is monotone — once cyclic at a level, forever
    cyclic there). Parity: tests pin it against check_graph_host and
    the from-scratch closure on every prefix of an edge stream.

    ``level_types``/``names`` parameterize the cumulative masks so
    other graph families (the txn isolation ladder) reuse the same
    incremental machinery; defaults are this family's LEVEL_TYPES."""

    def __init__(self, n: int = 0,
                 level_types: Optional[Sequence[Sequence[str]]] = None,
                 names: Optional[Sequence[str]] = None):
        self.level_types = tuple(tuple(ts) for ts in (
            LEVEL_TYPES if level_types is None else level_types))
        self.names = tuple(LEVELS if names is None else names)
        self.n_levels = len(self.level_types)
        self.n = 0
        self.cols = 0                  # padded column bucket
        self.edges: List[List[Tuple[int, int]]] = \
            [[] for _ in range(self.n_levels)]
        self.stats = {"edges": 0, "implied": 0, "row_updates": 0,
                      "recloses": 0}
        self._C: Optional[np.ndarray] = None   # [L, V, V/32] uint32
        if n:
            self.grow(n)

    # ------------------------------------------------------- plumbing
    def _alloc(self, n: int) -> None:
        # Rows index the full padded bucket so vectorized row updates
        # never bounds-check; pad rows/cols are edgeless and can never
        # join a cycle (the pack_graph invariant).
        self.cols = max(GRAPH_MIN_V, _pow2(n))
        self._C = np.zeros(
            (self.n_levels, self.cols, max(1, self.cols // 32)),
            np.uint32)

    def grow(self, n: int) -> None:
        """Widen the vertex space to ``n``. Free within the padded
        bucket; crossing it re-closes once at the wider shape."""
        if n <= self.n:
            return
        self.n = n
        if self._C is None:
            self._alloc(n)
            return
        if n <= self.cols:
            return                      # pad columns were always zero
        self._alloc(n)
        self.stats["recloses"] += 1
        for li in range(self.n_levels):
            for u, v in self.edges[li]:
                self._apply(li, u, v)

    def _apply(self, li: int, u: int, v: int) -> bool:
        """Close levels >= li under the new edge u → v against the
        existing closure. Returns False when the edge was already
        implied at every affected level."""
        C = self._C
        touched = False
        wv, bv = v // 32, np.uint32(1 << (v % 32))
        for l in range(li, self.n_levels):
            if C[l, u, wv] & bv:
                continue                # already implied at this level
            # rows that reach u (plus u itself) gain v's reach plus v.
            pred = (C[l, :, u // 32]
                    & np.uint32(1 << (u % 32))).astype(bool)
            pred[u] = True
            reach = C[l, v].copy()
            reach[wv] |= bv
            C[l, pred] |= reach
            self.stats["row_updates"] += int(pred.sum())
            touched = True
        return touched

    # --------------------------------------------------------- updates
    def add_edge(self, etype: str, u: int, v: int) -> None:
        """One dependency edge of EDGE_TYPES kind ``etype`` (levels it
        belongs to follow the cumulative LEVEL_TYPES masks)."""
        hi = max(int(u), int(v)) + 1
        if hi > self.n:
            self.grow(hi)
        li = next(i for i, types in enumerate(self.level_types)
                  if etype in types)
        self.edges[li].append((int(u), int(v)))
        self.stats["edges"] += 1
        if not self._apply(li, int(u), int(v)):
            self.stats["implied"] += 1

    def add_edges(self, etype: str, pairs) -> None:
        for u, v in pairs:
            self.add_edge(etype, u, v)

    # --------------------------------------------------------- verdict
    def reaches(self, li: int, u: int, v: int) -> bool:
        return bool(self._C is not None
                    and self._C[li, u, v // 32]
                    & np.uint32(1 << (v % 32)))

    def cyclic_levels(self) -> List[bool]:
        """Per cumulative level: does the closure hold a diagonal bit?
        (The device kernel's ``cyc`` output, derived incrementally.)"""
        if self._C is None:
            return [False] * self.n_levels
        idx = np.arange(self.n)
        return [bool((self._C[l, idx, idx // 32]
                      >> (idx % 32).astype(np.uint32) & 1).any())
                for l in range(self.n_levels)]

    def anomaly(self) -> Optional[str]:
        """The running verdict: the FIRST cumulative level whose mask
        closed into a cycle, or None. Monotone in the edge stream."""
        for li, cyc in enumerate(self.cyclic_levels()):
            if cyc:
                return self.names[li]
        return None
