"""Host-side model state-space enumeration and transition lowering.

The device linearizability kernel is model-agnostic: it never interprets op
semantics. Instead, the host enumerates the *reachable state space* of a
sequential model under the history's op vocabulary (a BFS to fixpoint) and
lowers every distinct op kind to a dense transition vector
``target[s] -> s' or -1``. The host model (jepsen_torch.models) is therefore
the single spec; the kernel merely follows integer tables.

This works whenever the reachable state space is small — which covers the
reference's practical linearizability workloads (CAS registers with small
value domains: etcd/consul/zookeeper/logcabin/aerospike; mutexes:
hazelcast locks — model semantics at jepsen/src/jepsen/model.clj:21-105).
The C++ search (jepsen_torch.native) walks the same tables. Histories
whose state space explodes past ``max_states`` are decided by the Python
host engine, ``checkers.linearizable.wgl_check``, whose configuration
states are model objects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..history.ops import Op, INVOKE
from ..models.core import Model, is_inconsistent


def canonical_value(v: Any):
    """Hashable canonical form of an op value (lists become tuples)."""
    if isinstance(v, list):
        return tuple(canonical_value(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(canonical_value(x) for x in v)
    if isinstance(v, tuple):
        return tuple(canonical_value(x) for x in v)
    return v


def op_kind(op: Op) -> Tuple:
    """The transition-relevant identity of an op: (f, canonical value)."""
    return (op.f, canonical_value(op.value))


class StateSpaceExplosion(Exception):
    """Reachable state space exceeded the kernel's static bound."""


@dataclass
class StateSpace:
    """An enumerated state space + transition tables for one op vocabulary.

    states:  model states; index 0 is the initial state.
    kinds:   op kinds, in first-seen order; index into ``target`` rows.
    target:  int32 [K, V] — target state index, or -1 if the op is
             inconsistent from that state.
    """

    states: List[Model]
    kinds: List[Tuple]
    kind_index: Dict[Tuple, int]
    target: np.ndarray
    _identity_kinds: Optional[frozenset] = None

    @property
    def n_states(self) -> int:
        return len(self.states)

    @property
    def n_kinds(self) -> int:
        return len(self.kinds)

    @property
    def identity_kinds(self) -> frozenset:
        """Kind indices whose transition is the total identity — valid
        from every state and state-preserving (they constrain nothing).
        Cached: one batch shares a StateSpace across thousands of
        histories."""
        if self._identity_kinds is None:
            V = self.target.shape[1]
            ident = np.arange(V, dtype=np.int32)
            self._identity_kinds = frozenset(
                k for k in range(self.n_kinds)
                if np.array_equal(self.target[k], ident))
        return self._identity_kinds

    def padded_target(self, v_pad: int, k_pad: int) -> np.ndarray:
        """Target table padded to [k_pad + 1, v_pad]; the final row is the
        all-invalid sentinel used for empty pending slots."""
        K, V = self.target.shape
        out = np.full((k_pad + 1, v_pad), -1, dtype=np.int32)
        out[:K, :V] = self.target
        return out


def _rep_op(kind: Tuple) -> Op:
    f, cv = kind
    v = list(cv) if isinstance(cv, tuple) else cv
    return Op(process=0, type=INVOKE, f=f, value=v)


# (model, kinds, max_states) -> StateSpace. One batch of histories pays
# the BFS once no matter how many pipeline stages re-derive the space
# (ingest, encode, check). StateSpaces are immutable once built.
_SPACE_MEMO: Dict[Tuple, StateSpace] = {}


def enumerate_statespace(model: Model, kinds: List[Tuple],
                         max_states: int) -> StateSpace:
    """BFS the reachable state space of ``model`` under ``kinds``.

    Raises StateSpaceExplosion past ``max_states``. Models must be
    hashable/eq-comparable (all jepsen_torch.models are). Memoized.
    """
    key = (model, tuple(kinds), max_states)
    hit = _SPACE_MEMO.get(key)
    if hit is not None:
        return hit
    if len(_SPACE_MEMO) > 256:
        _SPACE_MEMO.clear()
    space = _enumerate_statespace(model, kinds, max_states)
    _SPACE_MEMO[key] = space
    return space


def _enumerate_statespace(model: Model, kinds: List[Tuple],
                          max_states: int) -> StateSpace:
    kind_ops = [(k, _rep_op(k)) for k in kinds]
    states: List[Model] = [model]
    index: Dict[Model, int] = {model: 0}
    edges: Dict[Tuple[int, int], int] = {}  # (state, kind) -> target

    frontier = [0]
    while frontier:
        nxt = []
        for si in frontier:
            s = states[si]
            for ki, (_, op) in enumerate(kind_ops):
                s2 = s.step(op)
                if is_inconsistent(s2):
                    continue
                ti = index.get(s2)
                if ti is None:
                    ti = len(states)
                    if ti >= max_states:
                        raise StateSpaceExplosion(
                            f"more than {max_states} reachable states")
                    states.append(s2)
                    index[s2] = ti
                    nxt.append(ti)
                edges[(si, ki)] = ti
        frontier = nxt

    K, V = len(kinds), len(states)
    target = np.full((K, V), -1, dtype=np.int32)
    for (si, ki), ti in edges.items():
        target[ki, si] = ti
    return StateSpace(states=states, kinds=kinds,
                      kind_index={k: i for i, (k, _) in enumerate(kind_ops)},
                      target=target)


def history_kinds(prepared: List[Op]) -> List[Tuple]:
    """Distinct op kinds among invocations, in first-seen order."""
    seen: Dict[Tuple, None] = {}
    for op in prepared:
        if op.type == INVOKE:
            seen.setdefault(op_kind(op), None)
    return list(seen.keys())


def restrict_statespace(space: StateSpace, kind_idx) -> Tuple[StateSpace,
                                                              np.ndarray]:
    """Re-enumerate ``space`` under a subset of its kind vocabulary —
    the *state renumbering* behind the per-history live-alphabet
    shrink: a history that only ever applies ``kind_idx`` kinds can
    never leave the sub-reachable space, so its frontier fits in
    ``sub.n_states`` packed states instead of the batch vocabulary's
    full reachable set (fewer packed words = less VPU work per
    transition and a smaller VMEM working set).

    Returns ``(sub, lut)`` where ``lut`` maps full-space kind indices
    to sub-space indices (-1 for kinds outside the subset). The
    verdict is unchanged by construction: every state the restricted
    history can reach is reachable under the subset BFS (same initial
    state, same transition semantics), and target rows restricted to
    substates stay within substates. Memoized through
    ``enumerate_statespace`` (the initial model is ``space.states[0]``).
    """
    kind_idx = sorted(int(k) for k in kind_idx)
    sub_kinds = [space.kinds[i] for i in kind_idx]
    sub = enumerate_statespace(space.states[0], sub_kinds,
                               len(space.states) + 1)
    lut = np.full(space.n_kinds + 1, -1, np.int32)
    for j, i in enumerate(kind_idx):
        lut[i] = j
    return sub, lut
