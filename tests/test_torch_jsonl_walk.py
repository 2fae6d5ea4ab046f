"""The port's ``jsonl_to_columnar`` (stored histories onto the columnar
path) against the reference's, on the CPU.

Each case serializes one batch of histories to jsonl text with the
codec and converts it four ways: the port's native walk
(``native.ingest().walk_jsonl``), the port's ``native=False`` route (the
codec parse and the Python walk), the port's ``ops_to_columnar`` on the
parsed Op lists, and the reference's ``jsonl_to_columnar``. All four
must give the same arrays (type, process, kind, index) and the same
kinds vocabulary in the same order. The cases are the reference's edge
cases: random cas batches, nemesis (string-process) lines, list-valued
cas ops, error fields, crashed invocations (their kinds interned in line
order), bytes input, CRLF line ends, tabs after numbers, blank lines, a
seeded vocabulary, lines the scanner cannot place (the whole batch goes
to the codec route), and a line that is not JSON at all (both packages
raise). A walk that cannot be built raises. Tolerance: none.
"""
import json

import numpy as np
import pytest
import torch

from jepsen_tpu.history.columnar import jsonl_to_columnar as r_jsonl
from jepsen_tpu.models.core import cas_register as r_cas

from jepsen_torch import native as N
from jepsen_torch.history import columnar as PC
from jepsen_torch.history.codec import dumps_op, loads_op
from jepsen_torch.history.core import index
from jepsen_torch.history.ops import fail_op, info_op, invoke_op, ok_op
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import _build
from jepsen_torch.workloads.synth import synth_cas_batch

torch.set_num_threads(1)

FIELDS = ("type", "process", "kind", "index")


def texts_of(hists, sep="\n"):
    return [sep.join(dumps_op(op) for op in h) + sep for h in hists]


def edge_history():
    return index([
        invoke_op("nemesis", "start", None),
        info_op("nemesis", "start", "partitioned"),
        invoke_op(0, "write", 7), ok_op(0, "write", 7),
        invoke_op(1, "cas", [1, 2]),
        info_op(1, "cas", [1, 2], error="timeout"),
        invoke_op(2, "read", None), ok_op(2, "read", 7),
        invoke_op(3, "write", 4), fail_op(3, "write", 4),
        ok_op(4, "read", 1),                 # orphan completion
        invoke_op(0, "write", 3),            # crashed: no completion
    ])


def crashed_history():
    return index([invoke_op(p, "write", p) for p in range(10)])


def tabbed():
    return [(b'{"process":\t0,\t"type": "invoke", "f": "write",'
             b' "value": 1}\n'
             b'{"process":\t0,\t"type": "ok", "f": "write",'
             b' "value": 1}\n')]


def unscannable():
    """Valid JSON lines the scanner cannot place (no "value" key, a
    non-integer index): the batch goes to the codec route."""
    hs = synth_cas_batch(4, 9, n_procs=3, n_ops=10, n_values=3)
    t = texts_of(hs)
    t[1] = '{"process": 0, "type": "invoke", "f": "read"}\n' \
           '{"process": 0, "type": "ok", "f": "read", "value": 2}\n' + t[1]
    t[2] = t[2].replace('"index": 3', '"index": 3.0', 1)
    return t


CASES = {
    "random": lambda: texts_of(synth_cas_batch(
        24, 5, n_procs=4, n_ops=40, n_values=4, corrupt=0.2, p_info=0.1)),
    "long": lambda: texts_of(synth_cas_batch(4, 6, n_ops=80)),
    "edges": lambda: texts_of([edge_history()]),
    "edges_bytes": lambda: [t.encode() for t in texts_of([edge_history()])],
    "crlf": lambda: texts_of(synth_cas_batch(5, 7, n_ops=20), sep="\r\n"),
    "tabs": tabbed,
    "crashed": lambda: texts_of([crashed_history()]),
    "blank_lines": lambda: [t.replace("\n", "\n\n  \n")
                            for t in texts_of(synth_cas_batch(3, 8))],
    "unscannable": unscannable,
}
SEEDS = {None: None, "seeded": [("write", 9), ("read", 1), ("write", 7)]}


def parse(texts):
    return [[loads_op(line) for line in
             (t.decode() if isinstance(t, bytes) else t).splitlines()
             if line.strip()] for t in texts]


def assert_same(a, b):
    assert list(a.kinds) == list(b.kinds)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("seed", list(SEEDS))
@pytest.mark.parametrize("case", list(CASES))
def test_jsonl_routes_match_the_reference(case, seed):
    texts = CASES[case]()
    kinds = SEEDS[seed]
    want = r_jsonl(r_cas(), texts, kinds=kinds)
    native = PC.jsonl_to_columnar(cas_register(), texts, kinds=kinds)
    python = PC.jsonl_to_columnar(cas_register(), texts, kinds=kinds,
                                  native=False)
    walked = PC.ops_to_columnar(cas_register(), parse(texts), kinds=kinds)
    for got in (native, python, walked):
        assert_same(got, want)
    if case == "tabs":
        assert int((native.type[0] != PC.PAD).sum()) == 2


def test_scanner_bails_on_unscannable_lines():
    """The native scanner itself returns None on the unscannable batch
    (so the codec route really ran) and places every line of the
    others."""
    ext = N.ingest()
    parse_v = lambda s: json.loads(s)          # noqa: E731
    assert ext.walk_jsonl(unscannable(), {}, [], parse_v) is None
    assert ext.walk_jsonl(CASES["random"](), {}, [], parse_v) is not None


def test_not_json_raises_in_both():
    texts = CASES["random"]()[:3]
    texts[2] = "not json at all\n" + texts[2]
    with pytest.raises(Exception) as ref:
        r_jsonl(r_cas(), texts)
    for native in (True, False):
        with pytest.raises(type(ref.value)):
            PC.jsonl_to_columnar(cas_register(), texts, native=native)


def test_crashed_invocations_intern_in_line_order():
    h = crashed_history()
    native = PC.jsonl_to_columnar(cas_register(), texts_of([h]))
    python = PC.ops_to_columnar(cas_register(), [h], native=False)
    assert native.kinds == python.kinds == [("write", p) for p in range(10)]


def test_unbuildable_walk_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(N, "CXX", "no-such-cxx-compiler")
    monkeypatch.setattr(N, "_ingest_mod", None)
    texts = CASES["random"]()[:2]
    with pytest.raises(OSError):
        PC.jsonl_to_columnar(cas_register(), texts)
    assert PC.jsonl_to_columnar(cas_register(), texts,
                                native=False).batch == 2
