"""History serialization: one op a JSON line.

A copy of the reference's ``history/codec.py`` (its text log,
``write_txt``, is not ported): the same line format, so a history or a
WAL that either package writes reads back in the other. Tuples
round-trip as lists; independent-key values (``independent.KV``), sets
and bytes carry a tag so they come back as what they were.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, List

from .ops import Op


def _encode_kvs(v):
    """Independent-key tuples must survive the round trip as KV, not
    list, including nested occurrences."""
    from ..independent import KV
    if isinstance(v, KV):
        return {"__kv__": [_encode_kvs(v[0]), _encode_kvs(v[1])]}
    if isinstance(v, (list, tuple)):
        return [_encode_kvs(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_kvs(x) for k, x in v.items()}
    return v


def dumps_op(op: Op) -> str:
    d = {k: _encode_kvs(v) for k, v in op.to_dict().items()}
    return json.dumps(d, separators=(",", ":"), default=_default)


def loads_op(line: str) -> Op:
    d = json.loads(line)
    for k, v in list(d.items()):
        d[k] = _revive(v)
    return Op.from_dict(d)


def _default(o):
    if isinstance(o, (set, frozenset)):
        return {"__set__": sorted(o, key=repr)}
    if isinstance(o, (bytes, bytearray)):
        import base64
        return {"__bytes__": base64.b64encode(bytes(o)).decode("ascii")}
    # Refuse to guess: repr-ing a value would change its type on a round
    # trip and flip checker verdicts on reload.
    raise TypeError(f"op value of type {type(o).__name__} is not "
                    f"JSON-serializable: {o!r}")


def _revive(d):
    if isinstance(d, dict):
        if set(d.keys()) == {"__set__"}:
            return set(d["__set__"])
        if set(d.keys()) == {"__bytes__"}:
            import base64
            return base64.b64decode(d["__bytes__"])
        if set(d.keys()) == {"__kv__"}:
            from ..independent import KV
            return KV(_revive(d["__kv__"][0]), _revive(d["__kv__"][1]))
        return {k: _revive(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_revive(v) for v in d]
    return d


def write_jsonl(path, history: Iterable[Op], chunk: int = 8192) -> None:
    """Write ops as JSON lines, buffered in chunks, durably: an fsynced
    temp file and an atomic rename, so a crash mid-write leaves the old
    file or the new one, never a torn hybrid."""
    path_s = str(path)
    tmp = f"{path_s}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        buf: List[str] = []
        for op in history:
            buf.append(dumps_op(op))
            if len(buf) >= chunk:
                f.write("\n".join(buf) + "\n")
                buf.clear()
        if buf:
            f.write("\n".join(buf) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path_s)


class CorruptHistoryLine(ValueError):
    """A history line that does not parse, with the path and 1-based
    line number (a bare json.JSONDecodeError loses both)."""

    def __init__(self, path, lineno: int, cause: Exception):
        self.path, self.lineno = str(path), lineno
        super().__init__(
            f"{path}:{lineno}: corrupt/truncated history line: {cause}")


def read_jsonl(path, tolerant: bool = False) -> List[Op]:
    """Parse a JSONL history. A corrupt or truncated line raises
    CorruptHistoryLine; with ``tolerant=True`` it ends the read and the
    good prefix is returned (a process killed mid-write leaves at most
    one torn final line)."""
    out: List[Op] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(loads_op(line))
            except Exception as e:
                if tolerant:
                    break
                raise CorruptHistoryLine(path, lineno, e) from e
    return out
