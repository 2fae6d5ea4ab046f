"""Counterexample rendering for invalid linearizability results.

The reference renders invalid analyses to ``linear.svg`` through
knossos.linear.report (jepsen/src/jepsen/checker.clj:98-103). This is
the native twin: a dependency-free SVG of the concurrency window around
the first impossible completion — one lane per process, bars colored by
completion type (doc/color.md palette), the culprit op outlined red —
with the checker's surviving config sample printed beneath (the same
truncate-to-10 discipline as the result dict, checker.clj:104-107).
"""
from __future__ import annotations

import html
from typing import List, Optional, Sequence

from ..history.core import pairs
from ..history.ops import Op, OK, FAIL, INFO

# The timeline checker's palette (doc/color.md), kept here until the
# timeline checker is ported: bars colored by completion type, None for
# an invocation that never completed.
TYPE_COLORS = {OK: "#6DB6FE", INFO: "#FFAA26", FAIL: "#FEB5DA",
               None: "#eeeeee"}

LANE_H = 28
BAR_H = 20
LEFT = 110
WIDTH = 860
FONT = 'font-family="sans-serif" font-size="11"'


def _window(history: Sequence[Op], bad_index: int,
            radius: int = 12) -> List[Op]:
    """Ops within ``radius`` history positions of the bad op, plus any
    op pair spanning it (the concurrency window that constrains the
    search at the failure point)."""
    pos = next((i for i, op in enumerate(history)
                if op.index == bad_index), None)
    if pos is None:
        return list(history)[:2 * radius]
    lo, hi = max(0, pos - radius), min(len(history), pos + radius + 1)
    picked = {id(op) for op in history[lo:hi]}
    out = list(history[lo:hi])
    # Pull in invocations whose completion lies inside the window,
    # keeping history order — render_svg's x-scale is position-based,
    # so a spanning invocation must sort before the window, not pile
    # up at a fixed index detached from its completion.
    pulled = []
    open_inv = {}
    for i, op in enumerate(history):
        if op.is_invoke:
            open_inv[op.process] = (i, op)
        elif op.is_completion:
            inv = open_inv.pop(op.process, None)
            if inv is not None and id(op) in picked \
                    and id(inv[1]) not in picked:
                pulled.append(inv)
                picked.add(id(inv[1]))
    pulled.sort(key=lambda iv: iv[0])
    return [op for _, op in pulled] + out


def render_svg(model, history: Sequence[Op], result: dict) -> str:
    """The invalid-analysis SVG. ``result`` is the checker's dict —
    {"valid": False, "op": {...}, "configs": [...]}."""
    bad = (result.get("op") or {}).get("index")
    window = _window(list(history), bad if bad is not None else -1)
    client = [op for op in window if op.is_client]

    lanes: dict = {}
    for op in client:
        lanes.setdefault(op.process, len(lanes))

    # X scale over the window by history position (wall times may be
    # absent on re-checked histories).
    order = {id(op): i for i, op in enumerate(client)}
    n = max(len(client), 1)

    def x(op) -> float:
        return LEFT + order.get(id(op), 0) * (WIDTH - LEFT - 20) / n

    parts: List[str] = []
    for p, lane in lanes.items():
        y = 30 + lane * LANE_H
        parts.append(f'<text x="8" y="{y + 14}" {FONT}>'
                     f'process {html.escape(str(p))}</text>')
    for inv, comp in pairs(client):
        lane = lanes[inv.process]
        y = 30 + lane * LANE_H + (LANE_H - BAR_H) / 2
        x0 = x(inv)
        x1 = x(comp) + 16 if comp is not None else WIDTH - 10
        color = TYPE_COLORS.get(comp.type if comp is not None else None)
        is_bad = comp is not None and comp.index == bad
        stroke = '#D0021B" stroke-width="2.5' if is_bad else '#888'
        label = f"{inv.f} {inv.value!r}"
        if comp is not None and comp.value != inv.value:
            label += f" → {comp.value!r}"
        parts.append(
            f'<rect x="{x0:.1f}" y="{y:.1f}" '
            f'width="{max(x1 - x0, 14):.1f}" height="{BAR_H}" rx="3" '
            f'fill="{color}" stroke="{stroke}"/>')
        parts.append(f'<text x="{x0 + 3:.1f}" y="{y + 14:.1f}" {FONT}>'
                     f'{html.escape(label)}</text>')

    y0 = 40 + len(lanes) * LANE_H
    lines = [f'<text x="8" y="{y0}" {FONT} font-weight="bold">'
             f'No configuration survives op {bad}: '
             f'{html.escape(str((result.get("op") or {}).get("f", "?")))}'
             f'</text>']
    for i, cfg in enumerate((result.get("configs") or [])[:10]):
        lines.append(f'<text x="8" y="{y0 + 16 * (i + 1)}" {FONT}>'
                     f'{html.escape(str(cfg))}</text>')
    height = y0 + 16 * (len(lines) + 1) + 10
    return (f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{WIDTH}" height="{height}">'
            f'<text x="8" y="18" {FONT} font-weight="bold">'
            f'linearizability counterexample</text>'
            + "".join(parts) + "".join(lines) + "</svg>")


def write_analysis(test: dict, model, history: Sequence[Op],
                   result: dict, opts: Optional[dict] = None
                   ) -> Optional[str]:
    """Render an invalid result to <run dir>/linear.svg (the
    checker.clj:98-103 seam). No-op when valid or no store attached;
    returns the written path."""
    if result.get("valid") is not False:
        return None
    from .core import out_path
    path = out_path(test, opts, "linear.svg")
    if path is None:
        return None
    with open(path, "w") as f:
        f.write(render_svg(model, list(history), result))
    return path
