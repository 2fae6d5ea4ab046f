"""tools/trace_wide.py's stamped variant of K1's wide tiers is made by
text patches of the committed wgl_frontier.cu: each anchor must occur
once in wgl_wide_row. These tests apply the patches on the CPU (no
build), so that a change to wgl_wide_row that moves an anchor shows
here; update the anchors with it, or remove the script and this file
together."""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location(
    "trace_wide", ROOT / "tools" / "trace_wide.py")
TW = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TW)
SRC = ROOT / "jepsen_torch" / "ops" / "csrc" / "wgl_frontier.cu"

torch.set_num_threads(1)


@pytest.mark.parametrize("k", range(len(TW.TRACE_PATCHES)))
def test_each_anchor_occurs_once_in_the_committed_source(k):
    """And the patch only adds lines: the anchor's lines stay in the
    replacement, in their order."""
    old, new = TW.TRACE_PATCHES[k]
    assert SRC.read_text().count(old) == 1
    kept = iter(new.splitlines())
    assert all(line in kept for line in old.splitlines())


def test_variant_stamps_every_phase_and_leaves_the_source_alone():
    text = SRC.read_text()
    variant = TW.trace_variant_source(text)
    assert "g_trace" not in text and "TRACE_MARK" not in text
    marks = {int(m) for m in re.findall(r"TRACE_MARK\((\d)\);", variant)}
    assert marks == set(range(len(TW.TRACE_PHASES)))
    assert variant.endswith(TW.TRACE_READ)


def test_variant_refuses_a_source_without_the_anchors():
    with pytest.raises(RuntimeError, match="trace anchor"):
        TW.trace_variant_source("// no wide tier here\n")
