"""Which devices the production routes see.

The reference develops and tests its multi-device routes on XLA's host
platform with n virtual CPU devices, provisioned once per process before
jax is imported. The port's mesh is driven from one process over a grid
of ``torch.device``s, so provisioning is a process-wide list of devices
that can be set and undone at any time: the same device may appear many
times (the one card named n times, like the reference's virtual CPU
devices), and a mesh over it runs the same program as one over n cards.

With nothing provisioned the production routes see the CUDA cards
(``torch.cuda.device_count()`` of them), so a one-card host keeps its
single-device routes. ``provision_in_process`` changes what ``devices()``
returns for this process; ``provisioned`` does it for a block and then
restores the previous list, which is how tests keep a mesh from leaking
into other tests that share their worker process.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

_PROVISIONED: Optional[List[torch.device]] = None


def _normal(device) -> torch.device:
    """``torch.device(device)`` with a CUDA index filled in (``"cuda"``
    means card 0), so that it compares equal to a tensor's device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def provision_in_process(n_devices: int = 8, device="cuda") -> None:
    """Make the production routes of this process see ``n_devices``
    devices, every one of them ``device`` (the card named n times, or
    ``"cpu"``)."""
    global _PROVISIONED
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: provision at least one")
    _PROVISIONED = [_normal(device)] * int(n_devices)


@contextlib.contextmanager
def provisioned(n_devices: int = 8, device="cuda"):
    """``provision_in_process`` for the block, then the previous list."""
    global _PROVISIONED
    before = _PROVISIONED
    provision_in_process(n_devices, device)
    try:
        yield devices()
    finally:
        _PROVISIONED = before


def devices() -> List[torch.device]:
    """The devices the production routes see: the provisioned list, else
    the CUDA cards."""
    if _PROVISIONED is not None:
        return list(_PROVISIONED)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
