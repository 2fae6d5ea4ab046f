"""Where the port's entry points run: the CUDA card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch version on the CPU")
        return torch.device("cuda")
    return torch.device(device)
