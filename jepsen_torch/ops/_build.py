"""Build and load the port's hand-written CUDA libraries.

Each ``csrc/*.cu`` source exposes a plain C interface. ``build_library``
compiles one with ``nvcc`` into a shared library at first use, under
``build/jepsen_torch/`` at the root of the checkout, named by a hash of
the source and the flags (a changed source rebuilds, an unchanged one
loads in milliseconds), loads it with ``ctypes`` and sets the argument
and return types of the symbols it is given. A failed build raises with
nvcc's output; nothing falls back. Nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jepsen_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output (register and shared-memory use) per source name, from
# this process's builds.
BUILD_LOGS: Dict[str, str] = {}

# cudaErrorMemoryAllocation: the one launch error the fault ladder treats
# as an out-of-memory (ops.faults.classify_failure).
CUDA_ERROR_MEMORY_ALLOCATION = 2


class CudaLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error: ``code`` is the
    cudaError_t, ``entry`` the kernel's name."""

    def __init__(self, entry: str, code: int, message: str):
        super().__init__(f"{entry} launch failed: {message}")
        self.entry, self.code = entry, int(code)


def build_library(src: Path, symbols: Dict[str, Tuple[Sequence, object]]
                  ) -> ctypes.CDLL:
    """Compile ``src`` (once per source hash), load it, and declare each
    of ``symbols``: ``{name: (argtypes, restype)}``."""
    data = Path(src).read_bytes()
    tag = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{Path(src).stem}-{tag[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        BUILD_LOGS[Path(src).name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {Path(src).name}:\n"
                               f"{BUILD_LOGS[Path(src).name]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib
