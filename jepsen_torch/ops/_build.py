"""Build and load the port's native libraries: the hand-written CUDA
kernels and the C++ host engines.

Each ``csrc/*.cu`` source exposes a plain C interface. ``build_library``
compiles one with ``nvcc`` into a shared library at first use, under
``build/jepsen_torch/`` at the root of the checkout, named by a hash of
the source and the flags (a changed source rebuilds, an unchanged one
loads in milliseconds), loads it with ``ctypes`` and sets the argument
and return types of the symbols it is given. The host engines of
``jepsen_torch/native`` build the same way with ``g++`` (``GXX_FLAGS``):
a plain C library through ``build_library(..., compiler="g++")`` and a
CPython extension through ``load_extension``. A failed build raises with
the compiler's output; nothing falls back. Nothing here runs when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jepsen_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# The compiler's output (for nvcc: register and shared-memory use) per
# source name, from this process's builds.
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


def _executable(compiler: str) -> str:
    if compiler == "nvcc":
        return shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return shutil.which(compiler) or compiler


def compile_source(src: Path, compiler: str = "nvcc",
                   flags: Sequence[str] = NVCC_FLAGS,
                   libs: Sequence[str] = (), name: str = "") -> Path:
    """Compile ``src`` into ``BUILD_DIR`` once per hash of the source and
    the flags, and return the shared library's path. The compiler writes
    a file named by the process id, renamed into place when it is whole,
    so processes that build the same source at once never see a torn
    library. ``name`` is the file's stem (default ``lib<source stem>``);
    ``libs`` follow the source on the command line."""
    data = Path(src).read_bytes()
    tag = hashlib.sha256(data + " ".join([*flags, *libs]).encode()
                         ).hexdigest()
    so = BUILD_DIR / f"{name or 'lib' + Path(src).stem}-{tag[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = _executable(compiler)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([exe, *flags, "-o", str(tmp), str(src), *libs],
                              capture_output=True, text=True)
        BUILD_LOGS[Path(src).name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(exe).name} failed to build "
                               f"{Path(src).name}:\n"
                               f"{BUILD_LOGS[Path(src).name]}")
        os.replace(tmp, so)
    return so


def build_library(src: Path, symbols: Dict[str, Tuple[Sequence, object]],
                  *, compiler: str = "nvcc",
                  flags: Sequence[str] = NVCC_FLAGS,
                  libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``src`` (once per source hash), load it, and declare each
    of ``symbols``: ``{name: (argtypes, restype)}``."""
    lib = ctypes.CDLL(str(compile_source(src, compiler, flags, libs)))
    for name, (argtypes, restype) in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def load_extension(module: str, src: Path, flags: Sequence[str],
                   compiler: str = "g++"):
    """Compile the CPython extension ``module`` from ``src`` (once per
    source hash) and import it without registering it in
    ``sys.modules``."""
    so = compile_source(src, compiler, flags, name=module)
    spec = importlib.util.spec_from_file_location(module, so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
