"""K1's wide tiers traced by phase on one NVIDIA GPU.

    python3 tools/trace_wide.py

Builds a variant of ``jepsen_torch/ops/csrc/wgl_frontier.cu`` under
``build/trace/`` with clock64 stamps put into ``wgl_wide_row`` by the
text patches below (each anchor must occur once in the committed
source, which is left as it is), and replays every wide launch of
``chip_smoke.py``'s dc headline (its dc runs, healthy and faulty) alone
from a fresh carry, through the committed library and through the
variant. Every warp attributes the cycles since its last stamp to a
phase and its lane 0 adds them to a device counter when the row ends:
setup (the table staged, the frontier and bitmaps loaded), staging
(each 32-event tile), event (an event's slot sets, up to its first
round), groups (a round's dirty groups taken and their slot steps
pushed), vote (a round's votes, flag stamps and barrier), completion
(an OK's two passes or a failure's latch) and final (the frontier
written back); with the rounds, the dirty groups expanded and the rows.
Prints one JSON line with the split, the counters and both libraries'
times (the stamps' cost), then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke_harness", os.path.join(ROOT, "chip_smoke.py"))
CS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CS)
DC_ROWS, DC_STALE = CS.DC_ROWS, CS.DC_STALE
LaunchRecorder, emit, require = CS.LaunchRecorder, CS.emit, CS.require
prepared_single, time_launches = CS.prepared_single, CS.time_launches
rw_history, rw_job = CS.rw_history, CS.rw_job

TRACE_PHASES = ("setup", "staging", "event", "groups", "vote",
                "completion", "final")
TRACE_PATCHES = (
    ("template <int NW>\n__device__ __noinline__ void wgl_wide_row(",
     "__device__ unsigned long long g_trace[10];\n"
     "#define TRACE_MARK(p) { const long long n_ = clock64(); "
     "tr_acc[p] += n_ - tr_t; tr_t = n_; }\n"
     "template <int NW>\n__device__ __noinline__ void wgl_wide_row("),
    ("  const int Gl = static_cast<int>(Ml >> 5);\n",
     "  const int Gl = static_cast<int>(Ml >> 5);\n"
     "  long long tr_t = clock64();\n"
     "  long long tr_acc[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long tr_rounds = 0, tr_groups = 0;\n"),
    ("  for (int e0 = 0; e0 < N && !dead; e0 += kWideTile) {\n"
     "    const int ne = min(kWideTile, N - e0);\n",
     "  TRACE_MARK(0);\n"
     "  for (int e0 = 0; e0 < N && !dead; e0 += kWideTile) {\n"
     "    const int ne = min(kWideTile, N - e0);\n"),
    ("    for (int j = 0; j < ne; ++j) {\n      const int typ = ttyp[j];\n",
     "    TRACE_MARK(1);\n"
     "    for (int j = 0; j < ne; ++j) {\n      TRACE_MARK(5);\n"
     "      const int typ = ttyp[j];\n"),
    ("      for (int r = 0;; ++r) {\n        ++stamp;\n",
     "      TRACE_MARK(2);\n"
     "      for (int r = 0;; ++r) {\n        ++stamp;\n"),
    ("            wch |= wide_group<NW>(",
     "            ++tr_groups;\n            wch |= wide_group<NW>("),
    ("        const bool vch = __any_sync(kFullMask, wch);\n",
     "        TRACE_MARK(3);\n        ++tr_rounds;\n"
     "        const bool vch = __any_sync(kFullMask, wch);\n"),
    ("        wide_sync(clog);\n        const volatile int* seen = fl;\n",
     "        wide_sync(clog);\n        TRACE_MARK(4);\n"
     "        const volatile int* seen = fl;\n"),
    ("  if (frontier_in_smem && (ok || Fbg != Fg)) {\n"
     "    for (int w = 0; w < NW; ++w)\n"
     "      for (uint32_t m = tid; m < Ml; m += nt)\n"
     "        Fg[static_cast<long long>(w) * M + off + m] = Fl[w * Ml + m];\n",
     "  TRACE_MARK(5);\n"
     "  if (frontier_in_smem && (ok || Fbg != Fg)) {\n"
     "    for (int w = 0; w < NW; ++w)\n"
     "      for (uint32_t m = tid; m < Ml; m += nt)\n"
     "        Fg[static_cast<long long>(w) * M + off + m] = Fl[w * Ml + m];\n"),
    ("  // No CTA leaves while another may still read its shared memory.\n"
     "  if (clog > 0) cg::this_cluster().sync();\n}\n",
     "  TRACE_MARK(6);\n"
     "  if (lane == 0) {\n"
     "    for (int p = 0; p < 7; ++p)\n"
     "      atomicAdd(&g_trace[p],\n"
     "                static_cast<unsigned long long>(tr_acc[p]));\n"
     "    atomicAdd(&g_trace[7], tr_rounds);\n"
     "    atomicAdd(&g_trace[8], tr_groups);\n"
     "    if (tid == 0) atomicAdd(&g_trace[9], 1ull);\n"
     "  }\n"
     "  // No CTA leaves while another may still read its shared memory.\n"
     "  if (clog > 0) cg::this_cluster().sync();\n}\n"),
)
TRACE_READ = """
extern "C" int wgl_trace_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, zero, sizeof(zero)));
}
"""


def trace_variant_source(src: str) -> str:
    """The stamped variant of wgl_frontier.cu's text (TRACE_PATCHES)."""
    for old, new in TRACE_PATCHES:
        require(src.count(old) == 1,
                f"trace anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src + TRACE_READ


def trace_wide() -> None:
    """K1's wide tiers on every launch of the dc headline's dc runs
    (healthy and faulty), each launch replayed alone from a fresh carry
    by the committed library and by the stamped variant: the phase split
    of the variant's warp cycles, its counters, and both libraries'
    times (the stamps' cost)."""
    from jepsen_torch.history.columnar import ops_to_columnar
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import _build
    from jepsen_torch.ops import linearize as L
    W = L.cuda_wgl
    W.build()
    plain_lib = W._LIB
    path = os.path.join(ROOT, "build", "trace", "wgl_frontier_trace.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(W.SRC) as f:
        variant = trace_variant_source(f.read())
    with open(path, "w") as f:
        f.write(variant)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _build.build_library(path, {
        "wgl_frontier_launch": ([p, p, p, i, p, ctypes.c_longlong, p, p, p,
                                 p] + [i] * 15 + [p], ctypes.c_int),
        "wgl_frontier_error": ([ctypes.c_int], ctypes.c_char_p),
        "wgl_trace_read": ([ctypes.POINTER(ctypes.c_ulonglong)],
                           ctypes.c_int)})
    counters = (ctypes.c_ulonglong * 10)()

    def read():
        torch.cuda.synchronize()
        require(lib.wgl_trace_read(counters) == 0, "trace read failed")
        return list(counters)

    out = {"phase": "trace_wide", "phases": TRACE_PHASES, "runs": {},
           "ptxas": [ln.strip() for ln in _build.BUILD_LOGS.get(
               os.path.basename(path), "").splitlines()
               if "wgl_wide_kernel" in ln or "spill" in ln
               or "registers" in ln][:12]}
    for label, stale_rows in (("healthy", set()),
                              ("faulty", set(range(0, DC_ROWS, 8)))):
        hists = [rw_history(rw_job(s, DC_STALE if s in stale_rows else 0.0))
                 for s in range(DC_ROWS)]
        with LaunchRecorder(W) as k1:
            cols = ops_to_columnar(cas_register(), hists, max_states=64)
            L.check_columnar(cas_register(), cols, details="invalid",
                             scheduler_opts={"wgl_backend": "dc"})
        singles = [(a, kw) for a, kw in k1.singles if kw["W"] > W.W_WARP]
        require(singles and not k1.groups,
                f"{label}: no wide single launch, or a group launch")
        launches = []
        for a, kw in singles:
            W._LIB = plain_lib
            ms = time_launches([prepared_single(L, *a, **kw)], reps=3)
            W._LIB = lib
            prep = prepared_single(L, *a, **kw)
            traced_ms = time_launches([prep], reps=1)
            read()                       # the warm-up and timed windows
            prep[0]()
            prep[1]()
            c = read()
            plan = W.smem_plan(kw["V"], kw["W"], kw["w_live"],
                               K1=a[3].shape[-2],
                               shared_target=a[3].dim() == 2)
            launches.append({
                "V": kw["V"], "W": kw["W"], "rows": int(a[0].shape[0]),
                "events": int(a[0].shape[1]), "tier": plan["tier"],
                "cluster_ctas": plan["cluster_ctas"],
                "threads": plan["threads"], "ms": ms, "traced_ms": traced_ms,
                "cycles": dict(zip(TRACE_PHASES, c[:7])),
                "rounds": c[7], "groups": c[8], "rows_done": c[9]})
        W._LIB = plain_lib
        total = {ph: sum(x["cycles"][ph] for x in launches)
                 for ph in TRACE_PHASES}
        allc = sum(total.values())
        out["runs"][label] = {
            "launches": launches, "ms": sum(x["ms"] for x in launches),
            "traced_ms": sum(x["traced_ms"] for x in launches),
            "cycles": total,
            "share": {ph: total[ph] / allc for ph in TRACE_PHASES},
            "rounds": sum(x["rounds"] for x in launches),
            "groups": sum(x["groups"] for x in launches)}
    emit(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_wide: no CUDA device is available", file=sys.stderr)
        return 2
    smi = CS.nvidia_smi()
    trace_wide()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
