"""Smoke run of the jepsen_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA WGL kernel from the checkout's sources, holds it bit for
bit against its plain PyTorch version on the card (frontiers in shared
and in device memory, two state words, the event-chunked resume entry),
then drives the port's main path — ``check_batch`` on 10,000 seeded
CAS-register histories of 1,000 invocations each — and checks its
verdicts against the host oracle on sampled rows. Each phase prints one
JSON line; a failed check raises and the script exits non-zero. The
last three lines are the kernels line, the card's name and power limit
as nvidia-smi reports them, and the result line.

Exits 2 without a result when no CUDA device is available.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# The card's published peaks (H100 SXM data sheet, full 700 W power
# limit): device memory rate, and the int32 lane-op rate — half the
# 67 TFLOP/s float32 FMA rate's lanes (64 INT32 lanes per SM against 128
# FP32 lanes), one op per lane per clock: 67e12 / 2 / 2.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

NS_HISTORIES = 10_000     # north-star batch: 10k histories ...
NS_OPS = 1_000            # ... of 1,000 invocations each
ORACLE_ROWS = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def on(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def bucket_args(b, dev):
    tgt = b.target[0] if b.shared_target else b.target
    return (on(b.ev_type, dev), on(b.ev_slot, dev), on(b.ev_slots, dev),
            on(tgt, dev))


def kernel_vs_plain(args, V, W, w_live, dev, L, idx0=0):
    """Run one batch through the CUDA kernel and the plain version on
    the card from a fresh carry; return (equal, max_abs_err, rows
    invalid)."""
    carry = L.initial_carry(args[0].shape[0], V, W, dev)
    kv, kb, kf, kfb = L.get_kernel(V, W, w_live=w_live,
                                   resume=True)(*args, idx0, *carry)
    pv, pb, pf, pfb = L.plain_wgl(*args, idx0, *carry, V=V, W=W,
                                  w_live=w_live)
    torch.cuda.synchronize()
    equal = (torch.equal(kv, pv) and torch.equal(kb, pb)
             and torch.equal(kf, pf) and torch.equal(kfb, pfb))
    err = 0
    for x, y in ((kb, pb), (kf, pf), (kfb, pfb)):
        d = (x.to(torch.int64) & 0xFFFFFFFF) - (y.to(torch.int64)
                                                & 0xFFFFFFFF)
        err = max(err, int(d.abs().max()) if d.numel() else 0)
    err = max(err, int((kv != pv).sum()))
    return equal, err, int((~kv).sum())


# Seeded random tables (V, W, w_live, K1, shared target): every event
# code, slot and kind indices past both ends (they clamp and wrap as in
# the reference), int32 slot tables (K1 >= 127), two state words with
# bit 31, w_live < W, and a frontier in device memory.
RANDOM_CASES = ((8, 5, None, 7, True), (8, 9, 6, 12, False),
                (48, 6, None, 200, True), (64, 4, None, 9, False),
                (8, 16, 3, 6, True))


def random_tables(rng, B, N, V, W, w_live, K1, shared, dev):
    ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
    ev_slot = rng.integers(-1, W + 1, (B, N)).astype(np.int8)
    ev_slots = rng.integers(-1, K1 + 1, (B, N, W))
    # the completing slot holds a real op kind, as in an encoded history
    q = np.clip(ev_slot, 0, (w_live or W) - 1).astype(np.int64)
    ev_slots[np.arange(B)[:, None], np.arange(N)[None], q] = \
        rng.integers(0, K1 - 1, (B, N))
    ev_slots = ev_slots.astype(np.int8 if K1 < 127 else np.int32)
    shape = (K1, V) if shared else (B, K1, V)
    target = rng.integers(-1, V, shape).astype(np.int32)
    target[rng.random(shape) < 0.5] = -1     # rows both fail and survive
    target[..., K1 - 1, :] = -1
    return tuple(on(a, dev) for a in (ev_type, ev_slot, ev_slots, target))


def phase_kernel_parity(dev, L, synth, cas, prep, bucket_encode):
    out = {"phase": "kernel_vs_plain", "buckets": []}
    max_err = 0
    # (a) W = 6..18: shared-memory and device-memory frontiers.
    ha = synth(256, seed0=1, n_procs=5, n_ops=200, n_values=5,
               corrupt=0.25, p_info=0.05)
    ba = bucket_encode(cas(), [prep(h) for h in ha], max_states=64,
                       max_slots=18)
    # (b) two state words: V = 40 and 48.
    hb = synth(16, seed0=5, n_procs=4, n_ops=300, n_values=48,
               corrupt=0.25)
    bb = bucket_encode(cas(), [prep(h) for h in hb], max_states=64,
                       max_slots=18)
    Ws, Vs = set(), set()
    for tag, bs in (("a", ba), ("b", bb)):
        for b in bs:
            if not b.batch:
                continue
            eq, err, inv = kernel_vs_plain(bucket_args(b, dev), b.V, b.W,
                                           b.eff_w_live, dev, L)
            plan = L.cuda_wgl.smem_plan(b.V, b.W, b.eff_w_live)
            out["buckets"].append({
                "corpus": tag, "V": b.V, "W": b.W, "rows": b.batch,
                "events": b.n_events, "invalid": inv, "equal": eq,
                "frontier_in_smem": plan["frontier_in_smem"]})
            require(eq, f"kernel != plain at corpus {tag} V={b.V} "
                        f"W={b.W}")
            max_err = max(max_err, err)
            Ws.add(b.W)
            Vs.add(b.V)
    require(set(range(6, 19)) <= Ws, f"corpus (a) missed a W: {sorted(Ws)}")
    require(any(v > 32 for v in Vs), "no two-word corpus")
    # Seeded random tables, resumed at a nonzero event index.
    rng = np.random.default_rng(2024)
    for V, W, wl, K1, shared in RANDOM_CASES:
        args = random_tables(rng, 64, 48, V, W, wl, K1, shared, dev)
        eq, err, inv = kernel_vs_plain(args, V, W, wl, dev, L, idx0=1000)
        out["buckets"].append({
            "corpus": "random", "V": V, "W": W, "w_live": wl, "K1": K1,
            "shared_target": shared, "rows": 64, "events": 48,
            "invalid": inv, "equal": eq})
        require(eq, f"kernel != plain on random tables V={V} W={W}")
        max_err = max(max_err, err)
    # (c) the resume entry: event-chunked equals one-shot.
    resumed = 0
    for b in [x for x in ba if x.batch and x.W <= 12] + bb:
        one = L.run_encoded_batch(b, True, device=dev)
        chunked = L.run_event_chunked(b, 24, True, device=dev)
        for x, y in zip(one, chunked):
            require(np.array_equal(x, y),
                    f"chunked != one-shot at V={b.V} W={b.W}")
        resumed += 1
    out["resume_buckets"] = resumed
    out["max_abs_err"] = max_err
    emit(out)
    return max_err


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_main_path(dev, L, synth, cas, prep, bucket_encode, wgl_check):
    from jepsen_torch.ops.encode import take_rows
    t0 = time.perf_counter()
    hists = synth(NS_HISTORIES, seed0=0, n_procs=5, n_ops=NS_OPS,
                  n_values=5, corrupt=0.25, p_info=0.0)
    synth_s = time.perf_counter() - t0

    L.cuda_wgl.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = L.check_batch(cas(), hists)
    e2e_s = time.perf_counter() - t0
    launches = L.cuda_wgl.LAUNCHES
    require(launches > 0, "check_batch did not launch the kernel")
    require(len(results) == NS_HISTORIES, "missing verdicts")
    require(not any("fallback" in r for r in results),
            "north-star rows fell back to the host")

    # Field parity with the host oracle on sampled rows, invalid ones
    # included.
    invalid = [i for i, r in enumerate(results) if r["valid"] is False]
    valid = [i for i, r in enumerate(results) if r["valid"] is True]
    sample = invalid[:ORACLE_ROWS // 2] + valid[:ORACLE_ROWS // 2]
    require(len(sample) >= ORACLE_ROWS and invalid, "sample too small")
    for i in sample:
        want = wgl_check(cas(), hists[i])
        got = results[i]
        require(got["valid"] == want["valid"], f"verdict differs at {i}")
        if want["valid"] is False:
            require(got["op"]["index"] == want["op"]["index"],
                    f"bad op differs at {i}")
        require(got.get("configs") == want.get("configs"),
                f"configs differ at {i}")

    # The same batch again, layer by layer: host prepare, host encode,
    # host-to-device copy, the kernel, and the plain version.
    t0 = time.perf_counter()
    prepared = [prep(h) for h in hists]
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = [b for b in bucket_encode(cas(), prepared, max_states=64,
                                        max_slots=18) if b.batch]
    encode_s = time.perf_counter() - t0
    big = max(buckets, key=lambda b: b.batch)
    head = take_rows(big, range(min(256, big.batch)))
    eq, err, _ = kernel_vs_plain(bucket_args(head, dev), head.V, head.W,
                                 head.eff_w_live, dev, L)
    require(eq, "kernel != plain on the north-star slice")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    argsets = [(b, bucket_args(b, dev)) for b in buckets]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    kerns = [L.get_kernel(b.V, b.W, w_live=b.eff_w_live) for b in buckets]

    def run_kernel():
        for k, (_, a) in zip(kerns, argsets):
            k(*a)

    saved = L.cuda_wgl.LAUNCHES
    kernel_ms = time_cuda(run_kernel, reps=5)
    L.cuda_wgl.LAUNCHES = saved

    # Plain version on the same inputs, timed.
    def run_plain(**counters):
        for j, (b, a) in enumerate(argsets):
            L.plain_wgl(*a, 0, *L.initial_carry(b.batch, b.V, b.W, dev),
                        V=b.V, W=b.W, w_live=b.eff_w_live,
                        **{k: v[j] for k, v in counters.items()})

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # Once more, untimed, counting per row the closure sweeps and the
    # integer operations this batch's data needs (each closure
    # configuration expanded once per reaching slot, one word test per
    # kept mask): the latter is the op-count bound's input.
    sweeps = [torch.zeros(b.batch, dtype=torch.int64, device=dev)
              for b, _ in argsets]
    needed = [torch.zeros(b.batch, dtype=torch.int64, device=dev)
              for b, _ in argsets]
    run_plain(iters=sweeps, ops=needed)

    ops = sum(int(nd.sum()) for nd in needed)
    dense = nbytes = 0
    for (b, a), it in zip(argsets, sweeps):
        # The reference's dense formulation (vpu_op_model: every state
        # bit of every mask tested on every sweep), for comparison only.
        model = L.vpu_op_model(b.V, b.W, b.eff_w_live)
        live = int(np.isin(b.ev_type, (2, 3, 4)).sum())
        dense += model["per_iteration"] * int(it.sum()) \
            + model["per_event"] * live
        # inputs read once; outputs valid (bool), bad (int32) and the
        # frontier (int32 [B, words, 2^W]) written once
        nbytes += sum(t.numel() * t.element_size() for t in a) \
            + b.batch * (1 + 4 + 4 * model["words"] * model["masks"])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    emit({"phase": "main_path", "histories": NS_HISTORIES,
          "ops_per_history": NS_OPS, "synth_s": synth_s,
          "check_batch_s": e2e_s,
          "histories_per_s": NS_HISTORIES / e2e_s,
          "invalid": len(invalid), "oracle_rows": len(sample),
          "prepare_s": prepare_s, "encode_s": encode_s,
          "upload_ms": upload_ms, "kernel_ms": kernel_ms,
          "rest_s": e2e_s - prepare_s - encode_s
          - (upload_ms + kernel_ms) / 1e3,
          "buckets": [{"V": b.V, "W": b.W, "rows": b.batch,
                       "events": b.n_events} for b in buckets],
          "launches": launches, "plain_ms": plain_ms,
          "closure_sweeps": sum(int(it.sum()) for it in sweeps),
          "needed_ops": ops, "dense_model_lane_ops": dense,
          "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms})
    return {"launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from jepsen_torch.checkers.linearizable import prepare_history, wgl_check
    from jepsen_torch.models.core import cas_register
    from jepsen_torch.ops import linearize as L
    from jepsen_torch.ops.encode import bucket_encode
    from jepsen_torch.workloads.synth import synth_cas_batch

    smi = nvidia_smi()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    L.cuda_wgl.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in L.cuda_wgl.BUILD_LOG.splitlines()
             if "registers" in ln or "smem" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    parity_err = phase_kernel_parity(dev, L, synth_cas_batch, cas_register,
                                     prepare_history, bucket_encode)
    main_k = phase_main_path(dev, L, synth_cas_batch, cas_register,
                             prepare_history, bucket_encode, wgl_check)
    emit({"kernels": [{
        "name": "wgl_frontier", "route": "cuda",
        "source": "jepsen_torch/ops/csrc/wgl_frontier.cu",
        "replaces": "jepsen_tpu/ops/pallas_wgl.py:190",
        "launches": main_k["launches"], "parity": True,
        "max_abs_err": max(parity_err, main_k["max_abs_err"]),
        "ms": main_k["ms"], "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"], "bound_by": main_k["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
